"""Core of the paper, ported: RF mapping, graphs, censoring, the comm chain,
the step skeleton and the problem description."""
from repro_torch.core import (admm, censor, comm, graph, rff,  # noqa: F401
                              ridge, step)
