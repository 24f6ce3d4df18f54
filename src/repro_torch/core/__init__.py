"""Core of the paper, ported: RF mapping, graphs, losses, censoring, the
comm chain, the step skeleton and the problem description."""
from repro_torch.core import (admm, censor, comm, graph,  # noqa: F401
                              losses, rff, ridge, step, tree)
