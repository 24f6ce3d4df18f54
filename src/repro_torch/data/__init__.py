"""Data substrate: the paper's datasets and the LM token stream (numpy,
equal to the reference's)."""
from repro_torch.data import synthetic, tokens  # noqa: F401
from repro_torch.data.synthetic import (Dataset, paper_synthetic,  # noqa: F401
                                        uci_standin)
