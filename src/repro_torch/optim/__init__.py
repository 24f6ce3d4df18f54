"""Optimizers over dicts of tensors (SGD, AdamW): the deep-net training
loop's and the ring runtime's inner solver."""
from repro_torch.optim.optimizers import (OptConfig,  # noqa: F401
                                          apply_updates, init_opt_state,
                                          opt_update)
