"""Plain PyTorch version of the gathered row-dot (K6)."""
from __future__ import annotations

import torch


def gather_rowdot_ref(phi: torch.Tensor, stack: torch.Tensor,
                      slots: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_k phi[i, k] * stack[slots[i], k]: phi (B, D), stack
    (M, D), slots (B,) int32 on phi's device -> (B,)."""
    return (phi * stack.index_select(0, slots)).sum(-1)
