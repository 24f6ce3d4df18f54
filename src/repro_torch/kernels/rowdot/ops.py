"""Public entry points of the gathered row-dot (K6), as the many-model
scorer (`api.model.score_rows`) calls them."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.rowdot.rowdot import gather_rowdot


def rowdot(phi: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    """Row i of phi (B, D) against row i of thetas (B, D): the gathered
    row-dot with slots 0 .. B-1, so the same bits as any gather of the same
    rows."""
    return gather_rowdot(phi, thetas,
                         np.arange(phi.shape[0], dtype=np.int32))


__all__ = ["gather_rowdot", "rowdot"]
