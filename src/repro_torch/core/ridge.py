"""The centralized closed-form oracle the decentralized algorithms converge
to: Eq. (26), theta* = (Phi~'Phi~ + lam I)^{-1} Phi~'y~ in the RF space."""
from __future__ import annotations

import math

import torch


def rf_ridge(feats_all: torch.Tensor, labels_all: torch.Tensor,
             lam: float) -> torch.Tensor:
    """Optimal theta* (D,) of the RF-space objective (25)/(26), with the
    1/sqrt(T_i) row scaling of equal shards."""
    N, Ti, D = feats_all.shape
    scale = 1.0 / math.sqrt(Ti)
    phi = (feats_all * scale).reshape(N * Ti, D)
    y = (labels_all * scale).reshape(N * Ti)
    gram = phi.T @ phi + lam * torch.eye(D, dtype=phi.dtype,
                                         device=phi.device)
    return torch.linalg.solve(gram, phi.T @ y)
