"""Loss functions for the decentralized learning objective (Section 2).

All losses are convex in the prediction; in the RF space the composite local
objective R_hat_i(theta) is (strongly, with the ridge term) convex — the
property Remark 1 of the paper highlights as the payoff of RF mapping.
"""
from __future__ import annotations

import torch


def quadratic(y: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
    """(y - y_hat)^2 — regression (the paper's analyzed case)."""
    return (y - y_hat) ** 2


def logistic(y: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(-y * y_hat)) — binary classification, y in {-1, +1}."""
    z = -y * y_hat
    return torch.logaddexp(torch.zeros_like(z), z)


def hinge(y: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
    """max(0, 1 - y * y_hat) — SVM-style classification. torch.maximum
    splits the gradient evenly at a tie, as the reference's jnp.maximum
    does (clamp and relu would not)."""
    m = 1.0 - y * y_hat
    return torch.maximum(torch.zeros_like(m), m)


LOSSES = {"quadratic": quadratic, "logistic": logistic, "hinge": hinge}


def local_empirical_risk(theta: torch.Tensor, feats: torch.Tensor,
                         labels: torch.Tensor, lam: float,
                         loss: str = "quadratic") -> torch.Tensor:
    """R_hat_i(theta) of Eq. (15): mean loss over the local shard + ridge.

    feats: (T_i, D) RF-mapped inputs; labels: (T_i,); lam is lambda_i (the
    per-agent share lambda/N in the common-regularizer convention). Leading
    dims batch over agents: theta (N, D), feats (N, T_i, D), labels
    (N, T_i) give the (N,) per-agent risks, each of its own row only.
    """
    preds = (feats @ theta[..., None])[..., 0]
    data_term = torch.mean(LOSSES[loss](labels, preds), dim=-1)
    return data_term + lam * torch.sum(theta * theta, dim=-1)

