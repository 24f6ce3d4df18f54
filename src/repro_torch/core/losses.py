"""Loss functions for the decentralized learning objective (Section 2).

All losses are convex in the prediction; in the RF space the composite local
objective R_hat_i(theta) is (strongly, with the ridge term) convex — the
property Remark 1 of the paper highlights as the payoff of RF mapping.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding


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
    (N, T_i) give the (N,) per-agent risks, each of its own row only. A
    sweep's lanes, theta (G, N, D) against the same feats, give (G, N):
    one product per agent with the lanes as its G columns (Phi is not
    repeated per lane).
    """
    if theta.ndim == 3 and feats.ndim == 3:
        preds = torch.bmm(feats, theta.permute(1, 2, 0)).permute(2, 0, 1)
    else:
        preds = (feats @ theta[..., None])[..., 0]
    data_term = torch.mean(LOSSES[loss](labels, preds), dim=-1)
    return data_term + lam * torch.sum(theta * theta, dim=-1)


def _dloss(preds: torch.Tensor, labels: torch.Tensor,
           loss: str) -> torch.Tensor:
    """d/dpreds of the agent sum of the mean losses, by autograd."""
    with torch.enable_grad():
        p = preds.detach().requires_grad_(True)
        data = torch.mean(LOSSES[loss](labels, p), dim=-1)
        (g,) = torch.autograd.grad(torch.sum(data), p)
    return g


def data_grad(theta, feats, labels, loss: str = "quadratic"):
    """d/dtheta of the agent sum of the data terms of
    `local_empirical_risk`: Phi_i' dloss_i for theta (N, D), or a sweep's
    lanes theta (G, N, D) against the same feats. The products are those
    autograd of the risk takes, so the bits are its bits. On feature-
    sharded (`distributed.sharding.Blocked`) operands Phi_i theta_i is the
    psum of the feature blocks' partials and Phi_i' dloss_i block-local."""
    if theta.ndim == 3 and feats.ndim == 3:
        preds = torch.bmm(feats, theta.permute(1, 2, 0)).permute(2, 0, 1)
        dp = _dloss(preds, labels, loss)
        return torch.bmm(feats.transpose(1, 2),
                         dp.permute(1, 2, 0)).permute(2, 0, 1)
    preds = torch.einsum("ntd,nd->nt", feats, theta)
    dp = sharding.local(_dloss, preds, labels, loss)
    return torch.einsum("ntd,nt->nd", feats, dp)


def risk_grad(theta, feats, labels, lam: float,
              loss: str = "quadratic"):
    """d/dtheta of the agent sum of `local_empirical_risk`: (N, D), each
    row the gradient of its own agent's risk, summed as autograd of the
    risk sums it (the data term, then the ridge term's two halves)."""
    reg = lam * theta
    return data_grad(theta, feats, labels, loss) + (reg + reg)
