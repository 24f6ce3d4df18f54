"""Communication censoring — the CO in COKE.

Agent i transmits theta_i^k iff ||theta_hat_i^{k-1} - theta_i^k||_2 >= h(k)
(Eqs. 19-20), with h(k) = v mu^k. The decision is applied by value-masking:
receivers keep the stale broadcast of a censored agent.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CensorSchedule:
    """h(k) = v * mu^k. v=0 disables censoring (COKE degenerates to DKLA)."""

    v: float = 1.0
    mu: float = 0.95

    def __call__(self, k: int) -> float:
        """The threshold at iteration k, rounded to float32 as the
        reference's traced threshold is."""
        return float(np.float32(self.v) * np.float32(self.mu) ** np.float32(k))


def lane_thresholds(v, mu, k: int) -> np.ndarray:
    """h_g(k) for G lanes' (v_g, mu_g): (G,) float32, each formed as
    `CensorSchedule(v_g, mu_g)(k)` forms one (numpy float32 scalars, so a
    lane's threshold is bitwise the single fit's)."""
    return np.array([CensorSchedule(float(a), float(b))(k)
                     for a, b in zip(np.asarray(v), np.asarray(mu))],
                    dtype=np.float32)


def censor_decision(theta: torch.Tensor, theta_hat_prev: torch.Tensor,
                    threshold: float) -> torch.Tensor:
    """send flag per agent: ||theta_hat_prev - theta||_2 >= h(k).

    theta, theta_hat_prev: (..., D); returns bool (...,). threshold is a
    host float, or a tensor broadcast against the (...,) norms (a sweep's
    (G, 1) per-lane thresholds against (G, N) norms)."""
    xi = theta_hat_prev - theta
    return torch.sqrt(torch.sum(xi * xi, dim=-1)) >= threshold


def masked_broadcast(theta: torch.Tensor, theta_hat_prev: torch.Tensor,
                     send: torch.Tensor) -> torch.Tensor:
    """theta_hat^k = theta^k where transmitted, else the stale copy; one
    decision per agent masks the trailing feature axis wholesale."""
    if theta.ndim < 1:
        raise ValueError(
            f"masked_broadcast needs a trailing feature axis; got scalar "
            f"theta of shape {tuple(theta.shape)}")
    if theta.shape != theta_hat_prev.shape:
        raise ValueError(
            f"theta {tuple(theta.shape)} and theta_hat_prev "
            f"{tuple(theta_hat_prev.shape)} must match")
    if theta.dtype != theta_hat_prev.dtype:
        raise ValueError(
            f"theta dtype {theta.dtype} != theta_hat_prev dtype "
            f"{theta_hat_prev.dtype}: a silent upcast would desynchronize "
            "the replicas' broadcast values")
    if send.shape != theta.shape[:-1]:
        raise ValueError(
            f"send {tuple(send.shape)} must be theta's batch shape "
            f"{tuple(theta.shape[:-1])} (one decision per agent)")
    if send.dtype != torch.bool:
        raise ValueError(f"send must be boolean, got {send.dtype}")
    return torch.where(send[..., None], theta, theta_hat_prev)
