"""Centralized closed-form solvers: the oracles the decentralized algorithms
converge to (Theorems 1/2 measure the distance to these).

* `rf_ridge`: Eq. (26), theta* = (Phi~'Phi~ + lam I)^{-1} Phi~'y~ in the RF
  space (dimension D).
* `kernel_ridge`: Eq. (37) in the full RKHS (dimension T), for small tests:
  it carries the curse of dimensionality the paper escapes.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def rf_ridge(feats_all: torch.Tensor, labels_all: torch.Tensor,
             lam: float) -> torch.Tensor:
    """Optimal theta* (D,) of the RF-space objective (25)/(26), with the
    1/sqrt(T_i) row scaling of equal shards. The oracle is the
    centralized solve: on a mesh it gathers the feature-sharded Phi."""
    from repro_torch.distributed.sharding import unshard

    feats_all, labels_all = unshard(feats_all), unshard(labels_all)
    N, Ti, D = feats_all.shape
    # 1/sqrt(T_i) rounded to float32, as the reference forms it
    scale = float(np.float32(1.0) / np.sqrt(np.float32(Ti)))
    phi = (feats_all * scale).reshape(N * Ti, D)
    y = (labels_all * scale).reshape(N * Ti)
    gram = phi.T @ phi + lam * torch.eye(D, dtype=phi.dtype,
                                         device=phi.device)
    return torch.linalg.solve(gram, phi.T @ y)


def kernel_ridge(kernel_matrix: torch.Tensor, labels: torch.Tensor,
                 lam: float, num_samples_per_agent: int) -> torch.Tensor:
    """Optimal alpha* of Eq. (37) with equal shards: kernel_matrix (T, T)
    over all data, labels (T,). With K~ = K / sqrt(T_i) and y~ = y /
    sqrt(T_i), alpha* = (K K / T_i + lam K)^{-1} K y / T_i."""
    Ti = num_samples_per_agent
    K = kernel_matrix
    T = K.shape[0]
    lhs = K @ K / Ti + lam * K + 1e-8 * torch.eye(T, dtype=K.dtype,
                                                  device=K.device)
    rhs = K @ labels / Ti
    return torch.linalg.solve(lhs, rhs)


def effective_degrees_of_freedom(kernel_matrix: torch.Tensor,
                                 lam: float) -> torch.Tensor:
    """d_K^lambda = Tr(K (K + lam T I)^{-1}), Theorem 3's feature-count
    knob."""
    T = kernel_matrix.shape[0]
    eig = torch.linalg.eigvalsh(kernel_matrix)
    return torch.sum(eig / (eig + lam * T))


def sufficient_features(kernel_matrix: torch.Tensor, lam: float,
                        eps: float = 0.5, delta: float = 0.1) -> float:
    """The L >= (1/lam)(1/eps^2 + 2/(3 eps)) log(16 d_K^lam / delta)
    bound."""
    d = float(effective_degrees_of_freedom(kernel_matrix, lam))
    return (1.0 / lam) * (1.0 / eps**2 + 2.0 / (3.0 * eps)) * math.log(
        16.0 * d / delta)
