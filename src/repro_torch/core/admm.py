"""The decentralized RF-space learning problem (the reference's
`core/admm.py::Problem` and `make_problem`).

The problem description and `resolve_primal` are ported here; the
simulator's primal solves (Cholesky, CG, inner gradient descent) are
ROADMAP.md Queue 1 item 3. The fused backend runs the gradient primal inside
the `coke_megastep` kernel, the ring runtime as one optimizer step
(`distributed/consensus.py`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph import Graph

#: primal modes FitConfig accepts (as in the reference)
PRIMAL_MODES = ("auto", "cholesky", "cg", "gradient")
#: feature count above which primal="auto" picks CG over Cholesky
CG_CROSSOVER_DIM = 2048


def resolve_primal(primal: str, feature_dim: int, loss: str) -> str:
    """Resolve a FitConfig primal mode to the concrete update that runs.

    auto     -> "cholesky" up to CG_CROSSOVER_DIM features, "cg" above;
                general losses have no normal equations and fall back to
                "gradient".
    cholesky / cg -> forced; both solve (21a) and require the quadratic
                loss (ValueError otherwise).
    gradient -> the inexact gradient primal (any loss).
    """
    if primal not in PRIMAL_MODES:
        raise ValueError(
            f"unknown primal mode {primal!r}; choose from {PRIMAL_MODES}")
    if loss != "quadratic":
        if primal in ("cholesky", "cg"):
            raise ValueError(
                f"primal={primal!r} solves the quadratic-loss (21a) normal "
                f"equations; loss={loss!r} has none — use primal='gradient'")
        return "gradient"
    if primal == "auto":
        return "cg" if feature_dim > CG_CROSSOVER_DIM else "cholesky"
    return primal


@dataclasses.dataclass(frozen=True)
class Problem:
    """feats (N, T_i, D) RF-mapped local data (equal shards), labels
    (N, T_i), adjacency (N, N), the global ridge lambda (split lam/N per
    agent), the ADMM penalty rho and the loss name."""

    feats: torch.Tensor
    labels: torch.Tensor
    adjacency: torch.Tensor
    lam: float
    rho: float
    loss: str = "quadratic"

    @property
    def num_agents(self) -> int:
        return self.feats.shape[0]

    @property
    def feature_dim(self) -> int:
        return self.feats.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.feats.device

    def to(self, device) -> "Problem":
        return dataclasses.replace(
            self, feats=self.feats.to(device),
            labels=self.labels.to(device),
            adjacency=self.adjacency.to(device))


def make_problem(feats: torch.Tensor, labels: torch.Tensor, graph: Graph,
                 lam: float, rho: float, loss: str = "quadratic") -> Problem:
    return Problem(
        feats=feats, labels=labels,
        adjacency=torch.as_tensor(graph.adjacency, dtype=feats.dtype,
                                  device=feats.device),
        lam=lam, rho=rho, loss=loss)
