"""The ADMM solvers, DKLA (Algorithm 1) and COKE (Algorithm 2), and the
per-iteration metrics every history records."""
from __future__ import annotations

import torch

from repro_torch.api.config import SolveContext
from repro_torch.api.registry import register_solver
from repro_torch.core import comm as comm_mod
from repro_torch.core.admm import Problem


def _consensus_gap(theta: torch.Tensor) -> torch.Tensor:
    """max_i ||theta_i - mean theta|| over the (N, D) stack."""
    mean_theta = torch.mean(theta, dim=0, keepdim=True)
    return torch.max(torch.sqrt(torch.sum((theta - mean_theta) ** 2, dim=-1)))


def _stacked_metrics(problem: Problem, theta: torch.Tensor,
                     comms: torch.Tensor,
                     bits: torch.Tensor) -> dict[str, torch.Tensor]:
    """The paper's per-iteration train MSE, cumulative comms, consensus gap
    and cumulative bits, as device tensors (no host sync). The train MSE
    reads Phi once more, outside the megakernel."""
    preds = torch.einsum("ntd,nd->nt", problem.feats, theta)
    mse = torch.mean((problem.labels - preds) ** 2)
    return {"train_mse": mse, "comms": comms,
            "consensus_gap": _consensus_gap(theta),
            "bits": bits.to(torch.float32)}


class _ADMMSolver:
    def _policy(self, ctx: SolveContext) -> comm_mod.Chain:
        raise NotImplementedError


@register_solver("dkla")
class DKLASolver(_ADMMSolver):
    """Algorithm 1: COKE's update with the always-transmit h == 0 policy."""

    consensus_strategy = "dkla"

    def _policy(self, ctx: SolveContext) -> comm_mod.Chain:
        return comm_mod.uncensored(ctx.comm)


@register_solver("coke")
class COKESolver(_ADMMSolver):
    """Algorithm 2: censored transmissions, h(k) = v mu^k."""

    consensus_strategy = "coke"

    def _policy(self, ctx: SolveContext) -> comm_mod.Chain:
        return ctx.comm
