"""The solvers this port runs: the ADMM pair, DKLA (Algorithm 1) and COKE
(Algorithm 2), and the CTA diffusion baseline; and the per-iteration
metrics every history records.

Each solver names the backends it runs on (`backends`) and whether it
threads a communication policy (`comm_aware`), as in the reference; `fit`
rejects the rest with the reference's ValueError."""
from __future__ import annotations

import torch

from repro_torch.api.config import SolveContext
from repro_torch.api.registry import register_solver
from repro_torch.core import comm as comm_mod
from repro_torch.core.admm import Problem
from repro_torch.distributed.consensus import consensus_gap


def _stacked_metrics(problem: Problem, theta: torch.Tensor,
                     comms: torch.Tensor,
                     bits: torch.Tensor) -> dict[str, torch.Tensor]:
    """The paper's per-iteration train MSE, cumulative comms, consensus gap
    and cumulative bits, as device tensors (no host sync). The train MSE
    reads Phi once more, outside the kernels."""
    preds = torch.einsum("ntd,nd->nt", problem.feats, theta)
    mse = torch.mean((problem.labels - preds) ** 2)
    return {"train_mse": mse, **_comm_metrics(theta, comms, bits)}


def _comm_metrics(theta: torch.Tensor, comms: torch.Tensor,
                  bits: torch.Tensor) -> dict[str, torch.Tensor]:
    """The per-iteration metrics other than the train MSE."""
    return {"comms": comms,
            "consensus_gap": consensus_gap({"theta": theta}),
            "bits": bits.to(torch.float32)}


def _uncompressed_bits(problem: Problem, comms: torch.Tensor) -> torch.Tensor:
    """Bits for `comms` full-precision D-vector transmissions (the policy-
    unaware solvers: CTA broadcasts every iteration, uncompressed)."""
    return comms.to(torch.float32) * (comm_mod.FP_BITS * problem.feature_dim)


class _ADMMSolver:
    backends = ("simulator", "spmd", "fused")
    comm_aware = True
    # these solvers have a (21a) primal subproblem the exact solves apply to
    primal_aware = True

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


@register_solver("cta")
class CTASolver:
    """Combine-then-adapt diffusion (Section 5 baseline): Metropolis mixing
    then a local gradient step; transmits every iteration."""

    backends = ("simulator", "spmd")
    consensus_strategy = "cta"
    comm_aware = False  # diffusion transmits uncensored every iteration
    primal_aware = False
