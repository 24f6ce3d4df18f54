"""The solvers this port runs behind one contract: the ADMM pair, DKLA
(Algorithm 1) and COKE (Algorithm 2), the CTA diffusion baseline, and the
centralized ridge oracle; and the per-iteration metrics every history
records.

Each solver carries the reference's capability flags: the backends it runs
on (`backends`), whether it threads a communication policy (`comm_aware`),
follows a topology schedule (`topology_aware`), has a (21a) primal
subproblem (`primal_aware`), and has gossip and personalization forms
(`gossip_aware`, `personalization_aware`); the capability table
(`api/capabilities.py`) reads them. The simulator backend drives a solver
through `prepare_host` / `prepare_traced` (once per fit), `init_state`,
then `step` and `metrics` per iteration, and `theta_of`; the spmd and
fused backends read only `consensus_strategy` and `_policy`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.api.config import SolveContext
from repro_torch.api.registry import register_solver
from repro_torch.core import admm, cta, ridge
from repro_torch.core import comm as comm_mod
from repro_torch.core.admm import Problem
from repro_torch.core.graph import Graph, metropolis_weights
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
    topology_aware = True
    # these solvers have a (21a) primal subproblem the exact solves apply to
    primal_aware = True
    # the reference's gossip and personalized forms (not ported yet: the
    # capability table raises NotImplementedError for them)
    gossip_aware = True
    personalization_aware = True

    def _policy(self, ctx: SolveContext) -> comm_mod.Chain:
        raise NotImplementedError

    def prepare_host(self, problem: Problem, ctx: SolveContext):
        return None

    def _primal_mode(self, problem: Problem, ctx: SolveContext) -> str:
        """Cholesky / CG across the big-D crossover, gradient for general
        losses (core.admm.resolve_primal)."""
        return admm.resolve_primal(ctx.primal, problem.feature_dim,
                                   problem.loss)

    def prepare_traced(self, problem: Problem, ctx: SolveContext, host_aux):
        """{"chol": the (N, D, D) factor stack or None, "terms": the (21a)
        system's iteration-invariant parts} for the exact primals; None for
        the gradient primal. Under a topology schedule the normal matrix
        depends on each graph's degrees, so "chol" is an (M, N, D, D) stack
        and coke_step picks the active graph's. The reference builds these
        inside every compiled chunk; the port builds them once per fit."""
        mode = self._primal_mode(problem, ctx)
        if mode == "cholesky":
            if ctx.topology is None:
                chol = admm._ridge_factors(problem)
            else:
                chol = torch.stack([
                    admm._ridge_factors(dataclasses.replace(problem,
                                                            adjacency=a))
                    for a in ctx.topology.adjacencies])
            return {"chol": chol,
                    "terms": admm.primal_terms(problem, jacobi=False)}
        if mode == "cg":
            return {"chol": None, "terms": admm.primal_terms(problem)}
        return None

    def init_state(self, problem: Problem, ctx: SolveContext):
        return admm.init_state(problem, policy=self._policy(ctx))

    def step(self, problem: Problem, ctx: SolveContext, aux, state):
        mode = self._primal_mode(problem, ctx)
        aux = aux or {}
        return admm.coke_step(problem, self._policy(ctx), state,
                              aux.get("chol"), ctx.inner_steps, ctx.inner_lr,
                              topology=ctx.topology,
                              primal="cg" if mode == "cg" else "auto",
                              cg_tol=ctx.cg_tol, cg_maxiter=ctx.cg_maxiter,
                              terms=aux.get("terms"))

    def metrics(self, problem: Problem, ctx: SolveContext, aux, state):
        return _stacked_metrics(problem, state.theta, state.comms,
                                torch.sum(state.comm.bits))

    def theta_of(self, state) -> torch.Tensor:
        return state.theta


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
    topology_aware = False
    primal_aware = False

    def prepare_host(self, problem: Problem, ctx: SolveContext):
        g = Graph(adjacency=problem.adjacency.detach().cpu().numpy()
                  .astype(np.float64))
        return torch.as_tensor(metropolis_weights(g),
                               dtype=problem.feats.dtype,
                               device=problem.device)

    def prepare_traced(self, problem: Problem, ctx: SolveContext, host_aux):
        return host_aux  # the mixing matrix

    def init_state(self, problem: Problem, ctx: SolveContext):
        return cta.init_state(problem)

    def step(self, problem: Problem, ctx: SolveContext, aux, state):
        return cta.cta_step(problem, aux, ctx.cta_lr, state)

    def metrics(self, problem: Problem, ctx: SolveContext, aux, state):
        return _stacked_metrics(problem, state.theta, state.comms,
                                _uncompressed_bits(problem, state.comms))

    def theta_of(self, state) -> torch.Tensor:
        return state.theta


# ---------------------------------------------------------------------------
# Centralized closed-form oracle (Eq. 26)
# ---------------------------------------------------------------------------

class OracleState(NamedTuple):
    theta: torch.Tensor   # (N, D): theta* broadcast to every agent
    step: int
    comms: torch.Tensor   # () int32, always 0


@register_solver("ridge_oracle")
class RidgeOracleSolver:
    """The centralized RF-ridge optimum the decentralized algorithms must
    converge to, through the same fit surface (run num_iters=1). Its
    `comms` metric is 0: the oracle sees all data and exchanges nothing."""

    backends = ("simulator",)
    consensus_strategy = None
    comm_aware = False  # sees all data, exchanges nothing
    topology_aware = False
    primal_aware = False

    def prepare_host(self, problem: Problem, ctx: SolveContext):
        return None

    def prepare_traced(self, problem: Problem, ctx: SolveContext, host_aux):
        return ridge.rf_ridge(problem.feats, problem.labels, problem.lam)

    def init_state(self, problem: Problem, ctx: SolveContext):
        N, D = problem.num_agents, problem.feature_dim
        return OracleState(
            torch.zeros((N, D), dtype=problem.feats.dtype,
                        device=problem.device), 0,
            torch.zeros((), dtype=torch.int32, device=problem.device))

    def step(self, problem: Problem, ctx: SolveContext, aux,
             state: OracleState):
        theta = aux[None].expand(state.theta.shape).to(state.theta.dtype)
        return OracleState(theta.clone(), state.step + 1, state.comms)

    def metrics(self, problem: Problem, ctx: SolveContext, aux,
                state: OracleState):
        return _stacked_metrics(problem, state.theta, state.comms,
                                torch.zeros((), dtype=torch.int32,
                                            device=problem.device))

    def theta_of(self, state: OracleState) -> torch.Tensor:
        return state.theta
