"""Backend routing for `fit()`: the fused backend's megakernel path.

On megakernel-admissible configs (dkla/coke, gradient primal, quadratic
loss, static ring or circulant graph, no mesh or personalization) each
ADMM iteration runs the `coke_megastep` kernel substituted into the
`core.step.StepProgram` primal stage. Everything the reference sends
elsewhere raises NotImplementedError naming the ROADMAP.md item that ports
it: the simulator backend (Queue 1 item 3), and the spmd backend and the
fused backend's spmd + `coke_fused_update` fallback (item 7).

The fused backend requires a circulant graph, validated against the
problem's adjacency, so a mismatched FitConfig fails loudly instead of
silently solving a different consensus problem.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.api.config import FitConfig, SolveContext
from repro_torch.api.registry import Solver
from repro_torch.api.solvers import _stacked_metrics
from repro_torch.core import step as step_mod
from repro_torch.core.admm import CG_CROSSOVER_DIM, Problem
from repro_torch.core.graph import circulant
from repro_torch.kernels.coke_update.coke_update import coke_megastep

_SPMD_LATER = ("ROADMAP.md Queue 1 item 7 (spmd backend and the fused "
               "fallback through coke_fused_update)")

#: history dtypes, for the (0,)-histories of a zero-iteration chunk
_HIST_DTYPES = {"train_mse": torch.float32, "comms": torch.int32,
                "consensus_gap": torch.float32, "bits": torch.float32,
                "send_frac": torch.float32, "dist_to_oracle": torch.float32}


def _validate_topology(problem: Problem, offsets: tuple[int, ...]) -> None:
    N = problem.num_agents
    want = circulant(N, offsets).adjacency
    have = problem.adjacency.detach().cpu().numpy()
    if not np.array_equal(have, want):
        raise ValueError(
            "spmd/fused backends implement circulant topologies (ring "
            f"collectives with offsets {offsets}); the problem's adjacency "
            "does not match — build it with FitConfig(graph='ring'/"
            "'circulant') or use backend='simulator'")


def _resolve_consensus_primal(config: FitConfig, problem: Problem,
                              strategy: str) -> str:
    """The primal the fused runtime executes: "auto" keeps the one-step
    gradient update up to the big-D crossover, then switches to CG.
    Explicit "cholesky" is rejected: this backend never builds (D, D)."""
    if strategy not in ("dkla", "coke"):
        return "gradient"
    if config.primal == "cholesky":
        raise ValueError(
            "the spmd/fused backends never materialize per-agent (D, D) "
            "factors; use primal='cg' (exact, matrix-free) or "
            "'gradient'/'auto' (one-step inexact)")
    if config.primal == "cg":
        return "cg"
    if (config.primal == "auto" and problem.loss == "quadratic"
            and problem.feature_dim > CG_CROSSOVER_DIM):
        return "cg"
    return "gradient"


class _FusedCarry(NamedTuple):
    """core.step.run_step carry of the megakernel path."""

    theta: torch.Tensor       # (N, D)
    theta_hat: torch.Tensor   # (N, D)
    gamma: torch.Tensor       # (N, D)
    step: int                 # iterations done
    comms: torch.Tensor       # () int32 cumulative transmissions
    comm: Any                 # core.comm.CommState


def _stack_history(hist: dict[str, list], device) -> dict[str, torch.Tensor]:
    return {k: (torch.stack(v) if v else
                torch.empty((0,), dtype=_HIST_DTYPES[k], device=device))
            for k, v in hist.items()}


def _megastep_chunk(problem: Problem, st: _FusedCarry, oracle, chain, *,
                    offsets: tuple[int, ...], num_iters: int, lr: float):
    """`num_iters` iterations of the megakernel program: one
    `coke_megastep` call per iteration (two launches on the card),
    substituted into the StepProgram primal stage with
    `primal_owns_exchange=True`: the kernel reads the ring neighbours'
    theta_hat rows itself. History keys match the reference's fused chunk:
    train_mse / comms / consensus_gap / bits / send_frac
    [+ dist_to_oracle]. Histories stay device tensors and are stacked once
    at the end of the chunk."""
    n_agents = problem.num_agents
    device = problem.device

    def nbr_sum(x):
        out = None
        for o in offsets:
            both = torch.roll(x, o, 0) + torch.roll(x, -o, 0)
            out = both if out is None else out + both
        return out

    view = step_mod.GraphView(
        deg=torch.full((n_agents,), 2.0 * len(offsets), dtype=torch.float32,
                       device=device),
        nbr_sum=nbr_sum)

    def primal(k, g, theta0, theta_hat0, gamma0, nbr_hat):
        # the kernel's xi_sq is not used here: the portable chain.apply
        # recomputes the censor norm, as the reference does
        theta_new, _xi_sq = coke_megastep(
            theta0, theta_hat0, gamma0, problem.feats, problem.labels,
            rho=problem.rho, lam=problem.lam, lr=lr, offsets=offsets)
        return theta_new, {}

    program = step_mod.StepProgram(
        chain=chain, rho=problem.rho, exchange=lambda state, k: view,
        primal=primal, primal_owns_exchange=True)

    keys = ["train_mse", "comms", "consensus_gap", "bits", "send_frac"]
    if oracle is not None:
        keys.append("dist_to_oracle")
    hist: dict[str, list] = {k: [] for k in keys}
    for _ in range(num_iters):
        new_st, _ = step_mod.run_step(program, st)
        bits = torch.sum(new_st.comm.bits)
        m = _stacked_metrics(problem, new_st.theta, new_st.comms, bits)
        m["send_frac"] = ((new_st.comms - st.comms).to(torch.float32)
                          / n_agents)
        if oracle is not None:
            m["dist_to_oracle"] = torch.max(torch.linalg.norm(
                new_st.theta - oracle, dim=-1))
        for k in keys:
            hist[k].append(m[k])
        st = new_st
    return st, _stack_history(hist, device)


def consensus_runner(config: FitConfig, solver: Solver, problem: Problem,
                     ctx: SolveContext, oracle: torch.Tensor | None):
    """-> (carry0, chunk_fn, theta_fn) for the fused backend."""
    strategy = solver.consensus_strategy
    primal_mode = _resolve_consensus_primal(config, problem, strategy)
    if config.topology is not None:
        raise NotImplementedError(
            f"topology schedules are not ported yet: {_SPMD_LATER}")
    offsets = tuple(config.graph_offsets)
    _validate_topology(problem, offsets)

    # megakernel admission (the reference's gate): the gradient primal on
    # the quadratic loss over a fixed circulant, unsharded and not
    # personalized. The reference sends everything else to the spmd
    # runtime with the coke_fused_update kernel, which is not ported yet.
    use_mega = (config.backend == "fused"
                and strategy in ("dkla", "coke")
                and primal_mode == "gradient"
                and problem.loss == "quadratic"
                and config.topology is None
                and config.personalization is None)
    if not use_mega:
        raise NotImplementedError(
            f"this config is outside the megakernel path (strategy="
            f"{strategy!r}, primal={primal_mode!r}, loss={problem.loss!r}); "
            f"its reference path is not ported yet: {_SPMD_LATER}")

    chain = solver._policy(ctx)
    N, D = problem.num_agents, problem.feature_dim
    dev, dtype = problem.device, problem.feats.dtype
    carry0 = _FusedCarry(
        theta=torch.zeros((N, D), dtype=dtype, device=dev),
        theta_hat=torch.zeros((N, D), dtype=torch.float32, device=dev),
        gamma=torch.zeros((N, D), dtype=torch.float32, device=dev),
        step=0, comms=torch.zeros((), dtype=torch.int32, device=dev),
        comm=chain.init_state(N, dev))

    def chunk_fn(carry, n):
        return _megastep_chunk(problem, carry, oracle, chain,
                               offsets=offsets, num_iters=n,
                               lr=ctx.inner_lr)

    return carry0, chunk_fn, lambda carry: carry.theta
