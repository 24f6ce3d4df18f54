"""Backend routing for `fit()`: the spmd and fused backends.

  spmd  — the ring consensus runtime (`distributed/consensus.py`): the
          agent axis as a leading tensor dimension, neighbour exchange as
          `torch.roll`, the inexact one-step gradient primal. Runs dkla,
          coke and cta.
  fused — on megakernel-admissible configs (dkla/coke, gradient primal,
          quadratic loss, static ring or circulant graph) each ADMM
          iteration runs the `coke_megastep` kernel (K2) substituted into
          the `core.step.StepProgram` primal stage. Everything else falls
          back to the ring runtime with the augmented gradient in the
          `coke_fused_update` kernel (K3).

The CG primal (`primal="cg"`, or "auto" past D = 2048 on the quadratic
loss) raises NotImplementedError naming ROADMAP.md Queue 1 item 3; the
simulator backend raises in `fit`.

Both backends require a circulant graph, validated against the problem's
adjacency, so a mismatched FitConfig fails loudly instead of silently
solving a different consensus problem.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.api.config import FitConfig, SolveContext
from repro_torch.api.registry import Solver
from repro_torch.api.solvers import (_comm_metrics, _stacked_metrics,
                                     _uncompressed_bits)
from repro_torch.core import losses as losses_mod
from repro_torch.core import step as step_mod
from repro_torch.core.admm import CG_CROSSOVER_DIM, Problem, resolve_primal
from repro_torch.core.graph import circulant
from repro_torch.distributed import consensus as cns
from repro_torch.kernels.coke_update.coke_update import coke_megastep
from repro_torch.kernels.coke_update.ref import residual_sq
from repro_torch.optim.optimizers import OptConfig

_CG_LATER = ("ROADMAP.md Queue 1 item 3 (the CG primal, with the "
             "simulator's _primal_cg)")

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


def _local_grads(problem: Problem, theta: torch.Tensor) -> torch.Tensor:
    """Per-agent gradients of local_empirical_risk(theta_i, Phi_i, y_i,
    lam/N, loss): autograd of the agent sum, where each agent's risk
    depends on its own row only. Reads Phi twice (forward and backward)."""
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        risk = losses_mod.local_empirical_risk(
            th, problem.feats, problem.labels,
            problem.lam / problem.num_agents, problem.loss)
        (grad,) = torch.autograd.grad(torch.sum(risk), th)
    return grad


def _resolve_consensus_primal(config: FitConfig, problem: Problem,
                              strategy: str) -> str:
    """The primal the ring runtimes execute: "auto" keeps the one-step
    gradient update up to the big-D crossover, then switches to CG.
    Explicit "cholesky" is rejected: these backends never build (D, D)."""
    if strategy not in ("dkla", "coke"):
        return "gradient"
    if config.primal == "cholesky":
        raise ValueError(
            "the spmd/fused backends never materialize per-agent (D, D) "
            "factors; use primal='cg' (exact, matrix-free) or "
            "'gradient'/'auto' (one-step inexact)")
    if config.primal == "cg":
        return resolve_primal("cg", problem.feature_dim, problem.loss)
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
    at the end of the chunk.

    The train MSE of iteration k's theta is the sum of the squared
    residuals that K2 forms on its way in iteration k + 1, divided by N*T
    (run_step does not touch theta after the primal). Only the chunk's
    last iteration reads Phi again for it, so a chunk of n iterations
    reads Phi n + 1 times."""
    n_agents = problem.num_agents
    device = problem.device
    n_rows = problem.labels.numel()
    resid_sq = torch.empty((n_agents,), dtype=problem.feats.dtype,
                           device=device)

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
            rho=problem.rho, lam=problem.lam, lr=lr, offsets=offsets,
            resid_sq=resid_sq)
        return theta_new, {}

    program = step_mod.StepProgram(
        chain=chain, rho=problem.rho, exchange=lambda state, k: view,
        primal=primal, primal_owns_exchange=True)

    keys = ["train_mse", "comms", "consensus_gap", "bits", "send_frac"]
    if oracle is not None:
        keys.append("dist_to_oracle")
    hist: dict[str, list] = {k: [] for k in keys}
    for j in range(num_iters):
        new_st, _ = step_mod.run_step(program, st)
        if j:   # K2 just read theta_j, which iteration j - 1 left
            hist["train_mse"].append(torch.sum(resid_sq) / n_rows)
        bits = torch.sum(new_st.comm.bits)
        m = _comm_metrics(new_st.theta, new_st.comms, bits)
        m["send_frac"] = ((new_st.comms - st.comms).to(torch.float32)
                          / n_agents)
        if oracle is not None:
            m["dist_to_oracle"] = torch.max(torch.linalg.norm(
                new_st.theta - oracle, dim=-1))
        for k in keys[1:]:
            hist[k].append(m[k])
        st = new_st
    if num_iters:
        hist["train_mse"].append(torch.sum(residual_sq(
            problem.feats, st.theta, problem.labels)) / n_rows)
    return st, _stack_history(hist, device)


def _consensus_chunk(problem: Problem, params, cstate, oracle, chain, *,
                     ccfg: cns.ConsensusConfig, opt_cfg: OptConfig,
                     num_iters: int):
    """`num_iters` iterations of the ring runtime: local gradients, then
    `consensus_update` (through K3 when ccfg.use_fused_kernel). History
    keys match the reference's spmd chunk: train_mse / comms /
    consensus_gap / bits, then send_frac for dkla/coke
    [+ dist_to_oracle]."""
    keys = ["train_mse", "comms", "consensus_gap", "bits"]
    if ccfg.is_admm:
        keys.append("send_frac")
    if oracle is not None:
        keys.append("dist_to_oracle")
    hist: dict[str, list] = {k: [] for k in keys}
    for _ in range(num_iters):
        grads = {"theta": _local_grads(problem, params["theta"])}
        params, cstate, extra = cns.consensus_update(
            ccfg, opt_cfg, params, grads, cstate, comm=chain)
        bits = extra.get("bits")
        if bits is None:  # policy-unaware strategy (cta): full precision
            bits = _uncompressed_bits(problem, cstate["comms"])
        m = _stacked_metrics(problem, params["theta"], cstate["comms"], bits)
        m.update(extra)
        if oracle is not None:
            m["dist_to_oracle"] = torch.max(torch.linalg.norm(
                params["theta"] - oracle, dim=-1))
        for k in keys:
            hist[k].append(m[k])
    return (params, cstate), _stack_history(hist, problem.device)


def consensus_runner(config: FitConfig, solver: Solver, problem: Problem,
                     ctx: SolveContext, oracle: torch.Tensor | None):
    """-> (carry0, chunk_fn, theta_fn) for the spmd / fused backends."""
    strategy = solver.consensus_strategy
    primal_mode = _resolve_consensus_primal(config, problem, strategy)
    if config.topology is not None:
        raise NotImplementedError(
            "topology schedules are not ported yet: ROADMAP.md Queue 1 "
            "item 7 (topology schedules)")
    offsets = tuple(config.graph_offsets)
    _validate_topology(problem, offsets)
    if primal_mode == "cg":
        raise NotImplementedError(
            f"the CG primal on the ring runtimes is not ported yet: "
            f"{_CG_LATER}")
    N, D = problem.num_agents, problem.feature_dim
    dev, dtype = problem.device, problem.feats.dtype

    # megakernel admission (the reference's gate): the gradient primal on
    # the quadratic loss over a fixed circulant, unsharded and not
    # personalized (fit rejects topology schedules and personalization)
    use_mega = (config.backend == "fused"
                and strategy in ("dkla", "coke")
                and problem.loss == "quadratic")
    if use_mega:
        chain = solver._policy(ctx)
        carry0 = _FusedCarry(
            theta=torch.zeros((N, D), dtype=dtype, device=dev),
            theta_hat=torch.zeros((N, D), dtype=torch.float32, device=dev),
            gamma=torch.zeros((N, D), dtype=torch.float32, device=dev),
            step=0, comms=torch.zeros((), dtype=torch.int32, device=dev),
            comm=chain.init_state(N, dev))

        def mega_chunk_fn(carry, n):
            return _megastep_chunk(problem, carry, oracle, chain,
                                   offsets=offsets, num_iters=n,
                                   lr=ctx.inner_lr)

        return carry0, mega_chunk_fn, lambda carry: carry.theta

    # the ring runtime: spmd, and the fused backend's fallback through K3
    v, mu = config.resolved_censor
    k = len(offsets)
    ccfg = cns.ConsensusConfig(
        strategy=strategy, rho=problem.rho, censor_v=v, censor_mu=mu,
        offsets=offsets,
        # per-neighbour Metropolis weight on a 2k-regular circulant
        mix_weight=k / (2.0 * k + 1.0),
        use_fused_kernel=config.backend == "fused")
    lr = ctx.cta_lr if strategy == "cta" else ctx.inner_lr
    opt_cfg = OptConfig(kind="sgd", lr=lr)
    # the solver's policy view of the configured chain (DKLA strips the
    # censor thresholds); cta threads none
    chain = solver._policy(ctx) if solver.comm_aware else None
    params = {"theta": torch.zeros((N, D), dtype=dtype, device=dev)}
    cstate = cns.init_consensus_state(ccfg, opt_cfg, params, comm=chain)

    def chunk_fn(carry, n):
        params, cstate = carry
        return _consensus_chunk(problem, params, cstate, oracle, chain,
                                ccfg=ccfg, opt_cfg=opt_cfg, num_iters=n)

    return (params, cstate), chunk_fn, lambda carry: carry[0]["theta"]
