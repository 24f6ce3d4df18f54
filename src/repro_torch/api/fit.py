"""`fit(config) -> FitResult`: the port's training entry point.

It owns the iteration loop (a Python loop in host-visible chunks, where
the reference has `lax.scan`), the per-iteration metric recording and the
optional progress callbacks. The port runs the simulator backend (every
registered solver, each primal: Cholesky, CG, gradient), the spmd backend
and the fused backend (its megakernel path and its fallback to the ring
runtime); every other part of a FitConfig raises NotImplementedError
naming the ROADMAP.md item that ports it.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.api.backends import consensus_runner
from repro_torch.api.config import FitConfig, FitResult, SolveContext
from repro_torch.api.problems import build_problem
from repro_torch.api.registry import get_solver
from repro_torch.core import comm as comm_mod
from repro_torch.core import ridge
from repro_torch.core.admm import Problem
from repro_torch.device import resolve_device

ProgressCb = Callable[[int, dict], None]


def _check_solver(config: FitConfig, solver) -> None:
    """The reference's solver admission rules, with its ValueErrors."""
    reason, alternative = None, None
    if config.backend not in solver.backends:
        reason = (f"solver {config.algorithm!r} supports backends "
                  f"{tuple(solver.backends)!r}, not {config.backend}")
        alternative = "backend='simulator' (every solver runs there)"
    elif config.comm is not None and not solver.comm_aware:
        reason = (f"solver {config.algorithm!r} does not thread a "
                  "communication policy (it transmits unconditionally); "
                  "drop FitConfig.comm or pick a comm-aware algorithm "
                  "(dkla/coke/online_coke)")
        alternative = "algorithm='coke' with the same comm chain"
    elif (config.primal in ("cholesky", "cg")
          and not getattr(solver, "primal_aware", False)):
        reason = (f"solver {config.algorithm!r} has no (21a) primal "
                  f"subproblem for primal={config.primal} to solve; leave "
                  "primal='auto' or pick an ADMM solver (dkla/coke)")
        alternative = "algorithm='coke' with the same primal mode"
    if reason is not None:
        raise ValueError(f"{reason} — nearest supported: {alternative}")


def _check_slice(config: FitConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item, for any part
    of the config this port does not run yet, on every backend."""
    later = None
    if config.exec == "gossip":
        later = ("exec='gossip'", "Queue 1 item 10 (gossip and churn)")
    elif config.topology is not None:
        later = ("topology schedules", "Queue 1 item 7 (topology "
                 "schedules)")
    elif config.personalization is not None:
        later = ("personalization", "Queue 1 item 11 (personalization)")
    elif any(isinstance(s, (comm_mod.Quantize, comm_mod.Drop))
             for s in config.resolved_comm.stages):
        later = ("Quantize and Drop", "Queue 1 item 8 (full comm chain)")
    if later is not None:
        raise NotImplementedError(
            f"{later[0]} is not ported to repro_torch yet: ROADMAP.md "
            f"{later[1]}")


def _simulator_chunk(solver, problem: Problem, ctx: SolveContext, aux,
                     state, oracle, num_iters: int):
    """`num_iters` iterations of `solver` on the simulator: step, then the
    solver's metrics [+ dist_to_oracle], kept as device tensors and
    stacked once at the end of the chunk."""
    def record(st):
        m = solver.metrics(problem, ctx, aux, st)
        if oracle is not None:
            m["dist_to_oracle"] = torch.max(torch.linalg.norm(
                solver.theta_of(st) - oracle, dim=-1))
        return m

    hist: dict[str, list] = {}
    for _ in range(num_iters):
        state = solver.step(problem, ctx, aux, state)
        for k, v in record(state).items():
            hist.setdefault(k, []).append(v)
    if not num_iters:   # (0,)-histories with the keys and dtypes of a record
        return state, {k: torch.empty((0,), dtype=v.dtype, device=v.device)
                       for k, v in record(state).items()}
    return state, {k: torch.stack(v) for k, v in hist.items()}


def _simulator_runner(solver, problem: Problem, ctx: SolveContext, oracle):
    """-> (state0, chunk_fn, theta_fn). The reference prepares its traced
    aux (the Cholesky factors) inside every compiled chunk; here it is made
    once per fit, with the same values."""
    aux = solver.prepare_traced(problem, ctx,
                                solver.prepare_host(problem, ctx))

    def chunk_fn(state, n):
        return _simulator_chunk(solver, problem, ctx, aux, state, oracle, n)

    return solver.init_state(problem, ctx), chunk_fn, solver.theta_of


def _chunked_scan(chunk_fn, carry, num_iters: int, chunk_size: int | None,
                  progress_cb: ProgressCb | None):
    """Run the loop in host-visible chunks; chunk_size=None is one chunk.
    progress_cb(iters_done, last_metrics) receives device tensors."""
    hists, done = [], 0
    while True:
        n = num_iters - done if chunk_size is None else min(
            chunk_size, num_iters - done)
        carry, h = chunk_fn(carry, n)  # n == 0 still yields (0,)-histories
        done += n
        hists.append(h)
        if progress_cb is not None and n > 0:
            progress_cb(done, {k: v[-1] for k, v in h.items()})
        if done >= num_iters:
            break
    if len(hists) == 1:
        return carry, hists[0]
    return carry, {k: torch.cat([h[k] for h in hists]) for k in hists[0]}


def fit(config: FitConfig, problem: Problem | None = None, *,
        progress_cb: ProgressCb | None = None,
        oracle: torch.Tensor | None = None, mesh=None,
        device: torch.device | str | None = None) -> FitResult:
    """Run `config.algorithm` on `config.backend` and record the paper's
    evaluation trajectories.

    problem     — an existing `core.admm.Problem` (moved to `device`);
                  None builds one from config.krr / config.graph.
    progress_cb — called as progress_cb(iters_done, last_metrics) after
                  every `config.chunk_size` iterations.
    oracle      — theta* (D,) for a per-iteration distance-to-oracle;
                  computed in closed form when
                  `config.record_oracle_distance` is set and none is given.
    device      — None = "cuda" (raises when no card is present);
                  "cpu" runs the plain PyTorch versions of the kernels.
    """
    dev = resolve_device(device)
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (big-D sharding) is not ported to repro_torch yet: "
            "ROADMAP.md Queue 1 item 14")
    solver = get_solver(config.algorithm)
    _check_solver(config, solver)
    _check_slice(config)
    rff_params = None
    if problem is None:
        built = build_problem(config, device=dev)
        problem, rff_params = built.problem, built.rff_params
    elif problem.device != dev:
        problem = problem.to(dev)
    if oracle is None and config.record_oracle_distance:
        oracle = ridge.rf_ridge(problem.feats, problem.labels, problem.lam)
    elif oracle is not None:
        oracle = oracle.to(dev)

    ctx = SolveContext.from_config(config)
    if config.backend == "simulator":
        carry0, chunk_fn, theta_fn = _simulator_runner(solver, problem, ctx,
                                                       oracle)
    else:
        carry0, chunk_fn, theta_fn = consensus_runner(config, solver,
                                                      problem, ctx, oracle)
    carry, history = _chunked_scan(chunk_fn, carry0, config.resolved_iters,
                                   config.chunk_size, progress_cb)
    return FitResult(config=config, state=carry, history=history,
                     theta=theta_fn(carry), rff_params=rff_params)


def fit_stream(config: FitConfig, stream=None, **kw) -> FitResult:
    """Streaming fits are not ported yet."""
    raise NotImplementedError(
        "fit_stream is not ported to repro_torch yet: ROADMAP.md Queue 1 "
        "item 9 (streaming)")
