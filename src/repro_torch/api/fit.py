"""`fit(config) -> FitResult`: the port's training entry point.

It owns the iteration loop (a Python loop in host-visible chunks, where
the reference has `lax.scan`), the per-iteration metric recording and the
optional progress callbacks. Admission is the capability table's
(`api/capabilities.py`): the reference's ValueErrors first, then
NotImplementedError naming the ROADMAP.md item for what the port does not
run yet (gossip, personalization, `mesh=`, the streaming solvers). The port
runs the simulator backend (every registered solver, each primal), the spmd
backend and the fused backend (its megakernel path and its fallback to the
ring runtime), each with any comm chain (Censor, Quantize, Drop) and, where
the reference runs one, a topology schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.api.backends import consensus_runner
from repro_torch.api.capabilities import check_fit, check_stream
from repro_torch.api.config import FitConfig, FitResult, SolveContext
from repro_torch.api.problems import build_problem
from repro_torch.api.registry import get_solver, solver_spec
from repro_torch.core import ridge
from repro_torch.core.admm import Problem
from repro_torch.device import resolve_device

ProgressCb = Callable[[int, dict], None]


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
    check_fit(config, solver_spec(config.algorithm), mesh=mesh)
    solver = get_solver(config.algorithm)
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
    if config.topology is not None and (
            config.topology.num_agents != problem.num_agents):
        raise ValueError(
            f"topology schedule is over {config.topology.num_agents} "
            f"agents but the problem has {problem.num_agents}")

    ctx = SolveContext.from_config(config)
    if ctx.topology is not None:   # the schedule beside the problem
        ctx = dataclasses.replace(ctx, topology=ctx.topology.to(
            problem.device, problem.feats.dtype))
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
    """Streaming fits are not ported yet: the capability table raises the
    reference's ValueError where the reference rejects the config, else
    NotImplementedError naming ROADMAP.md item 9."""
    check_stream(config, solver_spec(config.algorithm))
    raise AssertionError("the capability table admitted fit_stream")
