"""`fit(config) -> FitResult`: the port's training entry point, and its
streaming sibling `fit_stream(config) -> FitResult` for the online family
over per-agent minibatch streams.

Both own the iteration loop (a Python loop in host-visible chunks, where
the reference has `lax.scan`), the per-iteration metric recording and the
optional progress callbacks, and walk the same `phase_plan`. Admission is
the capability table's (`api/capabilities.py`): the reference's
ValueErrors first, then NotImplementedError naming the ROADMAP.md item for
what the port does not run yet. The port runs the simulator
backend (every registered solver, each primal), the spmd backend and the
fused backend (its megakernel path and its fallback to the ring runtime),
each with any comm chain (Censor, Quantize, Drop), under synchronous or
gossip execution (participation sampling; churn on the simulator and spmd)
and, where the reference runs one, a topology schedule or a learned
collaboration graph (personalization, on the simulator and spmd);
fit_stream runs the streaming solvers on the simulator and spmd.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.api.backends import (consensus_runner,
                                      stream_consensus_runner)
from repro_torch.api.capabilities import check_fit, check_stream
from repro_torch.api.config import FitConfig, FitResult, SolveContext
from repro_torch.api.problems import (StreamProblem, build_problem,
                                      build_stream)
from repro_torch.api.registry import get_solver
from repro_torch.api.solvers import OnlineFitState
from repro_torch.core import ridge
from repro_torch.core.admm import COKEState, Problem
from repro_torch.core.personalize import PersonalizedState
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding

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
        return state, {k: torch.empty((0, *v.shape), dtype=v.dtype,
                                      device=v.device)
                       for k, v in record(state).items()}
    return state, {k: torch.stack(v) for k, v in hist.items()}


def _simulator_runner(solver, problem: Problem, ctx: SolveContext, oracle,
                      mesh=None):
    """-> (state0, chunk_fn, theta_fn). The reference prepares its traced
    aux (the Cholesky factors) inside every compiled chunk; here it is made
    once per fit, with the same values. On a mesh the problem comes
    feature-sharded (`fit` places it once); as in the reference, the host
    aux (the gossip NeighborTable) and the initial state are made from the
    graph whole (gathered once here), and the state is then placed with
    the feature layout. A learned graph (N, N) in the state stays whole:
    its trailing dim indexes agents, not features."""
    host = problem if mesh is None else dataclasses.replace(
        problem, adjacency=sharding.unshard(problem.adjacency))
    aux = solver.prepare_traced(problem, ctx, solver.prepare_host(host, ctx))
    state0 = solver.init_state(host, ctx)
    if mesh is not None:
        graph = getattr(state0, "adjacency", None)
        state0 = sharding.shard_features(state0, mesh, problem.num_agents)
        if graph is not None:
            state0 = state0._replace(adjacency=graph)

    def chunk_fn(state, n):
        return _simulator_chunk(solver, problem, ctx, aux, state, oracle, n)

    return state0, chunk_fn, solver.theta_of


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


def _pz_enter_live(carry, adjacency: torch.Tensor):
    """The carry transform at a personalized fit's warmup -> live boundary:
    the live program's carry holds the learned graph (starting as the
    configured static one), the warmup program's does not. A sweep's lane
    carry (G, N, D) gets the graph broadcast to (G, N, N)."""
    A0 = adjacency.to(torch.float32)
    if isinstance(carry, OnlineFitState):
        return carry._replace(adjacency=A0)
    if isinstance(carry, COKEState):
        if carry.theta.ndim == 3:
            A0 = A0.expand(carry.theta.shape[0], *A0.shape)
        return PersonalizedState(carry, A0)
    params, cstate = carry   # the ring runtime's (params, cstate) carry
    return params, dict(cstate, adjacency=A0)


def phase_plan(ctx: SolveContext, num_iters: int, adjacency):
    """One fit as its phased program: a tuple of (phase_ctx, num_iters,
    enter_fn), where enter_fn (None on the first phase) transforms the
    carry at the phase boundary. fit, fit_stream and sweep walk it.
    Ordinary fits are one phase; a personalized fit with warmup > 0 is two:
    iterations 1..warmup run with ctx.pz_warmup=True, which takes the
    static-consensus code path itself (so that prefix is bitwise a run
    without personalization at the same primal), then the live phase
    carries the learned graph. A zero-length live phase (warmup >=
    num_iters) still applies its transform, so the final carry holds the
    adjacency either way."""
    if ctx.personalization is None:
        return ((ctx, num_iters, None),)
    W = min(int(ctx.personalization.warmup), num_iters)
    if W <= 0:
        return ((ctx, num_iters, None),)
    ctx_warm = dataclasses.replace(ctx, pz_warmup=True)
    return ((ctx_warm, W, None),
            (ctx, num_iters - W,
             lambda carry: _pz_enter_live(carry, adjacency)))


def _phased_runner(make_runner, plan):
    """Drive a phase_plan through the chunked host loop: one runner per
    phase, carries handed across boundaries through the plan's enter
    transforms (also when a chunk ends exactly on a boundary), histories
    concatenated. -> (carry0, chunk_fn, theta_fn)."""
    if len(plan) == 1 and plan[0][2] is None:
        return make_runner(plan[0][0])
    runners = [make_runner(c) for c, _, _ in plan]
    ends, total = [], 0
    for _, n, _ in plan:
        total += n
        ends.append(total)
    pos = {"done": 0, "phase": 0}

    def chunk_fn(carry, n):
        hists, left = [], n
        while True:
            i = pos["phase"]
            m = min(left, ends[i] - pos["done"])
            carry, h = runners[i][1](carry, m)
            pos["done"] += m
            left -= m
            hists.append(h)
            while (pos["phase"] < len(ends) - 1
                   and pos["done"] >= ends[pos["phase"]]):
                pos["phase"] += 1
                enter = plan[pos["phase"]][2]
                if enter is not None:
                    carry = enter(carry)
            if left == 0:
                break
        if len(hists) == 1:
            return carry, hists[0]
        return carry, {k: torch.cat([h[k] for h in hists])
                       for k in hists[0]}

    return runners[0][0], chunk_fn, runners[-1][2]


def _solve_context(config: FitConfig, device, dtype,
                   num_agents: int) -> SolveContext:
    """The config's SolveContext, with a topology schedule and a gossip
    plan beside the problem."""
    ctx = SolveContext.from_config(config, num_agents, device)
    if ctx.topology is not None:
        ctx = dataclasses.replace(ctx, topology=ctx.topology.to(device,
                                                                dtype))
    return ctx


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
    mesh        — optional `launch.mesh.Mesh` for the big-D path: the
                  problem's feature dim is cut over the mesh's "model"
                  axis and the agent dim over its batch axes (theta,
                  theta_hat and gamma as (N/b, D/s) blocks; see
                  `distributed.sharding.feature_spec`). This process's
                  cells must lie on `device`. theta, the state and the
                  history come back gathered into plain tensors. Pair it
                  with primal="cg": the Cholesky primal gathers each
                  agent's (D, D) factor. On a mesh across ranks
                  (`make_host_mesh(..., group=)`) every rank calls fit
                  with the same arguments (SPMD; a problem built from the
                  same seed), runs its own cells' blocks, and gets the
                  whole result.
    device      — None = "cuda" (raises when no card is present);
                  "cpu" runs the plain PyTorch versions of the kernels.
    """
    if isinstance(problem, StreamProblem):
        raise ValueError(
            "fit() drives batch problems; run a StreamProblem through "
            "fit_stream(config, stream=...)")
    dev = resolve_device(device)
    solver = get_solver(config.algorithm)
    check_fit(config, solver)
    if mesh is not None:
        _check_mesh_devices(mesh, dev)
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

    ctx = _solve_context(config, problem.device, problem.feats.dtype,
                         problem.num_agents)
    if mesh is not None:
        # placed once: every phase's runner reads these blocks (a problem
        # already in this layout is kept as it is, not copied)
        problem = sharding.shard_problem(problem, mesh)

    def make_runner(c: SolveContext):
        if config.backend == "simulator":
            return _simulator_runner(solver, problem, c, oracle, mesh=mesh)
        return consensus_runner(config, solver, problem, c, oracle,
                                mesh=mesh)

    # a personalized fit's live phase starts from the graph whole
    carry0, chunk_fn, theta_fn = _phased_runner(
        make_runner, phase_plan(ctx, config.resolved_iters,
                                sharding.unshard(problem.adjacency)))
    carry, history = _chunked_scan(chunk_fn, carry0, config.resolved_iters,
                                   config.chunk_size, progress_cb)
    if mesh is not None:   # gathered once, at the end
        carry = sharding.unshard_tree(carry)
        history = sharding.unshard_tree(history)
    return FitResult(config=config, state=carry, history=history,
                     theta=theta_fn(carry), rff_params=rff_params)


def _check_mesh_devices(mesh, dev: torch.device) -> None:
    """This process's cells of a fit's mesh lie on the fit's device (the
    card it runs on, or the CPU when asked for)."""
    for d in mesh.distinct_devices():
        if d.type != dev.type or (dev.index is not None
                                  and d.index != dev.index):
            raise ValueError(
                f"the mesh has a cell on {d} but the fit runs on {dev}: "
                "build the mesh with make_host_mesh(..., device=) on the "
                "fit's device")


def fit_stream(config: FitConfig, stream: StreamProblem | None = None, *,
               theta0=None, progress_cb: ProgressCb | None = None,
               device: torch.device | str | None = None) -> FitResult:
    """Run a streaming solver (`online_dkla` / `online_coke` / `qc_odkla`)
    over a per-agent minibatch stream and record the regret-style history
    (instantaneous pre-update MSE, cumulative comms and bits, consensus
    gap) through the same chunked loop as `fit()`.

    stream      — an existing `StreamProblem` (moved to `device`); None
                  builds one from config.krr / config.stream /
                  config.online_batch with one round per iteration.
    theta0      — optional warm start, (D,) or (N, D): every agent begins
                  from it (theta and the last broadcast theta_hat), as
                  `KernelModel.partial_fit` passes.
    progress_cb — as in fit().
    device      — None = "cuda" (raises when no card is present).

    The capability table admits the config first, before the device is
    resolved. The result deploys as a batch fit's: `.to_model()`.
    """
    solver = get_solver(config.algorithm)
    check_stream(config, solver)
    dev = resolve_device(device)
    rff_params = None
    if stream is None:
        built = build_stream(config, device=dev)
        stream, rff_params = built.stream, built.rff_params
    elif stream.device != dev:
        stream = stream.to(dev)
    if tuple(stream.adjacency.shape) != (stream.num_agents,
                                         stream.num_agents):
        raise ValueError(
            f"stream adjacency {tuple(stream.adjacency.shape)} does not "
            f"match its {stream.num_agents} agents")
    if theta0 is not None:
        theta0 = torch.as_tensor(theta0, device=dev)

    ctx = _solve_context(config, dev, stream.feats.dtype, stream.num_agents)

    def make_runner(c: SolveContext):
        if config.backend == "simulator":
            return _simulator_runner(solver, stream, c, None)
        return stream_consensus_runner(config, solver, stream, c,
                                       theta0=theta0)

    carry0, chunk_fn, theta_fn = _phased_runner(
        make_runner, phase_plan(ctx, config.resolved_iters,
                                stream.adjacency))
    if config.backend == "simulator" and theta0 is not None:
        carry0 = solver.warm_start(carry0, theta0)
    carry, history = _chunked_scan(chunk_fn, carry0, config.resolved_iters,
                                   config.chunk_size, progress_cb)
    return FitResult(config=config, state=carry, history=history,
                     theta=theta_fn(carry), rff_params=rff_params)
