"""Backend routing for `fit()`: the spmd and fused backends (the simulator
runs in `api/fit.py`).

  spmd  — the ring consensus runtime (`distributed/consensus.py`): the
          agent axis as a leading tensor dimension, neighbour exchange as
          `torch.roll`, the inexact one-step gradient primal, or the exact
          matrix-free CG primal (`primal="cg"`, or "auto" past D = 2048 on
          the quadratic loss) through the runtime's `primal_solve` hook.
          Runs dkla, coke and cta.
  fused — on megakernel-admissible configs (dkla/coke, the gradient
          primal, quadratic loss, static ring or circulant graph) each ADMM
          iteration runs the `coke_megastep` kernel (K2) substituted into
          the `core.step.StepProgram` primal stage. Everything else falls
          back to the ring runtime: the gradient primal with the augmented
          gradient in the `coke_fused_update` kernel (K3), or the CG primal,
          which launches neither kernel.

`stream_consensus_runner` is fit_stream's spmd backend: the ring runtime's
streaming round (`consensus.stream_update`) over a StreamProblem's rounds,
with the simulator's history keys.

Under exec="gossip" every chunk draws round k's participation mask from
the carried `CommState` key and k, as the simulator does, so the backends
sample the same wake-up schedules and their comms and bits agree: into
`consensus_update` / `stream_update` (with the churn plan's alive and
joined masks), and on the megakernel path as the `comm_decide` stage
around K2 (the kernel computes every agent's theta', the mask applies
after it, as in the reference). Churn never reaches the fused backend:
the capability table rejects it.

A personalized fit's live phase carries the learned graph in the ring
runtime's state (`cstate["adjacency"]`): each chunk refreshes it with
`core.personalize.maybe_update` on the simulator's cadence before every
update and passes it as `consensus_update` / `stream_update`'s dense
`adjacency=`; the batch chunk also records `per_agent_mse` in both phases.
Personalization never reaches the fused backend: the capability table
rejects it (the kernels take a fixed ring).

On a mesh (`fit(mesh=)`) both backends run the ring runtime on the
feature-sharded problem and carry (`distributed.sharding`); the
megakernel's gate keeps the reference's `mesh is None`, so a fused fit on
a mesh takes the fallback, K3 once per block of the carry.

Both backends require a circulant graph, validated against the problem's
adjacency, so a mismatched FitConfig fails loudly instead of silently
solving a different consensus problem. A topology schedule runs on the
ring runtime when each of its graphs is the circulant its offsets name
(`_validate_schedule`); it never reaches the megakernel, and the fused
fallback rejects it (K3 takes a fixed degree), as in the reference.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.api.config import FitConfig, SolveContext
from repro_torch.api.registry import Solver
from repro_torch.api.solvers import (_comm_metrics, _pz_live,
                                     _stacked_metrics, _stream_metrics,
                                     _uncompressed_bits)
from repro_torch.core import admm
from repro_torch.core import losses as losses_mod
from repro_torch.core import personalize as personalize_mod
from repro_torch.core import step as step_mod
from repro_torch.core.admm import CG_CROSSOVER_DIM, Problem, resolve_primal
from repro_torch.core.graph import circulant
from repro_torch.distributed import consensus as cns
from repro_torch.distributed import sharding
from repro_torch.kernels.coke_update.coke_update import coke_megastep
from repro_torch.kernels.coke_update.ref import residual_sq
from repro_torch.optim.optimizers import OptConfig

#: history dtypes, for the (0,)-histories of a zero-iteration chunk
_HIST_DTYPES = {"train_mse": torch.float32, "comms": torch.int32,
                "consensus_gap": torch.float32, "bits": torch.float32,
                "send_frac": torch.float32, "dist_to_oracle": torch.float32,
                "instant_mse": torch.float32, "per_agent_mse": torch.float32}


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


def _validate_schedule(problem: Problem, topology) -> None:
    """Each scheduled graph must be the circulant its offsets claim:
    otherwise the ring runtime silently solves a different consensus
    problem than the simulator."""
    N = problem.num_agents
    for i, off in enumerate(topology.offsets):
        off = tuple(off)
        seen = set()
        for o in off:
            pair = frozenset(((o % N), (-o) % N))
            if (2 * o) % N == 0 or pair in seen:
                raise ValueError(
                    f"offset {o} is degenerate on N={N} agents (the ±{o} "
                    "permutes alias the same neighbor, double-counting it "
                    "in the ring runtime); choose offsets with 2*o % N != 0")
            seen.add(pair)
        want = circulant(N, off).adjacency
        have = topology.adjacencies[i].detach().cpu().numpy()
        if not np.array_equal(have, want):
            raise ValueError(
                f"topology schedule graph {i} does not match the circulant "
                f"with offsets {tuple(off)}; build the schedule with "
                "TopologySchedule.circulant_cycle or use "
                "backend='simulator'")


def _local_grads(problem: Problem, theta: torch.Tensor) -> torch.Tensor:
    """Per-agent gradients of local_empirical_risk(theta_i, Phi_i, y_i,
    lam/N, loss): autograd of the agent sum, where each agent's risk
    depends on its own row only. Reads Phi twice (forward and backward).
    On a mesh Phi theta is a psum and the gradient block-local
    (`losses.risk_grad`)."""
    return losses_mod.risk_grad(theta, problem.feats, problem.labels,
                                problem.lam / problem.num_agents,
                                problem.loss)


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


def _cg_primal_solve(problem: Problem, cg_tol: float, cg_maxiter: int):
    """The matrix-free CG solve of (21a) in the ring runtime's tree form:
    the runtime hands over (params, theta_hat, gamma, summed neighbour
    theta_hat, degree) and gets the exact primal back, warm-started from
    the previous iterate. The right-hand side's (2/T) Phi'y and the Jacobi
    diagonal's data part are made once here, for the whole fit."""
    terms = admm.primal_terms(problem)
    n_agents = problem.num_agents

    def solve(params, theta_hat, gamma, nbr_sum, deg):
        if isinstance(deg, torch.Tensor) and deg.ndim == 1:
            deg_vec = deg.to(problem.feats.dtype)   # churn: per agent
        else:
            deg_vec = torch.full((n_agents,), float(deg),
                                 dtype=problem.feats.dtype,
                                 device=problem.device)
        theta = admm._primal_cg(
            problem, gamma["theta"], theta_hat["theta"], nbr_sum["theta"],
            deg_vec, theta0=params["theta"], tol=cg_tol, maxiter=cg_maxiter,
            terms=terms)
        return {"theta": theta.to(params["theta"].dtype)}

    return solve


class _FusedCarry(NamedTuple):
    """core.step.run_step carry of the megakernel path."""

    theta: torch.Tensor       # (N, D)
    theta_hat: torch.Tensor   # (N, D)
    gamma: torch.Tensor       # (N, D)
    step: int                 # iterations done
    comms: torch.Tensor       # () int32 cumulative transmissions
    comm: Any                 # core.comm.CommState


def _stack_history(hist: dict[str, list], device,
                   num_agents: int = 0) -> dict[str, torch.Tensor]:
    """Stack each key's per-iteration tensors; an empty key becomes a
    (0,)-history ((0, N) for the per-agent MSE)."""
    def empty(k):
        shape = (0, num_agents) if k == "per_agent_mse" else (0,)
        return torch.empty(shape, dtype=_HIST_DTYPES[k], device=device)
    return {k: torch.stack(v) if v else empty(k) for k, v in hist.items()}


def _gossip_masks(gossip, comm_state, k: int, n_agents: int):
    """(participate, alive, joined) of round k under a gossip plan, drawn
    from the carried CommState key as the simulator draws them; joined is
    None where no row (re)joins."""
    alive = joined = None
    if gossip.has_churn:
        alive, joined = gossip.alive_at(k), gossip.joined_at(k)
    return (step_mod.participation_mask(comm_state.key, k, n_agents, gossip,
                                        alive), alive, joined)


def _megastep_chunk(problem: Problem, st: _FusedCarry, oracle, chain, *,
                    offsets: tuple[int, ...], num_iters: int, lr: float,
                    gossip=None):
    """`num_iters` iterations of the megakernel program: one
    `coke_megastep` call per iteration (two launches on the card),
    substituted into the StepProgram primal stage with
    `primal_owns_exchange=True`: the kernel reads the ring neighbours'
    theta_hat rows itself. History keys match the reference's fused chunk:
    train_mse / comms / consensus_gap / bits / send_frac
    [+ dist_to_oracle]. Histories stay device tensors and are stacked once
    at the end of the chunk. Under a gossip plan the program's comm_decide
    stage draws the participation mask after K2; sleepers keep theta.

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
        # recomputes the censor norm, as the reference does. K2 writes
        # theta' over its theta operand; under gossip a sleeper keeps
        # theta0, so the kernel gets a copy
        theta_new, _xi_sq = coke_megastep(
            theta0 if gossip is None else theta0.clone(), theta_hat0,
            gamma0, problem.feats, problem.labels,
            rho=problem.rho, lam=problem.lam, lr=lr, offsets=offsets,
            resid_sq=resid_sq)
        return theta_new, {}

    program = step_mod.StepProgram(
        chain=chain, rho=problem.rho, exchange=lambda state, k: view,
        primal=primal,
        comm_decide=(None if gossip is None
                     else step_mod.sampled_stage(gossip)),
        primal_owns_exchange=True)

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
                     num_iters: int, primal_solve=None, gossip=None,
                     personalize=None, pz_metric: bool = False):
    """`num_iters` iterations of the ring runtime: local gradients, then
    `consensus_update` (through K3 when ccfg.use_fused_kernel). With a
    `primal_solve` (the CG primal) the solve replaces the gradient step:
    zero gradients are passed and `_local_grads` is skipped, as in the
    reference, which saves its two Phi reads. Under a gossip plan each
    round's participation (and churn) masks go into `consensus_update`.
    In a personalized fit's live phase (`personalize`) each round first
    refreshes the carried graph if due and runs on it; `pz_metric` (both
    phases) adds per_agent_mse. History keys match the reference's spmd
    chunk: train_mse / comms / consensus_gap / bits, then send_frac for
    dkla/coke [+ per_agent_mse] [+ dist_to_oracle]."""
    keys = ["train_mse", "comms", "consensus_gap", "bits"]
    if ccfg.is_admm:
        keys.append("send_frac")
    if pz_metric:
        keys.append("per_agent_mse")
    if oracle is not None:
        keys.append("dist_to_oracle")
    hist: dict[str, list] = {k: [] for k in keys}
    for _ in range(num_iters):
        if primal_solve is None:
            grads = {"theta": _local_grads(problem, params["theta"])}
        else:
            grads = {"theta": torch.zeros_like(params["theta"])}
        participate = alive = joined = None
        if gossip is not None:
            participate, alive, joined = _gossip_masks(
                gossip, cstate["comm"], cstate["step"] + 1,
                problem.num_agents)
        adjacency = None
        if personalize is not None:   # the simulator's refresh
            adjacency = personalize_mod.maybe_update(
                personalize, params["theta"], cstate["step"] + 1,
                cstate["adjacency"])
        params, cstate, extra = cns.consensus_update(
            ccfg, opt_cfg, params, grads, cstate, comm=chain,
            primal_solve=primal_solve, participate=participate,
            adjacency=adjacency, alive=alive, joined=joined)
        if personalize is not None:
            cstate = dict(cstate, adjacency=adjacency)
        bits = extra.get("bits")
        if bits is None:  # policy-unaware strategy (cta): full precision
            bits = _uncompressed_bits(problem, cstate["comms"])
        m = _stacked_metrics(problem, params["theta"], cstate["comms"], bits,
                             per_agent=pz_metric)
        m.update(extra)
        if oracle is not None:
            m["dist_to_oracle"] = torch.max(torch.linalg.norm(
                params["theta"] - oracle, dim=-1))
        for k in keys:
            hist[k].append(m[k])
    return (params, cstate), _stack_history(hist, problem.device,
                                            problem.num_agents)


def _stream_chunk(stream, params, cstate, chain, *,
                  ccfg: cns.ConsensusConfig, num_iters: int, lam: float,
                  lr: float, eta: float | None, gossip=None,
                  personalize=None):
    """`num_iters` rounds of the ring runtime's streaming update, each on
    the stream's next round (wrapping), with the simulator's participation
    and churn masks under a gossip plan, and in a personalized live phase
    on the carried graph, refreshed on the simulator's cadence. History
    keys are the simulator's `_stream_metrics` keys."""
    keys = ["train_mse", "instant_mse", "comms", "consensus_gap", "bits"]
    hist: dict[str, list] = {k: [] for k in keys}
    for _ in range(num_iters):
        participate = alive = joined = None
        if gossip is not None:
            participate, alive, joined = _gossip_masks(
                gossip, cstate["comm"], cstate["step"] + 1,
                stream.num_agents)
        adjacency = None
        if personalize is not None:
            adjacency = personalize_mod.maybe_update(
                personalize, params["theta"], cstate["step"] + 1,
                cstate["adjacency"])
        feats, labels = stream.round_batch(cstate["step"])
        params, cstate, extra = cns.stream_update(
            ccfg, params, cstate, feats, labels, lam=lam, lr=lr, eta=eta,
            comm=chain, participate=participate, adjacency=adjacency,
            alive=alive, joined=joined)
        if personalize is not None:
            cstate = dict(cstate, adjacency=adjacency)
        m = _stream_metrics(params["theta"], cstate["comms"],
                            extra["bits"], extra["instant_mse"])
        for k in keys:
            hist[k].append(m[k])
    return (params, cstate), _stack_history(hist, stream.device)


def _pz_live_state(ctx: SolveContext, cstate: dict, adjacency):
    """In a personalized fit's live phase: put the starting graph (the
    configured one) into the ring runtime's state and return the
    Personalization that refreshes it; else None. The warmup phase runs
    the static ring program, with no graph in its state."""
    if not _pz_live(ctx):
        return None
    cstate["adjacency"] = adjacency.to(torch.float32)
    return ctx.personalization


def stream_consensus_runner(config: FitConfig, solver: Solver, stream,
                            ctx: SolveContext, theta0=None):
    """-> (carry0, chunk_fn, theta_fn) for fit_stream's spmd backend: the
    ring runtime's `stream_update` over the StreamProblem's rounds. Needs
    the circulant graph family, as the batch ring runtime does. theta0
    ((D,) or (N, D)) warm-starts theta and theta_hat."""
    offsets = tuple(config.graph_offsets)
    _validate_topology(stream, offsets)
    # stream_update reads only rho and the offsets from the config
    ccfg = cns.ConsensusConfig(rho=stream.rho, offsets=offsets)
    # the solver's policy view of the configured chain (online_dkla strips
    # the censor thresholds)
    chain = solver._policy(ctx)
    eta = solver._eta(ctx)
    N, D = stream.num_agents, stream.feature_dim
    dtype = stream.feats.dtype
    if theta0 is None:
        theta = torch.zeros((N, D), dtype=dtype, device=stream.device)
    else:
        theta = torch.as_tensor(theta0, dtype=dtype,
                                device=stream.device).expand(N, D)
    params = {"theta": theta}
    cstate = cns.init_stream_state(ccfg, theta, comm=chain)
    personalize = _pz_live_state(ctx, cstate, stream.adjacency)

    def chunk_fn(carry, n):
        params, cstate = carry
        return _stream_chunk(stream, params, cstate, chain, ccfg=ccfg,
                             num_iters=n, lam=stream.lam, lr=ctx.online_lr,
                             eta=eta, gossip=ctx.gossip,
                             personalize=personalize)

    return (params, cstate), chunk_fn, lambda carry: carry[0]["theta"]


def consensus_runner(config: FitConfig, solver: Solver, problem: Problem,
                     ctx: SolveContext, oracle: torch.Tensor | None,
                     mesh=None):
    """-> (carry0, chunk_fn, theta_fn) for the spmd / fused backends.

    mesh — optional `launch.mesh.Mesh` the problem was placed on
    (`fit` shards it once): the consensus carry (params, theta_hat,
    gamma, the neighbour caches, the optimizer slots and the policy's
    bits) is placed the same way, the feature dim cut over the mesh's
    "model" axis and the agent dim over its batch axes
    (`distributed.sharding.feature_spec`). The megakernel needs an
    unsharded carry: on a mesh a fused fit runs the ring runtime through
    K3, once per block, as the reference falls back to its ring runtime.
    A personalized fit's live phase starts its learned graph from the
    problem's, gathered whole once here, and keeps it whole in the
    carry."""
    strategy = solver.consensus_strategy
    primal_mode = _resolve_consensus_primal(config, problem, strategy)
    offset_schedule = None
    if config.topology is not None:
        offset_schedule = config.topology.offsets
        if offset_schedule is None:
            raise ValueError(
                "the spmd/fused backends implement circulant topologies; "
                "give the TopologySchedule its per-graph `offsets` (e.g. "
                "TopologySchedule.circulant_cycle) or use "
                "backend='simulator'")
        _validate_schedule(problem, config.topology)
        offsets = offset_schedule[0]
    else:
        offsets = tuple(config.graph_offsets)
        _validate_topology(problem, offsets)
    N, D = problem.num_agents, problem.feature_dim
    dev, dtype = problem.device, problem.feats.dtype

    # megakernel admission (the reference's gate): the one-step gradient
    # primal on the quadratic loss over a fixed circulant (no schedule),
    # unsharded and not personalized (the capability table rejects those
    # two first); a CG fit falls back to the ring runtime. The comm chain
    # is not part of the gate: it runs after K2, in run_step
    use_mega = (config.backend == "fused"
                and strategy in ("dkla", "coke")
                and primal_mode == "gradient"
                and problem.loss == "quadratic"
                and offset_schedule is None
                and mesh is None
                and ctx.personalization is None)
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
                                   lr=ctx.inner_lr, gossip=ctx.gossip)

        return carry0, mega_chunk_fn, lambda carry: carry.theta

    # the ring runtime: spmd, and the fused backend's fallback through K3
    v, mu = config.resolved_censor
    k = len(offsets)
    ccfg = cns.ConsensusConfig(
        strategy=strategy, rho=problem.rho, censor_v=v, censor_mu=mu,
        offsets=offsets, offset_schedule=offset_schedule,
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
    if mesh is not None:
        params = sharding.shard_features(params, mesh, N)
        cstate = sharding.shard_features(cstate, mesh, N)
    personalize = _pz_live_state(ctx, cstate,
                                 sharding.unshard(problem.adjacency))

    primal_solve = (_cg_primal_solve(problem, ctx.cg_tol, ctx.cg_maxiter)
                    if primal_mode == "cg" else None)

    def chunk_fn(carry, n):
        params, cstate = carry
        return _consensus_chunk(problem, params, cstate, oracle, chain,
                                ccfg=ccfg, opt_cfg=opt_cfg, num_iters=n,
                                primal_solve=primal_solve, gossip=ctx.gossip,
                                personalize=personalize,
                                pz_metric=ctx.personalization is not None)

    return (params, cstate), chunk_fn, lambda carry: carry[0]["theta"]
