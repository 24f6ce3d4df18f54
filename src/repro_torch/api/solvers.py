"""The solvers this port runs behind one contract: the ADMM pair, DKLA
(Algorithm 1) and COKE (Algorithm 2), the CTA diffusion baseline, the
streaming family (online-DKLA, online-COKE, QC-ODKLA) and the centralized
ridge oracle; and the per-iteration metrics every history records.

Each solver carries the reference's capability flags: the backends it runs
on (`backends`), whether it threads a communication policy (`comm_aware`),
follows a topology schedule (`topology_aware`), has a (21a) primal
subproblem (`primal_aware`), and has gossip and personalization forms
(`gossip_aware`, `personalization_aware`); the capability table
(`api/capabilities.py`) reads them. The simulator backend drives a solver
through `prepare_host` / `prepare_traced` (once per fit), `init_state`,
then `step` and `metrics` per iteration, and `theta_of`; the spmd and
fused backends read only `consensus_strategy` and `_policy`. Under
exec="gossip" the simulator's ADMM and streaming steps run through
`core.gossip` on a `NeighborTable` made once per fit. In the live phase of
a personalized fit the state carries the learned adjacency
(`core.personalize.PersonalizedState`, `OnlineFitState.adjacency`), which
the step refreshes on cadence before it runs on it (under gossip through
`core.personalize`'s dense steps); both phases record `per_agent_mse`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.api.config import SolveContext
from repro_torch.api.registry import register_solver
from repro_torch.core import admm, cta, online, ridge
from repro_torch.core import comm as comm_mod
from repro_torch.core import gossip as gossip_mod
from repro_torch.core import personalize as personalize_mod
from repro_torch.core.admm import Problem
from repro_torch.core.graph import Graph, metropolis_weights
from repro_torch.core.personalize import PersonalizedState
from repro_torch.distributed import sharding
from repro_torch.distributed.consensus import consensus_gap


def _stacked_metrics(problem: Problem, theta: torch.Tensor,
                     comms: torch.Tensor, bits: torch.Tensor,
                     per_agent: bool = False) -> dict[str, torch.Tensor]:
    """The paper's per-iteration train MSE, cumulative comms, consensus gap
    and cumulative bits, as device tensors (no host sync). The train MSE
    reads Phi once more, outside the kernels. Over a sweep's lanes, theta
    (G, N, D), comms and bits (G,), each metric is (G,), and Phi is read
    once for all lanes. per_agent=True adds the (N,) (lanes: (G, N))
    per-agent train MSE of a personalized fit, from the same residuals."""
    lanes = theta.ndim == 3
    if lanes:
        preds = torch.bmm(problem.feats, theta.permute(1, 2, 0))  # (N,T,G)
        sq = (problem.labels[..., None] - preds) ** 2
        mse = torch.mean(sq, dim=(0, 1))
    else:
        preds = torch.einsum("ntd,nd->nt", problem.feats, theta)
        sq = (problem.labels - preds) ** 2
        mse = torch.mean(sq)
    m = {"train_mse": mse, **_comm_metrics(theta, comms, bits)}
    if per_agent:
        agents = torch.mean(sq, dim=1)            # (N,) or (N, G)
        m["per_agent_mse"] = agents.T if lanes else agents
    return m


def _pz_live(ctx: SolveContext) -> bool:
    """Does this phase run the learned-graph machinery? A personalized
    fit's warmup phase (ctx.pz_warmup) takes the static-graph path itself;
    only its live phase carries and refreshes the learned adjacency."""
    return ctx.personalization is not None and not ctx.pz_warmup


def _gap(theta: torch.Tensor) -> torch.Tensor:
    """max_i ||theta_i - mean theta||, per lane over (G, N, D)."""
    if theta.ndim == 3:
        diff = theta - torch.mean(theta, dim=1, keepdim=True)
        return torch.amax(torch.sqrt(torch.sum(torch.square(diff), dim=-1)),
                          dim=-1)
    return consensus_gap({"theta": theta})


def _comm_metrics(theta: torch.Tensor, comms: torch.Tensor,
                  bits: torch.Tensor) -> dict[str, torch.Tensor]:
    """The per-iteration metrics other than the train MSE."""
    return {"comms": comms, "consensus_gap": _gap(theta),
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
    # the ADMM update has an asynchronous form: sampled participants step,
    # sleepers hold, duals delayed but correct (core.gossip.gossip_coke_step)
    gossip_aware = True
    # the consensus penalty takes a learned weighted graph directly (deg_i
    # becomes sum_j w_ij): FitConfig.personalization admits these solvers
    personalization_aware = True

    def _policy(self, ctx: SolveContext) -> comm_mod.Chain:
        raise NotImplementedError

    def prepare_host(self, problem: Problem, ctx: SolveContext):
        """Under gossip the padded neighbour table (gathers, no (N, N) on
        the step), made once from the adjacency on the host; not in the
        live personalized phase, whose graph changes during the run."""
        if ctx.gossip is not None and not _pz_live(ctx):
            return gossip_mod.NeighborTable.from_adjacency(
                problem.adjacency, device=problem.device)
        return None

    def _primal_mode(self, problem: Problem, ctx: SolveContext) -> str:
        """Cholesky / CG across the big-D crossover, gradient for general
        losses (core.admm.resolve_primal). Under churn or a learned graph
        the degrees change over the run, so Cholesky falls to the
        matrix-free CG solve, in both phases of a personalized fit (an
        explicit primal="cholesky" is rejected by the capability table)."""
        mode = admm.resolve_primal(ctx.primal, problem.feature_dim,
                                   problem.loss)
        if mode == "cholesky" and (
                ctx.personalization is not None
                or (ctx.gossip is not None and ctx.gossip.has_churn)):
            mode = "cg"
        return mode

    def prepare_traced(self, problem: Problem, ctx: SolveContext, host_aux):
        """{"chol": the (N, D, D) factor stack or None, "terms": the (21a)
        system's iteration-invariant parts} for the exact primals; None for
        the gradient primal. Under a topology schedule the normal matrix
        depends on each graph's degrees, so "chol" is an (M, N, D, D) stack
        and coke_step picks the active graph's. The reference builds these
        inside every compiled chunk; the port builds them once per fit."""
        mode = self._primal_mode(problem, ctx)
        if _pz_live(ctx):
            # no factors (the graph lives in the state); the CG system's
            # invariant parts do not depend on it
            return ({"chol": None, "terms": admm.primal_terms(problem)}
                    if mode == "cg" else None)
        if ctx.gossip is not None:
            # the factors from the table's degrees (the same values as the
            # adjacency's on a static graph)
            chol = (admm._ridge_factors(problem, deg=host_aux.degrees())
                    if mode == "cholesky" else None)
            terms = (admm.primal_terms(problem, jacobi=mode == "cg")
                     if mode in ("cholesky", "cg") else None)
            return {"table": host_aux, "chol": chol, "terms": terms}
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
        inner = admm.init_state(problem, policy=self._policy(ctx))
        if _pz_live(ctx):
            # the learned graph starts as the configured one and rides in
            # the state (one per lane over a sweep's (G, N, D) lanes)
            A = problem.adjacency.to(torch.float32)
            if inner.theta.ndim == 3:
                A = A.expand(inner.theta.shape[0], *A.shape)
            return PersonalizedState(inner, A)
        return inner

    def step(self, problem: Problem, ctx: SolveContext, aux, state):
        mode = self._primal_mode(problem, ctx)
        if _pz_live(ctx):
            pz = ctx.personalization
            terms = aux["terms"] if aux else None
            if ctx.gossip is not None:
                return personalize_mod.gossip_coke_step_dense(
                    problem, self._policy(ctx), pz, state, ctx.gossip,
                    inner_steps=ctx.inner_steps, inner_lr=ctx.inner_lr,
                    primal="cg" if mode == "cg" else "gradient",
                    cg_tol=ctx.cg_tol, cg_maxiter=ctx.cg_maxiter,
                    terms=terms)
            # sync: refresh the graph if due, then coke_step on it
            A = personalize_mod.maybe_update(
                pz, state.inner.theta, state.inner.step + 1,
                state.adjacency)
            inner = admm.coke_step(
                dataclasses.replace(problem, adjacency=A),
                self._policy(ctx), state.inner, None, ctx.inner_steps,
                ctx.inner_lr, primal="cg" if mode == "cg" else "auto",
                cg_tol=ctx.cg_tol, cg_maxiter=ctx.cg_maxiter, terms=terms)
            return PersonalizedState(inner, A)
        if ctx.gossip is not None:
            return gossip_mod.gossip_coke_step(
                problem, self._policy(ctx), state, aux["table"], ctx.gossip,
                chol=aux["chol"], inner_steps=ctx.inner_steps,
                inner_lr=ctx.inner_lr,
                primal=mode if mode in ("cg", "cholesky") else "gradient",
                cg_tol=ctx.cg_tol, cg_maxiter=ctx.cg_maxiter,
                terms=aux["terms"])
        aux = aux or {}
        return admm.coke_step(problem, self._policy(ctx), state,
                              aux.get("chol"), ctx.inner_steps, ctx.inner_lr,
                              topology=ctx.topology,
                              primal="cg" if mode == "cg" else "auto",
                              cg_tol=ctx.cg_tol, cg_maxiter=ctx.cg_maxiter,
                              terms=aux.get("terms"))

    def metrics(self, problem: Problem, ctx: SolveContext, aux, state):
        # both personalized phases record per_agent_mse (one key set
        # across the phases' concatenated histories)
        inner = state.inner if isinstance(state, PersonalizedState) \
            else state
        return _stacked_metrics(problem, inner.theta, inner.comms,
                                torch.sum(inner.comm.bits, dim=-1),
                                per_agent=ctx.personalization is not None)

    def theta_of(self, state) -> torch.Tensor:
        if isinstance(state, PersonalizedState):
            return state.inner.theta
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
# The streaming family: online-DKLA, online-COKE, QC-ODKLA
# ---------------------------------------------------------------------------

class OnlineFitState(NamedTuple):
    inner: online.OnlineState
    inst_mse: torch.Tensor   # pre-update MSE on the round's minibatch
    # the learned collaboration graph, in a personalized fit's live phase
    adjacency: torch.Tensor | None = None


def _stream_metrics(theta: torch.Tensor, comms: torch.Tensor,
                    bits: torch.Tensor,
                    inst: torch.Tensor) -> dict[str, torch.Tensor]:
    """The streaming history: the regret sample (the pre-update
    instantaneous MSE, which is also the train_mse trajectory: a stream
    has no fixed train set), cumulative comms and bits, and the consensus
    gap. The spmd backend records the same keys."""
    return {"train_mse": inst, "instant_mse": inst,
            **_comm_metrics(theta, comms, bits)}


def _window(x: torch.Tensor, start: int, size: int) -> torch.Tensor:
    """Columns start, start + 1, ... (size of them, modulo x.shape[1]) of
    x: contiguous runs as slices, joined by one cat where the window
    wraps. The indices are host ints, so nothing is copied to the device."""
    T = x.shape[1]
    parts, done = [], 0
    while done < size:
        lo = (start + done) % T
        n = min(size - done, T - lo)
        parts.append(x[:, lo:lo + n])
        done += n
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


class _OnlineSolver:
    """The streaming family's adapter, on two problem forms: a
    `StreamProblem` (fit_stream: round k is the stream's k-th minibatch)
    and a batch `Problem` (fit: round k is an `online_batch`-sized window
    rotating over each agent's shard). Both record the regret sample."""

    backends = ("simulator",)               # the batch fit() contract
    stream_backends = ("simulator", "spmd")
    streaming = True
    consensus_strategy = None
    comm_aware = True
    topology_aware = False
    # the streaming round has the ADMM round's asynchronous form: sampled
    # participants take the minibatch step and gossip, sleepers hold
    # (core.gossip.gossip_stream_step)
    gossip_aware = True
    # the streaming consensus penalty takes a learned weighted graph as the
    # batch one does (deg_i = sum_j w_ij)
    personalization_aware = True

    def _policy(self, ctx: SolveContext) -> comm_mod.Chain:
        raise NotImplementedError

    def _eta(self, ctx: SolveContext) -> float | None:
        """Linearized-ADMM proximal coefficient; None = gradient step."""
        return None

    def prepare_host(self, problem, ctx: SolveContext):
        if ctx.gossip is not None and not _pz_live(ctx):
            return gossip_mod.NeighborTable.from_adjacency(
                problem.adjacency, device=problem.device)
        return None

    def prepare_traced(self, problem, ctx: SolveContext, host_aux):
        return host_aux   # gossip: the neighbour table; sync: None

    def init_state(self, problem, ctx: SolveContext) -> OnlineFitState:
        inner = online.init_state(problem.num_agents, problem.feature_dim,
                                  problem.feats.dtype,
                                  policy=self._policy(ctx),
                                  device=problem.device)
        A = problem.adjacency.to(torch.float32) if _pz_live(ctx) else None
        return OnlineFitState(inner, torch.zeros(
            (), dtype=problem.feats.dtype, device=problem.device), A)

    def warm_start(self, state: OnlineFitState, theta0) -> OnlineFitState:
        """Re-seed a fresh state from deployed parameters: theta and the
        last broadcast theta_hat start at theta0 ((D,) or (N, D)), the
        duals at zero — KernelModel.partial_fit's entry."""
        theta = state.inner.theta
        theta0 = torch.as_tensor(theta0, dtype=theta.dtype,
                                 device=theta.device).expand(theta.shape)
        inner = state.inner._replace(theta=theta0, theta_hat=theta0)
        return state._replace(inner=inner)

    def _round_batch(self, problem, ctx: SolveContext, step: int):
        from repro_torch.api.problems import StreamProblem  # import cycle

        if isinstance(problem, StreamProblem):
            return problem.round_batch(step)
        b = ctx.online_batch
        start = (step * b) % problem.feats.shape[1]
        return (_window(problem.feats, start, b),
                _window(problem.labels, start, b))

    def step(self, problem, ctx: SolveContext, aux,
             state: OnlineFitState) -> OnlineFitState:
        feats, labels = self._round_batch(problem, ctx, state.inner.step)
        if _pz_live(ctx):
            # refresh the learned graph if due, then take the round on it
            A = personalize_mod.maybe_update(
                ctx.personalization, state.inner.theta,
                state.inner.step + 1, state.adjacency)
            if ctx.gossip is not None:
                inner, inst = personalize_mod.gossip_stream_step_dense(
                    state.inner, feats, labels, A, self._policy(ctx),
                    ctx.gossip, lam=problem.lam, rho=problem.rho,
                    lr=ctx.online_lr, eta=self._eta(ctx))
            else:
                inner, inst = online.stream_step(
                    state.inner, feats, labels, A, self._policy(ctx),
                    lam=problem.lam, rho=problem.rho, lr=ctx.online_lr,
                    eta=self._eta(ctx))
            return OnlineFitState(inner, inst, A)
        if ctx.gossip is not None:
            inner, inst = gossip_mod.gossip_stream_step(
                state.inner, feats, labels, aux, self._policy(ctx),
                ctx.gossip, lam=problem.lam, rho=problem.rho,
                lr=ctx.online_lr, eta=self._eta(ctx))
        else:
            inner, inst = online.stream_step(
                state.inner, feats, labels, problem.adjacency,
                self._policy(ctx), lam=problem.lam, rho=problem.rho,
                lr=ctx.online_lr, eta=self._eta(ctx))
        return OnlineFitState(inner, inst)

    def metrics(self, problem, ctx: SolveContext, aux,
                state: OnlineFitState):
        from repro_torch.api.problems import StreamProblem  # import cycle

        bits = torch.sum(state.inner.comm.bits, dim=-1)
        if isinstance(problem, StreamProblem):
            # a stream has no fixed per-agent set to score: no
            # per_agent_mse, personalized or not
            return _stream_metrics(state.inner.theta, state.inner.comms,
                                   bits, state.inst_mse)
        m = _stacked_metrics(problem, state.inner.theta, state.inner.comms,
                             bits, per_agent=ctx.personalization is not None)
        m["instant_mse"] = state.inst_mse
        return m

    def theta_of(self, state: OnlineFitState) -> torch.Tensor:
        return state.inner.theta


@register_solver("online_dkla")
class OnlineDKLASolver(_OnlineSolver):
    """Streaming DKLA, the always-transmit baseline of the online family:
    the policy's censor thresholds are forced to zero, its quantize and
    drop stages still apply."""

    def _policy(self, ctx: SolveContext) -> comm_mod.Chain:
        return comm_mod.uncensored(ctx.comm)


@register_solver("online_coke")
class OnlineCOKESolver(_OnlineSolver):
    """Streaming COKE: one censored gradient step on the streaming
    augmented Lagrangian per round."""

    def _policy(self, ctx: SolveContext) -> comm_mod.Chain:
        return ctx.comm


@register_solver("qc_odkla")
class QCODKLASolver(_OnlineSolver):
    """QC-ODKLA (Xu et al., 2022): the linearized-ADMM primal (per-agent
    stepsize 1/(eta + 2 rho deg_i)) with the full Censor/Quantize/Drop
    chain. `qc_eta=None` reuses the gradient stepsize `online_lr`; with
    the identity chain it is then bitwise online_coke."""

    def _policy(self, ctx: SolveContext) -> comm_mod.Chain:
        return ctx.comm

    def _eta(self, ctx: SolveContext) -> float | None:
        return ctx.qc_eta


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
        # a copy, on a mesh in the state's feature blocks
        theta = sharding.recut(theta.contiguous(), state.theta)
        return OracleState(theta, state.step + 1, state.comms)

    def metrics(self, problem: Problem, ctx: SolveContext, aux,
                state: OracleState):
        return _stacked_metrics(problem, state.theta, state.comms,
                                torch.zeros((), dtype=torch.int32,
                                            device=problem.device))

    def theta_of(self, state: OracleState) -> torch.Tensor:
        return state.theta
