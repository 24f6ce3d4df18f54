"""The step-composition layer: one per-iteration skeleton for the ADMM
family, as in the reference's `core/step.py`.

Every iteration runs the same named stages: `exchange` (the graph view),
`primal` (the (21a) update), `comm_decide` (who speaks: gossip
participation sampling), the comm chain's broadcast decision, the (21b)
dual ascent against the fresh broadcasts, and the transmission count. A
backend substitutes stages; `run_step` owns the order.

The simulator's exchange is `dense_view` (`A @ x` over the adjacency), or
under gossip `table_view` (gathers over a `core.gossip.NeighborTable`,
alive-weighted under churn); the fused megakernel path builds its own ring
view. With a `comm_decide` stage (`sampled_stage`), sleepers hold theta,
are silent in the broadcast (zero bits) and freeze their duals; under
churn a (re)joining agent restarts from zero.

A sweep runs G policy cells as one program on a leading lane axis: theta,
theta_hat and gamma are (G, N, D), `comms` is (G,), and the chain is a
`core.comm.LaneChain`. The stages broadcast over the lane axis (`A @ x`
over (G, N, D), degrees as (N, 1), participation masks (G, N)); where the
reference `vmap`s a whole fit, the port batches one step.

`stream_primal` is the streaming family's featurize + primal stage
(online-DKLA / online-COKE, and QC-ODKLA's linearized-ADMM form).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import prng

#: fold-in tag separating the participation stream from the comm stages'
#: per-round streams (Chain.apply folds the stage index; this sentinel can
#: never collide with one)
PARTICIPATION_TAG = 0x9E3779B1


def participation_key(key: prng.Key, k: int, rate: float) -> prng.Key:
    """The host key of round k's participation draw under the chain key:
    fold_in(key, k), then PARTICIPATION_TAG, then the rate's float32 bit
    pattern (the reference's `comm._fold_value`)."""
    r = prng.fold_in(prng.fold_in(key, k), PARTICIPATION_TAG)
    return prng.fold_in(r, int(np.float32(rate).view(np.uint32)))


def participation_mask(key, k: int, num_agents: int, plan,
                       alive: torch.Tensor | None = None) -> torch.Tensor:
    """(N,) bool: who computes and broadcasts in round k (the reference's
    `participation_mask`). `key` is the chain-level `CommState.key`: a host
    pair, or a sweep's (G, 2) array of lane keys, which gives (G, N), each
    lane drawing under its own key (`GossipPlan.lane_keys`). One
    `prng.uniform` of N words per round (G x N under lane keys).

    Straggler slowdowns scale the threshold or score, not the stream: in
    Bernoulli mode the acceptance probability divides by the slowdown; in
    fixed-size mode the draw is multiplied by it and the `size` lowest
    scores fire. The reference takes `top_k(-score)`, which breaks ties by
    the lower index; a stable descending sort of -score keeps that rule
    (`torch.topk` does not promise it). Dead agents score +inf and are
    masked afterwards. rate = 1.0 is exactly the all-ones mask."""
    dev = plan.participation.device
    if isinstance(key, np.ndarray):
        u = prng.uniform(plan.lane_keys(key, k, dev), (num_agents,), dev)
    else:
        u = prng.uniform(participation_key(key, k, plan.rate),
                         (num_agents,), dev)
    if plan.size is not None:
        score = u if plan.slowdown is None else u * plan.slowdown
        if alive is not None:
            score = torch.where(alive, score, torch.inf)
        order = torch.sort(-score, dim=-1, descending=True, stable=True)[1]
        m = torch.zeros(u.shape, dtype=torch.bool, device=dev).scatter_(
            -1, order[..., :plan.size], True)
    else:
        p = plan.participation
        if plan.slowdown is not None:
            p = torch.clamp_max(p / plan.slowdown, 1.0)
        m = u < p
    if alive is not None:
        m = m & alive
    return m


def _mask_rows(m: torch.Tensor, new, old):
    """Row-select over agent-stacked tuples of (..., N, D) tensors: agent
    i's rows take `new` iff m[i]. m is (N,), or (G, N) over a sweep's lanes
    ((N,) masks broadcast over the lanes). With an all-true mask this is
    bitwise `new`, the degenerate-gossip contract."""
    keep = m[..., None]
    return tuple(torch.where(keep, a, b) for a, b in zip(new, old))


@dataclasses.dataclass(frozen=True)
class GraphView:
    """What one iteration sees of the consensus graph: (N,) degrees, a
    neighbour-sum operator x (N, ...) -> sum_n w x_n, under churn the
    liveness mask and the rows that (re)joined this iteration, and, under a
    topology schedule, the Cholesky factors of the graph in effect."""

    deg: torch.Tensor
    nbr_sum: Callable[[torch.Tensor], torch.Tensor]
    alive: torch.Tensor | None = None
    joined: torch.Tensor | None = None
    chol: torch.Tensor | None = None


def dense_view(adjacency: torch.Tensor, deg: torch.Tensor | None = None,
               chol: torch.Tensor | None = None) -> GraphView:
    """A dense (possibly Erdos-Renyi, or learned and weighted) graph:
    `A @ x` neighbour sums and row-sum degrees, as the simulator exchanges.
    A sweep's per-lane learned graphs (G, N, N) give (G, N) degrees and a
    batched product over the lanes. On a mesh (feature-sharded x, A cut
    by rows) `A @ x` all-gathers x over the batch axes, then multiplies
    each row block of A (`distributed.sharding`)."""
    d = torch.sum(adjacency, dim=-1) if deg is None else deg
    return GraphView(deg=d, nbr_sum=lambda x: adjacency @ x, chol=chol)


def table_view(table, plan, k: int) -> GraphView:
    """Padded NeighborTable gathers under a gossip plan: alive-weighted
    degrees and sums, never an (N, N) tensor. `joined` marks the rows whose
    churn event fired at exactly iteration k, and is None where none did
    (the reference's all-false mask, which changes no row). The event index
    is found on the host; the alive row is a view of the device stack."""
    i = plan.event_index(k)
    alive = None if i is None else plan.alive_stack[i]
    deg, weights = plan.table_weights(table, i)
    return GraphView(deg=deg,
                     nbr_sum=lambda x: table.gather_sum(x, weights),
                     alive=alive, joined=plan.joined_at(k))


def sampled_stage(plan) -> Callable:
    """The gossip comm_decide stage: CommState-keyed participation
    sampling, masked to the live rows under churn."""
    def stage(key, k, g: GraphView):
        return participation_mask(key, k, g.deg.shape[-1], plan, g.alive)
    return stage


def true_div(x: torch.Tensor, value: float) -> torch.Tensor:
    """x / value as one float32 division, on the card too: CUDA divides a
    tensor by a host scalar through its reciprocal (a second rounding), the
    reference divides; a 0-d device tensor keeps the division."""
    return x / torch.full((), value, dtype=x.dtype, device=x.device)


def stream_primal(feats: torch.Tensor, labels: torch.Tensor, *, lam: float,
                  rho: float, lr: float, eta: float | None) -> Callable:
    """The streaming featurize + primal stage shared by online-DKLA/COKE
    (eta=None: one gradient step of size lr on the streaming augmented
    Lagrangian) and QC-ODKLA (eta=float: the linearized-ADMM closed form,
    a gradient step of size 1/(eta + 2 rho deg_i), written in the same
    subtractive form so that the two modes share every other float op).
    feats (N, b, D), labels (N, b): the round's fresh minibatch. Emits the
    pre-update instantaneous MSE, the online protocol's regret sample."""
    def stage(k, g: GraphView, theta0, theta_hat0, gamma0, nbr_hat):
        N = feats.shape[0]
        deg = g.deg
        preds = torch.einsum("nbd,nd->nb", feats, theta0)
        inst_mse = torch.mean((labels - preds) ** 2)
        resid = preds - labels
        g_data = true_div(2.0 * torch.einsum("nb,nbd->nd", resid, feats),
                          feats.shape[1])
        grad = (g_data + (2.0 * lam / N) * theta0
                + 2.0 * rho * deg[:, None] * theta0
                + gamma0
                - rho * (deg[:, None] * theta_hat0 + nbr_hat))
        if eta is None:
            theta_new = theta0 - lr * grad
        else:
            theta_new = theta0 - grad / (eta + 2.0 * rho * deg[:, None])
        return theta_new, {"inst_mse": inst_mse}
    return stage


@dataclasses.dataclass(frozen=True)
class StepProgram:
    """One per-iteration program: the comm chain, the dual stepsize and the
    substitutable stages. `exchange(state, k)` gives the GraphView;
    `primal(k, g, theta0, theta_hat0, gamma0, nbr_hat)` returns (theta_new,
    extras); `comm_decide(key, k, g)`, if set, returns the participation
    mask (None: synchronous, every agent updates and `chain.apply` runs
    unmasked). `primal_owns_exchange=True` declares that the primal stage
    reads its neighbours' theta_hat itself (the fused megakernel does), so
    `run_step` skips the pre-primal neighbour sum and passes nbr_hat=None."""

    chain: Any
    rho: float
    exchange: Callable[[Any, int], GraphView]
    primal: Callable
    comm_decide: Callable | None = None
    primal_owns_exchange: bool = False


def run_step(program: StepProgram, state):
    """Execute one iteration of `program` on a (theta, theta_hat, gamma,
    step, comms, comm) carry; returns (new_state, extras)."""
    chain = program.chain
    k = state.step + 1
    comm_state = chain.ensure_state(state.comm, state.theta.shape[-2],
                                    state.theta.device)
    g = program.exchange(state, k)

    theta0, theta_hat0, gamma0 = state.theta, state.theta_hat, state.gamma
    if g.joined is not None:
        # a (re)joining agent restarts cold: zero primal, broadcast, dual
        old = (theta0, theta_hat0, gamma0)
        theta0, theta_hat0, gamma0 = _mask_rows(
            g.joined, tuple(torch.zeros_like(t) for t in old), old)
    nbr_hat = (None if program.primal_owns_exchange
               else g.nbr_sum(theta_hat0))
    theta_new, extras = program.primal(k, g, theta0, theta_hat0, gamma0,
                                       nbr_hat)

    m = None
    theta = theta_new
    if program.comm_decide is not None:
        # gossip: sleepers hold their primal iterate, are silent in the
        # broadcast (zero bits), and their duals freeze (delayed but
        # correct: the next wake integrates (21b) against the broadcasts
        # of then)
        m = program.comm_decide(comm_state.key, k, g)
        (theta,) = _mask_rows(m, (theta_new,), (theta0,))

    theta_hat, send, comm_state = chain.apply(theta, theta_hat0, k,
                                              comm_state, active=m)

    # dual (21b): gamma_i += rho * sum_n (theta_hat_i - theta_hat_n)
    nbr_new = g.nbr_sum(theta_hat)
    gamma = gamma0 + program.rho * (g.deg[..., None] * theta_hat - nbr_new)
    if m is not None:
        (gamma,) = _mask_rows(m, (gamma,), (gamma0,))

    new_state = type(state)(
        theta=theta, theta_hat=theta_hat, gamma=gamma, step=k,
        comms=state.comms + torch.sum(send, dim=-1, dtype=torch.int32),
        comm=comm_state)
    return new_state, extras
