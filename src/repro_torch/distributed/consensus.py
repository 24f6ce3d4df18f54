"""The ring consensus runtime: COKE/DKLA/CTA as a data-parallel strategy.

Each agent holds its own parameter copy theta_i as a row of an
agent-stacked tree ({"theta": (N, D)}, or a deep net's dict of weights);
the consensus graph is a circulant ring. Neighbour exchange is
`torch.roll` along the agent axis.

Strategies:
  allreduce — standard DP (the mean gradient; `train.steps` runs it and
              keeps no agent stack: `needs_agent_stack`),
  dkla    — decentralized ADMM (Alg. 1) with an inexact inner argmin (one
            optimizer step on the augmented Lagrangian),
  coke    — dkla + communication censoring (Alg. 2): the exchange always
            runs but carries the *stale* theta_hat when censored, which is
            the same as not transmitting; transmissions are counted exactly,
  cta     — the diffusion combine-then-adapt baseline (ring Metropolis mix),
  coke_et — the event-triggered variant: `local_steps` purely local
            optimizer steps (`local_update`) between consensus rounds,
            each round coke's ADMM round.

The broadcast is governed by a `core.comm` policy chain passed to
`consensus_update(comm=...)`; the legacy `censor_v`/`censor_mu` knobs map
onto the censor-only chain. With `use_fused_kernel` the augmented gradient
runs through the hand-written `coke_fused_update` kernel (K3). A
`primal_solve` (the backends' matrix-free CG solve) replaces the optimizer
step with the exact (21a) primal and bypasses K3; the optimizer state
stays as it was.

A time-varying topology (`ConsensusConfig.offset_schedule`, a tuple of
offset tuples) cycles the ring's offsets per iteration for dkla/coke: the
host iteration k picks the tuple, and the neighbour fetch of the primal
runs under the graph in effect (the cache from the previous step belongs
to the previous graph). It requires the unfused path: K3 takes the degree
as a fixed parameter, as the reference's kernel does.

`init_stream_state` / `stream_update` are the streaming round on the same
ring (fit_stream's spmd backend): the fresh-minibatch gradient or QC-ODKLA
linearized-ADMM primal, the shared `core.comm` broadcast, and the dual
update's neighbour fetch cached for the next round's primal.

Gossip (`participate=`): sleepers hold params, optimizer state and dual,
are silent in the broadcast (zero bits) and integrate the dual drift at
their next wake; the rolls still run every round (value masking). Churn
(`alive=` / `joined=`, static ring only): dead agents are zeroed out of
every degree and neighbour sum before the rolls (`_alive_ring_sum`), the
cached fetch is bypassed and carried untouched, and joiners restart cold
(zero primal, broadcast, dual and a fresh optimizer slot), as on the
simulator.

A dense (learned) adjacency (`adjacency=`, the personalization hook, ADMM
strategies on the unfused path): weighted (N,) degrees sum(A, 1) and `A @
x` neighbour sums (`_dense_neighbors`) replace the rolls and the cache,
which belongs to a graph that may have changed and is carried untouched;
the expressions are the churn path's summed forms, the simulator's.

On a mesh (`api.fit(mesh=)`) the carry is feature-sharded
(`distributed.sharding`): the rolls move rows across the agent blocks
(`sharding.roll_agents`), the per-agent norms sum the feature blocks'
partials (psum), and the fused path launches K3 once per block of the
carry. As without a mesh, K3's xi^2 (the norm of the old iterate) is not
the censor's norm (of the new one): it is left unsummed, unused.

`consensus_update` and `local_update` take the entries they consume out
of their own copy of `state` and drop each tree after its last use: a
caller that keeps no other reference to `params`, `grads` or `state`
(the deep-net train steps) holds about one copy of the state during a
step instead of two.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import comm as comm_mod
from repro_torch.core.step import true_div
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.distributed.sharding import Blocked
from repro_torch.kernels.coke_update.ops import coke_update_pytree
from repro_torch.kernels.coke_update.ref import g_aug_ref
from repro_torch.optim.optimizers import (OptConfig, apply_updates,
                                          init_opt_state, opt_update)

@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    strategy: str = "allreduce"  # allreduce | dkla | coke | cta | coke_et
    rho: float = 1e-3
    censor_v: float = 1.0
    censor_mu: float = 0.99
    local_steps: int = 1         # coke_et: local steps per consensus round
    mix_weight: float = 1.0 / 3.0  # cta ring mixing (self + 2 neighbours)
    # consensus_gap is a reduction over the whole parameter tree; the deep
    # net's train step leaves it out with track_gap=False
    track_gap: bool = True
    # circulant topology: agent i ~ i +- o for each offset o; (1,) = ring
    offsets: tuple = (1,)
    # time-varying topology: a tuple of offset tuples, cycled per iteration
    offset_schedule: tuple | None = None
    # route the augmented gradient + censor norm through `coke_fused_update`
    use_fused_kernel: bool = False

    @property
    def degree(self) -> float:
        return 2.0 * len(self.offsets)

    @property
    def is_admm(self) -> bool:
        return self.strategy in ("dkla", "coke", "coke_et")

    def comm_chain(self) -> comm_mod.Chain:
        """The legacy (censor_v, censor_mu) knobs as a core.comm policy."""
        if self.strategy == "dkla":
            return comm_mod.Chain(())
        return comm_mod.Chain((comm_mod.Censor(self.censor_v,
                                               self.censor_mu),))


def needs_agent_stack(cfg: ConsensusConfig) -> bool:
    return cfg.strategy != "allreduce"


# ---------------------------------------------------------------------------
# Agent-stacked state
# ---------------------------------------------------------------------------

def stack_params(params, num_agents: int):
    """Broadcast params to a leading agent axis (all agents start equal)."""
    return tree_map(lambda p: p[None].expand(num_agents, *p.shape), params)


def init_consensus_state(ccfg: ConsensusConfig, opt_cfg: OptConfig,
                         params_stacked, comm=None) -> dict[str, Any]:
    """State carried across steps alongside the stacked params.

    comm — the policy chain whose persistent state (per-agent cumulative
    bits) rides in the consensus state; None = the legacy chain derived
    from ccfg. `step` is a host int: the censor threshold h(k) is formed
    on the host."""
    leaf = tree_leaves(params_stacked)[0]
    state: dict[str, Any] = {
        "opt": torch.func.vmap(lambda p: init_opt_state(opt_cfg, p))(
            params_stacked),
        "step": 0,
        "comms": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }
    if ccfg.is_admm:
        chain = ccfg.comm_chain() if comm is None else comm_mod.as_chain(comm)
        state["comm"] = chain.init_state(leaf.shape[0], leaf.device)
        theta_hat = tree_map(lambda p: p.to(torch.float32).clone(),
                             params_stacked)
        state["gamma"] = tree_map(torch.zeros_like, theta_hat)
        state["theta_hat"] = theta_hat
        # cached neighbour broadcasts: all agents start identical, so the
        # initial cache equals theta_hat itself (exact); the dual update's
        # fetch refills it for the next primal step
        state["nbr_left"] = theta_hat
        state["nbr_right"] = theta_hat
    return state


# ---------------------------------------------------------------------------
# Ring primitives over the agent axis
# ---------------------------------------------------------------------------

def _ring_neighbors(tree, offsets: tuple = (1,)):
    """Circulant neighbour copies by roll on the agent axis, returned as
    the (left, right) halves summed over the offsets."""
    left = right = None
    for o in offsets:
        l_o = tree_map(lambda x: torch.roll(x, o, 0), tree)
        r_o = tree_map(lambda x: torch.roll(x, -o, 0), tree)
        left = l_o if left is None else tree_map(torch.add, left, l_o)
        right = r_o if right is None else tree_map(torch.add, right, r_o)
    return left, right


def _degb(deg: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (N,) per-agent degree vector shaped to broadcast against an
    agent-stacked leaf (N, ...)."""
    return deg.reshape((deg.shape[0],) + (1,) * (x.ndim - 1))


def _dense_neighbors(adjacency: torch.Tensor, tree):
    """sum_n w_in x_n per agent: one (N, N) x (N, ...) product per leaf,
    the dense graph's counterpart of the ring's roll halves; on (N, D)
    leaves the simulator's `A @ theta_hat`."""
    def one(x):
        x = x.to(torch.float32)
        return (adjacency @ x.reshape(x.shape[0], -1)).reshape(x.shape)
    return tree_map(one, tree)


def _alive_ring_sum(tree, alive_f: torch.Tensor, offsets: tuple):
    """Liveness-masked circulant neighbour sum: dead agents' values are
    zeroed before the rolls, so each agent accumulates exactly sum_n
    alive_n x_n, bitwise the simulator's alive-weighted NeighborTable
    gather on deg-2 rings (masking by 1.0/0.0 is exact; two-term sums
    commute)."""
    masked = tree_map(lambda x: x * _degb(alive_f, x), tree)
    left, right = _ring_neighbors(masked, offsets)
    return tree_map(torch.add, left, right)


def _mask_rows(m: torch.Tensor, new, old):
    """Row-select over agent-stacked trees: agent i's leaves take `new`
    iff m[i]; scalar leaves pass through. With an all-true mask this is
    bitwise `new`, the degenerate-gossip contract."""
    def sel(a, b):
        if a.ndim == 0:
            return a
        return torch.where(m.reshape(m.shape + (1,) * (a.ndim - 1)), a, b)
    return tree_map(sel, new, old)


def _agent_norms(diff_tree) -> torch.Tensor:
    """Per-agent l2 norm over all parameters: (N,)."""
    sq = sum(torch.sum(torch.square(x.to(torch.float32)),
                       dim=tuple(range(1, x.ndim)))
             for x in tree_leaves(diff_tree))
    return torch.sqrt(sq)


def _check_supported(ccfg: ConsensusConfig, participate, adjacency, alive,
                     joined) -> None:
    """The reference's ValueErrors, raised before anything runs."""
    dense = adjacency is not None
    if ccfg.offset_schedule and not ccfg.is_admm:
        raise ValueError(
            "offset_schedule (time-varying topology) is implemented for "
            f"the ADMM strategies, not {ccfg.strategy!r}")
    if participate is not None and not ccfg.is_admm:
        raise ValueError(
            "gossip participation masking is implemented for the ADMM "
            f"strategies (dkla/coke/coke_et), not {ccfg.strategy!r}")
    if dense:
        if not ccfg.is_admm:
            raise ValueError(
                "a dense (learned) adjacency is implemented for the ADMM "
                f"strategies (dkla/coke/coke_et), not {ccfg.strategy!r}")
        if ccfg.use_fused_kernel:
            raise ValueError(
                "the fused coke_update kernel bakes the graph degree in "
                "as a static parameter; a dense adjacency requires "
                "use_fused_kernel=False")
        if ccfg.offset_schedule:
            raise ValueError(
                "offset_schedule and a dense adjacency are two competing "
                "definitions of the step's graph; pass one or the other")
    if ccfg.is_admm and ccfg.use_fused_kernel:
        if ccfg.offset_schedule:
            raise ValueError(
                "the fused coke_update kernel bakes the graph degree in as "
                "a static parameter; offset_schedule (time-varying "
                "topology) requires use_fused_kernel=False")
        if not dense and alive is not None:
            raise ValueError(
                "the fused coke_update kernel bakes the graph degree in "
                "as a static parameter; churn (a traced alive mask) "
                "requires use_fused_kernel=False")


def _vmapped_opt_update(opt_cfg: OptConfig, grads, opt, params):
    """The optimizer per agent row. On a mesh (blocked leaves) the update
    runs on the blocks as they are: without gradient clipping the SGD
    update is elementwise, the same per row as under vmap."""
    if isinstance(tree_leaves(params)[0], Blocked):
        if opt_cfg.grad_clip:
            raise NotImplementedError(
                "per-agent gradient clipping on a mesh (its global norm "
                "per row would need a psum rule of its own)")
        return opt_update(opt_cfg, grads, opt, params)
    return torch.func.vmap(lambda g, s, p: opt_update(opt_cfg, g, s, p))(
        grads, opt, params)


def consensus_update(ccfg: ConsensusConfig, opt_cfg: OptConfig,
                     params, grads, state, comm=None, primal_solve=None,
                     participate=None, adjacency=None, alive=None,
                     joined=None):
    """params/grads: agent-stacked trees (N, ...). Returns (new_params,
    new_state, metrics).

    comm — a core.comm policy chain governing the broadcast; None = the
    legacy chain from ccfg's censor knobs.
    primal_solve — (params, theta_hat, gamma, nbr_sum, deg) -> new params:
    the exact primal, in place of the optimizer step (grads are not read).
    participate — (N,) bool gossip participation mask (ADMM strategies).
    alive / joined — (N,) bool churn masks (ADMM on the static ring): the
    alive-weighted exchange, and the rows that restart cold (None where no
    row does).
    adjacency — an (N, N) dense weighted graph (ADMM, unfused): its row
    sums as the (N,) degrees and `A @ x` neighbour sums; the circulant
    cache is bypassed and carried untouched."""
    _check_supported(ccfg, participate, adjacency, alive, joined)
    state = dict(state)
    step = state["step"] + 1
    metrics: dict[str, torch.Tensor] = {}
    num_agents = tree_leaves(params)[0].shape[0]

    if ccfg.strategy == "cta":
        left, right = _ring_neighbors(params, ccfg.offsets)
        w = ccfg.mix_weight / len(ccfg.offsets)
        combined = tree_map(
            lambda p, l, r: ((1 - ccfg.degree * w) * p.to(torch.float32)
                             + w * (l + r).to(torch.float32)).to(p.dtype),
            params, left, right)
        del params, left, right
        updates, opt = _vmapped_opt_update(opt_cfg, grads, state.pop("opt"),
                                           combined)
        del grads
        new_params = apply_updates(combined, updates)
        new_state = dict(state, opt=opt, step=step,
                         comms=state["comms"] + num_agents)
        return new_params, new_state, metrics

    # --- ADMM family (dkla / coke / coke_et) on a circulant ---------------
    theta_hat, gamma = state.pop("theta_hat"), state.pop("gamma")
    chain = ccfg.comm_chain() if comm is None else comm_mod.as_chain(comm)
    rho = ccfg.rho
    opt0 = state.pop("opt")
    if joined is not None:
        # a (re)joining agent restarts cold: zero primal / broadcast / dual
        # rows and a fresh optimizer slot (core.gossip semantics)
        params, theta_hat, gamma, opt0 = (
            _mask_rows(joined, tree_map(torch.zeros_like, t), t)
            for t in (params, theta_hat, gamma, opt0))
    dense = adjacency is not None
    summed = alive is not None or dense
    if ccfg.offset_schedule:
        variants = ccfg.offset_schedule
        offsets = variants[(step - 1) % len(variants)]
        # a float32 scalar, as the reference's degs[graph_idx]: the product
        # 2 rho deg rounds in float32 as it does there
        deg = torch.tensor(2.0 * len(offsets), dtype=torch.float32)
        # the cached fetch belongs to the previous step's graph: fetch
        # theta_hat^{k-1} again under the graph in effect at step k
        left, right = _ring_neighbors(theta_hat, offsets)
    elif dense:
        # a learned weighted graph: (N,) degrees and product neighbour
        # sums; the cache belongs to an earlier graph and is carried
        # untouched
        offsets = ccfg.offsets
        deg = torch.sum(adjacency, dim=1)

        def fetch(x):
            return _dense_neighbors(adjacency, x)
        nbr_sum = fetch(theta_hat)
    elif summed:
        # churn: alive-weighted (N,) degrees and masked roll sums; the
        # cache, unmasked and stale across an event, is carried untouched
        offsets = ccfg.offsets
        alive_f = alive.to(torch.float32)
        deg_l, deg_r = _ring_neighbors(alive_f, offsets)
        deg = deg_l + deg_r

        def fetch(x):
            return _alive_ring_sum(x, alive_f, offsets)
        nbr_sum = fetch(theta_hat)
    else:
        offsets, deg = ccfg.offsets, ccfg.degree
        # neighbours' theta_hat^{k-1}: served from the cache filled by the
        # previous step's dual-update fetch, no roll here
        left, right = state.pop("nbr_left"), state.pop("nbr_right")

    # primal update (21a): exact when the caller supplies a solve (the
    # matrix-free CG path), otherwise one optimizer step on the augmented
    # Lagrangian gradient g_aug = g + 2 rho deg theta + gamma
    #                              - rho (deg theta_hat + sum_n theta_hat_n)
    if primal_solve is not None:
        if not summed:
            nbr_sum = tree_map(torch.add, left, right)
        new_params = primal_solve(params, theta_hat, gamma, nbr_sum, deg)
        opt = opt0
    elif summed:
        # the reference's summed-form expressions over (N,) degrees
        g_aug = tree_map(
            lambda g, p, th, gm, nb: (
                g.to(torch.float32)
                + 2.0 * rho * _degb(deg, p) * p.to(torch.float32)
                + gm - rho * (_degb(deg, th) * th + nb)),
            grads, params, theta_hat, gamma, nbr_sum)
    elif ccfg.use_fused_kernel:
        # the reference hands the kernel two equal halves of the neighbour
        # sum, not the two roll halves; the censor's norm is of the new
        # iterate, below, so K3's xi_sq goes unused. On a mesh K3 runs once
        # per block of the carry
        half = tree_map(lambda l, r: 0.5 * (l + r), left, right)
        g_aug, _ = coke_update_pytree(params, theta_hat, gamma, grads, half,
                                      half, rho=rho, deg=deg, norm=False)
        del half
    else:
        # the kernel's plain version, leaf by leaf: no launch
        g_aug = tree_map(
            lambda p, th, gm, g, l, r: g_aug_ref(p, th, gm, g, l, r,
                                                 rho=rho, deg=deg),
            params, theta_hat, gamma, grads, left, right)
    del grads
    if not summed:
        del left, right
    if primal_solve is None:
        updates, opt = _vmapped_opt_update(opt_cfg, g_aug, opt0, params)
        del g_aug
        new_params = apply_updates(params, updates)
        del updates

    # gossip: sleepers hold their primal iterate and optimizer state
    if participate is not None:
        new_params = _mask_rows(participate, new_params, params)
        opt = _mask_rows(participate, opt, opt0)
    del params, opt0

    # the communication policy over the flattened agent-stacked message,
    # with stale-value fallback (shared decision code with the other paths)
    leaf = tree_leaves(new_params)[0]
    comm_state = chain.ensure_state(state.get("comm"), num_agents,
                                    leaf.device)
    new_theta_hat, send, comm_state = comm_mod.apply_tree(
        chain, new_params, theta_hat, step, comm_state, active=participate)
    del theta_hat

    # dual (21b) with theta_hat^k: on a static ring the step's only
    # neighbour fetch, cached for the next primal update
    if summed:
        nbr_new = fetch(new_theta_hat)
        new_gamma = tree_map(
            lambda gm, th, nb: gm + rho * (_degb(deg, th) * th - nb),
            gamma, new_theta_hat, nbr_new)
        hat_l, hat_r = state["nbr_left"], state["nbr_right"]
    else:
        hat_l, hat_r = _ring_neighbors(new_theta_hat, offsets)
        new_gamma = tree_map(
            lambda gm, th, l, r: gm + rho * (deg * th - l - r),
            gamma, new_theta_hat, hat_l, hat_r)
    # gossip: sleepers' duals freeze (delayed but correct: the next wake
    # integrates (21b) against the broadcasts of then)
    if participate is not None:
        new_gamma = _mask_rows(participate, new_gamma, gamma)

    metrics["send_frac"] = torch.mean(send.to(torch.float32))
    metrics["bits"] = torch.sum(comm_state.bits)
    new_state = dict(state, opt=opt, step=step,
                     comms=state["comms"] + torch.sum(send, dtype=torch.int32),
                     theta_hat=new_theta_hat, gamma=new_gamma,
                     nbr_left=hat_l, nbr_right=hat_r, comm=comm_state)
    return new_params, new_state, metrics


def local_update(opt_cfg: OptConfig, params, grads, state):
    """A purely local step (no exchange over the agent axis): the censored
    rounds of the event-triggered coke_et strategy."""
    state = dict(state)
    updates, opt = _vmapped_opt_update(opt_cfg, grads, state.pop("opt"),
                                       params)
    del grads
    new_params = apply_updates(params, updates)
    return new_params, dict(state, opt=opt, step=state["step"] + 1)


def init_stream_state(ccfg: ConsensusConfig, theta0: torch.Tensor,
                      comm=None) -> dict[str, Any]:
    """The state `stream_update` carries beside the (N, D) params: the last
    broadcast theta_hat (theta0: agents may start unequal under a warm
    start), the duals, the neighbour cache (exact rolls of theta_hat) and
    the policy's CommState."""
    chain = comm_mod.as_chain(comm)
    theta_hat = theta0.to(torch.float32)
    left, right = _ring_neighbors(theta_hat, ccfg.offsets)
    return {
        "step": 0,
        "comms": torch.zeros((), dtype=torch.int32, device=theta0.device),
        "theta_hat": theta_hat,
        "gamma": torch.zeros_like(theta_hat),
        "nbr_left": left,
        "nbr_right": right,
        "comm": chain.init_state(theta0.shape[0], theta0.device),
    }


def stream_update(ccfg: ConsensusConfig, params, state, feats, labels, *,
                  lam: float, lr: float, eta: float | None = None,
                  comm=None, participate=None, adjacency=None, alive=None,
                  joined=None):
    """One streaming round on the ring runtime: fit_stream's spmd backend.

    params {"theta": (N, D)}; feats (N, b, D) / labels (N, b) the round's
    minibatch. The fresh-minibatch gradient step (eta=None) or QC-ODKLA's
    linearized-ADMM step (eta=float), then the same `core.comm` broadcast
    decision code as the simulator's `core.online.stream_step` (send
    decisions and bits match across backends), then the dual update, whose
    neighbour fetch is cached for the next round: 2 rolls per round per
    offset. `participate` (gossip) and `alive` / `joined` (churn) have
    `consensus_update`'s semantics; the round's minibatch still flows to
    sleepers (the regret sample covers every agent). `adjacency` (N, N), a
    learned dense graph, has `consensus_update`'s semantics; the
    expressions are the simulator's `core.online.stream_step`.
    Returns (new_params, new_state, metrics) with the pre-update
    instantaneous MSE and the cumulative bits."""
    dense = adjacency is not None
    theta = params["theta"]
    theta_hat, gamma = state["theta_hat"], state["gamma"]
    N = theta.shape[0]
    rho = ccfg.rho
    chain = comm_mod.as_chain(comm)
    k = state["step"] + 1

    if joined is not None:
        theta, theta_hat, gamma = (
            _mask_rows(joined, torch.zeros_like(t), t)
            for t in (theta, theta_hat, gamma))

    preds = torch.einsum("nbd,nd->nb", feats, theta)
    inst_mse = torch.mean((labels - preds) ** 2)
    # the streaming augmented-Lagrangian gradient; the simulator's
    # adjacency @ theta_hat served from the cached rolls
    resid = preds - labels
    g_data = true_div(2.0 * torch.einsum("nb,nbd->nd", resid, feats),
                      feats.shape[1])
    if dense:
        # a learned graph: weighted (N, 1) degrees and the product sum
        # (the cache is bypassed and carried untouched)
        deg = torch.sum(adjacency, dim=1)[:, None]
        nbr_sum = adjacency @ theta_hat
    elif alive is not None:
        # churn: alive-weighted (N, 1) degrees and masked roll sums (the
        # stale cache is bypassed and carried untouched)
        alive_f = alive.to(torch.float32)
        deg_l, deg_r = _ring_neighbors(alive_f, ccfg.offsets)
        deg = (deg_l + deg_r)[:, None]
        nbr_sum = _alive_ring_sum(theta_hat, alive_f, ccfg.offsets)
    else:
        deg = ccfg.degree       # a host float: circulant topologies only
        nbr_sum = state["nbr_left"] + state["nbr_right"]
    g = (g_data + (2.0 * lam / N) * theta
         + 2.0 * rho * deg * theta
         + gamma
         - rho * (deg * theta_hat + nbr_sum))
    if eta is None:
        new_theta = theta - lr * g
    elif alive is not None or dense:
        new_theta = theta - g / (eta + 2.0 * rho * deg)
    else:
        new_theta = theta - true_div(g, eta + 2.0 * rho * deg)
    # gossip: sleepers hold their primal iterate
    if participate is not None:
        new_theta = _mask_rows(participate, new_theta, theta)

    comm_state = chain.ensure_state(state.get("comm"), N, theta.device)
    new_theta_hat, send, comm_state = chain.apply(new_theta, theta_hat, k,
                                                  comm_state,
                                                  active=participate)

    # dual with theta_hat^k: the round's only neighbour fetch, cached for
    # the next primal (churn: the masked sum again, the cache untouched)
    if dense:
        new_gamma = gamma + rho * (deg * new_theta_hat
                                   - adjacency @ new_theta_hat)
        hat_l, hat_r = state["nbr_left"], state["nbr_right"]
    elif alive is not None:
        new_gamma = gamma + rho * (
            deg * new_theta_hat
            - _alive_ring_sum(new_theta_hat, alive_f, ccfg.offsets))
        hat_l, hat_r = state["nbr_left"], state["nbr_right"]
    else:
        hat_l, hat_r = _ring_neighbors(new_theta_hat, ccfg.offsets)
        new_gamma = gamma + rho * (deg * new_theta_hat - hat_l - hat_r)
    # gossip: sleepers' duals freeze
    if participate is not None:
        new_gamma = _mask_rows(participate, new_gamma, gamma)

    metrics = {"instant_mse": inst_mse,
               "bits": torch.sum(comm_state.bits)}
    new_state = dict(state, step=k,
                     comms=state["comms"] + torch.sum(send,
                                                      dtype=torch.int32),
                     theta_hat=new_theta_hat, gamma=new_gamma,
                     nbr_left=hat_l, nbr_right=hat_r, comm=comm_state)
    return {"theta": new_theta}, new_state, metrics


def consensus_gap(params) -> torch.Tensor:
    """max_i ||theta_i - mean theta|| — the Fig.-1 functional-consensus
    diagnostic, for agent-stacked params."""
    diff = tree_map(lambda p: p.to(torch.float32)
                    - torch.mean(p.to(torch.float32), 0, keepdim=True),
                    params)
    return torch.max(_agent_norms(diff))
