"""The ring consensus runtime: COKE/DKLA/CTA as a data-parallel strategy.

Each agent holds its own parameter copy theta_i as a row of an
agent-stacked tree ({"theta": (N, D)}); the consensus graph is a circulant
ring. Neighbour exchange is `torch.roll` along the agent axis.

Strategies ported here:
  dkla — decentralized ADMM (Alg. 1) with an inexact inner argmin (one
         optimizer step on the augmented Lagrangian),
  coke — dkla + communication censoring (Alg. 2): the exchange always
         runs but carries the *stale* theta_hat when censored, which is
         the same as not transmitting; transmissions are counted exactly,
  cta  — the diffusion combine-then-adapt baseline (ring Metropolis mix).

The broadcast is governed by a `core.comm` policy chain passed to
`consensus_update(comm=...)`; the legacy `censor_v`/`censor_mu` knobs map
onto the censor-only chain. With `use_fused_kernel` the augmented gradient
runs through the hand-written `coke_fused_update` kernel (K3).

Not ported yet, and raising NotImplementedError naming the ROADMAP.md
item: the exact primal (`primal_solve`, CG: item 3), gossip participation
and churn (item 10), a dense learned graph (item 11), time-varying
topologies (`offset_schedule`, item 7), and the allreduce / coke_et
strategies of the deep-net layer (item 15).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import comm as comm_mod
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels.coke_update.ops import coke_update_pytree
from repro_torch.kernels.coke_update.ref import coke_update_ref
from repro_torch.optim.optimizers import (OptConfig, apply_updates,
                                          init_opt_state, opt_update)

_LATER = {
    "primal_solve": "the exact primal (primal_solve, the CG solve) is not "
                    "ported to repro_torch yet: ROADMAP.md Queue 1 item 3",
    "participate": "gossip participation is not ported to repro_torch yet: "
                   "ROADMAP.md Queue 1 item 10",
    "churn": "churn (alive/joined masks) is not ported to repro_torch yet: "
             "ROADMAP.md Queue 1 item 10",
    "adjacency": "a dense (learned) adjacency is not ported to repro_torch "
                 "yet: ROADMAP.md Queue 1 item 11",
    "offset_schedule": "time-varying topologies (offset_schedule) are not "
                       "ported to repro_torch yet: ROADMAP.md Queue 1 "
                       "item 7",
    "strategy": "the allreduce and coke_et strategies belong to the "
                "deep-net layer, not ported to repro_torch yet: ROADMAP.md "
                "Queue 1 item 15",
}


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    strategy: str = "allreduce"  # allreduce | dkla | coke | cta | coke_et
    rho: float = 1e-3
    censor_v: float = 1.0
    censor_mu: float = 0.99
    mix_weight: float = 1.0 / 3.0  # cta ring mixing (self + 2 neighbours)
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


def _agent_norms(diff_tree) -> torch.Tensor:
    """Per-agent l2 norm over all parameters: (N,)."""
    sq = sum(torch.sum(torch.square(x.to(torch.float32)),
                       dim=tuple(range(1, x.ndim)))
             for x in tree_leaves(diff_tree))
    return torch.sqrt(sq)


def _check_supported(ccfg: ConsensusConfig, primal_solve, participate,
                     adjacency, alive, joined) -> None:
    """The reference's ValueErrors, then NotImplementedError for what the
    port does not run yet."""
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
    if ccfg.strategy not in ("dkla", "coke", "cta"):
        raise NotImplementedError(_LATER["strategy"])
    for what, given in (("participate", participate is not None),
                        ("churn", alive is not None or joined is not None),
                        ("adjacency", dense),
                        ("offset_schedule", bool(ccfg.offset_schedule)),
                        ("primal_solve", primal_solve is not None)):
        if given:
            raise NotImplementedError(_LATER[what])


def _vmapped_opt_update(opt_cfg: OptConfig, grads, opt, params):
    return torch.func.vmap(lambda g, s, p: opt_update(opt_cfg, g, s, p))(
        grads, opt, params)


def consensus_update(ccfg: ConsensusConfig, opt_cfg: OptConfig,
                     params, grads, state, comm=None, primal_solve=None,
                     participate=None, adjacency=None, alive=None,
                     joined=None):
    """params/grads: agent-stacked trees (N, ...). Returns (new_params,
    new_state, metrics).

    comm — a core.comm policy chain governing the broadcast; None = the
    legacy chain from ccfg's censor knobs. The other keyword arguments are
    the reference's hooks for the exact primal, gossip, a learned graph
    and churn; they raise (see the module docstring)."""
    _check_supported(ccfg, primal_solve, participate, adjacency, alive,
                     joined)
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
        updates, opt = _vmapped_opt_update(opt_cfg, grads, state["opt"],
                                           combined)
        new_params = apply_updates(combined, updates)
        new_state = dict(state, opt=opt, step=step,
                         comms=state["comms"] + num_agents)
        return new_params, new_state, metrics

    # --- ADMM family (dkla / coke) on a static circulant -------------------
    theta_hat, gamma = state["theta_hat"], state["gamma"]
    chain = ccfg.comm_chain() if comm is None else comm_mod.as_chain(comm)
    rho, deg = ccfg.rho, ccfg.degree
    # neighbours' theta_hat^{k-1}: served from the cache filled by the
    # previous step's dual-update fetch, no roll here
    left, right = state["nbr_left"], state["nbr_right"]

    # primal update (21a): one optimizer step on the augmented Lagrangian
    # gradient g_aug = g + 2 rho deg theta + gamma
    #                  - rho (deg theta_hat + sum_n theta_hat_n)
    if ccfg.use_fused_kernel:
        # the reference hands the kernel two equal halves of the neighbour
        # sum, not the two roll halves; the norm is recomputed below
        half = tree_map(lambda l, r: 0.5 * (l + r), left, right)
        g_aug, _ = coke_update_pytree(params, theta_hat, gamma, grads, half,
                                      half, rho=rho, deg=deg)
    else:
        # the kernel's plain version over the flattened trees: no launch
        flat = [comm_mod.flatten_agents(t)
                for t in (params, theta_hat, gamma, grads, left, right)]
        g, _ = coke_update_ref(*(f for f, _ in flat), rho=rho, deg=deg)
        g_aug = comm_mod.unflatten_agents(g, flat[0][1], params)
    updates, opt = _vmapped_opt_update(opt_cfg, g_aug, state["opt"], params)
    new_params = apply_updates(params, updates)

    # the communication policy over the flattened agent-stacked message,
    # with stale-value fallback (shared decision code with the other paths)
    leaf = tree_leaves(params)[0]
    comm_state = chain.ensure_state(state.get("comm"), num_agents,
                                    leaf.device)
    new_theta_hat, send, comm_state = comm_mod.apply_tree(
        chain, new_params, theta_hat, step, comm_state)

    # dual (21b) with theta_hat^k: the step's only neighbour fetch, cached
    # for the next primal update
    hat_l, hat_r = _ring_neighbors(new_theta_hat, ccfg.offsets)
    new_gamma = tree_map(lambda gm, th, l, r: gm + rho * (deg * th - l - r),
                         gamma, new_theta_hat, hat_l, hat_r)

    metrics["send_frac"] = torch.mean(send.to(torch.float32))
    metrics["bits"] = torch.sum(comm_state.bits)
    new_state = dict(state, opt=opt, step=step,
                     comms=state["comms"] + torch.sum(send, dtype=torch.int32),
                     theta_hat=new_theta_hat, gamma=new_gamma,
                     nbr_left=hat_l, nbr_right=hat_r, comm=comm_state)
    return new_params, new_state, metrics


def consensus_gap(params) -> torch.Tensor:
    """max_i ||theta_i - mean theta|| — the Fig.-1 functional-consensus
    diagnostic, for agent-stacked params."""
    diff = tree_map(lambda p: p.to(torch.float32)
                    - torch.mean(p.to(torch.float32), 0, keepdim=True),
                    params)
    return torch.max(_agent_norms(diff))
