"""Composable communication policies: the broadcast rule as a chain of
stages run over one message per round.

    policy = Chain([Censor(v=0.5, mu=0.97)])   # Eq. 19-20: h(k) = v mu^k

A `Chain` runs the message through every stage, finalizes the masked
broadcast (stale-value fallback) and accounts the bits each transmitter
paid. Only the Censor stage is ported so far: `Quantize` and `Drop` exist so
that a reference-shaped policy is recognised, and raise NotImplementedError
when run (ROADMAP.md Queue 1 item 8). `CommState.key` is a placeholder until
those stochastic stages and gossip arrive.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core.censor import (CensorSchedule, censor_decision,
                                     masked_broadcast)
from repro_torch.core.tree import tree_leaves, tree_unflatten

#: uncompressed payload precision: float32 coordinates
FP_BITS = 32.0

_LATER = "ROADMAP.md Queue 1 item 8 (full comm chain)"


class Msg(NamedTuple):
    """One broadcast round in flight through the policy pipeline."""

    payload: torch.Tensor      # (N, D) values receivers adopt if delivered
    prev: torch.Tensor         # (N, D) stale broadcast the receivers hold
    send: torch.Tensor         # (N,) bool: transmitter decisions (paid)
    delivered: torch.Tensor    # (N,) bool: links that carried the message
    bits_per_value: float      # per-coordinate payload width
    overhead_bits: float       # per-message header (e.g. a scale)


class CommState(NamedTuple):
    """Persistent policy state threaded through the fit loop.

    bits is float32, as in the reference: f32 stays exact through 2^24 and
    both packages compute it identically, so bit histories compare exactly.
    key is a placeholder (None) until the stochastic stages are ported."""

    bits: torch.Tensor   # (N,) float32 cumulative bits paid by each agent
    key: Any = None
    stages: tuple = ()


@dataclasses.dataclass(frozen=True)
class Censor:
    """The CO in COKE: transmit iff ||payload - prev|| >= v * mu^k."""

    v: float = 1.0
    mu: float = 0.95

    def init_state(self, num_agents: int):
        return ()

    def transform(self, msg: Msg, state, k: int) -> tuple[Msg, tuple]:
        h_k = CensorSchedule(self.v, self.mu)(k)
        send = censor_decision(msg.payload, msg.prev, h_k)
        return msg._replace(send=msg.send & send), state


@dataclasses.dataclass(frozen=True)
class Quantize:
    """b-bit stochastic quantization of the innovation (not ported yet)."""

    bits: float = 8.0
    seed: int = 0
    stochastic: bool = True

    def init_state(self, num_agents: int):
        return ()

    def transform(self, msg: Msg, state, k: int):
        raise NotImplementedError(f"Quantize is not ported yet: {_LATER}")


@dataclasses.dataclass(frozen=True)
class Drop:
    """Bernoulli(p) link failure per broadcast (not ported yet)."""

    p: float = 0.0
    seed: int = 1

    def init_state(self, num_agents: int):
        return ()

    def transform(self, msg: Msg, state, k: int):
        raise NotImplementedError(f"Drop is not ported yet: {_LATER}")


STAGE_TYPES = (Censor, Quantize, Drop)


@dataclasses.dataclass(frozen=True)
class Chain:
    """Ordered composition of stages; Chain(()) is the always-transmit
    full-precision broadcast (DKLA's policy)."""

    stages: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "stages", tuple(self.stages))

    def init_state(self, num_agents: int,
                   device: torch.device | str = "cpu") -> CommState:
        return CommState(
            bits=torch.zeros((num_agents,), dtype=torch.float32,
                             device=device),
            key=None,
            stages=tuple(s.init_state(num_agents) for s in self.stages))

    def ensure_state(self, state: CommState | None, num_agents: int,
                     device: torch.device | str = "cpu") -> CommState:
        """Re-initialize when `state` was built for another chain structure
        or agent count; keeps the cumulative bits when their shape fits."""
        if state is None or tuple(state.bits.shape) != (num_agents,):
            return self.init_state(num_agents, device)
        if len(state.stages) != len(self.stages):
            return CommState(bits=state.bits, key=None, stages=tuple(
                s.init_state(num_agents) for s in self.stages))
        return state

    def apply(self, theta: torch.Tensor, prev: torch.Tensor, k: int,
              state: CommState
              ) -> tuple[torch.Tensor, torch.Tensor, CommState]:
        """Run one synchronous broadcast round of (N, D) candidates against
        the (N, D) stale copies. Returns (theta_hat, send, new_state)."""
        num_agents, dim = theta.shape[0], theta.shape[-1]
        ones = torch.ones((num_agents,), dtype=torch.bool, device=theta.device)
        msg = Msg(payload=theta, prev=prev, send=ones, delivered=ones,
                  bits_per_value=FP_BITS, overhead_bits=0.0)
        sstates = []
        for stage, ss in zip(self.stages, state.stages):
            msg, ss = stage.transform(msg, ss, k)
            sstates.append(ss)
        effective = msg.send & msg.delivered
        theta_hat = masked_broadcast(msg.payload, prev, effective)
        per_msg = dim * msg.bits_per_value + msg.overhead_bits
        paid = torch.where(msg.send, per_msg, 0.0).to(torch.float32)
        return theta_hat, msg.send, CommState(bits=state.bits + paid,
                                              key=state.key,
                                              stages=tuple(sstates))

    def describe(self) -> str:
        """One-liner, e.g. 'censor(v=0.5,mu=0.97)'; 'broadcast' for the
        empty chain (the reference's spelling)."""
        if not self.stages:
            return "broadcast"
        parts = []
        for s in self.stages:
            if isinstance(s, Censor):
                parts.append(f"censor(v={s.v},mu={s.mu})")
            elif isinstance(s, Quantize):
                parts.append(f"quantize(bits={s.bits})")
            elif isinstance(s, Drop):
                parts.append(f"drop(p={s.p})")
            else:
                parts.append(type(s).__name__.lower())
        return "|".join(parts)


def as_chain(policy) -> Chain:
    """Normalize any policy spelling to a Chain: None -> always-broadcast,
    a CensorSchedule -> the paper's rule, a bare stage -> singleton chain."""
    if policy is None:
        return Chain(())
    if isinstance(policy, Chain):
        return policy
    if isinstance(policy, CensorSchedule):
        return Chain((Censor(policy.v, policy.mu),))
    if isinstance(policy, STAGE_TYPES):
        return Chain((policy,))
    if isinstance(policy, (list, tuple)):
        return Chain(tuple(policy))
    raise TypeError(
        f"not a communication policy: {policy!r} (expected Chain, a stage, "
        "a CensorSchedule, a stage sequence, or None)")


def censored(policy) -> bool:
    """Does the policy contain a Censor stage?"""
    return any(isinstance(s, Censor) for s in as_chain(policy).stages)


def uncensored(chain: Chain) -> Chain:
    """Same structure with every censor threshold forced to zero — the
    always-transmit (DKLA) variant of a policy."""
    return Chain(tuple(
        dataclasses.replace(s, v=s.v * 0) if isinstance(s, Censor) else s
        for s in chain.stages))


# ---------------------------------------------------------------------------
# Agent-stacked trees (the ring runtime's message form)
# ---------------------------------------------------------------------------

def flatten_agents(tree) -> tuple[torch.Tensor, list]:
    """Agent-stacked tree -> ((N, D_total) float32, leaves). A single
    float32 (N, D) leaf comes back as itself, not a copy."""
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    parts = [leaf.reshape(n, -1).to(torch.float32) for leaf in leaves]
    flat = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return flat, leaves


def unflatten_agents(flat: torch.Tensor, leaves: list, like=None):
    """Inverse of flatten_agents; returns the leaves, or a tree with the
    structure of `like` when given."""
    out, off = [], 0
    n = leaves[0].shape[0]
    for leaf in leaves:
        size = leaf.numel() // n
        out.append(flat[:, off:off + size].reshape(leaf.shape))
        off += size
    return out if like is None else tree_unflatten(like, out)


def apply_tree(chain: Chain, params_tree, prev_tree, k: int,
               state: CommState):
    """Chain.apply over agent-stacked trees: flatten both to (N, D_total)
    float32, run the policy once (one decision per agent), unflatten the
    broadcast. Equal to the flat path on a single (N, D) leaf."""
    flat, leaves = flatten_agents(params_tree)
    prev_flat, _ = flatten_agents(prev_tree)
    hat_flat, send, state = chain.apply(flat, prev_flat, k, state)
    return unflatten_agents(hat_flat, leaves, params_tree), send, state
