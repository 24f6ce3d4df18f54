"""Composable communication policies: the broadcast rule as a chain of
stages run over one message per round.

    policy = Chain([Censor(v=0.5, mu=0.97),   # Eq. 19-20: h(k) = v mu^k
                    Quantize(bits=4),         # stochastic b-bit innovations
                    Drop(p=0.05)])            # Bernoulli link failures

A `Chain` runs the message through every stage, finalizes the masked
broadcast (stale-value fallback) and accounts the bits each transmitter
paid. `send` is the transmitter's decision (a censored agent pays
nothing); `delivered` models the network (a dropped broadcast was paid for,
but receivers keep the stale value); receivers adopt the (possibly
quantized) payload iff send and delivered.

Randomness follows the reference bit for bit (`core.prng`, jax's threefry):
`Chain.chain_key` folds the stage indices, the static stage seeds and every
numeric stage parameter (as float32 bit patterns) into PRNGKey(0), and
`Chain.apply` draws stage i of round k from fold_in(fold_in(key, k), i).
Keys are host ints, derived without touching the device; only the uniform
draws run there. Stage parameters are host floats, so the bit accounting
(`bits_per_value`, `overhead_bits`) is formed on the host in float32, as
the reference forms it on the device, and reads nothing back.

`Chain([Censor(v, mu), Quantize(bits=inf), Drop(p=0)])` is exactly the
identity extension of the paper's rule: its trajectories equal COKE's bit
for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.censor import (CensorSchedule, censor_decision,
                                     masked_broadcast)
from repro_torch.core.tree import tree_leaves, tree_unflatten

#: uncompressed payload precision: float32 coordinates
FP_BITS = 32.0


class Msg(NamedTuple):
    """One broadcast round in flight through the policy pipeline."""

    payload: torch.Tensor      # (N, D) values receivers adopt if delivered
    prev: torch.Tensor         # (N, D) stale broadcast the receivers hold
    send: torch.Tensor         # (N,) bool: transmitter decisions (paid)
    delivered: torch.Tensor    # (N,) bool: links that carried the message
    bits_per_value: float      # per-coordinate payload width (float32 value)
    overhead_bits: float       # per-message header (e.g. a scale)


class CommState(NamedTuple):
    """Persistent policy state threaded through the fit loop.

    bits is float32, as in the reference: f32 stays exact through 2^24 and
    both packages compute it identically, so bit histories compare exactly.
    key is the chain's base PRNG key (`Chain.chain_key`), a host pair of
    uint32 words."""

    bits: torch.Tensor   # (N,) float32 cumulative bits paid by each agent
    key: prng.Key = (0, 0)
    stages: tuple = ()


def _f32(x) -> np.float32:
    return np.float32(x)


@dataclasses.dataclass(frozen=True)
class Censor:
    """The CO in COKE: transmit iff ||payload - prev|| >= v * mu^k."""

    v: float = 1.0
    mu: float = 0.95

    def init_state(self, num_agents: int):
        return ()

    def transform(self, msg: Msg, state, k: int, key=None
                  ) -> tuple[Msg, tuple]:
        h_k = CensorSchedule(self.v, self.mu)(k)
        send = censor_decision(msg.payload, msg.prev, h_k)
        return msg._replace(send=msg.send & send), state


@dataclasses.dataclass(frozen=True)
class Quantize:
    """The Q in QC-ODKLA: b-bit uniform quantization of the innovation
    (payload - prev), stochastically rounded (unbiased), with a per-agent
    float32 scale shipped as message overhead. bits=inf is the exact
    identity (full-precision payload, FP_BITS accounting)."""

    bits: float = 8.0
    seed: int = 0
    stochastic: bool = True

    def init_state(self, num_agents: int):
        return ()

    def transform(self, msg: Msg, state, k: int, key=None
                  ) -> tuple[Msg, tuple]:
        if not math.isfinite(self.bits):      # bits=inf: the identity
            return msg, state
        b = _f32(self.bits)
        levels = _f32(2.0) ** (b - _f32(1.0)) - _f32(1.0)
        innov = msg.payload - msg.prev
        # a device scalar, not a host one: CUDA divides by a host scalar
        # through its reciprocal, the reference divides
        lv = torch.full((), float(levels), dtype=innov.dtype,
                        device=innov.device)
        scale = torch.amax(torch.abs(innov), dim=-1, keepdim=True)
        safe = torch.where(scale > 0, scale, 1.0)
        x = innov / safe * lv                 # in [-levels, levels]
        if self.stochastic:
            if key is None:   # bare-stage calls outside a Chain
                key = prng.fold_in(prng.PRNGKey(self.seed), k)
            lo = torch.floor(x)
            u = prng.uniform(key, x.shape, x.device)
            x = lo + (u < (x - lo)).to(x.dtype)
        else:
            x = torch.round(x)                # half to even, as jnp.round
        deq = msg.prev + x / lv * safe
        return msg._replace(
            payload=deq, bits_per_value=float(b),
            overhead_bits=float(_f32(msg.overhead_bits)
                                + _f32(FP_BITS))), state


@dataclasses.dataclass(frozen=True)
class Drop:
    """Bernoulli(p) link failure per broadcast: the transmitter pays, the
    receivers keep the stale value. p=0 is the exact identity."""

    p: float = 0.0
    seed: int = 1

    def init_state(self, num_agents: int):
        return ()

    def transform(self, msg: Msg, state, k: int, key=None
                  ) -> tuple[Msg, tuple]:
        if key is None:       # bare-stage calls outside a Chain
            key = prng.fold_in(prng.PRNGKey(self.seed), k)
        u = prng.uniform(key, msg.delivered.shape, msg.delivered.device)
        keep = u >= float(_f32(self.p))
        return msg._replace(delivered=msg.delivered & keep), state


STAGE_TYPES = (Censor, Quantize, Drop)

#: each stage's numeric parameters in the order of the reference's pytree
#: leaves (its dataclasses' data fields); seeds and flags are static
_DATA_FIELDS = {Censor: ("v", "mu"), Quantize: ("bits",), Drop: ("p",)}


def _fold_value(key: prng.Key, leaf) -> prng.Key:
    """Fold a numeric policy parameter into a key bit-exactly: its float32
    bit pattern is the fold data, so any change of a parameter moves the
    stream and equal parameters fold identically."""
    return prng.fold_in(key, int(_f32(leaf).view(np.uint32)))


@dataclasses.dataclass(frozen=True)
class Chain:
    """Ordered composition of stages; Chain(()) is the always-transmit
    full-precision broadcast (DKLA's policy)."""

    stages: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "stages", tuple(self.stages))

    def chain_key(self) -> prng.Key:
        """The chain's base key: PRNGKey(0) folded with each stage's index
        and static seed, then with every numeric parameter (Censor v, mu;
        Quantize bits; Drop p) in leaf order. DKLA's `uncensored` chain
        (v = 0) therefore draws another stream than COKE's."""
        key = prng.PRNGKey(0)
        for i, s in enumerate(self.stages):
            key = prng.fold_in(key, i)
            seed = getattr(s, "seed", None)
            if seed is not None:
                key = prng.fold_in(key, int(seed))
        for s in self.stages:
            for name in _DATA_FIELDS.get(type(s), ()):
                key = _fold_value(key, getattr(s, name))
        return key

    def init_state(self, num_agents: int,
                   device: torch.device | str = "cpu") -> CommState:
        return CommState(
            bits=torch.zeros((num_agents,), dtype=torch.float32,
                             device=device),
            key=self.chain_key(),
            stages=tuple(s.init_state(num_agents) for s in self.stages))

    def ensure_state(self, state: CommState | None, num_agents: int,
                     device: torch.device | str = "cpu") -> CommState:
        """Re-initialize when `state` was built for another chain structure
        or agent count; keeps the cumulative bits when their shape fits."""
        if state is None or tuple(state.bits.shape) != (num_agents,):
            return self.init_state(num_agents, device)
        if len(state.stages) != len(self.stages):
            return CommState(bits=state.bits, key=self.chain_key(),
                             stages=tuple(s.init_state(num_agents)
                                          for s in self.stages))
        return state

    def apply(self, theta: torch.Tensor, prev: torch.Tensor, k: int,
              state: CommState
              ) -> tuple[torch.Tensor, torch.Tensor, CommState]:
        """Run one synchronous broadcast round of (N, D) candidates against
        the (N, D) stale copies at the host iteration k. Returns
        (theta_hat, send, new_state)."""
        num_agents, dim = theta.shape[0], theta.shape[-1]
        ones = torch.ones((num_agents,), dtype=torch.bool, device=theta.device)
        msg = Msg(payload=theta, prev=prev, send=ones, delivered=ones,
                  bits_per_value=FP_BITS, overhead_bits=0.0)
        # per-round entropy: the carried key is constant through the fit;
        # folding in k and the stage index gives a replayable stream that
        # differs per round and per stage
        round_key = prng.fold_in(state.key, k)
        sstates = []
        for i, (stage, ss) in enumerate(zip(self.stages, state.stages)):
            msg, ss = stage.transform(msg, ss, k,
                                      key=prng.fold_in(round_key, i))
            sstates.append(ss)
        effective = msg.send & msg.delivered
        theta_hat = masked_broadcast(msg.payload, prev, effective)
        # the reference's float32 scalars: dim * bits_per_value + overhead
        per_msg = float(_f32(dim) * _f32(msg.bits_per_value)
                        + _f32(msg.overhead_bits))
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
