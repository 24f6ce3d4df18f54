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

On a mesh the messages are feature-sharded `distributed.sharding.Blocked`
tensors: the censor norm is the sqrt of the psum of the blocks' squared
partials, Quantize's scale the max over the blocks' maxima, and each
draw (Quantize's, Drop's) is made once over the unsharded shape, one
K5 launch on the card as without a mesh, then split into the blocks.

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
                                     lane_thresholds, masked_broadcast)
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
            # one draw of the unsharded shape; on a mesh the comparison
            # cuts it into the message's feature blocks, so the bits are
            # those of the unsharded run
            u = prng.uniform(key, x.shape, x.device)
            x = lo + (u < (x - lo)).to(x.dtype)
        else:
            x = torch.round(x)                # half to even, as jnp.round
        deq = msg.prev + x / lv * safe
        return msg._replace(
            payload=deq, bits_per_value=float(b),
            overhead_bits=float(_f32(msg.overhead_bits)
                                + _f32(FP_BITS))), state

    def transform_lanes(self, payload, prev, levels, finite, key):
        """The stage over G lanes, (G, N, D): `levels` the (G, 1, 1) device
        tensor of each lane's 2^(b-1) - 1 (inf where b = inf), `finite` the
        (G, 1, 1) mask of finite lanes (None when all are), `key` the
        (G, 2) draw keys. Every lane is quantized, as the reference does
        under vmap, and a lane with b = inf keeps its payload: a select,
        so the inf/NaN of its quantized values never reaches the result."""
        innov = payload - prev
        scale = torch.amax(torch.abs(innov), dim=-1, keepdim=True)
        safe = torch.where(scale > 0, scale, 1.0)
        x = innov / safe * levels
        if self.stochastic:
            lo = torch.floor(x)
            u = prng.uniform(key, x.shape[1:], x.device)
            x = lo + (u < (x - lo)).to(x.dtype)
        else:
            x = torch.round(x)
        deq = prev + x / levels * safe
        return deq if finite is None else torch.where(finite, deq, payload)


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

    def transform_lanes(self, delivered, p, key):
        """The stage over G lanes: delivered (G, N), p the (G, 1) float32
        drop rates on the device, key the (G, 2) draw keys."""
        u = prng.uniform(key, delivered.shape[1:], delivered.device)
        return delivered & (u >= p)


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
              state: CommState, active: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, CommState]:
        """Run one broadcast round of (N, D) candidates against the (N, D)
        stale copies at the host iteration k. Returns (theta_hat, send,
        new_state).

        active — optional (N,) bool participation mask (gossip): an
        inactive agent is silent this round whatever the stages decide,
        pays zero bits, and its receivers keep the stale value. None (and
        an all-true mask) is exactly the synchronous broadcast."""
        num_agents, dim = theta.shape[0], theta.shape[-1]
        ones = torch.ones((num_agents,), dtype=torch.bool, device=theta.device)
        msg = Msg(payload=theta, prev=prev,
                  send=ones if active is None else active.to(torch.bool),
                  delivered=ones, bits_per_value=FP_BITS, overhead_bits=0.0)
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
    always-transmit (DKLA) variant of a policy (of each lane's policy, for
    a LaneChain: made once per LaneChain, so its device tables are too)."""
    def make():
        return dataclasses.replace(chain, stages=tuple(
            dataclasses.replace(s, v=s.v * 0) if isinstance(s, Censor)
            else s for s in chain.stages))

    if isinstance(chain, LaneChain):
        if "uncensored" not in chain._memo:
            chain._memo["uncensored"] = make()
        return chain._memo["uncensored"]
    return make()


# ---------------------------------------------------------------------------
# Lane-batched policies: a sweep's G cells as one chain
# ---------------------------------------------------------------------------

#: rounds of per-lane thresholds and draw keys made on the host at a time
LANE_BLOCK = 128


def _upload(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on `device` without waiting for the device: from
    pageable memory CUDA stages the bytes before it returns."""
    return torch.from_numpy(arr).to(device, non_blocking=True)


def _structure(chain: Chain) -> tuple:
    """What the reference's `jax.tree.structure` of a Chain holds: the
    stage types in order and each stage's static fields (Quantize seed and
    stochastic, Drop seed)."""
    out = []
    for s in chain.stages:
        if type(s) not in _DATA_FIELDS:
            raise TypeError(f"not a sweepable policy stage: {s!r}")
        out.append((type(s), tuple(
            (f.name, getattr(s, f.name)) for f in dataclasses.fields(s)
            if f.name not in _DATA_FIELDS[type(s)])))
    return tuple(out)


def stack_policies(policies) -> "LaneChain":
    """G same-structure chains as one LaneChain (the reference's
    `api/sweep.py` `_stack_policies`): each numeric parameter becomes the
    (G,) float32 array of the cells' values."""
    chains = [as_chain(p) for p in policies]
    structures = {_structure(c) for c in chains}
    if len(structures) != 1:
        raise ValueError(
            "all sweep cells must share one policy structure (same stages "
            f"in the same order); got {len(structures)} distinct "
            "structures — mixing e.g. censor-only and censor+quantize "
            "cells would need separate compiled programs")
    stages = tuple(
        dataclasses.replace(s, **{
            f: np.array([_f32(getattr(c.stages[i], f)) for c in chains],
                        dtype=np.float32)
            for f in _DATA_FIELDS[type(s)]})
        for i, s in enumerate(chains[0].stages))
    return LaneChain(stages, num_lanes=len(chains))


@dataclasses.dataclass(frozen=True, eq=False)
class LaneChain(Chain):
    """G same-structure chains run as one policy over a leading lane axis:
    messages are (G, N, D), decisions (G, N), `CommState.bits` (G, N) and
    `CommState.key` the (G, 2) numpy array of each lane's chain key. Each
    stage's numeric parameters are (G,) float32 numpy arrays
    (`stack_policies`). Lane g is bitwise `cell(g)` run alone: its
    thresholds come from `CensorSchedule` on the host, its draws from its
    own keys (`prng.uniform` under a (G, 2) key tensor), its bits from the
    same float32 accounting.

    Per-lane thresholds and draw keys are made on the host for
    LANE_BLOCK rounds at a time and copied to the device without a wait;
    the quantizer levels, drop rates and message sizes once. No round
    reads anything back from the device."""

    num_lanes: int = 1

    __eq__ = object.__eq__
    __hash__ = object.__hash__

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "_memo", {})

    def cell(self, g: int) -> Chain:
        """Lane g's chain, with host-float parameters."""
        return Chain(tuple(
            dataclasses.replace(s, **{f: float(getattr(s, f)[g])
                                      for f in _DATA_FIELDS[type(s)]})
            for s in self.stages))

    def chain_key(self) -> np.ndarray:
        """(G, 2) int64: each lane's `Chain.chain_key`."""
        return np.array([self.cell(g).chain_key()
                         for g in range(self.num_lanes)], dtype=np.int64)

    def init_state(self, num_agents: int,
                   device: torch.device | str = "cpu") -> CommState:
        return CommState(
            bits=torch.zeros((self.num_lanes, num_agents),
                             dtype=torch.float32, device=device),
            key=self.chain_key(),
            stages=tuple(s.init_state(num_agents) for s in self.stages))

    def ensure_state(self, state: CommState | None, num_agents: int,
                     device: torch.device | str = "cpu") -> CommState:
        if state is None or tuple(state.bits.shape) != (self.num_lanes,
                                                        num_agents):
            return self.init_state(num_agents, device)
        return state

    def _drawn(self) -> list[int]:
        """Indices of the stages that draw: Drop, and a stochastic Quantize
        with a finite lane."""
        return [i for i, s in enumerate(self.stages)
                if isinstance(s, Drop) or (
                    isinstance(s, Quantize) and s.stochastic
                    and np.isfinite(s.bits).any())]

    def _round_tables(self, base_key: np.ndarray, k: int, device):
        """(thresholds (C, G), keys (S, G, 2)) of round k on `device`:
        C censor stages, S drawing stages (`_drawn`); views into a block
        of LANE_BLOCK rounds made on the host."""
        block = (k - 1) // LANE_BLOCK
        memo_key = ("round", str(device), base_key.tobytes())
        have = self._memo.get(memo_key)
        if have is None or have[0] != block:
            ks = np.arange(block * LANE_BLOCK + 1,
                           (block + 1) * LANE_BLOCK + 1)
            censors = [s for s in self.stages if isinstance(s, Censor)]
            thr = np.zeros((LANE_BLOCK, len(censors), self.num_lanes),
                           dtype=np.float32)
            for j, kk in enumerate(ks):
                for c, s in enumerate(censors):
                    thr[j, c] = lane_thresholds(s.v, s.mu, int(kk))
            round_keys = prng.fold_in_lanes(base_key[None],
                                            ks[:, None])   # (B, G, 2)
            keys = np.zeros((LANE_BLOCK, len(self._drawn()), self.num_lanes,
                             2), dtype=np.int64)
            for j, i in enumerate(self._drawn()):
                keys[:, j] = prng.fold_in_lanes(round_keys, i)
            have = (block, _upload(thr, device), _upload(keys, device))
            self._memo[memo_key] = have
        j = (k - 1) % LANE_BLOCK
        return have[1][j], have[2][j]

    def _static_tables(self, dim: int, device):
        """Per Quantize stage its (levels, finite mask or None) as
        (G, 1, 1) device tensors; per Drop stage its (G, 1) rates; the
        (G, 1) float32 message size dim * bits_per_value + overhead,
        formed per lane as `Chain.apply` forms it."""
        memo_key = ("static", str(device), dim)
        if memo_key not in self._memo:
            G = self.num_lanes
            bpv = [_f32(FP_BITS)] * G
            over = [_f32(0.0)] * G
            per_stage = []
            for s in self.stages:
                if isinstance(s, Quantize):
                    fin = np.isfinite(s.bits)
                    lv = np.array([
                        _f32(2.0) ** (_f32(b) - _f32(1.0)) - _f32(1.0)
                        if f else np.inf for b, f in zip(s.bits, fin)],
                        dtype=np.float32)
                    for g in range(G):
                        if fin[g]:
                            bpv[g] = _f32(s.bits[g])
                            over[g] = _f32(over[g] + _f32(FP_BITS))
                    per_stage.append((
                        _upload(lv.reshape(G, 1, 1), device),
                        None if fin.all() else _upload(
                            fin.reshape(G, 1, 1), device)))
                elif isinstance(s, Drop):
                    per_stage.append(_upload(
                        s.p.reshape(G, 1).astype(np.float32), device))
                else:
                    per_stage.append(None)
            per_msg = np.array([_f32(dim) * bpv[g] + over[g]
                                for g in range(G)], dtype=np.float32)
            self._memo[memo_key] = (per_stage,
                                    _upload(per_msg.reshape(G, 1), device))
        return self._memo[memo_key]

    def apply(self, theta: torch.Tensor, prev: torch.Tensor, k: int,
              state: CommState, active: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, CommState]:
        """One broadcast round of every lane: (G, N, D) candidates against
        the (G, N, D) stale copies at the host iteration k; `active` the
        optional (G, N) participation mask (see `Chain.apply`). Returns
        (theta_hat (G, N, D), send (G, N), new_state)."""
        G, N, dim = theta.shape
        dev = theta.device
        thresholds, keys = self._round_tables(state.key, k, dev)
        per_stage, per_msg = self._static_tables(dim, dev)
        drawn = {i: j for j, i in enumerate(self._drawn())}
        ones = torch.ones((G, N), dtype=torch.bool, device=dev)
        payload, delivered = theta, ones
        send = ones if active is None else active.to(torch.bool)
        c = 0
        for i, s in enumerate(self.stages):
            if isinstance(s, Censor):
                send = send & censor_decision(payload, prev,
                                              thresholds[c][:, None])
                c += 1
            elif isinstance(s, Quantize):
                if np.isfinite(s.bits).any():   # all inf: the identity
                    levels, finite = per_stage[i]
                    payload = s.transform_lanes(
                        payload, prev, levels, finite,
                        keys[drawn[i]] if i in drawn else None)
            else:
                delivered = s.transform_lanes(delivered, per_stage[i],
                                              keys[drawn[i]])
        theta_hat = masked_broadcast(payload, prev, send & delivered)
        paid = torch.where(send, per_msg, 0.0)
        return theta_hat, send, CommState(bits=state.bits + paid,
                                          key=state.key, stages=state.stages)


# ---------------------------------------------------------------------------
# Agent-stacked trees (the ring runtime's message form)
# ---------------------------------------------------------------------------

def flatten_agents(tree) -> tuple[torch.Tensor, list]:
    """Agent-stacked tree -> ((N, D_total) float32, leaves). A single
    float32 (N, D) leaf comes back as itself, not a copy."""
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    if len(leaves) == 1 and leaves[0].ndim == 2:
        # one (N, D) leaf (a feature-sharded one too) is its own message
        return leaves[0].to(torch.float32), leaves
    parts = [leaf.reshape(n, -1).to(torch.float32) for leaf in leaves]
    flat = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return flat, leaves


def unflatten_agents(flat: torch.Tensor, leaves: list, like=None):
    """Inverse of flatten_agents; returns the leaves, or a tree with the
    structure of `like` when given."""
    if len(leaves) == 1 and tuple(flat.shape) == tuple(leaves[0].shape):
        out = [flat]
        return out if like is None else tree_unflatten(like, out)
    out, off = [], 0
    n = leaves[0].shape[0]
    for leaf in leaves:
        size = leaf.numel() // n
        out.append(flat[:, off:off + size].reshape(leaf.shape))
        off += size
    return out if like is None else tree_unflatten(like, out)


def apply_tree(chain: Chain, params_tree, prev_tree, k: int,
               state: CommState, active: torch.Tensor | None = None):
    """Chain.apply over agent-stacked trees: flatten both to (N, D_total)
    float32, run the policy once (one decision per agent), unflatten the
    broadcast. Equal to the flat path on a single (N, D) leaf. `active` is
    the gossip participation mask (see Chain.apply)."""
    flat, leaves = flatten_agents(params_tree)
    prev_flat, _ = flatten_agents(prev_tree)
    hat_flat, send, state = chain.apply(flat, prev_flat, k, state,
                                        active=active)
    return unflatten_agents(hat_flat, leaves, params_tree), send, state
