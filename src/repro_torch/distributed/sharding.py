"""Feature sharding for the big-D kernel-learning path: the reference's
rules (`src/repro/distributed/sharding.py`) and the blocked layout that
carries them out.

The rules, word for word: `feature_spec` shards the trailing feature dim
of an agent-stacked (N, ..., D) leaf over the mesh's "model" axis iff it
divides, and the agent dim over the batch axes iff it is the agent axis
and divides; `theta_stack_spec` shards a serving stack's feature dim and
keeps its slot axis replicated; `batch_specs` shards a batch's leading dim
over the batch axes iff it divides. A spec is a `P`, the port's own
PartitionSpec: a tuple of one entry per dim (None, an axis name, or a
tuple of names; a one-name tuple is the name, as jax normalizes it).

The layout. Under GSPMD the reference places an array and the compiler
inserts the collectives. Here `shard` cuts a tensor into a `Blocked`:
this process's blocks stacked in one contiguous tensor (B_loc, M_loc,
*block) on its device, B the blocks of the dim cut over the batch axes
and M those of the dim cut over "model" (1 for an axis the spec
replicates, so a replicated axis costs nothing; a fully replicated value
is a plain tensor). Every block data[b, m] is itself contiguous, so K1,
K3 and K6 take it as it is. On a one-process mesh (no group, or W = 1)
the process holds every block, B_loc = B and M_loc = M: on one card a
mesh is a layout, not a saving. On a mesh across ranks
(`launch.mesh.make_host_mesh(..., group=)`) each rank holds the blocks of
its own rectangle of cells, from (b0, m0) = `mesh.local_range`; block
indices (`Blocked.block`, `blockwise(index=True)`, `block_index`,
`local_block`) are global. Every rank runs the same program (SPMD).

Arithmetic is one torch call on the stacked data: `Blocked` answers
torch's elementwise functions and operators itself (a plain operand that
holds the full size of a cut dim is viewed in the blocks' layout, so the
one unsharded draw of a stochastic stage splits into the blocks it
meets), and the collectives GSPMD would insert are named functions:

  psum_model — per-model-block partials (a contraction or a reduction
               over the cut feature dim) summed in ascending block order,
               by explicit adds in the partials' dtype (fp32);
  the batch-axis reduction — after psum_model, the batch blocks in
               ascending order, the same way;
  roll_agents — the ring roll of the agent axis across batch blocks;
  all_gather — the blocks of one axis concatenated (the dense graph's
               A @ x gathers x over the batch axis first, then multiplies
               each row block of A; the gossip table's `neighbor_sum`
               gathers x so, then each row block takes its neighbours);
  unshard    — every block gathered into one plain tensor.

Across ranks each of them first gathers the blocks of its axis from the
ranks that hold them (`gather_ranks` over the mesh's sub-group along that
axis, `torch.distributed.all_gather`) into global block order, then runs
as on one process: the partials are folded over all M (or B) blocks in
ascending order, never folded per rank and the per-rank sums added, so
one summation order holds whatever the rank split, and comms and bits
with it. Where every rank drives one same card (`Mesh.card_shared`),
large card tensors travel by CUDA IPC instead of the backend (the same
bytes). Elementwise arithmetic and block-local work move nothing.
`broadcast_ranks` carries a picklable value from group rank 0 to every
rank: the serving commands of `serve.KernelServer` on such a mesh.

An agent-stacked deep-net train state (`train.steps` on a mesh) is cut
by `agent_stack_spec`, the reference's `_agent_stack_specs` at model
extent 1: the agent axis over the batch axes. `from_rows` builds such a
leaf from this rank's own agents (no rank makes the whole stack),
`agent_range` names them and `agent_row` reads one by global index;
`roll_agents_many` gives the ring's rolls of a leaf from one gather.

Reductions (`torch.sum`, `mean`, `amax`, `max`, `linalg.norm`) and the
two-operand `torch.einsum` contractions over the feature dim go through
them; an operation that no rule covers raises NotImplementedError naming
it, never a silent gather. `blockwise` runs a function (a kernel's
wrapper) once per block; `local` runs one that maps blocks to blocks
once on the stacked data.

The LM's rules, word for word too: `param_specs` shards a transformer's
weights by tensor parallelism over "model" iff a dim divides
(`_leaf_spec`), `decode_state_specs` its serve state (batch over the
batch axes, KV heads over "model", else the cache length), and
`step_in_specs` a step's inputs; `activation_spec` is the residual
stream's spec under `seq_parallel` (`models.common.shard_activations`).
The reference stacks a model's layers along leading dims of each leaf
and scans; the port keeps each layer's leaf apart (blocks.3.attn.wq, a
hybrid's blocks.1.2.ssm.w_x, a serve state's list of per-layer caches).
A port leaf's spec is the reference's spec of its stack, leading stack
entries and all, so the two compare entry for entry; the stack entries
index the layer: they are None, except where `fsdp=True` finds no weight
dim to put the batch axes on and puts them on the stack dim itself. Then
layer i lives on batch block i // (layers / batch extent), which
`param_shardings` records as the leaf's `layer_block`; `NamedSharding`
pairs a spec with its mesh and `place` cuts the leaf by the spec of its
own dims.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.launch.mesh import batch_axes


class P(tuple):
    """A PartitionSpec: one entry per dim, None (replicated), an axis name
    or a tuple of names. A one-name tuple is normalized to the name."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


# ---------------------------------------------------------------------------
# The rules (the reference's, word for word)
# ---------------------------------------------------------------------------

def _div(size: int, mesh, axis: str | tuple[str, ...] | None):
    """axis if size divides the mesh extent, else None."""
    if axis is None:
        return None
    if isinstance(axis, tuple):
        extent = math.prod(mesh.shape[a] for a in axis)
    else:
        extent = mesh.shape[axis]
    return axis if size % extent == 0 else None


def feature_spec(shape: tuple[int, ...], mesh, num_agents: int) -> P:
    """PartitionSpec for one agent-stacked consensus leaf: the trailing
    feature dim over "model" iff divisible, the leading agent axis over the
    batch axes iff it is the agent axis (size N) and divisible; 0-d and
    everything the rule cannot prove agent-stacked replicates."""
    ndim = len(shape)
    if ndim == 0:
        return P()
    ba = batch_axes(mesh)
    lead = _div(shape[0], mesh, ba) if (ba and shape[0] == num_agents) \
        else None
    if ndim == 1:
        return P(lead)
    feat = _div(shape[-1], mesh, "model") if "model" in mesh.axis_names \
        else None
    return P(lead, *([None] * (ndim - 2)), feat)


def _map_leaves(fn: Callable, tree):
    """fn over the array leaves (anything with a .shape) of a tree of
    dicts, lists, tuples and NamedTuples; other leaves pass unchanged."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    if hasattr(tree, "shape"):
        return fn(tree)
    return tree


def feature_specs(tree, mesh, num_agents: int):
    """feature_spec over a tree (consensus carry, problem, model params)."""
    return _map_leaves(lambda leaf: feature_spec(tuple(leaf.shape), mesh,
                                                 num_agents), tree)


def theta_stack_spec(shape: tuple[int, ...], mesh) -> P:
    """PartitionSpec of the many-model serving (M, D) stack: the slot axis
    replicated (the scorer gathers rows by slot), the feature dim over
    "model" iff divisible."""
    feat = _div(shape[-1], mesh, "model") if "model" in mesh.axis_names \
        else None
    return P(*([None] * (len(shape) - 1)), feat)


def batch_specs(cfg, specs_pytree, mesh):
    """Batches: the leading batch dim over the batch axes (iff divisible),
    everything else replicated. `cfg` is unused, as in the reference."""
    ba = batch_axes(mesh)

    def rule(leaf):
        b = _div(leaf.shape[0], mesh, ba) if len(leaf.shape) >= 1 else None
        return P(b, *([None] * (len(leaf.shape) - 1)))

    return _map_leaves(rule, specs_pytree)


# ---------------------------------------------------------------------------
# The LM's rules (the reference's, word for word)
# ---------------------------------------------------------------------------

def _leaf_spec(cfg, mesh, path: str, shape: tuple[int, ...], n_stack: int,
               fsdp: bool) -> P:
    """PartitionSpec for the *unstacked* trailing dims; `n_stack` leading
    scan dims get None (or FSDP over batch axes on the first stack dim)."""
    m = "model"
    name = path.split("/")[-1]
    dims = shape[n_stack:]

    def spec(*parts):
        lead = [None] * n_stack
        parts = list(parts)
        if fsdp:
            # ZeRO-style: shard the largest still-unsharded weight dim over
            # the batch axes (falls back to the stack dim when divisible)
            ba = batch_axes(mesh)
            extent = math.prod(mesh.shape[a] for a in ba) if ba else 0
            if extent:
                cands = [(dims[i], i) for i in range(len(parts))
                         if parts[i] is None and dims[i] % extent == 0
                         and dims[i] >= extent]
                if cands:
                    _, idx = max(cands)
                    parts[idx] = ba
                elif n_stack >= 1 and shape[0] % extent == 0:
                    lead[0] = ba
        return P(*lead, *parts)

    if name in ("embed",):                       # (Vp, d)
        return spec(_div(dims[0], mesh, m), None)
    if name == "lm_head":                        # (d, Vp)
        return spec(None, _div(dims[1], mesh, m))
    if name in ("wq", "wk", "wv"):               # (d, H, Dh)
        return spec(None, _div(dims[1], mesh, m), None)
    if name == "wo":                             # (H, Dh, d)
        return spec(_div(dims[0], mesh, m), None, None)
    if name == "wq_b" or name == "wkv_b":        # (r, H, e)
        return spec(None, _div(dims[1], mesh, m), None)
    if name in ("wq_a", "wkv_a"):                # (d, r) small latents
        return spec(None, None)
    if name in ("w_gate", "w_up"):
        if len(dims) == 3:                       # MoE experts (E, d, f)
            e = _div(dims[0], mesh, m)
            return spec(e, None, _div(dims[2], mesh, m) if e is None else None)
        return spec(None, _div(dims[1], mesh, m))   # dense (d, f)
    if name == "w_down":
        if len(dims) == 3:                       # (E, f, d)
            e = _div(dims[0], mesh, m)
            return spec(e, _div(dims[1], mesh, m) if e is None else None, None)
        return spec(_div(dims[0], mesh, m), None)   # (f, d)
    if name in ("shared_gate", "shared_up"):     # (d, fs)
        return spec(None, _div(dims[1], mesh, m))
    if name == "shared_down":                    # (fs, d)
        return spec(_div(dims[0], mesh, m), None)
    if name in ("w_z", "w_x"):                   # ssm (d, d_inner)
        return spec(None, _div(dims[1], mesh, m))
    if name == "w_dt":                           # ssm (d, H)
        return spec(None, _div(dims[1], mesh, m))
    if name == "w_bc":                           # ssm (d, 2N) — B/C shared
        return spec(None, None)
    if name == "conv_x":                         # ssm (W, d_inner)
        return spec(None, _div(dims[1], mesh, m))
    if name in ("conv_bc", "conv_bx", "conv_bbc"):
        if name == "conv_bx":                    # (d_inner,)
            return spec(_div(dims[0], mesh, m))
        return spec(*([None] * len(dims)))
    if name == "norm" and len(dims) == 1:        # ssm gated norm (d_inner,)
        return spec(_div(dims[0], mesh, m))
    if name == "out_proj":                       # ssm (d_inner, d)
        return spec(_div(dims[0], mesh, m), None)
    if name == "router":                         # (d, E) fp32, small
        return spec(None, None)
    # norms, biases, conv, A_log, D, dt_bias, scalars -> replicated
    return spec(*([None] * len(dims)))


_STACKED_ROOTS = ("blocks", "encoder", "decoder")


def _stack_depth(cfg, path: str) -> int:
    parts = path.split("/")
    root = next((p for p in parts if p in _STACKED_ROOTS), None)
    if root is None:
        return 0
    if root == "blocks" and cfg.arch_type == "hybrid":
        return 2  # (groups, every, ...)
    return 1


def _stack_extents(cfg, path: str) -> tuple[int, ...]:
    """The leading dims the reference stacks a leaf of `path` along."""
    n = _stack_depth(cfg, path)
    if n == 0:
        return ()
    if n == 2:
        return (cfg.num_layers // cfg.shared_attn_every,
                cfg.shared_attn_every)
    if path.split("/")[0] == "encoder":
        return (cfg.encoder_layers,)
    return (cfg.num_layers,)


def _ref_path(name: str) -> tuple[str, tuple[int, ...]]:
    """A port parameter name -> (the reference's path, the layer index):
    "blocks.3.attn.wq" -> ("blocks/attn/wq", (3,)), a hybrid's
    "blocks.1.2.ssm.w_x" -> ("blocks/ssm/w_x", (1, 2))."""
    parts = name.split(".")
    return ("/".join(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def param_specs(cfg, shapes: dict, mesh, fsdp: bool = False) -> dict:
    """{parameter name: P} over a {name: tensor} dict (`models.model.
    param_dict`, or the meta tensors of `param_shapes`): each leaf's spec
    is the reference's for its stack (the leaf's shape behind the layer
    counts), leading stack entries included."""
    out = {}
    for name, leaf in shapes.items():
        path, _ = _ref_path(name)
        out[name] = _leaf_spec(cfg, mesh, path,
                               _stack_extents(cfg, path) + tuple(leaf.shape),
                               _stack_depth(cfg, path), fsdp)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec and its mesh. `spec` keeps a per-layer leaf's `n_stack`
    leading stack entries; `layer_block` is the batch block that holds the
    layer where fsdp put the stack dim over the batch axes (None where the
    stack is not cut). `place` cuts a leaf by the spec of its own dims."""
    mesh: Any
    spec: P
    n_stack: int = 0
    layer_block: int | None = None

    @property
    def leaf_spec(self) -> P:
        return P(*self.spec[self.n_stack:])

    def place(self, x: torch.Tensor):
        return shard(x, self.mesh, self.leaf_spec)


def param_shardings(cfg, shapes: dict, mesh, fsdp: bool = False) -> dict:
    """{parameter name: NamedSharding} of `param_specs`."""
    out = {}
    for name, spec in param_specs(cfg, shapes, mesh, fsdp).items():
        path, index = _ref_path(name)
        n = _stack_depth(cfg, path)
        block = None
        if n and spec[0] is not None:
            per = _stack_extents(cfg, path)[0] // _extent(mesh, "batch")
            block = index[0] // per
        out[name] = NamedSharding(mesh, spec, n, block)
    return out


def activation_spec(cfg) -> P:
    """The residual stream's (B, S, d) spec under `cfg.seq_parallel`: S
    over the model axis, B over `cfg.act_batch_axes`."""
    ba = cfg.act_batch_axes if len(cfg.act_batch_axes) > 1 \
        else cfg.act_batch_axes[0]
    return P(ba, cfg.act_model_axis, None)


def _state_rule(mesh, name: str, shape: tuple[int, ...]) -> P:
    """The reference's serve-state rule for one leaf of the stacked
    `shape`, by its field name."""
    ba = batch_axes(mesh)
    ndim = len(shape)
    if name == "slot_positions":                   # (L, C) or (G, C)
        return P(*([None] * ndim))
    if name in ("k", "v"):                         # (L, B, C, KV, Dh)
        b = _div(shape[1], mesh, ba)
        kv = _div(shape[3], mesh, "model")
        c = None if kv else _div(shape[2], mesh, "model")
        return P(None, b, c, kv, None)
    if name in ("ckv", "krope"):                   # (L, B, C, r)
        b = _div(shape[1], mesh, ba)
        c = _div(shape[2], mesh, "model")
        return P(None, b, c, None)
    if name in ("cross_k", "cross_v"):             # (L, B, S_enc, KV, Dh)
        b = _div(shape[1], mesh, ba)
        kv = _div(shape[3], mesh, "model")
        c = None if kv else _div(shape[2], mesh, "model")
        return P(None, b, c, kv, None)
    if name == "conv_x":                           # (.., B, W-1, di)
        lead = ndim - 3
        b = _div(shape[lead], mesh, ba)
        return P(*([None] * lead), b, None, _div(shape[-1], mesh, "model"))
    if name == "conv_bc":                          # (.., B, W-1, 2N)
        lead = ndim - 3
        b = _div(shape[lead], mesh, ba)
        return P(*([None] * lead), b, None, None)
    if name == "state":                            # (.., B, H, P, N)
        lead = ndim - 4
        b = _div(shape[lead], mesh, ba)
        return P(*([None] * lead), b,
                 _div(shape[lead + 1], mesh, "model"), None, None)
    # fallback: replicate
    return P(*([None] * ndim))


def decode_state_specs(cfg, state: dict, mesh) -> dict:
    """Serve-state sharding over the port's state (`models.model.
    init_serve_state`: a list of per-layer caches, or tensors, under each
    key): (L, B, C, KV, Dh) caches shard batch over the batch axes and KV
    heads over "model", falling back to a sequence-parallel cache (C over
    "model") where the heads do not divide. Each leaf's spec is the
    reference's for the stack of the list (a hybrid's SSM caches stacked
    as (groups, every)), in the place of the leaf."""
    out = {}
    for key, caches in state.items():
        lead = (len(caches),)
        if key == "ssm" and cfg.arch_type == "hybrid":
            lead = (cfg.num_layers // cfg.shared_attn_every,
                    cfg.shared_attn_every)

        def rule(name, leaf, lead=lead):
            return _state_rule(mesh, name, lead + tuple(leaf.shape))

        out[key] = [type(c)(*(rule(f, x) for f, x in zip(c._fields, c)))
                    if hasattr(c, "_fields") else rule(key, c)
                    for c in caches]
    return out


def step_in_specs(cfg, kind: str, specs: dict, mesh):
    """Input PartitionSpecs for a step of the given kind."""
    if kind in ("train", "prefill"):
        return batch_specs(cfg, specs, mesh)
    ba = batch_axes(mesh)
    return {
        "token": P(_div(specs["token"].shape[0], mesh, ba), None),
        "position": P(),
        "state": decode_state_specs(cfg, specs["state"], mesh),
    }


# ---------------------------------------------------------------------------
# The blocked layout
# ---------------------------------------------------------------------------

def _kind(mesh, entry) -> str | None:
    """A spec entry as the layout reads it: None, "model" or "batch" (the
    batch axes jointly, the only way the rules use them)."""
    if entry is None:
        return None
    if entry == "model":
        return "model"
    ba = batch_axes(mesh)
    if ba and entry == (ba[0] if len(ba) == 1 else ba):
        return "batch"
    raise ValueError(f"spec entry {entry!r} is neither 'model' nor the "
                     f"mesh's batch axes {ba}")


def _extent(mesh, kind: str) -> int:
    if kind == "model":
        return mesh.shape.get("model", 1)
    return math.prod(mesh.shape[a] for a in batch_axes(mesh))


def _entry(mesh, kind: str | None):
    if kind is None:
        return None
    if kind == "model":
        return "model"
    ba = batch_axes(mesh)
    return ba[0] if len(ba) == 1 else ba


def _spec_of(mesh, kinds) -> P:
    memo = mesh.__dict__.setdefault("_specs", {})
    kinds = tuple(kinds)
    if kinds not in memo:
        memo[kinds] = P(*(_entry(mesh, k) for k in kinds))
    return memo[kinds]


def mesh_device(mesh) -> torch.device:
    """This process's device: the one its own cells lie on, where the
    layout stacks its blocks of a tensor."""
    devs = mesh.distinct_devices()
    if len(devs) != 1:
        raise ValueError(
            f"this process's cells lie on {len(devs)} devices: a mesh runs "
            "one process per card (give each card its own rank: "
            "make_host_mesh(..., group=))")
    return devs[0]


def _lead(mesh, kinds, partial: bool = False) -> tuple[int, int]:
    """(B_loc, M_loc): this process's batch blocks and model blocks of a
    layout (1 along an axis the layout does not cut)."""
    return (mesh.local_range("batch")[1] if "batch" in kinds else 1,
            mesh.local_range("model")[1] if ("model" in kinds or partial)
            else 1)


# the bytes this process received through `gather_ranks`, and its calls;
# the bytes and calls of `broadcast_ranks` (phase 28 of chip_smoke.py
# reports them per rank)
TRAFFIC = {"bytes": 0, "calls": 0, "broadcast_bytes": 0, "broadcasts": 0}

# the first message of every `broadcast_ranks`: a value whose pickle fits
# (a serving command of up to ~500 rows of d = 5 inputs does) is
# one collective, a longer one two
BROADCAST_BYTES = 1 << 14


def broadcast_ranks(obj, group, device: torch.device):
    """rank 0 of `group`'s `obj` on every rank of it: the serving
    commands' transport. On group rank 0 obj is any picklable value (numpy
    arrays travel as their bytes); the other ranks pass None and get rank
    0's. One `torch.distributed.broadcast` of BROADCAST_BYTES on `device`
    (the pickle's length, then its head), and a second of the rest where
    it is longer: every rank knows both sizes from the first. The tensors
    lie on the rank's device, as NCCL needs; the backend is the caller's
    `init_process_group`."""
    import pickle

    import torch.distributed as dist
    src = dist.get_global_rank(group, 0)
    head = torch.zeros(BROADCAST_BYTES, dtype=torch.uint8)
    rest = None
    if dist.get_rank(group) == 0:
        blob = np.frombuffer(pickle.dumps(obj, pickle.HIGHEST_PROTOCOL),
                             np.uint8)
        k = min(blob.size, BROADCAST_BYTES - 8)
        head[:8] = torch.tensor([blob.size]).view(torch.uint8)
        head[8:8 + k] = torch.from_numpy(blob[:k].copy())
        head = head.to(device)
        if blob.size > k:
            rest = torch.from_numpy(blob[k:].copy()).to(device)
    else:
        head = head.to(device)
    dist.broadcast(head, src, group=group)
    host = head.cpu()
    n = int(host[:8].view(torch.int64))
    k = min(n, BROADCAST_BYTES - 8)
    if n > k:
        if rest is None:
            rest = torch.empty(n - k, dtype=torch.uint8, device=device)
        dist.broadcast(rest, src, group=group)
        blob = torch.cat([host[8:8 + k], rest.cpu()])
    else:
        blob = host[8:8 + k]
    TRAFFIC["broadcast_bytes"] += BROADCAST_BYTES + (n - k)
    TRAFFIC["broadcasts"] += 1 + (n > k)
    return pickle.loads(blob.numpy().tobytes())


# a card tensor of at least this many bytes, between ranks that share the
# card, travels by CUDA IPC (`gather_ranks(on_card=True)`); a smaller one
# through the backend, whose one collective costs less than the IPC path's
# handle exchange and barrier
IPC_MIN_BYTES = 1 << 20


def gather_ranks(t: torch.Tensor, group, size: int, dim: int, *,
                 on_card: bool = False) -> torch.Tensor:
    """t from each of the `size` ranks of `group`, concatenated along
    `dim` in group-rank order: the one transport of the layout
    (`torch.distributed.all_gather`, which gloo and NCCL both take, on the
    group given; the backend is the caller's `init_process_group`). A
    tensor on the card goes to the collective as it is.

    on_card — every rank of `group` drives this same card
    (`launch.mesh.Mesh.card_shared`): gloo stages a card tensor through
    the host at ~0.5 GB/s, so one of at least IPC_MIN_BYTES travels by
    CUDA IPC instead: each rank passes a handle to its tensor's memory
    through the group (`all_gather_object`), copies its peers' tensors
    into their places on the card, and a barrier on the group releases
    the senders' memory. The copies are the same bytes either way."""
    import torch.distributed as dist
    t = t.contiguous()
    if on_card and t.is_cuda and t.nbytes >= IPC_MIN_BYTES:
        out = _gather_on_card(t, group, size, dim)
    else:
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=group)
        out = torch.cat(parts, dim=dim)
    TRAFFIC["bytes"] += t.nbytes * (size - 1)
    TRAFFIC["calls"] += 1
    return out


def _gather_on_card(t: torch.Tensor, group, size: int, dim: int):
    """`gather_ranks` between ranks that share t's card, by CUDA IPC
    handles (torch.multiprocessing's: the sender's event is waited on
    before the copy, and its memory is counted as shared until the
    receivers let go of it)."""
    import torch.distributed as dist
    from torch.multiprocessing.reductions import reduce_tensor
    me = dist.get_rank(group)
    handles = [None] * size
    dist.all_gather_object(handles, reduce_tensor(t), group=group)
    shape = list(t.shape)
    shape[dim] *= size
    whole = torch.empty(shape, dtype=t.dtype, device=t.device)
    places = whole.split(t.shape[dim], dim=dim)
    peers = []
    for r, (rebuild, args) in enumerate(handles):
        if r == me:
            places[r].copy_(t)
            continue
        peers.append(rebuild(*args))
        places[r].copy_(peers[-1])
    # the copies are done before the peers' memory is let go of (which
    # closes its mapping here) and before the barrier lets them free it
    torch.cuda.current_stream(t.device).synchronize()
    del peers
    dist.barrier(group=group)
    return whole


def _gather_axis(mesh, t: torch.Tensor, kind: str) -> torch.Tensor:
    """A stack (B_loc, M_loc, ...) with the lead axis of `kind` made whole:
    this rank's blocks and its peers' along that axis, in global block
    order (the peers hold the same blocks of the other axis)."""
    group, size = mesh.axis_group(kind)
    if group is None:
        return t
    return gather_ranks(t, group, size, 0 if kind == "batch" else 1,
                        on_card=mesh.card_shared)


def _broadcast(shapes) -> torch.Size:
    """torch.broadcast_shapes, without its per-call overhead."""
    nd = max(len(s) for s in shapes)
    out = [1] * nd
    for s in shapes:
        for k, n in enumerate(s, nd - len(s)):
            if n != 1:
                if out[k] not in (1, n):
                    raise RuntimeError(f"shapes {shapes} do not broadcast")
                out[k] = n
    return torch.Size(out)


def _block_range(size: int, extent: int, idx: int) -> slice:
    n = size // extent
    return slice(idx * n, (idx + 1) * n)


class Blocked:
    """A tensor of `shape` cut into blocks by `spec` over `mesh`.

    data    — this process's blocks stacked in one contiguous tensor
              (B_loc, M_loc, *block) on its device: B_loc its batch
              blocks (1 where no dim is cut over the batch axes), M_loc
              its model blocks (1 where none is cut over "model" and the
              value is not partial); all B x M blocks on a one-process
              mesh. Global block (b, m) is data[b - b0, m - m0], itself
              contiguous: a kernel takes it as it is, and elementwise
              arithmetic is one torch call on data.
    partial — the blocks are per-model-block partials of one value of
              `shape` (a contraction over the cut feature dim), which
              `psum_model` sums; no arithmetic runs on them before that.
    """

    __slots__ = ("mesh", "_spec", "kinds", "shape", "data", "partial")

    def __init__(self, mesh, spec, shape, data: torch.Tensor,
                 partial: bool = False, kinds=None):
        self.mesh = mesh
        self.shape = torch.Size(shape)
        self.data = data
        self.partial = partial
        if kinds is not None:          # the layout's own calls
            self._spec = spec
            self.kinds = tuple(kinds)
            return
        self._spec = spec if isinstance(spec, P) else P(*spec)
        self.kinds = tuple(_kind(mesh, e) for e in self._spec)
        if len(self.kinds) != len(self.shape):
            raise ValueError(f"spec {self.spec} does not fit shape "
                             f"{tuple(self.shape)}")
        want = (*_lead(mesh, self.kinds, partial), *(
            s // _extent(mesh, k) if k else s
            for s, k in zip(self.shape, self.kinds)))
        if tuple(data.shape) != want or not data.is_contiguous():
            raise ValueError(f"data {tuple(data.shape)} is not the "
                             f"contiguous stack {want} of this layout")

    # ---- tensor-like surface ---------------------------------------------
    @property
    def spec(self) -> P:
        if self._spec is None:
            self._spec = _spec_of(self.mesh, self.kinds)
        return self._spec

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def dim(self) -> int:
        return len(self.shape)

    def size(self, d: int | None = None):
        return self.shape if d is None else self.shape[d]

    def numel(self) -> int:
        return math.prod(self.shape)

    def __len__(self) -> int:
        return self.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def blocks(self) -> dict:
        """{(batch block, model block, device): block}, views of this
        process's data, by global block index."""
        B, M = self.data.shape[:2]
        b0, m0 = self._origin()
        dev = self.data.device
        return {(b0 + b, m0 + m, dev): self.data[b, m]
                for b in range(B) for m in range(M)}

    def _origin(self) -> tuple[int, int]:
        """(b0, m0): the global index of data[0, 0]."""
        return (self.mesh.local_range("batch")[0] if "batch" in self.kinds
                else 0,
                self.mesh.local_range("model")[0]
                if "model" in self.kinds or self.partial else 0)

    def __repr__(self) -> str:
        return (f"Blocked(shape={tuple(self.shape)}, spec={self.spec}, "
                f"dtype={self.dtype}, blocks={self.data.shape[0]}x"
                f"{self.data.shape[1]}" + (", partial" if self.partial
                                           else "") + ")")

    def __iter__(self):
        raise NotImplementedError(
            "iterating a blocked tensor would gather it; map over its "
            "blocks (distributed.sharding.blockwise) or unshard it")

    def __bool__(self):
        raise NotImplementedError("a blocked tensor has no truth value")

    def block(self, b: int = 0, m: int = 0) -> torch.Tensor:
        """The block that cell (global batch index b, model index m)
        holds (the one block along an axis the layout does not cut); a
        KeyError where this process does not hold it."""
        b0, m0 = self._origin()
        B, M = self.data.shape[:2]
        i = b - b0 if "batch" in self.kinds else 0
        j = m - m0 if "model" in self.kinds or self.partial else 0
        if not (0 <= i < B and 0 <= j < M):
            raise KeyError((b, m))
        return self.data[i, j]

    # ---- methods ---------------------------------------------------------
    def to(self, *args, **kwargs):
        """A dtype conversion. A device is accepted only where it is the
        one the blocks already lie on."""
        dev = kwargs.pop("device", None)
        rest = []
        for a in args:
            if isinstance(a, (torch.device, str)):
                dev = a
            else:
                rest.append(a)
        if dev is not None:
            want, held = torch.device(dev), self.data.device
            if want.type != held.type or want.index not in (None,
                                                            held.index):
                raise NotImplementedError(
                    f"moving a blocked tensor to {dev}: its blocks stay "
                    "on their cells' device")
        if not rest and not kwargs:
            return self
        return _elementwise(torch.Tensor.to, (self, *rest), kwargs)

    def float(self):
        return _elementwise(torch.Tensor.float, (self,), {})

    def cpu(self) -> torch.Tensor:
        """The whole tensor on the host: every block gathered."""
        return unshard(self).cpu()

    def clone(self):
        return _elementwise(torch.Tensor.clone, (self,), {})

    def contiguous(self):
        return self

    def detach(self):
        return self

    def abs(self):
        return _elementwise(torch.abs, (self,), {})

    def sqrt(self):
        return _elementwise(torch.sqrt, (self,), {})

    def square(self):
        return _elementwise(torch.square, (self,), {})

    def sum(self, dim=None, keepdim=False, dtype=None):
        return _reduce("sum", self, dim, keepdim, dtype)

    def mean(self, dim=None, keepdim=False, dtype=None):
        return _reduce("mean", self, dim, keepdim, dtype)

    def amax(self, dim=(), keepdim=False):
        return _reduce("amax", self, dim, keepdim, None)

    def max(self):
        return _reduce("amax", self, None, False, None)

    def reshape(self, *shape):
        """The identity; a reshape of the uncut leading dims of a tensor
        cut only on its last dim, which keeps its size; or one of the
        uncut trailing dims of a tensor cut only on its leading (agent)
        dim, which keeps that dim (an agent-stacked leaf flattened to
        (N, -1) and back)."""
        shape = tuple(shape[0]) if len(shape) == 1 and isinstance(
            shape[0], (tuple, list, torch.Size)) else tuple(shape)
        full = torch.empty(self.shape, device="meta").reshape(shape).shape
        if full == self.shape:
            return self
        if not self.partial and self.kinds[0] is not None \
                and not any(self.kinds[1:]) and full[0] == self.shape[0]:
            data = self.data.reshape(*self.data.shape[:3], *full[1:])
            return _wrap(self.mesh, [self.kinds[0]] + [None] * (
                len(full) - 1), full, data)
        if self.partial or any(self.kinds[:-1]) \
                or full[-1] != self.shape[-1]:
            raise NotImplementedError(
                f"reshaping a blocked tensor {tuple(self.shape)} -> "
                f"{tuple(full)}")
        data = self.data.reshape(*self.data.shape[:2], *full[:-1],
                                 self.data.shape[-1])
        return _wrap(self.mesh, [None] * (len(full) - 1) + [self.kinds[-1]],
                     full, data)

    def __getitem__(self, idx):
        return _getitem(self, idx)

    def __matmul__(self, other):
        return _matmul(self, other)

    def __rmatmul__(self, other):
        return _matmul(other, self)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _REDUCTIONS:
            return _REDUCTIONS[func](*args, **kwargs)
        if func in (torch.roll, torch.Tensor.roll):
            return roll_agents(*args, **kwargs)
        if func in (torch.matmul, torch.Tensor.matmul,
                    torch.Tensor.__matmul__):
            return _matmul(*args)
        if func is torch.Tensor.__rmatmul__:
            return _matmul(args[1], args[0])
        if func is torch.einsum:
            return _einsum(*args)
        if func is torch.stack:
            return _stack(*args, **kwargs)
        if func is torch.cat:
            return _cat(*args, **kwargs)
        if func in _ELEMENTWISE:
            return _elementwise(func, args, kwargs)
        raise NotImplementedError(
            f"{getattr(func, '__name__', func)} has no rule for blocked "
            "tensors")


_OPERATORS = ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
              "__rmul__", "__truediv__", "__rtruediv__", "__neg__",
              "__pow__", "__rpow__", "__and__", "__rand__", "__or__",
              "__ror__", "__xor__", "__invert__", "__eq__", "__ne__",
              "__gt__", "__ge__", "__lt__", "__le__", "__abs__")


def _operators():
    """Blocked's arithmetic and comparison operators, on the stacked
    data."""
    def op(name):
        fn = getattr(torch.Tensor, name)

        def method(self, *args):
            return _elementwise(fn, (self, *args), {})
        method.__name__ = name
        return method
    for name in _OPERATORS:
        setattr(Blocked, name, op(name))
    Blocked.__hash__ = object.__hash__


_ELEMENTWISE = set()
for _name in ("add", "sub", "mul", "div", "true_divide", "neg", "where",
              "square", "sqrt", "rsqrt", "abs", "floor", "ceil", "round",
              "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "cos",
              "sin", "exp", "log", "log1p", "logaddexp", "sigmoid", "tanh",
              "zeros_like", "ones_like", "full_like", "empty_like",
              "logical_and", "logical_or", "logical_not", "logical_xor",
              "eq", "ne", "gt", "ge", "lt", "le", "pow", "sign", "isfinite",
              "bitwise_and", "bitwise_or"):
    _ELEMENTWISE.add(getattr(torch, _name))
    if hasattr(torch.Tensor, _name):
        _ELEMENTWISE.add(getattr(torch.Tensor, _name))
for _name in _OPERATORS + ("to", "float", "double", "clone", "contiguous",
                           "detach", "type"):
    _ELEMENTWISE.add(getattr(torch.Tensor, _name))
_operators()


def _wrap(mesh, kinds, shape, data: torch.Tensor, partial: bool = False):
    """A Blocked of this (B, M, *block) data (made contiguous), or the
    plain tensor of a value that nothing cuts."""
    if not partial and not any(kinds):
        return data[0, 0]
    if not data.is_contiguous():
        data = data.contiguous()
    return Blocked(mesh, None, shape, data, partial, kinds=kinds)


def _view(x, shape, kinds, mesh) -> torch.Tensor:
    """x — a Blocked, or a plain tensor on the mesh's device, its dims
    right-aligned with `shape` as broadcasting aligns them — as a
    (B or 1, M or 1, *block) view that broadcasts against the stacked
    data of the `kinds` layout of `shape`: each dim that the layout cuts
    and x holds whole is split into (blocks, block), its block axis moved
    to the lead and narrowed to this process's blocks. Splitting, moving
    and narrowing dims copies nothing."""
    if isinstance(x, Blocked):
        v, held = x.data, x.kinds
    else:
        v, held = x.reshape(1, 1, *x.shape), (None,) * x.ndim
    od, nd = len(shape), len(held)
    if nd < od:
        v = v.reshape(*v.shape[:2], *([1] * (od - nd)), *v.shape[2:])
        held = (None,) * (od - nd) + tuple(held)
    for k, kind in enumerate(kinds):
        n = v.shape[2 + k]
        if kind is None or held[k] is not None or n == 1:
            continue
        lead = 0 if kind == "batch" else 1
        if kind in held:
            raise NotImplementedError("two dims cut over one mesh axis")
        held = held[:k] + (kind,) + held[k + 1:]
        e = _extent(mesh, kind)
        v = v.unflatten(2 + k, (e, n // e)).movedim(2 + k, lead) \
            .squeeze(lead + 1)
        start, count = mesh.local_range(kind)
        if count != e:
            v = v.narrow(lead, start, count)
    return v


def _flat_args(args, kwargs):
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, (list, tuple)):
            yield from a
        else:
            yield a


def _elementwise(func, args, kwargs):
    """func once over the stacked data of broadcast operands: a plain
    operand that holds the full size of a cut dim is viewed in the
    blocks' layout (so the one unsharded draw of a stochastic stage splits
    into the blocks it meets)."""
    first, same = None, not kwargs
    for a in args:
        if isinstance(a, Blocked):
            if first is None:
                first = a
            elif a.kinds != first.kinds or a.shape != first.shape:
                same = False
        elif isinstance(a, (torch.Tensor, list, tuple)):
            same = False
    if same and not first.partial:
        # the common case: operands of one layout, scalars beside them
        return _wrap(first.mesh, first.kinds, first.shape, func(*(
            a.data if isinstance(a, Blocked) else a for a in args)))
    flat = list(_flat_args(args, kwargs))
    blocked = [a for a in flat if isinstance(a, Blocked)]
    if any(a.partial for a in blocked):
        raise NotImplementedError(
            f"{getattr(func, '__name__', func)} on model partials: "
            "psum_model them first")
    first = blocked[0]
    mesh, dev = first.mesh, first.data.device
    tensors = [a for a in flat if isinstance(a, (Blocked, torch.Tensor))]
    if len(tensors) == len(blocked) and all(
            a.kinds == first.kinds and a.shape == first.shape
            for a in blocked):
        kinds, shape = first.kinds, first.shape

        def conv(a):
            if isinstance(a, Blocked):
                return a.data
            if isinstance(a, (list, tuple)):
                return type(a)(conv(x) for x in a)
            return a
    else:
        shape = _broadcast([a.shape for a in tensors])
        od = len(shape)
        out_kinds: list[str | None] = [None] * od
        for a in blocked:
            for ko, kind in enumerate(a.kinds):
                k = ko + od - a.ndim
                if kind is None or a.shape[ko] != shape[k]:
                    continue
                if out_kinds[k] not in (None, kind):
                    raise NotImplementedError(
                        f"operands cut dim {k} over different axes")
                out_kinds[k] = kind
        kinds = tuple(out_kinds)
        if len({k for k in kinds if k}) != sum(1 for k in kinds if k):
            raise NotImplementedError("two dims cut over one mesh axis")

        def conv(a):
            if isinstance(a, torch.Tensor) and a.ndim and a.device != dev:
                a = a.to(dev)
            if isinstance(a, (Blocked, torch.Tensor)):
                return _view(a, shape, kinds, mesh)
            if isinstance(a, (list, tuple)):
                return type(a)(conv(x) for x in a)
            return a
    out = func(*(conv(a) for a in args),
               **{n: conv(v) for n, v in kwargs.items()})
    return _wrap(mesh, kinds, shape, out)


def _fold(t: torch.Tensor, axis: int, op) -> torch.Tensor:
    """The left fold of t's slices along `axis` (kept, of size 1): block
    0, then 1, ... in ascending order, by explicit ops."""
    acc = t.narrow(axis, 0, 1)
    for i in range(1, t.shape[axis]):
        acc = op(acc, t.narrow(axis, i, 1))
    return acc


def fold_add(t: torch.Tensor, axis: int) -> torch.Tensor:
    """The sum of t's slices along `axis` (dropped) as the left fold
    0, 1, ...: one order whatever t's other dims (torch.sum's order over a
    dim that is not the innermost depends on the tensor's shape), so a
    block's rows sum as the whole tensor's rows do."""
    return _fold(t, axis, torch.add).squeeze(axis)


def psum_model(x):
    """Sum the model-axis partials of `x` in ascending block order (across
    ranks: gathered over the model axis first, then folded)."""
    if not isinstance(x, Blocked) or not x.partial:
        return x
    return _wrap(x.mesh, x.kinds, x.shape, _fold(
        _gather_axis(x.mesh, x.data, "model"), 1, torch.add))


def _reduce(op: str, x, dim, keepdim: bool, dtype):
    """A reduction: within each block on the stacked data, then the
    blocks' results folded over the cut axes it spans, the model blocks
    in ascending order, then the batch blocks (across ranks each axis
    gathered whole before its fold)."""
    if not isinstance(x, Blocked):
        raise TypeError("not a blocked tensor")
    if x.partial:
        x = psum_model(x)
        if not isinstance(x, Blocked):
            return _REDUCTIONS_PLAIN[op](x, dim, keepdim, dtype)
    nd = x.ndim
    if dim is None or dim == ():
        dims = tuple(range(nd))
    else:
        dims = tuple(sorted(d % nd for d in (
            dim if isinstance(dim, (tuple, list)) else (dim,))))
    over = {x.kinds[d] for d in dims} - {None}
    red = "sum" if op == "mean" else op
    t = _REDUCTIONS_PLAIN[red](x.data, tuple(d + 2 for d in dims), True,
                               dtype)
    fold = torch.add if red == "sum" else torch.maximum
    if "model" in over:
        t = _fold(_gather_axis(x.mesh, t, "model"), 1, fold)
    if "batch" in over:
        t = _fold(_gather_axis(x.mesh, t, "batch"), 0, fold)
    if op == "mean":
        count = math.prod(x.shape[d] for d in dims)
        t = t / torch.full((), count, dtype=t.dtype, device=t.device)
    kinds = [None if d in dims else x.kinds[d] for d in range(nd)]
    shape = [1 if d in dims else x.shape[d] for d in range(nd)]
    if not keepdim:
        keep = [d for d in range(nd) if d not in dims]
        t = t.reshape(*t.shape[:2], *(t.shape[2 + d] for d in keep))
        kinds = [kinds[d] for d in keep]
        shape = [shape[d] for d in keep]
    return _wrap(x.mesh, tuple(kinds), shape, t)


def _plain_sum(t, dims, keepdim, dtype):
    return torch.sum(t, dim=dims, keepdim=keepdim, dtype=dtype)


def _plain_mean(t, dims, keepdim, dtype):
    return torch.mean(t, dim=dims, keepdim=keepdim, dtype=dtype)


def _plain_amax(t, dims, keepdim, dtype):
    return torch.amax(t, dim=dims if dims is not None else (),
                      keepdim=keepdim)


_REDUCTIONS_PLAIN = {"sum": _plain_sum, "mean": _plain_mean,
                     "amax": _plain_amax}


def _sum(input, dim=None, keepdim=False, *, dtype=None):
    return _reduce("sum", input, dim, keepdim, dtype)


def _mean(input, dim=None, keepdim=False, *, dtype=None):
    return _reduce("mean", input, dim, keepdim, dtype)


def _amax(input, dim=(), keepdim=False):
    return _reduce("amax", input, dim, keepdim, None)


def _max(input, *rest, **kw):
    if rest or kw:
        raise NotImplementedError("torch.max over a dim of a blocked tensor")
    return _reduce("amax", input, None, False, None)


def _norm(x, ord=None, dim=None, keepdim=False, *, dtype=None):
    if ord not in (None, 2):
        raise NotImplementedError(f"norm ord={ord} of a blocked tensor")
    return torch.sqrt(_reduce("sum", x * x, dim, keepdim, dtype))


_REDUCTIONS = {torch.sum: _sum, torch.Tensor.sum: _sum,
               torch.mean: _mean, torch.Tensor.mean: _mean,
               torch.amax: _amax, torch.Tensor.amax: _amax,
               torch.max: _max, torch.Tensor.max: _max,
               torch.linalg.norm: _norm, torch.linalg.vector_norm: _norm}


def _getitem(x: Blocked, idx):
    """Indexing that keeps every cut dim whole: Ellipsis, None (a new
    uncut dim), and ints or slices on uncut dims."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    n_real = sum(1 for i in idx if i is not None and i is not Ellipsis)
    if sum(1 for i in idx if i is Ellipsis) > 1:
        raise IndexError("one Ellipsis at most")
    expanded = []
    for i in idx:
        if i is Ellipsis:
            expanded += [slice(None)] * (x.ndim - n_real)
        else:
            expanded.append(i)
    expanded += [slice(None)] * (x.ndim - sum(
        1 for i in expanded if i is not None))
    kinds, d = [], 0
    for i in expanded:
        if i is None:
            kinds.append(None)
            continue
        kind = x.kinds[d]
        if kind is not None and i != slice(None):
            raise NotImplementedError(
                f"indexing the cut dim {d} of a blocked tensor")
        if not isinstance(i, int):
            kinds.append(kind)
        d += 1
    data = x.data[(slice(None), slice(None), *expanded)]
    shape = [s * _extent(x.mesh, k) if k else s
             for s, k in zip(data.shape[2:], kinds)]
    return _wrap(x.mesh, tuple(kinds), shape, data, x.partial)


def all_gather(x, axis: str = "batch"):
    """Concatenate the blocks of the dim cut over `axis` ("batch" or
    "model"): the result holds that dim whole."""
    if not isinstance(x, Blocked) or axis not in x.kinds:
        return x
    if x.partial:
        raise NotImplementedError("all_gather of model partials")
    d = x.kinds.index(axis)
    lead = 0 if axis == "batch" else 1
    # the block axis beside the dim, as its major part, then merged
    data = _gather_axis(x.mesh, x.data, axis).movedim(lead, 1 + d) \
        .flatten(1 + d, 2 + d).unsqueeze(lead)
    kinds = tuple(None if k == axis else k for k in x.kinds)
    return _wrap(x.mesh, kinds, x.shape, data)


def unshard(x, device: torch.device | None = None):
    """Gather a blocked tensor into one plain tensor (on `device`, default
    the mesh's); anything else passes through."""
    if not isinstance(x, Blocked):
        return x
    x = all_gather(all_gather(psum_model(x), "model"), "batch")
    return x if device is None else x.to(device)


def unshard_tree(tree):
    return _map_leaves(unshard, tree)


def roll_agents(x, shifts, dims=None):
    """torch.roll (which a Blocked routes here); over a batch-cut agent
    axis, the ring roll across batch blocks (the blocks' rows in agent
    order, gathered over the batch axis, rolled, cut again)."""
    if isinstance(dims, (tuple, list)):
        if len(dims) != 1:
            raise NotImplementedError("roll over several dims")
        dims = dims[0]
    if isinstance(shifts, (tuple, list)):
        shifts = shifts[0]
    if not isinstance(x, Blocked):
        return torch.roll(x, shifts, dims)
    if dims is None:
        raise NotImplementedError("a flattened roll of a blocked tensor")
    if x.partial:
        raise NotImplementedError("rolling model partials")
    d = dims % x.ndim
    if x.kinds[d] is None:
        return _wrap(x.mesh, x.kinds, x.shape,
                     torch.roll(x.data, shifts, 2 + d))
    if x.kinds[d] != "batch":
        raise NotImplementedError("rolling the cut feature dim")
    return _rolls_of(x, _gather_axis(x.mesh, x.data, "batch"), d,
                     (shifts,))[0]


def _rolls_of(x, whole: torch.Tensor, d: int, shifts) -> list:
    """x rolled by each shift along its batch-cut dim d, from `whole`,
    x's data gathered over the batch axis: the rows of the blocks this
    process holds, each copied from row (i - shift) mod N as torch.roll
    would put it there (no rolled copy of the whole is made)."""
    B = whole.shape[0]
    rows = whole.movedim(0, 1 + d).flatten(1 + d, 2 + d)
    N = rows.shape[1 + d]
    b0, nb = x.mesh.local_range("batch")
    own = torch.arange(b0 * (N // B), (b0 + nb) * (N // B),
                       device=rows.device)
    return [_wrap(x.mesh, x.kinds, x.shape, rows.index_select(
        1 + d, (own - s) % N).unflatten(1 + d, (nb, -1)).movedim(1 + d, 0))
        for s in shifts]


def roll_agents_many(x, shifts) -> list:
    """[torch.roll(x, s, 0) for s in shifts]: the ring's neighbour rolls
    of an agent-stacked leaf. A leaf whose agent dim is cut over the batch
    axis is gathered once for all the shifts (one `gather_ranks` across
    ranks), and each roll taken from that one copy: the rolled rows are
    copies, so every roll has the bits of its own `roll_agents`."""
    if not isinstance(x, Blocked) or x.kinds[0] != "batch":
        return [torch.roll(x, s, 0) for s in shifts]
    if x.partial:
        raise NotImplementedError("rolling model partials")
    return _rolls_of(x, _gather_axis(x.mesh, x.data, "batch"), 0, shifts)


def neighbor_sum(x, idx: torch.Tensor, weights: torch.Tensor):
    """sum_k weights[i, k] x[idx[i, k]] over the agent dim of x, (N,) or
    (N, D): the gossip NeighborTable's gather, with the plain (N, K)
    idx and weights. x is gathered over the batch axes, then each row
    block gathers its own rows' neighbours (feature blocks stay
    block-local) and sums over K by the plain form's `fold_add`, so every
    row is bitwise the plain gather's."""
    if not isinstance(x, Blocked) or x.ndim not in (1, 2):
        raise NotImplementedError(
            "neighbor_sum takes a blocked (N,) or (N, D) tensor")
    if x.partial:
        raise NotImplementedError("gathering model partials")
    xg = all_gather(x, "batch")
    v = xg.data[0] if isinstance(xg, Blocked) else xg[None]   # (M, N, ...)
    N, K = idx.shape
    B = _extent(x.mesh, "batch") if x.kinds[0] == "batch" else 1
    b0, nb = x.mesh.local_range("batch") if B > 1 else (0, 1)
    rows = idx.reshape(B, N // B, K)[b0:b0 + nb]
    g = v[:, rows].movedim(1, 0)                     # (B_loc, M, N/B, K, ...)
    w = weights.reshape(B, 1, N // B, K)[b0:b0 + nb]
    out = fold_add(w * g, -1) if x.ndim == 1 else fold_add(
        w[..., None] * g, -2)
    return _wrap(x.mesh, x.kinds, x.shape, out)


def _matmul(a, b):
    """The dense graph's neighbour sum: A (N, N), plain or row-cut over
    the batch axes, times x (N, ...) whose agent dim may be cut: x is
    gathered over the batch axes, then each row block of A multiplies it
    (feature blocks stay block-local)."""
    if isinstance(a, Blocked) and a.partial or isinstance(b, Blocked) \
            and b.partial:
        raise NotImplementedError("matmul of model partials")
    if isinstance(a, Blocked) and "model" in a.kinds or a.ndim != 2:
        raise NotImplementedError(
            "matmul of blocked tensors other than A (N, N) @ x (N, ...)")
    mesh = (a if isinstance(a, Blocked) else b).mesh
    row_kind = a.kinds[0] if isinstance(a, Blocked) else (
        b.kinds[0] if isinstance(b, Blocked) else None)
    xg = all_gather(b, "batch")
    if isinstance(xg, Blocked):
        xv, rest = xg.data, list(xg.kinds[1:])
    else:
        xv, rest = xg.reshape(1, 1, *xg.shape), [None] * (b.ndim - 1)
    av = _view(a, a.shape, (row_kind, None), mesh)
    kinds = (row_kind, *rest)
    B, M = _lead(mesh, kinds)
    # one product per block: a broadcast batched product would round
    # otherwise than the plain A @ x
    out = torch.stack([av[min(b, av.shape[0] - 1), 0]
                       @ xv[0, min(m, xv.shape[1] - 1)]
                       for b in range(B) for m in range(M)])
    return _wrap(mesh, kinds, (a.shape[0], *b.shape[1:]),
                 out.reshape(B, M, *out.shape[1:]))


def _einsum(eq: str, *ops):
    """A two-operand contraction whose contracted letters may be cut over
    "model": one batched product over this process's stacked blocks
    (`_contract`), then psum_model."""
    if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
        ops = tuple(ops[0])
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    if len(ins) != len(ops):
        raise ValueError(f"einsum {eq!r} takes {len(ins)} operands")
    letter_kind: dict[str, str | None] = {}
    mesh = None
    for sub, op in zip(ins, ops):
        if isinstance(op, Blocked):
            if op.partial:
                raise NotImplementedError("einsum of model partials")
            mesh = op.mesh
            for ch, kind in zip(sub, op.kinds):
                if kind is not None:
                    if letter_kind.get(ch) not in (None, kind):
                        raise NotImplementedError(
                            f"einsum letter {ch!r} cut two ways")
                    letter_kind[ch] = kind
    contracted = [ch for ch in letter_kind if ch not in out]
    if any(letter_kind[ch] == "batch" for ch in contracted):
        raise NotImplementedError("einsum contracting the batch-cut dim")
    partial = any(letter_kind[ch] == "model" for ch in contracted)
    kinds = tuple(letter_kind.get(ch) for ch in out)
    sizes = {}
    for sub, op in zip(ins, ops):
        for ch, s in zip(sub, op.shape):
            sizes[ch] = s
    views = [_view(op, op.shape, tuple(letter_kind.get(ch) for ch in sub),
                   mesh) for sub, op in zip(ins, ops)]
    # one lead for all: einsum broadcasting a lead of 1 against the
    # blocks would copy the other operand (all of Phi), expanding copies
    # only the small one
    lead = (max(v.shape[0] for v in views), max(v.shape[1] for v in views))
    views = [v.expand(*lead, *v.shape[2:]) for v in views]
    y, z = [c for c in "YZABCDEFGHIJKLMNOPQRSTUVWX" if c not in eq][:2]
    res = _contract([y + z + sub for sub in ins], y + z + out, views)
    return psum_model(_wrap(mesh, kinds, [sizes[ch] for ch in out], res,
                            partial))


def _contract(subs: list[str], out: str, views) -> torch.Tensor:
    """A two-operand einsum. Where every letter both operands hold has
    size > 1, torch.einsum itself. Where one has size 1 (a rank holding
    one batch block), the batched product torch.einsum makes when it has
    not, over the flattened letters: (batch, left-only, summed) @ (batch,
    summed, right-only). torch.einsum would treat the size-1 letter as
    right-only, which changes the order its product sums in; so a rank
    holding one block rounds as a process holding several."""
    (sa, a), (sb, b) = zip(subs, views)
    if all(a.shape[sa.index(c)] > 1 and b.shape[sb.index(c)] > 1
           for c in sa if c in sb):
        return torch.einsum(f"{sa},{sb}->{out}", a, b)
    batch = [c for c in out if c in sa and c in sb]
    lo = [c for c in out if c in sa and c not in sb]
    ro = [c for c in out if c in sb and c not in sa]
    summed = [c for c in sa if c in sb and c not in out]
    for s, v in ((sa, a), (sb, b)):
        extra = [c for c in s if c not in out and c not in summed]
        if extra or len(set(s)) != len(s):
            raise NotImplementedError(
                f"einsum {','.join(subs)}->{out} on blocked tensors")
    size: dict[str, int] = {}
    for c, k in list(zip(sa, a.shape)) + list(zip(sb, b.shape)):
        size[c] = max(size.get(c, 1), k)
    # a letter of size 1 in one operand broadcasts, as in torch.einsum
    a = a.expand(*(size[c] for c in sa))
    b = b.expand(*(size[c] for c in sb))
    n = [math.prod(size[c] for c in g) for g in (batch, lo, summed, ro)]
    am = a.permute(*(sa.index(c) for c in batch + lo + summed)) \
        .reshape(n[0], n[1], n[2])
    bm = b.permute(*(sb.index(c) for c in batch + summed + ro)) \
        .reshape(n[0], n[2], n[3])
    res = torch.bmm(am, bm).reshape(*(size[c] for c in batch + lo + ro))
    order = batch + lo + ro
    return res.permute(*(order.index(c) for c in out))


def _stack(tensors, dim=0):
    """torch.stack of equally laid-out blocked tensors along a new
    leading (uncut) dim."""
    tensors = list(tensors)
    first = tensors[0]
    if dim != 0 or not all(isinstance(t, Blocked) and t.spec == first.spec
                           and not t.partial for t in tensors):
        raise NotImplementedError("torch.stack of blocked tensors other "
                                  "than equal layouts along dim 0")
    return _wrap(first.mesh, (None, *first.kinds),
                 (len(tensors), *first.shape),
                 torch.stack([t.data for t in tensors], dim=2))


def _cat(tensors, dim=0):
    """torch.cat of equally laid-out blocked tensors along an uncut dim."""
    tensors = list(tensors)
    first = tensors[0]
    d = dim % first.ndim
    if first.kinds[d] is not None or not all(
            isinstance(t, Blocked) and t.kinds == first.kinds
            and not t.partial for t in tensors):
        raise NotImplementedError("torch.cat of blocked tensors other "
                                  "than equal layouts along an uncut dim")
    shape = list(first.shape)
    shape[d] = sum(t.shape[d] for t in tensors)
    return _wrap(first.mesh, first.kinds, shape,
                 torch.cat([t.data for t in tensors], dim=2 + d))


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def shard(x: torch.Tensor, mesh, spec) -> Any:
    """Cut `x` into the blocks of `spec` over `mesh`, this process's
    blocks stacked in one contiguous tensor on its device (no copy where
    x already is that stack, as a batch-only cut of a contiguous tensor
    on a one-process mesh is). A spec that cuts nothing gives `x` itself
    on the device; a Blocked already in this layout on this mesh is
    returned as it is (so a problem sharded once can be passed to several
    `fit(mesh=)` calls). Across ranks every rank is given the whole `x`
    (built from the same seed, or gathered) and keeps a copy of its own
    blocks only: the whole value lives on the rank only while it is
    placed, and moves to the device only as those blocks."""
    kinds = tuple(_kind(mesh, e) for e in P(*spec))
    if isinstance(x, Blocked):
        if x.mesh is mesh and x.kinds == kinds and not x.partial:
            return x              # already laid out so: no copy
        x = unshard(x)
    if len(kinds) != x.ndim:
        raise ValueError(f"spec {P(*spec)} does not fit shape "
                         f"{tuple(x.shape)}")
    for d, kind in enumerate(kinds):
        if kind is not None and x.shape[d] % _extent(mesh, kind):
            raise ValueError(
                f"dim {d} of size {x.shape[d]} does not divide over the "
                f"{_extent(mesh, kind)} blocks of {kind!r}")
    dev = mesh_device(mesh)
    if not mesh.ranked:
        x = x.to(dev)
        return _wrap(mesh, kinds, x.shape, _view(x, x.shape, kinds, mesh))
    data = _view(x, x.shape, kinds, mesh).to(dev).contiguous()
    if data.untyped_storage().nbytes() > data.nbytes:
        data = data.clone()          # a view would keep the whole x alive
    return _wrap(mesh, kinds, x.shape, data)


def shard_features(tree, mesh, num_agents: int):
    """Place every array leaf of an agent-stacked tree (a carry, a state,
    params) with its `feature_spec` layout; other leaves pass unchanged."""
    return _map_leaves(lambda leaf: shard(
        leaf, mesh, feature_spec(tuple(leaf.shape), mesh, num_agents)),
        tree)


def problem_specs(problem, mesh) -> tuple[P, P, P]:
    """(feats, labels, adjacency) specs of `shard_problem`: feats (N, T,
    D) carry the feature dim on "model" and the agent dim on the batch
    axes; labels and adjacency shard only the agent dim (their trailing
    dims are samples and agents, not features)."""
    ba = batch_axes(mesh)
    lead = _div(problem.num_agents, mesh, ba) if ba else None
    feat = _div(problem.feature_dim, mesh, "model") \
        if "model" in mesh.axis_names else None
    return P(lead, None, feat), P(lead, None), P(lead, None)


def shard_problem(problem, mesh):
    """Feature-shard a `core.admm.Problem` (or a StreamProblem-like
    dataclass with feats / labels / adjacency)."""
    fs, ls, adjs = problem_specs(problem, mesh)
    return dataclasses.replace(
        problem, feats=shard(problem.feats, mesh, fs),
        labels=shard(problem.labels, mesh, ls),
        adjacency=shard(problem.adjacency, mesh, adjs))


def shard_theta_stack(stack: torch.Tensor, mesh):
    """Place an (M, D) theta stack with its serving layout."""
    return shard(stack, mesh, theta_stack_spec(tuple(stack.shape), mesh))


def blockwise(fn: Callable, *xs, out, partial=False, mesh=None,
              index: bool = False):
    """fn over aligned blocks. For every (batch block, model block) of
    the layout the operands and results cut together that this process
    holds, fn gets each Blocked operand's block for that cell and every
    other argument as it is (with index=True, the cell's global (b, m)
    first). `out` is the spec of
    the result (a tuple of specs when fn returns a tuple); `partial` (a
    bool, or one per output) marks results that are per-model-block
    partials, summed by `psum_model` into `out`. A result's full shape is
    its block's shape times the cut extents. `mesh` is needed only when
    no operand is blocked."""
    blocked = [x for x in xs if isinstance(x, Blocked)]
    mesh = blocked[0].mesh if blocked else mesh
    single = not isinstance(out, tuple) or isinstance(out, P)
    specs = (out,) if single else out
    partials = (partial,) * len(specs) if isinstance(partial, bool) \
        else tuple(partial)
    union = set()
    for x in blocked:
        union |= set(x.kinds)
    for spec in specs:
        union |= {_kind(mesh, e) for e in P(*spec)}
    B, M = _lead(mesh, union, any(partials) and "model" in union)
    b0 = mesh.local_range("batch")[0] if "batch" in union else 0
    m0 = mesh.local_range("model")[0] if "model" in union else 0
    results = []
    for b in range(b0, b0 + B):
        for m in range(m0, m0 + M):
            args = [x.block(b, m) if isinstance(x, Blocked) else x
                    for x in xs]
            results.append(fn((b, m), *args) if index else fn(*args))
    wrapped = []
    for j, (spec, part) in enumerate(zip(specs, partials)):
        kinds = tuple(_kind(mesh, e) for e in P(*spec))
        outs = [r if single else r[j] for r in results]
        blk = outs[0].shape
        data = outs[0].reshape(1, 1, *blk) if len(outs) == 1 else \
            torch.stack(outs).reshape(B, M, *blk)
        part = part and "model" in union
        if "batch" not in kinds:            # replicas: one is kept
            data = data[:1]
        if "model" not in kinds and not part:
            data = data[:, :1]
        shape = [s * _extent(mesh, k) if k else s
                 for s, k in zip(blk, kinds)]
        wrapped.append(psum_model(_wrap(mesh, kinds, shape, data,
                                        partial=part)))
    return wrapped[0] if single else tuple(wrapped)


def local(fn: Callable, *xs):
    """fn on plain operands as they are, or once on the stacked blocks of
    Blocked operands of one layout: for an fn that maps each block to the
    same block of its result (elementwise, or reducing nothing that is
    cut), such as a loss derivative by autograd, which cannot run on a
    Blocked."""
    blocked = [x for x in xs if isinstance(x, Blocked)]
    if not blocked:
        return fn(*xs)
    first = blocked[0]
    if any(x.partial or x.kinds != first.kinds or x.shape != first.shape
           for x in blocked) or any(isinstance(x, torch.Tensor)
                                    for x in xs):
        raise NotImplementedError(
            "local() takes Blocked operands of one layout")
    return _wrap(first.mesh, first.kinds, first.shape,
                 fn(*(x.data if isinstance(x, Blocked) else x for x in xs)))


def spec_of(x, *dims) -> P:
    """The spec entries of x's dims `dims` (None for a None entry, and
    for every dim of a plain tensor): the layout of a result built from
    those dims of x, for `blockwise`."""
    spec = x.spec if isinstance(x, Blocked) else None
    return P(*(spec[d] if spec is not None and d is not None else None
               for d in dims))


def recut(x, like):
    """x (of like's shape) laid out as `like`: the dims that `like` cuts
    and x holds whole are cut; x's own cuts must agree. x itself where
    like is a plain tensor."""
    if not isinstance(like, Blocked):
        return x
    v = _view(x, like.shape, like.kinds, like.mesh)
    return _wrap(like.mesh, like.kinds, like.shape,
                 v.expand(*like.data.shape[:2], *v.shape[2:]))


def rows_like(t, like):
    """A plain per-agent tensor (N, ...) cut to the batch blocks of
    `like`'s agent dim (itself when that dim is uncut)."""
    if isinstance(t, Blocked) or not isinstance(like, Blocked) \
            or like.kinds[0] != "batch":
        return t
    return shard(t, like.mesh, P(like.spec[0], *([None] * (t.ndim - 1))))


def with_rows(x, index, rows):
    """A copy of x with rows `index` of its uncut leading dim set to
    `rows` — an int index and a row, or a long index tensor and (k, ...)
    rows — cut as x is: the copy on write of a serving stack."""
    if not isinstance(x, Blocked):
        out = x.clone()
        out[index] = rows
        return out
    if x.kinds[0] is not None:
        raise NotImplementedError("writing rows of a cut dim")
    data = x.data.clone()
    if isinstance(index, int):
        v = _view(rows, x.shape[1:], x.kinds[1:], x.mesh)
    else:
        v = _view(rows, (len(index), *x.shape[1:]), x.kinds, x.mesh)
    data[:, :, index] = v
    return _wrap(x.mesh, x.kinds, x.shape, data)


def block_index(x: Blocked, dim: int, b: int, m: int) -> slice:
    """The range of dim `dim` of `x` that block (b, m) holds."""
    kind = x.kinds[dim]
    if kind is None:
        return slice(None)
    return _block_range(x.shape[dim], _extent(x.mesh, kind),
                        b if kind == "batch" else m)


def local_block(x, b: int = 0, m: int = 0):
    """Block (b, m) of x, by global index, for tests and probes: a
    KeyError where this process does not hold it."""
    if not isinstance(x, Blocked):
        return x
    B, M = x.data.shape[:2]
    b0, m0 = x._origin()
    if not (b0 <= b < b0 + B and m0 <= m < m0 + M):
        raise KeyError((b, m))
    return x.data[b - b0, m - m0]


# ---------------------------------------------------------------------------
# Agent-stacked deep-net trees (the trainer's agents on their own ranks)
# ---------------------------------------------------------------------------

def _check_agent_mesh(mesh, num_agents: int) -> int:
    """The batch extent B of a mesh that cuts an N-agent stack over its
    batch axes and nothing over "model": B divides N (N / B agents a
    batch block). NotImplementedError where "model" has extent > 1."""
    if _extent(mesh, "model") > 1:
        raise NotImplementedError(
            "an agent stack on a mesh whose 'model' extent is "
            f"{_extent(mesh, 'model')}: an agent's layers cut over 'model' "
            "(tensor parallelism) is ROADMAP.md Queue 1 item 14f")
    B = _extent(mesh, "batch")
    if num_agents % B:
        raise ValueError(f"{num_agents} agents do not divide over the "
                         f"{B} batch blocks of the mesh")
    return B


def agent_stack_spec(shape: tuple[int, ...], mesh, num_agents: int) -> P:
    """The reference's `_agent_stack_specs` (`launch/dryrun.py:45-67`)
    for one leaf of an agent-stacked train state on a mesh whose "model"
    extent is 1: the leading agent dim over the batch axes where the leaf
    has one (leading dim N), every other dim and every other leaf
    replicated (the param rules' "model" entries cut nothing at extent 1,
    and fsdp is off, as there)."""
    _check_agent_mesh(mesh, num_agents)
    ndim = len(shape)
    if ndim and shape[0] == num_agents:
        return P(_entry(mesh, "batch"), *([None] * (ndim - 1)))
    return P(*([None] * ndim))


def agent_range(mesh, num_agents: int) -> range:
    """The global indices of the agents this process holds: the rows of
    its batch blocks, in agent order."""
    n = num_agents // _check_agent_mesh(mesh, num_agents)
    b0, nb = mesh.local_range("batch")
    return range(b0 * n, (b0 + nb) * n)


def from_rows(rows: torch.Tensor, mesh, num_agents: int):
    """An agent-stacked (N, ...) leaf cut by `agent_stack_spec`, built
    from this process's rows only: `rows` (len(agent_range), ...) holds
    its agents in agent order. No process makes the whole stack, where
    `shard` cuts a whole tensor. On a mesh with one batch block the leaf
    is the plain tensor itself."""
    own = agent_range(mesh, num_agents)
    if rows.shape[0] != len(own):
        raise ValueError(f"{rows.shape[0]} rows for the {len(own)} agents "
                         "this process holds")
    shape = (num_agents, *rows.shape[1:])
    kinds = tuple(_kind(mesh, e) for e in agent_stack_spec(
        shape, mesh, num_agents))
    if _extent(mesh, "batch") == 1:
        kinds = (None,) * rows.ndim
    nb = mesh.local_range("batch")[1] if kinds[0] else 1
    data = rows.to(mesh_device(mesh)).reshape(
        nb, 1, rows.shape[0] // nb, *rows.shape[1:])
    return _wrap(mesh, kinds, shape, data)


def agent_row(x, i: int) -> torch.Tensor:
    """Row i (a global agent index) of an agent-stacked leaf, as a view:
    of a plain tensor x[i]; of one cut over the batch axes the row in the
    block that holds it, a KeyError where this process does not (indexing
    a Blocked by [i] would gather it)."""
    if not isinstance(x, Blocked):
        return x[i]
    if x.partial or x.kinds[0] != "batch" or any(x.kinds[1:]):
        raise NotImplementedError(
            "agent_row reads a leaf cut over the batch axes only")
    n = x.shape[0] // _extent(x.mesh, "batch")
    return x.block(i // n)[i % n]
