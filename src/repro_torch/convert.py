"""Carry the reference's arrays into the port.

A port draw of the random features at a seed does not equal the
reference's `jax.random` draw, so a problem or a model moves between the
two packages by its arrays: these helpers take numpy arrays (from the JAX
package, `np.asarray(...)`) and build the port's objects on a device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.model import KernelModel, model_from_arrays
from repro_torch.api.problems import StreamProblem
from repro_torch.core.admm import Problem
from repro_torch.core.graph import TopologySchedule
from repro_torch.core.rff import RFFParams
from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import LM
from repro_torch.serve.theta_store import ThetaStore


def rff_params_from_numpy(omega, bias, mapping: str = "cos_bias", *,
                          device: torch.device | str | None = None
                          ) -> RFFParams:
    dev = resolve_device(device)
    return RFFParams(omega=torch.tensor(np.asarray(omega), device=dev),
                     bias=torch.tensor(np.asarray(bias), device=dev),
                     mapping=mapping)


def problem_from_numpy(feats, labels, adjacency, lam: float, rho: float,
                       loss: str = "quadratic",
                       device: torch.device | str | None = None) -> Problem:
    dev = resolve_device(device)
    feats = torch.tensor(np.asarray(feats), device=dev)
    return Problem(
        feats=feats,
        labels=torch.tensor(np.asarray(labels), device=dev),
        adjacency=torch.tensor(np.asarray(adjacency), dtype=feats.dtype,
                               device=dev),
        lam=float(lam), rho=float(rho), loss=loss)


def stream_from_numpy(feats, labels, adjacency, lam: float, rho: float, *,
                      device: torch.device | str | None = None
                      ) -> StreamProblem:
    """The port's StreamProblem from the reference's featurized stream:
    feats (R, N, b, D), labels (R, N, b), adjacency (N, N)."""
    dev = resolve_device(device)
    feats = torch.tensor(np.asarray(feats), device=dev)
    return StreamProblem(
        feats=feats, labels=torch.tensor(np.asarray(labels), device=dev),
        adjacency=torch.tensor(np.asarray(adjacency), dtype=feats.dtype,
                               device=dev),
        lam=float(lam), rho=float(rho))


def topology_from_reference(adjacencies, offsets=None, *,
                            device: torch.device | str | None = None
                            ) -> TopologySchedule:
    """The port's schedule from the reference's (M, N, N) adjacency stack
    (`np.asarray(schedule.adjacencies)`) and its `offsets`."""
    return TopologySchedule(
        adjacencies=torch.tensor(np.asarray(adjacencies, np.float32),
                                 device=resolve_device(device)),
        offsets=offsets)


def model_from_numpy(arrays: dict, sidecar: dict | None = None, *,
                     device: torch.device | str | None = None
                     ) -> KernelModel:
    """`arrays` uses the reference's `KernelModel._array_tree()` names
    (omega, bias, theta, optional thetas); `sidecar` the saved sidecar's
    keys (mapping, bandwidth, kernel, meta, ...)."""
    return model_from_arrays({k: np.asarray(v) for k, v in arrays.items()},
                             sidecar or {}, resolve_device(device))


def theta_store_from_reference(store, *,
                               device: torch.device | str | None = None
                               ) -> ThetaStore:
    """The port's ThetaStore in the state of a reference `ThetaStore`
    (read under its lock, as numpy): the whole stack, each resident id in
    LRU order with its slot, the free list, the versions, the dirty set,
    the pins and the counters, so that the same operations then act the
    same on both. The fault and writeback handlers are not carried: attach
    the port's own."""
    with store._lock:
        stack = np.array(store.stack, copy=True)
        slots = list(store._slots.items())
        free = list(store._free)
        versions = dict(store._versions)
        dirty = set(store._dirty)
        pins = dict(store._pins)
        stats = dict(store._stats)
    port = ThetaStore(store.capacity, store.num_features, device=device)
    with port._lock:
        port._stack = torch.tensor(stack, device=port.device)
        port._slots.update(slots)
        port._free = free
        port._versions = versions
        port._dirty_rows = {m: port._stack[dict(slots)[m]].to(
            "cpu", copy=True) for m in dirty}
        port._pins = pins
        port._stats = stats
    return port


def _leaves(tree, prefix: str = ""):
    """(dotted path, array) for every leaf of a nested dict."""
    for name, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", val


# the reference's layer stacks: leaves stacked along a leading layer axis
# (a hybrid's blocks along two, groups then layers)
_STACKS = ("blocks", "encoder", "decoder")


def lm_params_from_numpy(cfg: ModelConfig, params: dict, *,
                         device: torch.device | str | None = None) -> LM:
    """The port's model with the reference's weights: `params` is the
    reference's `models.model.init_params` pytree as numpy arrays, whose
    blocks (an enc-dec model's encoder and decoder) are stacked along a
    leading layer axis, or in a hybrid along two, (groups,
    shared_attn_every), beside its `shared_attn` block. Every leaf must
    find its place in the port's module, and every weight of the module
    must be given (`load_state_dict(strict=True)`)."""
    state = {}
    for path, arr in _leaves(params):
        arr = np.asarray(arr)
        top, _, rest = path.partition(".")
        if top in _STACKS:
            lead = 2 if top == "blocks" and cfg.arch_type == "hybrid" else 1
            for idx in np.ndindex(arr.shape[:lead]):
                where = ".".join(map(str, idx))
                state[f"{top}.{where}.{rest}"] = torch.tensor(arr[idx])
        else:
            state[path] = torch.tensor(arr)
    model = LM(cfg, device=resolve_device(device))
    model.load_state_dict(state, strict=True)
    return model


def lm_params_to_numpy(params) -> dict:
    """The inverse of `lm_params_from_numpy`: the reference's parameter tree
    as numpy arrays, blocks, encoder and decoder stacked along a leading
    layer axis (a hybrid's blocks.g.e along two, groups then layers).
    `params` is an `LM` or a dict of tensors by parameter name
    (`models.model.param_dict`), optionally agent-stacked (N, ...) as the
    consensus strategies' state is; then every leaf keeps the agent axis
    first and the stacks follow it, the reference's layout."""
    if isinstance(params, LM):
        params = {n: p.detach() for n, p in params.named_parameters()}
    agents = params["embed"].ndim == 3
    tree: dict = {}
    layers: dict[tuple[str, str], list] = {}
    for name, t in params.items():
        arr = t.detach().cpu().numpy()
        parts = name.split(".")
        if parts[0] in _STACKS:
            lead = 2 if parts[2].isdigit() else 1
            idx = tuple(int(p) for p in parts[1:1 + lead])
            layers.setdefault((parts[0], ".".join(parts[1 + lead:])),
                              []).append((idx, arr))
        else:
            tree[name] = arr
    for (top, rest), items in layers.items():
        items.sort(key=lambda x: x[0])
        grid = tuple(n + 1 for n in items[-1][0])
        axis = 1 if agents else 0
        stacked = np.stack([a for _, a in items], axis=axis)
        stacked = stacked.reshape(*stacked.shape[:axis], *grid,
                                  *stacked.shape[axis + 1:])
        node = tree.setdefault(top, {})
        *path, leaf = rest.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = stacked
    # nested names (shared_attn.attn.wq) become nested dicts, as blocks'
    for name in [n for n in tree if "." in n]:
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = tree.pop(name)
    return tree
