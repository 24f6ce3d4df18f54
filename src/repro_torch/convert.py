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
        port._dirty = dirty
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


def lm_params_from_numpy(cfg: ModelConfig, params: dict, *,
                         device: torch.device | str | None = None) -> LM:
    """The port's model with the reference's weights: `params` is the
    reference's `models.model.init_params` pytree as numpy arrays, whose
    blocks are stacked along a leading layer axis. Every leaf must find its
    place in the port's module, and every weight of the module must be
    given (`load_state_dict(strict=True)`)."""
    state = {}
    for path, arr in _leaves(params):
        arr = np.asarray(arr)
        if path.startswith("blocks."):
            rest = path[len("blocks."):]
            for i in range(arr.shape[0]):
                state[f"blocks.{i}.{rest}"] = torch.tensor(arr[i])
        else:
            state[path] = torch.tensor(arr)
    model = LM(cfg, device=resolve_device(device))
    model.load_state_dict(state, strict=True)
    return model
