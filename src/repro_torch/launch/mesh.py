"""Device meshes for the big-D path (the reference's `launch/mesh.py`).

A `Mesh` names its axes and holds one `torch.device` per cell. The batch
axes ("pod", "data") jointly carry the consensus-agent (or request-row)
dimension, the "model" axis the feature dimension
(`distributed.sharding`). Cells may share a device: on one card a
(data=2, model=4) mesh is eight cells on that card, a layout of the
tensors into blocks rather than a way to hold more of them.

The reference's `make_production_mesh` (256 or 512 TPU chips for its
dry run) has no counterpart here: the dry run that lowers XLA programs
against those meshes is out of scope for the port (ROADMAP.md, "Out of
scope").
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device


def _concrete(dev: torch.device) -> torch.device:
    """"cuda" -> "cuda:<current>", so that cells and tensors compare."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Named axes over a grid of devices: `shape` maps each axis name to
    its extent (in axis order, as the reference's `mesh.shape`), `devices`
    is the numpy object array of `torch.device`s of that shape."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        grid = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = _concrete(torch.device(np.asarray(
                devices, dtype=object)[idx]))
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid needs "
                             f"{grid.ndim} axis names, got {axis_names}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(n) for a, n in zip(self.axis_names,
                                                grid.shape)}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> list[torch.device]:
        out: list[torch.device] = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device: torch.device | str | None = None,
                   devices=None) -> Mesh:
    """A ("data", "model") mesh of data x model cells. By default every
    cell is `resolve_device(device)`: the card ("cuda", which raises
    without one unless device="cpu" is asked for). `devices` gives the
    cells' devices explicitly: a (data, model) grid, or a flat list of
    data * model devices in row-major order."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh extents must be >= 1, got ({data}, "
                         f"{model})")
    if devices is None:
        dev = resolve_device(device)
        grid = np.empty((data, model), dtype=object)
        grid.fill(dev)
    else:
        flat = list(np.asarray(devices, dtype=object).flat)
        if len(flat) != data * model:
            raise ValueError(f"a ({data}, {model}) mesh needs "
                             f"{data * model} devices, got {len(flat)}")
        for d in flat:
            resolve_device(d)
        grid = np.empty((data, model), dtype=object)
        for i, d in enumerate(flat):
            grid[i // model, i % model] = d
    return Mesh(grid, ("data", "model"))


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that jointly shard the batch / consensus-agent dimension."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def num_agents(mesh) -> int:
    """Number of consensus agents = product of batch axes."""
    return math.prod(mesh.shape[a] for a in batch_axes(mesh))
