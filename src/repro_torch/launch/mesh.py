"""Device meshes for the big-D path (the reference's `launch/mesh.py`).

A `Mesh` names its axes and holds one `torch.device` per cell. The batch
axes ("pod", "data") jointly carry the consensus-agent (or request-row)
dimension, the "model" axis the feature dimension
(`distributed.sharding`). Cells may share a device: on one card a
(data=2, model=4) mesh is eight cells on that card, a layout of the
tensors into blocks rather than a way to hold more of them.

A mesh across ranks. With `group=` (a `torch.distributed` process group
holding every process of the default group) the cells are owned by the
group's W ranks: the (batch, model) grid of cells, the batch axes
flattened in row-major order, is cut into W = w_b x w_m rectangular
sub-grids, one per rank in row-major order over (batch, model). Each rank
holds only its own cells' blocks (`distributed.sharding`); `ranks` is the
grid of owners beside `devices`. The sub-groups along each axis (the w_m
ranks of one batch row, the w_b ranks of one model column) are made once,
here, with `dist.new_group`, in the same order on every rank: new_group
is collective over the default group, so every process builds the mesh
(SPMD). A process drives one card: its own cells lie on one device, where
JAX drives several devices from one process. The backend is the caller's
`init_process_group`; the layout calls only `all_gather` on these groups
(and, where every rank drives one same card, `card_shared`, passes CUDA
IPC handles through them: `distributed.sharding.gather_ranks`).
W = 1, or no group, is the one-process layout.

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


def _split_of(world: int, B: int, M: int, split) -> tuple[int, int]:
    """(w_b, w_m): the rank grid over a (B, M) grid of cells. The given
    split, else the one that cuts the batch blocks most (agent rows are
    independent between exchanges, so a batch cut needs fewer
    collectives than a feature cut)."""
    if split is not None:
        w_b, w_m = (int(s) for s in split)
        if w_b * w_m != world or B % w_b or M % w_m:
            raise ValueError(
                f"split {tuple(split)} does not cut a ({B}, {M}) grid of "
                f"cells into {world} equal rectangles")
        return w_b, w_m
    for w_b in sorted((d for d in range(1, world + 1) if world % d == 0),
                      reverse=True):
        if B % w_b == 0 and M % (world // w_b) == 0:
            return w_b, world // w_b
    raise ValueError(
        f"{world} ranks do not cut a ({B}, {M}) grid of cells into equal "
        "rectangles (w_b x w_m = W with w_b | B and w_m | M)")


class Mesh:
    """Named axes over a grid of devices: `shape` maps each axis name to
    its extent (in axis order, as the reference's `mesh.shape`), `devices`
    is the numpy object array of `torch.device`s of that shape, `ranks`
    the owner of each cell (all 0 without a group).

    group / split — see the module docstring: the process group whose
    ranks own the cells and the (w_b, w_m) rank grid (None: the split that
    cuts the batch blocks most)."""

    def __init__(self, devices, axis_names: tuple[str, ...], *, group=None,
                 split=None):
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
        B = math.prod(self.shape[a] for a in batch_axes(self))
        M = self.shape.get("model", 1)
        self.group, self.rank, self.world = group, 0, 1
        self.split = (1, 1)
        self._groups: dict[str, object] = {}
        if group is not None:
            import torch.distributed as dist
            if not dist.is_available() or not dist.is_initialized():
                raise ValueError(
                    "group= needs an initialized process group "
                    "(torch.distributed.init_process_group)")
            self.world = dist.get_world_size(group)
            if self.world != dist.get_world_size():
                raise ValueError(
                    f"a mesh's group must hold every process of the default "
                    f"group (dist.new_group is collective over it): "
                    f"{self.world} of {dist.get_world_size()}")
            self.rank = dist.get_rank(group)
            self.split = _split_of(self.world, B, M, split)
            w_b, w_m = self.split
            # every sub-group, in one order on every rank; a sub-group of
            # one rank moves nothing and is not made
            for rb in range(w_b if w_m > 1 else 0):
                g = dist.new_group([rb * w_m + rm for rm in range(w_m)])
                if rb == self.rank // w_m:
                    self._groups["model"] = g
            for rm in range(w_m if w_b > 1 else 0):
                g = dist.new_group([rb * w_m + rm for rb in range(w_b)])
                if rm == self.rank % w_m:
                    self._groups["batch"] = g
        elif split is not None and tuple(split) != (1, 1):
            raise ValueError(f"split {tuple(split)} without a group")
        w_b, w_m = self.split
        rb, rm = divmod(self.rank, w_m)
        self._range = {"batch": (rb * (B // w_b), B // w_b),
                       "model": (rm * (M // w_m), M // w_m)}
        self.ranks = np.empty(grid.shape, dtype=np.int64)
        for idx in np.ndindex(grid.shape):
            b, m = self.cell_index(idx)
            self.ranks[idx] = (b // (B // w_b)) * w_m + m // (M // w_m)
        own = self.distinct_devices()
        if len(own) != 1:
            raise ValueError(
                f"this process's cells lie on {len(own)} devices {own}: a "
                "mesh runs one process per card (give each card its own "
                "rank: make_host_mesh(..., group=))")
        # whether every rank drives one same card: there the layout's
        # large gathers go by CUDA IPC (`sharding.gather_ranks`)
        self.card_shared = False
        if group is not None and own[0].type == "cuda":
            import torch.distributed as dist
            ids = [None] * self.world
            dist.all_gather_object(ids, str(torch.cuda.get_device_properties(
                own[0]).uuid), group=group)
            self.card_shared = len(set(ids)) == 1

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def ranked(self) -> bool:
        """Whether the cells are spread over more than one rank."""
        return self.world > 1

    def cell_index(self, idx: tuple[int, ...]) -> tuple[int, int]:
        """A grid index -> (batch block, model block): the batch axes
        flattened in row-major order."""
        ba = batch_axes(self)
        b = 0
        for a in ba:
            b = b * self.shape[a] + idx[self.axis_names.index(a)]
        m = idx[self.axis_names.index("model")] \
            if "model" in self.axis_names else 0
        return b, m

    def local_range(self, kind: str) -> tuple[int, int]:
        """(first block, count) of this rank's blocks along "batch" (the
        batch axes jointly) or "model"."""
        return self._range[kind]

    def local_cells(self) -> list[tuple[int, int]]:
        """This rank's cells as (batch block, model block), row-major."""
        (b0, nb), (m0, nm) = self._range["batch"], self._range["model"]
        return [(b, m) for b in range(b0, b0 + nb)
                for m in range(m0, m0 + nm)]

    def axis_group(self, kind: str):
        """(process group, its size) of this rank's peers along "batch"
        (same model blocks, the other batch blocks) or "model": (None, 1)
        where the axis is not split over ranks."""
        g = self._groups.get(kind)
        w_b, w_m = self.split
        return (g, w_b if kind == "batch" else w_m) if g is not None \
            else (None, 1)

    def distinct_devices(self) -> list[torch.device]:
        """The devices of this process's own cells (every cell's without
        a group): one, since a process drives one card."""
        out: list[torch.device] = []
        for idx in np.ndindex(self.devices.shape):
            d = self.devices[idx]
            if self.ranks[idx] == self.rank and d not in out:
                out.append(d)
        return out


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device: torch.device | str | None = None,
                   devices=None, group=None, split=None) -> Mesh:
    """A ("data", "model") mesh of data x model cells. By default every
    cell is `resolve_device(device)`: the card ("cuda", which raises
    without one unless device="cpu" is asked for). `devices` gives the
    cells' devices explicitly: a (data, model) grid, or a flat list of
    data * model devices in row-major order.

    group — a process group of W ranks (see the module docstring): every
    rank calls this with the same extents and its own `device`
    ("cuda:<local rank>" on several cards, "cuda:0" where ranks share
    one, "cpu" in the tests). The grid holds that device in every cell:
    a rank reads only its own cells' devices, never a peer's.
    split — the (w_b, w_m) rank grid; ValueError where W ranks cannot
    cut the cells into equal rectangles."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh extents must be >= 1, got ({data}, "
                         f"{model})")
    if devices is None:
        dev = _concrete(resolve_device(device))
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
    return Mesh(grid, ("data", "model"), group=group, split=split)


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that jointly shard the batch / consensus-agent dimension."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def num_agents(mesh) -> int:
    """Number of consensus agents = product of batch axes."""
    return math.prod(mesh.shape[a] for a in batch_axes(mesh))
