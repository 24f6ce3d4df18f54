"""`ThetaStore` — the on-device paged home of thousands of resident models.

The random-feature construction makes every fitted model a (D,) theta
sharing one featurizer, so "thousands of models resident" is ONE (M, D)
tensor on the device. The store manages it like a page table:

  - slot allocation from a free list, then LRU eviction of unpinned slots
    (eviction pages the model back to the registry via `writeback` iff the
    resident theta is dirty, i.e. newer than any published version);
  - faulting: `ensure(id)` on a miss calls `fault(id) -> (theta, version)`
    (the registry load, wired up by `KernelServer`) and installs the
    result; disk I/O happens on the calling (collector) thread, never
    inside a device call;
  - pinned slots: `pin`/`unpin` refcounts protect in-flight work, so an
    eviction never reuses a slot some queued bucket still indexes;
  - atomic snapshots: `lookup_batch(ids)` resolves every id (faulting and
    pinning as it goes, so an id faulted late in the batch cannot evict
    one resolved early) and returns (stack, slots) captured under one
    lock.

Copy on write. The reference's snapshots are torn-proof because jax
arrays are immutable. Torch tensors are not, so no write ever touches the
live stack: `put` and `put_many` copy the whole stack, write the copy and
rebind `self._stack` under the lock. A snapshot returned by `lookup_batch`
keeps the old tensor alive and unchanged, and a concurrent put is either
entirely visible or entirely invisible to it. The price is one copy of
the stack per put, as in the reference (its jitted `stack.at[slot].set`
is not donated); it is off the scoring path. Every copy is made on the
current stream of the writing thread, which for every thread of a server
is the device's default stream, so a snapshot's memory is never reused
under a kernel still reading it.

On a mesh (`mesh=`) the stack is laid out by `theta_stack_spec`: the
slot axis whole, the feature dim cut over the mesh's "model" axis into
contiguous (M, D/s) column blocks (`distributed.sharding.Blocked`), the
blocks K6 reads. `put` / `put_many` copy on write block by block: every
block is copied, written and the new blocks rebound together, so a
snapshot's blocks never change either.

On a mesh across ranks (`make_host_mesh(..., group=)`) the store is SPMD:
every rank builds it with the same arguments and calls `put`, `put_many`,
`evict`, `ensure` and `lookup_batch` with the same arguments in the same
order, and each writes only the column blocks of its own cells, so every
rank holds the same slots, LRU order, versions and counters.
`KernelServer` on such a mesh keeps that order for its own calls. No
store operation makes a collective: thetas come in whole (a blocked
theta across ranks is refused), and a copy of a dirty row's whole theta
is kept from its `put`, which is what a dirty eviction writes back
(always the same bits as the row, which arrived whole; on one process
too). The copy is made where the caller's theta lies, before the write
and outside the lock: on the host across ranks, whose commands carry
numpy, so no put waits for the card.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding

# The stack is fp32: K6 and the shared scorer take nothing else.
STACK_DTYPE = torch.float32


def check_mesh(mesh, device: torch.device, what: str) -> None:
    """Every cell of a serving mesh that this process holds lies on the
    serving device."""
    if mesh is None:
        return
    for d in mesh.distinct_devices():
        if d.type != device.type or (device.index is not None
                                     and d.index != device.index):
            raise ValueError(
                f"{what}: the mesh has a cell on {d}, the store or server "
                f"runs on {device}")


def write_rows(stack, slots: list[int], thetas: torch.Tensor):
    """A copy of `stack` with rows `slots` set to `thetas` (k, D); on a
    mesh every column block is copied and written with its columns."""
    if len(slots) == 1:
        return sharding.with_rows(stack, slots[0], thetas[0])
    return sharding.with_rows(
        stack, torch.tensor(slots, dtype=torch.long, device=stack.device),
        thetas)


class ThetaStore:
    """Paged (capacity, D) fp32 theta stack with LRU eviction and pinned
    slots, on `device` (None = "cuda").

    mesh      — optional `launch.mesh.Mesh` (cells on `device`): the
                stack in `theta_stack_spec`'s column blocks.
    fault     — optional `fault(model_id) -> (theta (D,), version | None)`
                miss handler (KernelServer wires the registry load here).
    writeback — optional `writeback(model_id, theta, version) -> version`
                called when a DIRTY resident model is evicted; without it,
                evicting a dirty model raises rather than silently losing
                the only copy of a refined theta.
    """

    def __init__(self, capacity: int, num_features: int, *,
                 device: torch.device | str | None = None, mesh=None,
                 fault: Callable | None = None,
                 writeback: Callable | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.device = resolve_device(device)
        check_mesh(mesh, self.device, "ThetaStore")
        self.mesh = mesh
        self.capacity = int(capacity)
        self.num_features = int(num_features)
        self.fault = fault
        self.writeback = writeback
        self._stack = torch.zeros((self.capacity, self.num_features),
                                  dtype=STACK_DTYPE, device=self.device)
        if mesh is not None:
            self._stack = sharding.shard_theta_stack(self._stack, mesh)
        self._lock = threading.RLock()
        self._slots: OrderedDict[str, int] = OrderedDict()  # LRU: old → new
        self._free = list(range(self.capacity - 1, -1, -1))
        self._pins: dict[str, int] = {}
        # a copy of each dirty id's whole theta: what eviction writes back
        self._dirty_rows: dict[str, torch.Tensor] = {}
        self._versions: dict[str, int | None] = {}
        self._stats = {"hits": 0, "faults": 0, "evictions": 0,
                       "writebacks": 0}

    # ---- introspection ---------------------------------------------------
    @property
    def _dirty(self) -> set[str]:
        """Ids whose resident theta is newer than any published version."""
        return set(self._dirty_rows)

    @property
    def stack(self) -> torch.Tensor:
        """The current (capacity, D) tensor (a Blocked of column blocks on
        a mesh). Snapshot it under
        `lookup_batch` when slot indices must stay consistent with it;
        never write into it."""
        return self._stack

    def __contains__(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self._slots

    def __len__(self) -> int:
        with self._lock:
            return len(self._slots)

    def resident(self) -> list[str]:
        """Resident ids, least-recently-used first."""
        with self._lock:
            return list(self._slots)

    def version_of(self, model_id: str) -> int | None:
        with self._lock:
            if model_id not in self._slots:
                raise KeyError(f"model {model_id!r} is not resident")
            return self._versions[model_id]

    def stats(self) -> dict:
        with self._lock:
            s = dict(self._stats)
            s["resident"] = len(self._slots)
            s["capacity"] = self.capacity
            s["pinned"] = sum(1 for c in self._pins.values() if c > 0)
        return s

    # ---- pinning ---------------------------------------------------------
    def pin(self, model_id: str) -> None:
        """Protect a resident model's slot from eviction (refcounted)."""
        with self._lock:
            if model_id not in self._slots:
                raise KeyError(f"model {model_id!r} is not resident")
            self._pins[model_id] = self._pins.get(model_id, 0) + 1

    def unpin(self, model_id: str) -> None:
        with self._lock:
            count = self._pins.get(model_id, 0)
            if count <= 0:
                raise RuntimeError(f"model {model_id!r} is not pinned")
            if count == 1:
                self._pins.pop(model_id)
            else:
                self._pins[model_id] = count - 1

    # ---- allocation / paging --------------------------------------------
    def _as_thetas(self, thetas, shape: tuple[int, ...], keep: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(thetas on the store's device, with keep= a STACK_DTYPE copy of
        them where the caller's lie, else None): a copy of a host array
        waits for no kernel, a clone on the card is queued."""
        if isinstance(thetas, sharding.Blocked):
            if thetas.mesh.ranked:
                raise ValueError(
                    "a ThetaStore takes whole thetas: a theta in blocks "
                    "across ranks would be gathered inside a store call; "
                    "give every rank the whole theta")
            thetas = sharding.unshard(thetas)
        if not isinstance(thetas, torch.Tensor):
            thetas = torch.tensor(np.asarray(thetas))
        if tuple(thetas.shape) != shape:
            what = "theta" if len(shape) == 1 else "thetas"
            raise ValueError(f"{what} must be {shape}, got "
                             f"{tuple(thetas.shape)}")
        kept = thetas.to(dtype=STACK_DTYPE, copy=True) if keep else None
        return thetas.to(device=self.device, dtype=STACK_DTYPE), kept

    def _allocate(self) -> int:
        """A free slot, evicting the LRU unpinned model if needed.
        Caller holds the lock."""
        if self._free:
            return self._free.pop()
        for victim in self._slots:  # OrderedDict iterates LRU-first
            if self._pins.get(victim, 0) == 0:
                self._evict_locked(victim)
                return self._free.pop()
        raise RuntimeError(
            f"ThetaStore is full ({self.capacity} slots) and every "
            "resident model is pinned — raise the capacity or reduce the "
            "number of distinct models in flight at once")

    def _evict_locked(self, model_id: str) -> None:
        if model_id in self._dirty_rows:
            if self.writeback is None:
                raise RuntimeError(
                    f"evicting dirty model {model_id!r} would lose its "
                    "only copy — attach a registry writeback or publish "
                    "it first")
            new_v = self.writeback(model_id, self._dirty_rows[model_id],
                                   self._versions[model_id])
            self._mark(model_id, None)
            self._versions[model_id] = new_v
            self._stats["writebacks"] += 1
        slot = self._slots.pop(model_id)
        self._versions.pop(model_id, None)
        self._free.append(slot)
        self._stats["evictions"] += 1

    def _mark(self, model_id: str, row: torch.Tensor | None) -> None:
        """Dirty with a copy of its whole theta `row`, or clean (None).
        Caller holds the lock."""
        if row is None:
            self._dirty_rows.pop(model_id, None)
        else:
            self._dirty_rows[model_id] = row

    def evict(self, model_id: str) -> None:
        """Explicitly page one model out (writeback if dirty)."""
        with self._lock:
            if model_id not in self._slots:
                raise KeyError(f"model {model_id!r} is not resident")
            if self._pins.get(model_id, 0):
                raise RuntimeError(f"model {model_id!r} is pinned")
            self._evict_locked(model_id)

    def put(self, model_id: str, theta, *, version: int | None = None,
            dirty: bool = False) -> int:
        """Install (or hot-swap) one model's theta; returns its slot.

        An existing resident id keeps its slot. The write goes into a copy
        of the stack, which then replaces it: snapshots taken before the
        put keep scoring the old theta (hot-swap atomicity)."""
        theta, row = self._as_thetas(theta, (self.num_features,), dirty)
        with self._lock:
            slot = self._slots.get(model_id)
            if slot is None:
                slot = self._allocate()
                self._slots[model_id] = slot
            self._slots.move_to_end(model_id)
            self._stack = write_rows(self._stack, [slot], theta[None])
            self._versions[model_id] = version
            self._mark(model_id, row)
            return slot

    def put_many(self, ids: list[str], thetas, *,
                 dirty: bool = False) -> list[int]:
        """Bulk install, one copy of the stack: the bench/preload path.
        Preloads default to CLEAN: the caller is assumed to hold them
        elsewhere, so eviction may simply drop them; pass dirty=True for
        thetas whose only copy is the store."""
        thetas, rows = self._as_thetas(thetas, (len(ids), self.num_features),
                                       dirty)
        with self._lock:
            slots = []
            for i, model_id in enumerate(ids):
                slot = self._slots.get(model_id)
                if slot is None:
                    slot = self._allocate()
                    self._slots[model_id] = slot
                self._slots.move_to_end(model_id)
                self._versions[model_id] = None
                self._mark(model_id, None if rows is None else rows[i])
                slots.append(slot)
            self._stack = write_rows(self._stack, slots, thetas)
            return slots

    def ensure(self, model_id: str) -> int:
        """Resident slot of `model_id`, faulting it in on a miss."""
        with self._lock:
            slot = self._slots.get(model_id)
            if slot is not None:
                self._slots.move_to_end(model_id)
                self._stats["hits"] += 1
                return slot
            if self.fault is None:
                raise KeyError(
                    f"model {model_id!r} is not resident and the store has "
                    "no fault handler (registry)")
            theta, version = self.fault(model_id)
            self._stats["faults"] += 1
            return self.put(model_id, theta, version=version, dirty=False)

    def lookup_batch(self, ids: list[str]
                     ) -> tuple[torch.Tensor, np.ndarray, list]:
        """Resolve a batch of ids to one consistent (stack, slots) pair.

        Returns (stack_snapshot, slots int32 (len(ids),), errors). For
        each id one of three things holds: resolved (slot >= 0, error
        None); failed (slot -1, errors[i] = the exception: an unknown
        model fails only its own rows, never the batch); or DEFERRED
        (slot -1, error None): the store ran out of unpinned slots
        because ids resolved earlier in this same batch are pinned, so
        the caller should score the resolved ids and retry the deferred
        ones in a fresh round. That is how a single flush with more
        distinct tenants than store capacity pages through in several
        device rounds instead of erroring.

        Every resolved id is pinned while later ids fault, so an
        intra-batch eviction can never reuse a slot this batch indexes;
        the snapshot is taken before unpinning, under the same lock as
        every write, so it is consistent with the returned slots."""
        slots = np.full(len(ids), -1, np.int32)
        errors: list[Exception | None] = [None] * len(ids)
        with self._lock:
            pinned: list[str] = []
            try:
                for i, model_id in enumerate(ids):
                    try:
                        slots[i] = self.ensure(model_id)
                    except RuntimeError as e:
                        # capacity pressure: if it is OUR pins crowding the
                        # store, defer (slot -1, no error): a retry after
                        # this round's pins drop will succeed
                        if not pinned:
                            errors[i] = e
                        continue
                    except Exception as e:  # unknown id, bad shape, ...
                        errors[i] = e
                        continue
                    self.pin(model_id)
                    pinned.append(model_id)
                stack = self._stack
            finally:
                for model_id in pinned:
                    self.unpin(model_id)
        return stack, slots, errors
