"""`KernelServer` — microbatched scoring for `KernelModel` artifacts,
single-tenant or many-model, on one device or on a mesh of ranks.

Sibling to the LLM `Engine`: where the Engine amortizes decode steps over a
batch of sequences, the KernelServer amortizes RFF scoring over concurrent
requests. Callers `submit()` arbitrarily-sized query batches from any
thread; a collector thread coalesces everything waiting (until `max_batch`
rows are in hand or `max_delay_ms` passes), slices the merged batch into
largest-bucket-sized pieces and pads each piece to a bucketed shape, so
every device call has one of the |buckets| shapes however the batch landed,
scores them, and scatters the rows back to each request's future (numpy
arrays, as in the reference).

Two tenancy modes share that machinery:

  - **single-tenant** (`KernelServer(model)`): one frozen `KernelModel`,
    scored as `featurize(x) @ theta`.
  - **multi-tenant** (`KernelServer(registry=...)` and/or `store=...`):
    requests are tagged with a model id (`submit(x, model_id="user-42")`).
    The collector resolves each id to a slot of the `ThetaStore`'s one
    resident (M, D) stack, faulting misses in from the `ModelRegistry`
    off the device-call path, and the bucket is scored by the module-level
    `api.model.score_rows`: featurize once, then each row against its
    gathered theta slot. With backend="fused" on the card a bucket call is
    exactly one K1 launch (the featurizer) and one K6 launch (the gathered
    row-dot, `kernels/rowdot`), with no (b, D) gathered copy of theta.
    Both kernels give each row bits that depend only on its own input and
    theta, so an answer equals `KernelModel.score_rows` at the request's
    own row count, whoever shares its bucket. `publish()` hot-swaps a
    refined theta atomically: registry first, then the resident slot; an
    in-flight bucket holds its snapshot of the old stack, which the store
    never writes into, so no request ever scores a torn theta.

The collector launches on the current stream of the server's device (the
default stream; no side streams), and each bucket call ends in one
`.cpu()` of its answers, so a snapshot's memory is never reused under a
running kernel. The server keeps the template's whole omega, bias and
theta on the host from construction: the featurizer check of a fault or
a publish and the artifacts it writes back read that copy.

On a mesh (`mesh=`) the template model is sharded (`KernelModel.shard`)
and the store holds its stack in column blocks (`ThetaStore(mesh=)`).
Buckets are rounded up to multiples of the batch axes' extent, as in the
reference, so a bucket's rows always split over the batch axes
(`batch_specs`); each (row block, feature block) runs K1, then K6 on its
stack block, and the blocks' partials are summed in the fixed block
order. An answer is therefore still bitwise the sharded model's
`score_rows` at the request's own row count.

On a mesh across ranks (`make_host_mesh(..., group=)`) the server is SPMD.
Every rank builds the store and the server with the same arguments (the
same template `model=`, which a mesh across ranks requires). The front,
rank 0 of the mesh's group, alone takes `submit`, `predict` and
`publish`, coalesces, and talks to the registry (faults, dirty
writebacks, publishes); on every other rank, a follower, those three
raise RuntimeError. Each flush round, each publish (a put into the store)
and the stop is one command: the front broadcasts it over the group
(`sharding.broadcast_ranks`: the ids, the front's slots, what each of its
store handler calls returned or raised, the bucket's x and any whole
thetas faulted in or published), and every rank then makes the same
store calls, replaying the front's handler results, and the same
`score_rows` calls, each on its own blocks. All of a server's collectives
(the broadcast and the scorer's gathers) run on one thread per rank: the
collector on the front, the follower loop elsewhere; `publish` on a
caller's thread enqueues its command and waits on it. A request that
fails before scoring (an unknown id, another featurizer) fails alone, on
no rank scored. An error once scoring has begun, or a follower that finds
itself out of step with the front, leaves the ranks apart: that rank's
server fails every pending future and stops (its `stop()` raises), and
the others stop within the group's timeout. An idle front broadcasts a
heartbeat command every `heartbeat_s` seconds, so a follower waiting in
the broadcast never reaches the group's timeout: keep `heartbeat_s` well
below it. `stop()` on the front drains the queue, then broadcasts the
stop; on a follower it runs the follower loop until that stop comes
(starting it if `autostart=False` left it unstarted), so `with
KernelServer(...)` works on every rank. A server across ranks does not
restart once stopped.

    server = KernelServer(registry=ModelRegistry("models/"))   # on "cuda"
    fut = server.submit(x, model_id="user-42")    # (b, d) -> Future[(b,)]
    y = fut.result()
    server.publish("user-42", refined_model)      # hot-swap, no restart
    server.stop()
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch.api.model import (PREDICT_BACKENDS, KernelModel, _dot,
                                   score_rows)
from repro_torch.core.rff import RFFParams
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import batch_specs
from repro_torch.launch.mesh import num_agents
from repro_torch.serve.theta_store import ThetaStore, check_mesh

_STOP = object()
_DEFAULT_ID = "default"


@dataclasses.dataclass(frozen=True)
class KernelServeConfig:
    """Microbatching policy for the scoring server."""

    max_batch: int = 1024            # rows per device call
    max_delay_ms: float = 2.0        # collector wait for co-batchable work
    buckets: tuple[int, ...] = (32, 128, 512, 1024)  # padded batch shapes
    backend: str = "ref"             # "ref" | "fused" (the K1 featurizer)

    def __post_init__(self):
        if self.backend not in PREDICT_BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; choose from "
                f"{PREDICT_BACKENDS}")
        if not self.buckets or tuple(sorted(self.buckets)) != self.buckets:
            raise ValueError("buckets must be a non-empty ascending tuple")


@dataclasses.dataclass
class _Request:
    x: np.ndarray                    # (b, d)
    future: Future
    model_id: str | None = None      # None = the server's default model


@dataclasses.dataclass
class _Publish:
    """A publish on a mesh across ranks, run by the collector."""
    model_id: str
    theta: np.ndarray                # (D,) float32, whole
    art: KernelModel | None          # the registry's artifact
    future: Future


def _whole(x) -> torch.Tensor:
    """x whole on the host, gathering a blocked x of a one-process mesh; a
    blocked x across ranks is refused (its gather would be a collective
    on one rank's thread alone)."""
    if isinstance(x, sharding.Blocked):
        if x.mesh.ranked:
            raise ValueError(
                "a mesh across ranks serves whole models and thetas: give "
                "every rank the whole array, not its blocks")
        x = sharding.unshard(x)
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x))
    return x.detach().cpu()


class KernelServer:
    """Thread-safe microbatching front-end over one scoring call, on
    `device` (None = "cuda"; pass device="cpu" without a card).

    heartbeat_s — on a mesh across ranks, the front's longest silence:
    an idle front broadcasts a heartbeat command this often (keep it well
    below the process group's timeout)."""

    def __init__(self, model: KernelModel | None = None,
                 config: KernelServeConfig | None = None,
                 mesh=None, *, registry=None, store: ThetaStore | None = None,
                 store_capacity: int = 1024, autostart: bool = True,
                 device: torch.device | str | None = None,
                 heartbeat_s: float = 5.0):
        self.cfg = config or KernelServeConfig()
        self.device = resolve_device(device)
        check_mesh(mesh, self.device, "KernelServer")
        self.mesh = mesh
        self.registry = registry
        self.multi_tenant = registry is not None or store is not None
        self._ranked = mesh is not None and mesh.ranked
        self._front = not self._ranked or mesh.rank == 0
        self._heartbeat_s = float(heartbeat_s)
        # every padded shape must divide over the batch axes (extent 1
        # without a mesh: the configured buckets)
        extent = num_agents(mesh) if mesh is not None else 1
        self._buckets = tuple(-(-b // extent) * extent
                              for b in self.cfg.buckets)
        self._max_batch = -(-self.cfg.max_batch // extent) * extent

        # the template model defines the one featurizer every tenant
        # shares (the common-seed RFF premise): an explicit model wins,
        # else the registry's first catalogued model
        if model is None:
            if self._ranked:
                raise ValueError(
                    "a KernelServer on a mesh across ranks needs model= "
                    "on every rank (the same template): only the front "
                    "reads the registry")
            if registry is None:
                raise ValueError(
                    "KernelServer needs a model, or a registry to take "
                    "its featurizer template from")
            ids = registry.models()
            if not ids:
                raise ValueError(
                    "the registry is empty — pass model= so the server "
                    "knows its featurizer (input_dim / D / RFF draw)")
            model = registry.load(ids[0])
        # omega, bias and theta whole on the host (a model sharded on a
        # one-process mesh is gathered here; across ranks give the whole
        # model, which the server shards)
        self._template = model.replace(
            rff_params=RFFParams(omega=_whole(model.omega),
                                 bias=_whole(model.bias),
                                 mapping=model.mapping),
            theta=_whole(model.theta), thetas=None, mesh=None)
        if model.device != self.device:
            model = model.replace().to(self.device)   # the caller's stays
        if mesh is not None and model.mesh is not mesh:
            model = model.shard(mesh)
        self.model = model

        # eager backend/mapping validation at construction, through the one
        # routing point all scoring paths share
        model.featurize(torch.zeros((1, model.input_dim),
                                    dtype=model.theta.dtype,
                                    device=self.device), self.cfg.backend)

        if self.multi_tenant:
            self.store = store if store is not None else ThetaStore(
                store_capacity, model.num_features, device=self.device,
                mesh=mesh)
            if mesh is not None and getattr(self.store, "mesh",
                                            None) is not mesh:
                raise ValueError(
                    "a server on a mesh needs a store on the same mesh: "
                    "ThetaStore(..., mesh=mesh)")
            if self.store.num_features != model.num_features:
                raise ValueError(
                    f"store is sized for D={self.store.num_features} but "
                    f"the featurizer produces D={model.num_features}")
            if self.store.stack.device != model.theta.device:
                raise ValueError(
                    f"the store lies on {self.store.stack.device}, the "
                    f"server on {model.theta.device}")
            if registry is not None:
                if self.store.fault is None:
                    self.store.fault = self._fault
                if self.store.writeback is None:
                    self.store.writeback = self._writeback
            self._default_id = model.model_id or _DEFAULT_ID
            self.store.put(self._default_id, self._template.theta,
                           version=model.version,
                           dirty=model.version is None)
            params, backend = model.rff_params, self.cfg.backend

            def score_multi(stack, x, slots):
                # one featurize for the whole mixed bucket, then each row
                # against its gathered theta slot: `KernelModel.score_rows`
                # runs the same function
                return score_rows(params, x, stack, slots, backend=backend,
                                  mesh=mesh)

            self._score_multi = score_multi
        else:
            self.store = None
            self._default_id = model.model_id
            theta, backend = model.theta, self.cfg.backend

            def score(x):
                return _dot(model.featurize(x, backend), theta)

            self._score = score

        self._queue: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "rows": 0, "batches": 0,
                       "padded_rows": 0}
        self._worker: threading.Thread | None = None
        self._stopped = False
        # across ranks: the command's record (front) or replay (follower)
        # of the store handlers' results, the requests in flight, the
        # error that stopped this rank, and whether it stopped for good
        self._log = None
        self._out_of_step: str | None = None
        self._inflight: list = []
        self._failure: Exception | None = None
        self._finished = False
        if autostart:
            self.start()

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> None:
        if self._worker is not None:
            return
        if self._ranked:
            if self._finished:
                raise RuntimeError("a KernelServer on a mesh across ranks "
                                   "does not restart once stopped")
        else:
            self._stopped = False
        self._spawn()

    def _spawn(self) -> None:
        target, name = (self._loop, "kernel-server") if self._front else \
            (self._follow, "kernel-server-follower")
        self._worker = threading.Thread(target=target, daemon=True,
                                        name=name)
        self._worker.start()

    def stop(self) -> None:
        """Drain outstanding requests, then stop the collector thread (on
        a mesh across ranks, see the module docstring)."""
        if self._ranked:
            self._stop_ranked()
            return
        with self._lock:
            # same lock as submit(): every request that passed the _stopped
            # check is on the queue before the sentinel, so none is lost
            if self._stopped:
                return
            self._stopped = True
            self._queue.put(_STOP)
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        self._drain_inline()

    def _stop_ranked(self) -> None:
        if self._front:
            with self._lock:
                if not self._stopped:
                    self._stopped = True
                    self._queue.put(_STOP)
        if self._worker is None and not self._finished:
            self._spawn()        # the loop drains and broadcasts the stop
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        self._finished = True
        if self._failure is not None:
            raise RuntimeError(
                f"KernelServer on rank {self.mesh.rank} stopped on an "
                f"error: {self._failure!r}") from self._failure

    def _drain_inline(self) -> None:
        """Score anything still queued (requests enqueued while the worker
        was shutting down, or with no worker ever started)."""
        leftover = []
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                leftover.append(item)
        if leftover:
            self._flush(leftover)

    def __enter__(self) -> "KernelServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _check_front(self, what: str) -> None:
        if not self._front:
            raise RuntimeError(
                f"{what} on rank {self.mesh.rank}: on a mesh across ranks "
                "only the front (rank 0 of the mesh's group) takes "
                "requests and publishes; this rank follows its commands")

    # ---- many-model management -------------------------------------------
    def _check_compatible(self, other: KernelModel, model_id: str) -> None:
        """Every tenant must share the template's featurizer: that is what
        lets a mixed bucket featurize once."""
        tpl = self._template
        if (other.input_dim != tpl.input_dim
                or other.num_features != tpl.num_features
                or other.rff_params.mapping != tpl.rff_params.mapping
                or not torch.equal(_whole(other.omega), tpl.omega)
                or not torch.equal(_whole(other.bias), tpl.bias)):
            raise ValueError(
                f"model {model_id!r} was fitted against a different RFF "
                "featurizer than this server's template — many-model "
                "serving shares ONE common-seed feature map; refit with "
                "the shared draw or serve it from its own server")

    def _fault(self, model_id: str):
        """ThetaStore miss handler: load the latest registry version on
        the collector thread, never inside a device call."""
        loaded = self.registry.load(model_id)  # KeyError if unknown
        self._check_compatible(loaded, model_id)
        return loaded.theta, loaded.version

    def _writeback(self, model_id: str, theta, version):
        """ThetaStore dirty-eviction handler: page the refined theta back
        into the registry as a fresh version."""
        art = self._template.replace(
            theta=theta,
            meta={**self._template.meta, "published_via": "ThetaStore.evict"})
        return self.registry.publish(model_id, art)

    def publish(self, model_id: str, model) -> int | None:
        """Hot-swap one tenant's parameters under live traffic.

        `model` is a refined `KernelModel` (e.g. from `partial_fit`) or a
        bare (D,) theta. The registry gains the new version FIRST, then
        the resident slot flips: in-flight buckets finish on their
        snapshot of the old stack, every later bucket sees the new theta,
        and a crash in between leaves a valid catalog whose next fault
        serves the new version. Returns the published version (None when
        the server has no registry: the theta becomes resident and dirty,
        to be written back on eviction). On a mesh across ranks the
        collector runs it as one command, between two flush rounds."""
        self._check_front("publish")
        if not self.multi_tenant:
            raise RuntimeError(
                "publish() needs a multi-tenant server — construct with "
                "registry= and/or store=")
        if isinstance(model, KernelModel):
            self._check_compatible(model, model_id)
            theta = _whole(model.theta)
            art = model
        else:
            theta = _whole(model if isinstance(model, torch.Tensor)
                           else np.asarray(model, np.float32))
            art = self._template.replace(
                theta=theta, meta={**self.model.meta,
                                   "published_via": "KernelServer.publish"})
        if not self._ranked:
            return self._install(model_id, theta, art)
        item = _Publish(model_id, theta.to(torch.float32).numpy(), art,
                        Future())
        with self._lock:
            if self._stopped or self._worker is None:
                raise RuntimeError("KernelServer is not running: a publish "
                                   "on a mesh across ranks waits for its "
                                   "collector")
            self._queue.put(item)
        return item.future.result()

    def _install(self, model_id: str, theta, art) -> int | None:
        """publish's registry write, then its store put."""
        if self.registry is not None:
            version = self.registry.publish(model_id, art)
            self.store.put(model_id, theta, version=version, dirty=False)
            return version
        self.store.put(model_id, theta, dirty=True)
        return None

    # ---- request path ----------------------------------------------------
    def submit(self, x, model_id: str | None = None) -> Future:
        """Enqueue a query batch; resolves to (b,) predictions ((,) for a
        bare (d,) vector). `model_id` tags the request with the tenant to
        score against (multi-tenant servers; defaults to the server's
        default model when it has one)."""
        self._check_front("submit")
        x = np.asarray(x, np.float32)
        scalar = x.ndim == 1
        if scalar:
            x = x[None]
        if x.ndim != 2 or x.shape[-1] != self.model.input_dim:
            raise ValueError(
                f"expected (b, {self.model.input_dim}) queries, got "
                f"{x.shape}")
        if model_id is None:
            model_id = self._default_id
            if self.multi_tenant and model_id is None:
                raise ValueError(
                    "this multi-tenant server has no default model — tag "
                    "the request: submit(x, model_id=...)")
        elif not self.multi_tenant and model_id != self._default_id:
            raise ValueError(
                f"this server serves only {self._default_id or 'its one'!s} "
                f"model, not {model_id!r} — construct with registry=/store= "
                "for many-model serving")
        fut: Future = Future()
        if scalar:
            inner, fut = fut, Future()
            inner.add_done_callback(
                lambda f: fut.set_exception(f.exception())
                if f.exception() else fut.set_result(f.result()[0]))
            req = _Request(x, inner, model_id)
        else:
            req = _Request(x, fut, model_id)
        with self._lock:
            # check-and-enqueue under the stop() lock: either this request
            # lands on the queue ahead of the _STOP sentinel, or it raises
            if self._stopped:
                raise RuntimeError("KernelServer is stopped")
            self._queue.put(req)
            self._stats["requests"] += 1
        return fut

    def predict(self, x, model_id: str | None = None) -> np.ndarray:
        """Synchronous convenience wrapper around submit()."""
        return self.submit(x, model_id).result()

    def stats(self) -> dict:
        with self._lock:
            s = dict(self._stats)
        s["mean_rows_per_batch"] = (s["rows"] / s["batches"]
                                    if s["batches"] else 0.0)
        if self.store is not None:
            s["store"] = self.store.stats()
        return s

    # ---- collector -------------------------------------------------------
    def _on_device(self) -> None:
        """A server thread launches on the server's card (the current
        device is per thread)."""
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)

    def _loop(self) -> None:
        self._on_device()
        if not self._ranked:
            self._collect()
            return
        try:
            self._collect()
            self._send(("stop",))
        except Exception as e:  # noqa: BLE001 - the ranks are apart
            self._fail(e)

    def _collect(self) -> None:
        beat = self._heartbeat_s if self._ranked else None
        while True:
            try:
                item = self._queue.get(timeout=beat)
            except queue.Empty:
                self._send(("beat",))
                continue
            if item is _STOP:
                return
            if isinstance(item, _Publish):
                self._run_publish(item)
                continue
            batch = [item]
            rows = item.x.shape[0]
            deadline = time.monotonic() + self.cfg.max_delay_ms / 1e3
            nxt = None
            while rows < self._max_batch:
                timeout = deadline - time.monotonic()
                try:
                    nxt = (self._queue.get_nowait() if timeout <= 0
                           else self._queue.get(timeout=timeout))
                except queue.Empty:
                    nxt = None
                    break
                if nxt is _STOP or isinstance(nxt, _Publish):
                    break
                batch.append(nxt)
                rows += nxt.x.shape[0]
                nxt = None
            # a publish taken off the queue is pending until it runs: an
            # error across ranks in this flush fails it too (`_fail`)
            self._inflight = batch + ([nxt] if isinstance(nxt, _Publish)
                                      else [])
            self._flush(batch)
            if nxt is _STOP:
                return
            if nxt is not None:
                self._run_publish(nxt)

    def _pad_to_bucket(self, n: int) -> int:
        """Smallest bucket holding n rows. Only defined up to the largest
        bucket: `_flush` slices oversize batches into bucket-shaped device
        calls first, so every scorer call has one of the |buckets| shapes
        on ragged traffic."""
        for b in self._buckets:
            if n <= b:
                return b
        raise AssertionError(
            f"_pad_to_bucket({n}) beyond the largest bucket "
            f"{self._buckets[-1]} — oversize flushes must be sliced first")

    def _upload(self, xs: np.ndarray) -> torch.Tensor:
        # pageable memory is staged at once: no wait for the card
        x = torch.from_numpy(xs).to(self.device, non_blocking=True)
        if self.mesh is None:
            return x
        # the bucket's rows over the batch axes, iff they divide
        (spec,) = batch_specs(None, (x,), self.mesh)
        return sharding.shard(x, self.mesh, spec)

    def _score_padded(self, xs: np.ndarray) -> tuple[np.ndarray, int]:
        """One bucket-shaped device call: pad n <= max-bucket rows up to
        their bucket, score, strip the padding. Returns (preds, pad rows);
        the caller commits stats only once the WHOLE flush scored, so a
        failing later slice leaves no stats counting rows no caller ever
        received."""
        n = xs.shape[0]
        padded = self._pad_to_bucket(n)
        if padded != n:
            xs = np.concatenate(
                [xs, np.zeros((padded - n, xs.shape[1]), xs.dtype)])
        preds = self._score(self._upload(xs)).cpu().numpy()
        return preds[:n], padded - n

    def _score_padded_multi(self, stack: torch.Tensor, xs: np.ndarray,
                            slots: np.ndarray) -> tuple[np.ndarray, int]:
        """The multi-tenant twin of `_score_padded`: pads rows AND slot
        ids (padding gathers slot 0, always a valid row of the stack, and
        its results are stripped). The slots stay host int32: the scorer
        checks their range before it uploads them."""
        n = xs.shape[0]
        padded = self._pad_to_bucket(n)
        if padded != n:
            xs = np.concatenate(
                [xs, np.zeros((padded - n, xs.shape[1]), xs.dtype)])
            slots = np.concatenate(
                [slots, np.zeros(padded - n, slots.dtype)])
        preds = self._score_multi(stack, self._upload(xs),
                                  slots).cpu().numpy()
        return preds[:n], padded - n

    def _flush(self, batch: list[_Request]) -> None:
        if not self.multi_tenant:
            xs = np.concatenate([r.x for r in batch])
            self._send(("round", None, None, [], xs, None))
            self._score_and_scatter(batch, xs)
            return
        # Resolve every request's model id to a theta slot (faulting
        # misses in from the registry) and snapshot ONE consistent stack
        # per round. A request whose id cannot be resolved fails alone;
        # requests DEFERRED under capacity pressure (more distinct models
        # waiting than unpinned slots) page through in follow-up rounds
        # once the current round's slots free up. Across ranks each round
        # is one command, sent once the front's lookup has run.
        remaining = batch
        while remaining:
            ids = [r.model_id for r in remaining]
            with self._command([]) as events:
                stack, req_slots, errors = self.store.lookup_batch(ids)
            kept, deferred = [], []
            for r, slot, err in zip(remaining, req_slots, errors):
                if err is not None:
                    r.future.set_exception(err)
                elif slot < 0:
                    deferred.append(r)
                else:
                    kept.append((r, slot))
            xs = slots = None
            if kept:
                xs = np.concatenate([r.x for r, _ in kept])
                slots = np.concatenate(
                    [np.full(r.x.shape[0], slot, np.int32)
                     for r, slot in kept])
            self._send(("round", ids, req_slots, events, xs, slots))
            if kept:
                self._score_and_scatter([r for r, _ in kept], xs, stack,
                                        slots)
            elif deferred:
                # no progress is possible: every slot is pinned by work
                # outside this flush; fail rather than spin
                err = RuntimeError(
                    "ThetaStore has no unpinned slot for any waiting "
                    "model — raise the store capacity")
                for r in deferred:
                    r.future.set_exception(err)
                return
            remaining = deferred

    def _score_all(self, xs: np.ndarray, stack=None,
                   slots: np.ndarray | None = None) -> list:
        """The merged rows' bucket calls; commits the stats once all
        scored. The collector coalesces until rows >= max_batch, so the
        LAST request can overshoot; and a single submit() may exceed
        max_batch outright. The merged batch is sliced into
        largest-bucket-sized device calls instead of padding past the
        bucket table."""
        n, cap = xs.shape[0], self._buckets[-1]
        if stack is not None:
            scored = [self._score_padded_multi(stack, xs[off:off + cap],
                                               slots[off:off + cap])
                      for off in range(0, n, cap)]
        else:
            scored = [self._score_padded(xs[off:off + cap])
                      for off in range(0, n, cap)]
        with self._lock:
            self._stats["batches"] += len(scored)
            self._stats["rows"] += n
            self._stats["padded_rows"] += sum(pad for _, pad in scored)
        return scored

    def _score_and_scatter(self, batch: list[_Request], xs: np.ndarray,
                           stack=None, slots: np.ndarray | None = None
                           ) -> None:
        try:
            scored = self._score_all(xs, stack, slots)
        except Exception as e:
            if self._ranked:     # the ranks are apart: stop them all
                raise
            for r in batch:      # fail every caller of it, keep serving
                r.future.set_exception(e)
            return
        preds = np.concatenate([p for p, _ in scored])
        off = 0
        for r in batch:
            b = r.x.shape[0]
            r.future.set_result(preds[off:off + b])
            off += b

    # ---- across ranks ----------------------------------------------------
    def _send(self, cmd: tuple) -> None:
        """The front's command to every rank (a no-op on one process)."""
        if self._ranked:
            sharding.broadcast_ranks(cmd, self.mesh.group, self.device)

    def _run_publish(self, item: _Publish) -> None:
        """A publish as one command: the registry write, then the put,
        whose handler calls (dirty evictions) the followers replay."""
        self._inflight = [item]
        try:
            version = None if self.registry is None else \
                self.registry.publish(item.model_id, item.art)
        except Exception as e:  # noqa: BLE001 - the caller's error
            item.future.set_exception(e)
            return
        failed = None
        dirty = self.registry is None
        with self._command([]) as events:
            try:
                self.store.put(item.model_id, item.theta, version=version,
                               dirty=dirty)
            except Exception as e:  # noqa: BLE001 - the caller's error
                failed = e
        self._send(("put", item.model_id, item.theta, version, dirty,
                    events, failed is not None))
        if failed is not None:
            item.future.set_exception(failed)
        else:
            item.future.set_result(version)

    @contextlib.contextmanager
    def _command(self, events: list):
        """The store's fault and writeback handlers inside one command:
        across ranks the front records what each call returned or raised
        into `events`, a follower replays them (`_event`); on one process
        the handlers run as they are."""
        if not self._ranked:
            yield events
            return
        st = self.store
        handlers = (st.fault, st.writeback)
        self._log = events if self._front else iter(events)
        self._out_of_step = None
        if handlers[0] is not None:
            st.fault = lambda mid: self._event("fault", mid, handlers[0],
                                               mid)
        if handlers[1] is not None:
            st.writeback = lambda mid, theta, v: self._event(
                "writeback", mid, handlers[1], mid, theta, v)
        try:
            yield events
        finally:
            st.fault, st.writeback = handlers
            log, self._log = self._log, None
        if not self._front and (self._out_of_step
                                or next(log, None) is not None):
            raise RuntimeError(
                f"rank {self.mesh.rank} is out of step with the front: "
                f"{self._out_of_step or 'the front made more store calls'}")

    def _event(self, kind: str, model_id: str, handler, *args):
        """One store handler call inside a command (see `_command`). A
        fault's theta is carried whole as float32 numpy, so every rank
        installs the same bits."""
        if self._front:
            try:
                value = handler(*args)
                if kind == "fault":
                    theta, version = value
                    value = (_whole(theta).to(torch.float32).numpy(),
                             version)
            except Exception as e:
                self._log.append((kind, model_id, False,
                                  (isinstance(e, RuntimeError), repr(e))))
                raise
            self._log.append((kind, model_id, True, value))
            return value
        ev = next(self._log, None)
        if ev is None or ev[:2] != (kind, model_id):
            self._out_of_step = (f"the front's store called {ev and ev[:2]}"
                                 f", this rank's ({kind}, {model_id!r})")
            raise RuntimeError(self._out_of_step)
        if not ev[2]:
            runtime, msg = ev[3]
            raise (RuntimeError if runtime else LookupError)(
                f"on the front: {msg}")
        return ev[3]

    def _follow(self) -> None:
        """A follower's loop: every command of the front, in its order,
        until the stop (or an error, which stops this rank)."""
        self._on_device()
        try:
            while True:
                cmd = sharding.broadcast_ranks(None, self.mesh.group,
                                               self.device)
                if cmd[0] == "stop":
                    return
                if cmd[0] == "round":
                    self._replay_round(*cmd[1:])
                elif cmd[0] == "put":
                    self._replay_put(*cmd[1:])
        except Exception as e:  # noqa: BLE001 - raised by stop()
            self._failure = e

    def _replay_round(self, ids, front_slots, events, xs, slots) -> None:
        stack = None
        if ids is not None:
            with self._command(events):
                stack, got, _ = self.store.lookup_batch(ids)
            if not np.array_equal(got, front_slots):
                raise RuntimeError(
                    f"rank {self.mesh.rank} is out of step with the front: "
                    f"slots {got.tolist()} against {front_slots.tolist()}")
        if xs is not None:
            self._score_all(xs, stack, slots)

    def _replay_put(self, model_id, theta, version, dirty, events,
                    failed) -> None:
        with self._command(events):
            try:
                self.store.put(model_id, theta, version=version,
                               dirty=dirty)
                ok = True
            except Exception:  # noqa: BLE001 - compared with the front's
                ok = False
        if ok == failed:
            raise RuntimeError(
                f"rank {self.mesh.rank} is out of step with the front: "
                f"its put of {model_id!r} {'failed' if ok else 'ran'}")

    def _fail(self, e: Exception) -> None:
        """The front after an error across ranks: fail every request in
        flight and every one queued, refuse new ones, stop."""
        with self._lock:
            self._stopped = True
            self._failure = e
        pending = list(self._inflight)
        while True:
            try:
                pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        err = RuntimeError(f"KernelServer stopped on an error across "
                           f"ranks: {e!r}")
        for item in pending:
            if item is not _STOP and not item.future.done():
                item.future.set_exception(err)
