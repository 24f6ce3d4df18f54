"""The port's many-model serving (`repro_torch.serve`: `ModelRegistry`,
`ThetaStore`, `KernelServer`, and `KernelModel.score_rows`) on the CPU,
against the reference's `repro.serve`.

Every test of tests/test_kernel_server.py and tests/test_serve_many.py has
a counterpart here, under the same name where the contract is the same.
The base model is the reference's fit of those files' config, carried
across with `convert.model_from_numpy`; the per-user variants are the same
numpy perturbations; queries are seeded numpy arrays.

Tolerances. Side by side with the reference, the port's served answers are
within REF_ATOL = 2e-6 of the reference server's on the same registry and
queries (the reference's own predict tolerance at D = 16,
tests/test_serve_many.py:248-249), and single-tenant answers within the
reference's 1e-6 of `predict`. The port's own contracts are bitwise: a
tagged answer equals `KernelModel.score_rows` at the request's own row
count, alone or co-batched with other tenants, paged or resident. (The
reference misses its bitwise pin by one ulp on XLA-CPU: its score_rows at
b = 2 and its 512-row bucket reduce in different orders.)

Server tests wait on futures with a timeout, so a hang fails one test.
"""
import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FitConfig as JFitConfig
from repro.api import KRRConfig as JKRRConfig
from repro.api import fit as jax_fit
from repro.serve import KernelServeConfig as JKernelServeConfig
from repro.serve import KernelServer as JKernelServer
from repro.serve import ModelRegistry as JModelRegistry
from repro.serve import ThetaStore as JThetaStore

from repro_torch import convert
from repro_torch.api import (FitConfig, KernelModel, KRRConfig,
                             Personalization, build_problem, fit)
from repro_torch.serve import (KernelServeConfig, KernelServer,
                               ModelRegistry, ThetaStore)

torch.set_num_threads(2)

CPU = "cpu"
TIMEOUT = 60
REF_ATOL = 2e-6
PREDICT_ATOL = 1e-6
BASE = JFitConfig(
    krr=JKRRConfig(num_agents=4, samples_per_agent=30, num_features=16,
                   lam=1e-2, rho=0.5, seed=0),
    algorithm="coke", censor_v=0.5, censor_mu=0.97, num_iters=30)


def _carry(jm) -> KernelModel:
    """The port's copy of a reference KernelModel, by its arrays."""
    return convert.model_from_numpy(
        {k: np.asarray(v) for k, v in jm._array_tree().items()},
        {"mapping": jm.rff_params.mapping, "bandwidth": jm.bandwidth,
         "kernel": jm.kernel, "meta": jm.meta, "model_id": jm.model_id,
         "version": jm.version}, device=CPU)


@pytest.fixture(scope="module")
def jmodel():
    return jax_fit(BASE).to_model()


@pytest.fixture(scope="module")
def base_model(jmodel):
    return _carry(jmodel)


def _variant_theta(base, i: int) -> np.ndarray:
    """tests/test_serve_many.py::variant's theta: the base theta plus
    N(0, 0.1^2) from default_rng(1000 + i)."""
    rng = np.random.default_rng(1000 + i)
    return np.asarray(base.theta) + rng.normal(
        scale=0.1, size=base.num_features).astype(np.float32)


def variant(base: KernelModel, i: int) -> KernelModel:
    return base.replace(theta=torch.from_numpy(_variant_theta(base, i)),
                        thetas=None)


def jvariant(jbase, i: int):
    return dataclasses.replace(jbase, theta=jnp.asarray(
        _variant_theta(jbase, i)), thetas=None)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def rowwise_ref(model: KernelModel, x: np.ndarray, theta,
                backend: str = "ref") -> np.ndarray:
    """The bit-level serving reference: score_rows with x's rows all
    tagged to one theta, at x's own row count."""
    rows = np.broadcast_to(_np(theta), (x.shape[0], model.num_features))
    return _np(model.score_rows(x, rows, backend=backend))


@pytest.fixture(scope="module")
def registry8(tmp_path_factory, base_model):
    reg = ModelRegistry(str(tmp_path_factory.mktemp("registry")), device=CPU)
    for i in range(8):
        reg.publish(f"user-{i}", variant(base_model, i))
    return reg


@pytest.fixture(scope="module")
def queries(base_model):
    rng = np.random.default_rng(7)
    return rng.uniform(size=(64, base_model.input_dim)).astype(np.float32)


@pytest.fixture(scope="module")
def queries0(base_model):
    """tests/test_kernel_server.py's queries."""
    rng = np.random.default_rng(0)
    return rng.uniform(size=(64, base_model.input_dim)).astype(np.float32)


def _predict(model, x, **kw) -> np.ndarray:
    return _np(model.predict(x, **kw))


# ---------------------------------------------------------------------------
# KernelServer, single tenant (tests/test_kernel_server.py)
# ---------------------------------------------------------------------------

def test_served_predictions_match_model(base_model, queries0):
    direct = _predict(base_model, queries0)
    with KernelServer(base_model, device=CPU) as server:
        out = server.predict(queries0)
        np.testing.assert_allclose(out, direct, atol=PREDICT_ATOL)
        # scalar requests resolve to scalars
        assert np.asarray(server.predict(queries0[0])).shape == ()
    assert isinstance(out, np.ndarray) and out.dtype == np.float32


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_single_tenant_answers_match_the_reference_server(
        base_model, jmodel, queries0, backend):
    cfg = dict(max_delay_ms=1.0, backend=backend)
    with KernelServer(base_model, KernelServeConfig(**cfg),
                      device=CPU) as server:
        got = [server.submit(queries0[i:i + 5]) for i in range(0, 60, 5)]
        got = np.concatenate([f.result(timeout=TIMEOUT) for f in got])
    with JKernelServer(jmodel, JKernelServeConfig(**cfg)) as jserver:
        want = np.asarray(jserver.predict(queries0[:60]))
    np.testing.assert_allclose(got, want, rtol=0, atol=REF_ATOL)


def test_microbatching_coalesces_queued_requests(base_model, queries0):
    """Requests enqueued before the collector starts are scored in one
    padded device call, each future receiving exactly its rows."""
    server = KernelServer(base_model, KernelServeConfig(max_delay_ms=1.0),
                          autostart=False, device=CPU)
    futs = [server.submit(queries0[i:i + 3]) for i in range(0, 63, 3)]
    server.start()
    outs = np.concatenate([f.result(timeout=TIMEOUT) for f in futs])
    server.stop()
    np.testing.assert_allclose(outs, _predict(base_model, queries0[:63]),
                               atol=PREDICT_ATOL)
    stats = server.stats()
    assert stats["requests"] == 21
    assert stats["batches"] == 1          # all 21 coalesced
    assert stats["rows"] == 63
    assert stats["padded_rows"] == 128 - 63  # padded up to the 128 bucket


def test_concurrent_submitters_all_get_correct_rows(base_model, queries0):
    direct = _predict(base_model, queries0)
    results = {}

    def client(i, server):
        results[i] = server.submit(
            queries0[i * 8:(i + 1) * 8]).result(timeout=TIMEOUT)

    with KernelServer(base_model, KernelServeConfig(max_delay_ms=5.0),
                      device=CPU) as server:
        threads = [threading.Thread(target=client, args=(i, server))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
    for i in range(8):
        np.testing.assert_allclose(results[i], direct[i * 8:(i + 1) * 8],
                                   atol=PREDICT_ATOL)


def test_fused_backend_parity(base_model, queries0):
    with KernelServer(base_model, device=CPU) as ref_srv:
        ref = ref_srv.predict(queries0)
    with KernelServer(base_model, KernelServeConfig(backend="fused"),
                      device=CPU) as fused_srv:
        fused = fused_srv.predict(queries0)
    np.testing.assert_allclose(ref, fused, atol=1e-5)


def test_oversized_batch_spills_past_largest_bucket(base_model):
    rng = np.random.default_rng(1)
    big = rng.uniform(size=(40, base_model.input_dim)).astype(np.float32)
    cfg = KernelServeConfig(max_batch=16, buckets=(8, 16))
    server = KernelServer(base_model, cfg, autostart=False, device=CPU)
    fut = server.submit(big)  # single request larger than max_batch
    server.start()
    out = fut.result(timeout=TIMEOUT)
    server.stop()
    np.testing.assert_allclose(out, _predict(base_model, big),
                               atol=PREDICT_ATOL)


@pytest.mark.parametrize("tenancy", ["single", "multi"])
def test_every_scorer_call_has_a_bucket_shape(base_model, registry8,
                                              queries0, tenancy):
    """Oversize flushes (a single over-max request, or the collector's
    overshoot from the final coalesced request) are sliced into
    bucket-shaped device calls: every scorer call has one of the
    configured buckets' shapes, in rows and, multi-tenant, in slots."""
    rng = np.random.default_rng(2)
    cfg = KernelServeConfig(max_batch=16, buckets=(8, 16), max_delay_ms=20.0)
    multi = tenancy == "multi"
    server = KernelServer(base_model, cfg, autostart=False, device=CPU,
                          registry=registry8 if multi else None)
    shapes = []
    if multi:
        inner = server._score_multi

        def recorded(stack, xs, slots):
            shapes.append(xs.shape[0])
            assert slots.shape == (xs.shape[0],)
            return inner(stack, xs, slots)

        server._score_multi = recorded
        tag = "user-2"
        want = lambda x: rowwise_ref(  # noqa: E731
            base_model, x, registry8.load(tag).theta)
    else:
        inner = server._score
        server._score = lambda xs: (shapes.append(xs.shape[0]), inner(xs))[1]
        tag = None
        want = lambda x: _predict(base_model, x)  # noqa: E731
    big = rng.uniform(size=(41, base_model.input_dim)).astype(np.float32)
    futs = [server.submit(big, tag)]
    # plus a pile of small requests: the collector overshoots max_batch
    # by whatever the last one brought
    futs += [server.submit(queries0[i:i + 7], tag) for i in range(0, 35, 7)]
    server.start()
    outs = [f.result(timeout=TIMEOUT) for f in futs]
    server.stop()
    np.testing.assert_allclose(outs[0], want(big), atol=PREDICT_ATOL)
    for j, f in enumerate(outs[1:]):
        np.testing.assert_allclose(f, want(queries0[j * 7:(j + 1) * 7]),
                                   atol=PREDICT_ATOL)
    assert shapes, "no device calls recorded"
    assert set(shapes) <= set(server._buckets)


def test_bad_request_fails_its_future_only(base_model, queries0):
    with KernelServer(base_model, device=CPU) as server:
        with pytest.raises(ValueError, match="queries"):
            server.submit(np.zeros((2, 99), np.float32))
        # the server keeps serving after the rejected request
        np.testing.assert_allclose(server.predict(queries0[:4]),
                                   _predict(base_model, queries0[:4]),
                                   atol=PREDICT_ATOL)


def test_stop_drains_queued_requests(base_model, queries0):
    """Requests accepted before stop() must resolve even if the collector
    never picked them up: stop() scores the queue remainder inline."""
    server = KernelServer(base_model, autostart=False, device=CPU)
    futs = [server.submit(queries0[i:i + 2]) for i in range(0, 10, 2)]
    server.stop()  # worker never started; drain must resolve every future
    outs = np.concatenate([f.result(timeout=5) for f in futs])
    np.testing.assert_allclose(outs, _predict(base_model, queries0[:10]),
                               atol=PREDICT_ATOL)


def test_stopped_server_rejects_submissions(base_model, queries0):
    server = KernelServer(base_model, device=CPU)
    server.predict(queries0[:2])
    server.stop()
    server.stop()  # idempotent
    with pytest.raises(RuntimeError, match="stopped"):
        server.submit(queries0[:2])


def test_config_validation():
    with pytest.raises(ValueError, match="backend"):
        KernelServeConfig(backend="quantum")
    with pytest.raises(ValueError, match="buckets"):
        KernelServeConfig(buckets=(128, 32))


# ---------------------------------------------------------------------------
# device, mesh and score_rows
# ---------------------------------------------------------------------------

def test_entry_points_default_to_the_card(base_model, tmp_path,
                                          monkeypatch):
    """device=None means "cuda": without a card the registry, the store
    and the server raise instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ModelRegistry(str(tmp_path)),
                 lambda: ThetaStore(2, 4),
                 lambda: KernelServer(base_model, autostart=False)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_theta_stack_spec_shards_feature_dim(base_model):
    """The reference shards the stack's feature dim over a mesh's "model"
    axis and keeps the slot axis whole; the port's store lays its stack
    out by the same spec, as contiguous (M, D/s) column blocks, one per
    model block on a one-device mesh, and a server on the mesh keeps that
    store."""
    from jax.sharding import AbstractMesh

    from repro.distributed.sharding import theta_stack_spec as jspec
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh

    for data, model, D in ((2, 4, 16), (1, 4, 16), (2, 4, 18), (4, 2, 16)):
        mesh = make_host_mesh(data, model, device=CPU)
        store = ThetaStore(8, D, device=CPU, mesh=mesh)
        want = jspec((8, D), AbstractMesh((data, model), ("data", "model")))
        assert tuple(sharding.theta_stack_spec((8, D), mesh)) == \
            tuple(want)
        stack = store.stack
        if want[-1] is None:          # D does not divide: one whole stack
            assert isinstance(stack, torch.Tensor)
            assert tuple(stack.shape) == (8, D)
            continue
        assert tuple(stack.spec) == tuple(want)
        assert len(stack.blocks) == model
        for blk in stack.blocks.values():
            assert blk.is_contiguous() and tuple(blk.shape) == (8,
                                                                D // model)
    mesh = make_host_mesh(2, 4, device=CPU)
    server = KernelServer(base_model, mesh=mesh, device=CPU,
                          autostart=False, store=ThetaStore(
                              8, base_model.num_features, device=CPU,
                              mesh=mesh))
    assert server.store.stack.spec == sharding.theta_stack_spec(
        (8, base_model.num_features), mesh)


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_score_rows_matches_the_reference_and_is_row_stable(
        base_model, jmodel, queries, backend):
    rng = np.random.default_rng(4)
    thetas = rng.normal(size=(64, base_model.num_features)).astype(np.float32)
    got = _np(base_model.score_rows(queries, thetas, backend=backend))
    want = np.asarray(jmodel.score_rows(queries, thetas, backend=backend))
    np.testing.assert_allclose(got, want, rtol=0, atol=REF_ATOL)
    for lo, n in ((0, 1), (3, 2), (10, 3), (32, 32)):
        part = _np(base_model.score_rows(queries[lo:lo + n],
                                         thetas[lo:lo + n], backend=backend))
        np.testing.assert_array_equal(part, got[lo:lo + n])
    # within reduction order of predict's matvec
    np.testing.assert_allclose(
        _np(base_model.score_rows(queries, np.broadcast_to(
            _np(base_model.theta), thetas.shape), backend=backend)),
        _predict(base_model, queries, backend=backend), atol=PREDICT_ATOL)


def test_score_rows_fused_needs_the_cos_bias_mapping(base_model, queries):
    sin = base_model.replace(rff_params=dataclasses.replace(
        base_model.rff_params, mapping="cos_sin"),
        theta=torch.zeros(2 * base_model.num_features))
    rows = np.zeros((4, sin.num_features), np.float32)
    with pytest.raises(ValueError, match="cos_bias"):
        sin.score_rows(queries[:4], rows, backend="fused")
    with pytest.raises(ValueError, match="backend"):
        base_model.score_rows(queries[:4], rows[:, :16], backend="quantum")
    assert sin.score_rows(queries[:4], rows).shape == (4,)


# ---------------------------------------------------------------------------
# ModelRegistry
# ---------------------------------------------------------------------------

def test_registry_publish_load_roundtrips_bit_identically(tmp_path,
                                                          base_model):
    reg = ModelRegistry(str(tmp_path), device=CPU)
    m = variant(base_model, 0)
    v = reg.publish("alice", m)
    assert v == 1
    assert m.model_id is None and m.version is None  # the caller's model
    loaded = reg.load("alice")
    for name in ("theta", "omega", "bias"):
        assert torch.equal(getattr(loaded, name), getattr(m, name)), name
    # identity is stamped on publish and survives the round trip
    assert loaded.model_id == "alice" and loaded.version == 1
    assert loaded.meta == m.meta
    # predictions are therefore bit-identical too
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(8, m.input_dim)).astype(np.float32)
    np.testing.assert_array_equal(_predict(loaded, x), _predict(m, x))
    # a version dir is itself a plain KernelModel artifact
    direct = KernelModel.load(reg.artifact_path("alice", 1), device=CPU)
    assert torch.equal(direct.theta, m.theta)


def test_registry_versions_and_latest(tmp_path, base_model):
    reg = ModelRegistry(str(tmp_path), device=CPU)
    thetas = []
    for i in range(3):
        m = variant(base_model, i)
        thetas.append(m.theta)
        assert reg.publish("bob", m) == i + 1
    assert reg.versions("bob") == [1, 2, 3]
    assert reg.latest_version("bob") == 3
    assert reg.models() == ["bob"] and len(reg) == 1
    assert "bob" in reg and "carol" not in reg
    assert torch.equal(reg.load("bob").theta, thetas[2])
    assert torch.equal(reg.load("bob", 2).theta, thetas[1])
    with pytest.raises(KeyError):
        reg.load("carol")
    with pytest.raises(KeyError):
        reg.load("bob", 9)
    # versions are immutable
    with pytest.raises(ValueError, match="immutable"):
        reg.publish("bob", variant(base_model, 9), version=2)


def test_registry_rejects_bad_ids(tmp_path, base_model):
    reg = ModelRegistry(str(tmp_path), device=CPU)
    for bad in ("", "a/b", "../up", ".hidden", "sp ace"):
        with pytest.raises(ValueError, match="model id"):
            reg.publish(bad, base_model)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_registry_directories_load_across_packages(tmp_path, base_model,
                                                   jmodel, writer):
    """The on-disk layout is the reference's: a directory written by
    either package loads in the other with the arrays bitwise equal and
    the identity and meta kept."""
    port = ModelRegistry(str(tmp_path), device=CPU)
    ref = JModelRegistry(str(tmp_path))
    for i in range(3):
        if writer == "port":
            assert port.publish("carol", variant(base_model, i)) == i + 1
        else:
            assert ref.publish("carol", jvariant(jmodel, i)) == i + 1
    assert port.models() == ref.models() == ["carol"]
    assert port.versions("carol") == ref.versions("carol") == [1, 2, 3]
    for v in (1, 3):
        got, want = port.load("carol", v), ref.load("carol", v)
        for name, a, b in (("theta", got.theta, want.theta),
                           ("omega", got.omega, want.rff_params.omega),
                           ("bias", got.bias, want.rff_params.bias)):
            np.testing.assert_array_equal(_np(a), np.asarray(b),
                                          err_msg=name)
        assert (got.model_id, got.version) == (want.model_id,
                                               want.version) == ("carol", v)
        assert got.meta == want.meta
        assert got.rff_params.mapping == want.rff_params.mapping


# ---------------------------------------------------------------------------
# ThetaStore
# ---------------------------------------------------------------------------

def _theta(d, i):
    return np.full(d, float(i), np.float32)


def test_theta_store_lru_eviction_order():
    store = ThetaStore(3, 4, device=CPU)
    for name in ("a", "b", "c"):
        store.put(name, _theta(4, ord(name)))
    store.ensure("a")                      # a becomes most-recently-used
    store.put("d", _theta(4, 1))           # evicts b: the LRU entry
    assert store.resident() == ["c", "a", "d"]
    assert "b" not in store
    assert store.stats()["evictions"] == 1
    # the surviving slots still hold their exact thetas
    stack, slots, errors = store.lookup_batch(["a", "c", "d"])
    assert errors == [None, None, None]
    np.testing.assert_array_equal(_np(stack[slots[0]]), _theta(4, ord("a")))
    np.testing.assert_array_equal(_np(stack[slots[2]]), _theta(4, 1))


def test_theta_store_pinned_slot_protected():
    store = ThetaStore(2, 4, device=CPU)
    store.put("a", _theta(4, 1))
    store.put("b", _theta(4, 2))
    store.ensure("a")                      # a is MRU; b is the LRU victim...
    store.pin("b")                         # ...but pinned
    store.put("c", _theta(4, 3))           # must evict a instead
    assert "b" in store and "a" not in store
    store.pin("c")
    with pytest.raises(RuntimeError, match="pinned"):
        store.put("d", _theta(4, 4))       # every slot pinned
    store.unpin("b")
    store.put("d", _theta(4, 4))           # now b can go
    assert "d" in store and "b" not in store
    with pytest.raises(RuntimeError, match="not pinned"):
        store.unpin("b")


def test_theta_store_fault_and_dirty_writeback():
    backing = {"x": (np.full(4, 9.0, np.float32), 3)}
    published = {}

    def fault(mid):
        if mid not in backing:
            raise KeyError(mid)
        return backing[mid]

    store = None

    def writeback(mid, theta, version):
        # a copy of the row, never a view of the stack
        assert theta.untyped_storage().data_ptr() != \
            store.stack.untyped_storage().data_ptr()
        published[mid] = (_np(theta).copy(), version)
        return (version or 0) + 1

    store = ThetaStore(1, 4, device=CPU, fault=fault, writeback=writeback)
    assert store.ensure("x") >= 0          # faulted in
    assert store.version_of("x") == 3
    assert store.stats()["faults"] == 1
    with pytest.raises(KeyError):
        store.ensure("nope")
    # a dirty resident pages back to the registry on eviction
    store.put("dirty", np.full(4, 5.0, np.float32), dirty=True)  # evicts x
    assert store._dirty == {"dirty"}
    store.ensure("x")                      # evicts dirty -> writeback
    np.testing.assert_array_equal(published["dirty"][0],
                                  np.full(4, 5.0, np.float32))
    assert store.stats()["writebacks"] == 1 and store._dirty == set()
    # without a writeback, evicting a dirty model refuses to lose it
    lone = ThetaStore(1, 4, device=CPU)
    lone.put("only", np.full(4, 1.0, np.float32), dirty=True)
    with pytest.raises(RuntimeError, match="dirty"):
        lone.put("next", np.full(4, 2.0, np.float32))


def test_theta_store_shape_validation():
    store = ThetaStore(2, 4, device=CPU)
    with pytest.raises(ValueError, match="theta"):
        store.put("a", np.zeros(5, np.float32))
    with pytest.raises(ValueError, match="thetas"):
        store.put_many(["a", "b"], np.zeros((2, 5), np.float32))
    with pytest.raises(ValueError, match="capacity"):
        ThetaStore(0, 4, device=CPU)


def test_theta_store_stack_is_fp32_whatever_the_input():
    """The stack is fp32, the one dtype K6 and the shared scorer take:
    the store has no dtype option, and puts of other dtypes are cast."""
    with pytest.raises(TypeError, match="dtype"):
        ThetaStore(2, 4, device=CPU, dtype=torch.bfloat16)
    store = ThetaStore(2, 4, device=CPU)
    store.put("a", np.arange(4, dtype=np.float64) / 3)
    store.put_many(["b"], torch.ones((1, 4), dtype=torch.bfloat16))
    assert store.stack.dtype == torch.float32
    np.testing.assert_array_equal(
        _np(store.stack[store.ensure("a")]),
        (np.arange(4, dtype=np.float64) / 3).astype(np.float32))
    np.testing.assert_array_equal(_np(store.stack[store.ensure("b")]),
                                  np.ones(4, np.float32))


def test_lookup_snapshot_keeps_the_old_theta_after_put():
    """Torch tensors are mutable, so no write touches the live stack: a
    snapshot taken before a put (or put_many) keeps scoring the old theta,
    and the store's stack shows the new one."""
    store = ThetaStore(4, 8, device=CPU)
    store.put("a", _theta(8, 1))
    store.put("b", _theta(8, 2))
    snap, slots, _ = store.lookup_batch(["a", "b"])
    kept = snap.clone()
    store.put("a", _theta(8, 7))
    store.put_many(["b", "c"], np.stack([_theta(8, 8), _theta(8, 9)]))
    assert torch.equal(snap, kept)
    np.testing.assert_array_equal(_np(snap[slots[0]]), _theta(8, 1))
    np.testing.assert_array_equal(_np(snap[slots[1]]), _theta(8, 2))
    now, slots2, _ = store.lookup_batch(["a", "b", "c"])
    assert list(slots2[:2]) == list(slots)  # resident ids keep their slots
    np.testing.assert_array_equal(_np(now[slots2]),
                                  np.stack([_theta(8, k) for k in (7, 8, 9)]))


def _store_state(store):
    """(LRU order with slots, each resident row, versions, dirty set,
    counters) of a store of either package."""
    ids = store.resident()
    stack = _np(store.stack)
    with store._lock:
        slots = [store._slots[i] for i in ids]
        versions = {i: store._versions[i] for i in ids}
        dirty = set(store._dirty)
        stats = dict(store._stats)
    return ids, slots, stack[slots], versions, dirty, stats


def _assert_same_store(port, ref):
    got, want = _store_state(port), _store_state(ref)
    assert got[0] == want[0]          # LRU order
    assert got[1] == want[1]          # slots
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3:] == want[3:]        # versions, dirty, counters


def test_theta_store_from_reference_carries_the_same_state():
    """The same put / put_many / fault / evict / writeback sequence on a
    reference and a port store; the converter carries the reference's
    state across at every step, and the carried store then acts as the
    reference does."""
    D = 6
    backing = {f"r{i}": (np.full(D, 10.0 + i, np.float32), i)
               for i in range(5)}
    written = {"ref": [], "port": []}

    def handlers(side):
        def fault(mid):
            if mid not in backing:
                raise KeyError(mid)
            return backing[mid]

        def writeback(mid, theta, version):
            written[side].append((mid, _np(theta).copy(), version))
            return (version or 0) + 100

        return dict(fault=fault, writeback=writeback)

    ref = JThetaStore(4, D, **handlers("ref"))
    port = ThetaStore(4, D, device=CPU, **handlers("port"))
    rng = np.random.default_rng(0)

    def steps():
        yield lambda s: s.put("a", rng.normal(size=D).astype(np.float32))
        yield lambda s: s.put_many(["b", "c"], rng.normal(
            size=(2, D)).astype(np.float32))
        yield lambda s: s.ensure("r0")                        # fault
        yield lambda s: s.put("d", rng.normal(size=D).astype(np.float32),
                              dirty=True)                      # evicts a
        yield lambda s: s.ensure("b")
        yield lambda s: s.ensure("r1")                         # evicts c
        yield lambda s: s.put("a", rng.normal(size=D).astype(np.float32),
                              version=5)                       # evicts r0
        yield lambda s: s.lookup_batch(["r2", "a", "r3", "zz"])  # evicts d
        yield lambda s: s.evict("a")

    for i, step in enumerate(steps()):
        state = rng.bit_generator.state
        step(ref)
        rng.bit_generator.state = state
        step(port)
        _assert_same_store(port, ref)
        carried = convert.theta_store_from_reference(ref, device=CPU)
        _assert_same_store(carried, ref)
        assert carried._free == list(ref._free), i
    assert [w[0] for w in written["port"]] == ["d"]
    assert [(m, v) for m, _, v in written["ref"]] == \
        [(m, v) for m, _, v in written["port"]]
    # the carried store continues as the reference does
    carried = convert.theta_store_from_reference(ref, device=CPU)
    carried.fault, carried.writeback = handlers("port").values()
    for s in (ref, carried):
        s.ensure("r4")
        s.put("e", np.full(D, 3.0, np.float32), dirty=True)
        s.ensure("r0")
    _assert_same_store(carried, ref)


# ---------------------------------------------------------------------------
# multi-tenant KernelServer (tests/test_serve_many.py)
# ---------------------------------------------------------------------------

def test_multi_tenant_gather_parity_under_paging(base_model, registry8,
                                                 queries):
    """Tagged requests through a store FORCED smaller than the tenant set:
    every answer bitwise the row-wise reference with that tenant's
    registry theta, and within reduction order of its predict."""
    rng = np.random.default_rng(3)
    server = KernelServer(
        model=base_model, registry=registry8,
        store=ThetaStore(4, base_model.num_features, device=CPU),
        config=KernelServeConfig(max_delay_ms=5.0), autostart=False,
        device=CPU)
    reqs = []
    for i in range(20):
        mid = f"user-{rng.integers(0, 8)}"
        b = int(rng.integers(2, 6))
        x = queries[:b] + np.float32(0.01) * i
        reqs.append((mid, x, server.submit(x, mid)))
    server.start()
    outs = [(mid, x, f.result(timeout=TIMEOUT)) for mid, x, f in reqs]
    server.stop()
    assert server.stats()["store"]["faults"] > 0  # paging happened
    for mid, x, out in outs:
        theta = registry8.load(mid).theta
        np.testing.assert_array_equal(out, rowwise_ref(base_model, x, theta))
        np.testing.assert_allclose(out, _predict(registry8.load(mid), x),
                                   atol=REF_ATOL)


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_served_answers_match_the_reference_server(base_model, jmodel,
                                                   registry8, queries,
                                                   backend):
    """The same registry directory (written by the port), the same tagged
    queries through a paging store: the port's answers within REF_ATOL of
    the reference server's."""
    rng = np.random.default_rng(5)
    reqs = [(f"user-{rng.integers(0, 8)}",
             queries[:int(rng.integers(1, 6))] + np.float32(0.01) * i)
            for i in range(24)]
    cfg = dict(max_delay_ms=5.0, backend=backend)
    server = KernelServer(model=base_model, registry=registry8,
                          store_capacity=4, config=KernelServeConfig(**cfg),
                          autostart=False, device=CPU)
    jserver = JKernelServer(model=jmodel,
                            registry=JModelRegistry(registry8.root),
                            store_capacity=4,
                            config=JKernelServeConfig(**cfg),
                            autostart=False)
    outs = []
    for srv in (server, jserver):
        futs = [srv.submit(x, mid) for mid, x in reqs]
        srv.start()
        outs.append([np.asarray(f.result(timeout=TIMEOUT)) for f in futs])
        srv.stop()
    for (mid, x), got, want in zip(reqs, *outs):
        np.testing.assert_allclose(got, want, rtol=0, atol=REF_ATOL,
                                   err_msg=mid)
        np.testing.assert_array_equal(got, rowwise_ref(
            base_model, x, registry8.load(mid).theta, backend))


def test_thousand_resident_models_bit_parity(base_model, queries):
    """One server, >= 1000 resident models in one (M, D) stack, every
    tagged answer bitwise its model's row-wise reference, through
    bucket-padded gathered calls."""
    M, D = 1000, base_model.num_features
    rng = np.random.default_rng(11)
    thetas = rng.normal(scale=0.2, size=(M, D)).astype(np.float32)
    ids = [f"u{i:04d}" for i in range(M)]
    store = ThetaStore(1024, D, device=CPU)
    store.put_many(ids, thetas)
    server = KernelServer(model=base_model, store=store,
                          config=KernelServeConfig(max_delay_ms=5.0),
                          autostart=False, device=CPU)
    assert len(store) >= 1000
    picks = rng.integers(0, M, size=100)
    futs = [server.submit(queries[j % 32:j % 32 + 2], ids[i])
            for j, i in enumerate(picks)]
    server.start()
    outs = [f.result(timeout=TIMEOUT) for f in futs]
    server.stop()
    for j, (i, out) in enumerate(zip(picks, outs)):
        x = queries[j % 32:j % 32 + 2]
        np.testing.assert_array_equal(out,
                                      rowwise_ref(base_model, x, thetas[i]))


def test_answer_independent_of_cobatched_tenants(base_model, registry8,
                                                 queries):
    """Row-stability: the same (x, model) request scores bitwise the same
    flushed alone or coalesced into a full mixed bucket."""
    x = queries[:3]
    with KernelServer(model=base_model, registry=registry8, device=CPU,
                      config=KernelServeConfig(max_delay_ms=0.0)) as server:
        alone = server.predict(x, "user-3")
    server = KernelServer(model=base_model, registry=registry8, device=CPU,
                          config=KernelServeConfig(max_delay_ms=5.0),
                          autostart=False)
    futs = [server.submit(queries[4 * i % 60:4 * i % 60 + 4],
                          f"user-{i % 8}") for i in range(31)]
    probe = server.submit(x, "user-3")
    server.start()
    for f in futs:
        f.result(timeout=TIMEOUT)
    cobatched = probe.result(timeout=TIMEOUT)
    server.stop()
    assert server.stats()["batches"] == 1   # one 128-row bucket
    np.testing.assert_array_equal(alone, cobatched)
    np.testing.assert_array_equal(alone, rowwise_ref(
        base_model, x, registry8.load("user-3").theta))


def test_publish_hot_swaps_for_subsequent_requests(base_model, queries,
                                                   tmp_path):
    reg = ModelRegistry(str(tmp_path), device=CPU)
    reg.publish("solo", variant(base_model, 0))
    x = queries[:4]
    with KernelServer(model=base_model, registry=reg, device=CPU) as server:
        before = server.predict(x, "solo")
        refined = _np(variant(base_model, 5).theta)
        v = server.publish("solo", refined)
        assert v == 2 and reg.latest_version("solo") == 2
        after = server.predict(x, "solo")
        # a refined KernelModel publishes too
        assert server.publish("solo", variant(base_model, 6)) == 3
    np.testing.assert_array_equal(
        before, rowwise_ref(base_model, x, reg.load("solo", 1).theta))
    np.testing.assert_array_equal(after, rowwise_ref(base_model, x, refined))
    assert not np.array_equal(before, after)
    # the registry artifact round-trips the refined theta bit-identically
    np.testing.assert_array_equal(_np(reg.load("solo", 2).theta), refined)
    assert reg.load("solo", 2).meta["published_via"] == \
        "KernelServer.publish"


def test_hot_swap_atomicity_under_fire(base_model, registry8, queries):
    """No request ever scores a torn theta: while publishes hammer one
    tenant, every concurrent answer equals EXACTLY one published version's
    reference, and every in-flight future resolves."""
    reg_theta = _np(registry8.load("user-0").theta)
    versions = [reg_theta] + [
        reg_theta + np.float32(0.5) * (k + 1) for k in range(8)]
    x = queries[:4]
    refs = [rowwise_ref(base_model, x, th) for th in versions]
    server = KernelServer(model=base_model, store=ThetaStore(
        16, base_model.num_features, device=CPU), device=CPU,
        config=KernelServeConfig(max_delay_ms=0.5))
    server.publish("user-0", versions[0])
    results, failures = [], []

    def client():
        for _ in range(30):
            try:
                results.append(server.submit(x, "user-0").result(
                    timeout=TIMEOUT))
            except Exception as e:  # noqa: BLE001 - recorded and asserted
                failures.append(e)

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    for th in versions[1:]:
        server.publish("user-0", th)
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    server.stop()
    assert not failures
    assert len(results) == 120
    for out in results:
        assert any(np.array_equal(out, ref) for ref in refs), \
            "a served answer matched no published theta: torn read"


# ---------------------------------------------------------------------------
# request-lifecycle hardening
# ---------------------------------------------------------------------------

def test_unknown_model_fails_its_future_only(base_model, registry8,
                                             queries):
    with KernelServer(model=base_model, registry=registry8,
                      device=CPU) as server:
        bad = server.submit(queries[:2], "nobody")
        with pytest.raises(KeyError, match="nobody"):
            bad.result(timeout=TIMEOUT)
        # the collector survived; tagged traffic keeps flowing
        out = server.predict(queries[:2], "user-1")
        np.testing.assert_array_equal(
            out, rowwise_ref(base_model, queries[:2],
                             registry8.load("user-1").theta))


def test_wrong_input_dim_raises_before_enqueue(base_model, registry8):
    with KernelServer(model=base_model, registry=registry8,
                      device=CPU) as server:
        with pytest.raises(ValueError, match="queries"):
            server.submit(np.zeros((2, 99), np.float32), "user-1")
        before = server.stats()["requests"]
    assert before == 0  # the bad request never reached the queue


def test_stopped_multi_tenant_server_rejects_submissions(base_model,
                                                         registry8,
                                                         queries):
    server = KernelServer(model=base_model, registry=registry8, device=CPU)
    server.predict(queries[:2], "user-1")
    server.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        server.submit(queries[:2], "user-1")


def test_single_tenant_server_rejects_foreign_model_ids(base_model,
                                                        queries):
    with KernelServer(base_model, device=CPU) as server:
        with pytest.raises(ValueError, match="many-model"):
            server.submit(queries[:2], "someone-else")


def test_multi_tenant_construction_contracts(base_model, jmodel, registry8,
                                             tmp_path):
    # publish() is a multi-tenant feature
    with KernelServer(base_model, device=CPU) as single:
        with pytest.raises(RuntimeError, match="multi-tenant"):
            single.publish("x", base_model.theta)
    # an empty registry cannot define the featurizer template
    with pytest.raises(ValueError, match="registry"):
        KernelServer(registry=ModelRegistry(str(tmp_path), device=CPU),
                     device=CPU)
    # a store sized for a different D is rejected
    with pytest.raises(ValueError, match="D="):
        KernelServer(model=base_model, device=CPU,
                     store=ThetaStore(4, base_model.num_features + 1,
                                      device=CPU))
    # a tenant fitted against a different featurizer is rejected
    other = _carry(jax_fit(BASE.replace(
        krr=dataclasses.replace(BASE.krr, seed=123))).to_model())
    with KernelServer(model=base_model, registry=registry8,
                      device=CPU) as server:
        with pytest.raises(ValueError, match="featurizer"):
            server.publish("alien", other)
    # without model= the template is the registry's first model
    reg = ModelRegistry(str(tmp_path / "two"), device=CPU)
    for name, i in (("zed", 1), ("amy", 2)):
        reg.publish(name, variant(base_model, i))
    with KernelServer(registry=reg, device=CPU) as server:
        assert (server.model.model_id, server.model.version) == ("amy", 1)
        assert torch.equal(server.model.omega, base_model.omega)


# ---------------------------------------------------------------------------
# personalized models served by id
# ---------------------------------------------------------------------------

PZ_KRR = dict(dataset="heterogeneous", num_agents=12, samples_per_agent=60,
              num_tasks=3, num_features=32, lam=1e-3, rho=0.1,
              censor_v=0.3, censor_mu=0.97, seed=0)


def test_personalized_models_served_by_id(tmp_path):
    """A personalized fit's per-agent models published into the port's
    own registry (`FitResult.publish_models`), then served by id: each
    `pz-NNN` answer bitwise that model's score_rows, and within REF_ATOL
    of the reference's server on the same registry directory."""
    cfg = FitConfig(krr=KRRConfig(**PZ_KRR), graph="ring", num_iters=20,
                    primal="cg",
                    personalization=Personalization(k=3, every=5, warmup=5))
    built = build_problem(cfg, device=CPU)
    res = fit(cfg, problem=built.problem, device=CPU)
    reg = ModelRegistry(str(tmp_path), device=CPU)
    published = res.publish_models(reg, prefix="pz",
                                   rff_params=built.rff_params)
    assert published == [(f"pz-{i:03d}", 1) for i in range(12)]
    models = res.to_models(built.rff_params)
    rng = np.random.default_rng(9)
    reqs = [(int(rng.integers(0, 12)),
             rng.uniform(-1, 1, size=(int(rng.integers(1, 5)), 5)
                         ).astype(np.float32)) for _ in range(30)]
    cfg_s = dict(max_delay_ms=5.0)
    server = KernelServer(registry=reg, store_capacity=6, device=CPU,
                          config=KernelServeConfig(**cfg_s), autostart=False)
    jserver = JKernelServer(registry=JModelRegistry(str(tmp_path)),
                            store_capacity=6,
                            config=JKernelServeConfig(**cfg_s),
                            autostart=False)
    outs = []
    for srv in (server, jserver):
        futs = [srv.submit(x, f"pz-{i:03d}") for i, x in reqs]
        srv.start()
        outs.append([np.asarray(f.result(timeout=TIMEOUT)) for f in futs])
        srv.stop()
    assert server.stats()["store"]["faults"] > 0
    for (i, x), got, want in zip(reqs, *outs):
        own = models[i].score_rows(
            x, models[i].theta.expand(x.shape[0], -1))
        np.testing.assert_array_equal(got, _np(own), err_msg=str(i))
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=REF_ATOL * scale,
                                   err_msg=str(i))
