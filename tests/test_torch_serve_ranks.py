"""Serving on a mesh across ranks in the port (`ThetaStore(mesh=)` and
`KernelServer(mesh=)` on `make_host_mesh(..., group=)`) on the CPU,
against the one-process mesh server and the reference's server.

Each split of the (2, 4) mesh runs in one spawn of W gloo ranks over a
FileStore (a group timeout of two minutes), as in
tests/test_torch_mesh_ranks.py: W = 2 cut over the batch axis (2, 1) and
over the model axis (1, 2), and W = 4 cut (2, 2). Every rank builds the
same stores and servers (SPMD); the front (rank 0) alone submits and
publishes, from client threads, while every other rank follows its
commands. The cases: a single-tenant server; a resident multi-tenant
store under three client threads; a paged store against a registry (the
template's dirty theta written back into the front's registry, an
unknown id failing alone); hot swap under fire; an oversize request
sliced into bucket calls; a follower's submit, predict and publish
refused; stop ending every rank's server thread. Every rank writes what
it got to a file, and the parent holds each answer BITWISE to the
one-process (2, 4) mesh server's answer to that request alone (its own
row count), every follower's store and bucket calls to the front's, and
the one-process answers to the reference's `repro.serve.KernelServer` on
the same arrays (carried across by `convert`) within
tests/test_torch_sharding.py's 1e-5.

A second W = 2 spawn runs with a group timeout of a few seconds: an idle
server for longer than that timeout still answers (the front's
heartbeats keep its follower's broadcast alive), and then a follower
that raises mid-serve fails the spawn well inside that timeout.
"""
import datetime
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import convert
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve import (KernelServeConfig, KernelServer,
                               ModelRegistry, ThetaStore)

CPU = "cpu"
MESH = (2, 4)
SPLITS = {"W2-batch": (2, 1), "W2-model": (1, 2), "W4": (2, 2)}
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
SHORT_TIMEOUT = datetime.timedelta(seconds=4)
IDLE_S = 6.0          # longer than SHORT_TIMEOUT
HEARTBEAT_S = 0.5
TOL = 1e-5            # tests/test_torch_sharding.py
TIMEOUT = 60
BUCKETS = (8, 32)     # a 70-row request is three bucket calls
RESIDENT = 40
REGISTRY = 12
PAGED_SLOTS = 4
SWAP_VERSIONS = 5
CASES = ("single", "resident", "paged", "swap", "oversize")


def _config(delay_ms=5.0):
    return KernelServeConfig(backend="fused", max_delay_ms=delay_ms,
                             buckets=BUCKETS)


def _model(arrays):
    return convert.model_from_numpy(
        {k: arrays[f"model_{k}"] for k in ("omega", "bias", "theta")},
        {"mapping": "cos_bias", "bandwidth": 1.0}, device=CPU)


def _res_ids():
    return [f"r{i:03d}" for i in range(RESIDENT)]


def _reg_ids():
    return [f"p{i:02d}" for i in range(REGISTRY)]


# ---------------------------------------------------------------------------
# What every rank runs
# ---------------------------------------------------------------------------

def _clients(server, ids, queries, *, clients, requests, seed):
    """`clients` threads, each firing `requests` tagged requests of 1-5
    query rows at uniform ids, back to back: [(id, x, answer)]."""
    answers, failures = [], []
    lock = threading.Lock()

    def client(cid):
        rng = np.random.default_rng(seed + cid)
        got = []
        try:
            for _ in range(requests):
                mid = ids[int(rng.integers(0, len(ids)))]
                lo = int(rng.integers(0, len(queries) - 5))
                x = queries[lo:lo + int(rng.integers(1, 6))]
                got.append((mid, x, server.submit(x, mid).result(
                    timeout=TIMEOUT)))
        except Exception as e:  # noqa: BLE001 - asserted below
            failures.append(e)
        with lock:
            answers.extend(got)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not failures and not any(t.is_alive() for t in threads), \
        failures[:1]
    return answers


def _refused(server):
    """What a follower's submit, predict and publish raise."""
    out = {}
    for what, call in (("submit", lambda: server.submit(np.zeros((1, 5)))),
                       ("predict", lambda: server.predict(np.zeros((1, 5)))),
                       ("publish", lambda: server.publish(
                           "u", np.zeros(server.model.num_features)))):
        try:
            call()
            out[what] = None
        except RuntimeError as e:
            out[what] = str(e)
    return out


def _finish(server, store=None):
    """Stop the server (on every rank) and what the parent compares."""
    server.stop()
    out = {"server": {k: v for k, v in server.stats().items()
                      if k not in ("requests", "store")}}
    if store is not None:
        out["resident"] = store.resident()
        out["stats"] = store.stats()
    return out


def serve_cases(rank, mesh, arrays, regdir) -> dict:
    """Every case on `mesh` (a rank's share of it): {case: results}."""
    front = rank == 0
    model = _model(arrays)
    D = model.num_features
    queries = arrays["queries"]
    out = {}
    kw = dict(mesh=mesh, device=CPU, heartbeat_s=HEARTBEAT_S)

    # single-tenant: a few requests, coalesced
    srv = KernelServer(model, _config(), autostart=False, **kw)
    answers = []
    if front:
        reqs = [queries[i:i + n] for i, n in ((0, 1), (3, 3), (9, 8),
                                              (20, 5))]
        futs = [srv.submit(x) for x in reqs]
        srv.start()
        answers = [(None, x, f.result(timeout=TIMEOUT))
                   for x, f in zip(reqs, futs)]
    out["single"] = dict(_finish(srv), answers=answers)

    # resident: RESIDENT ids put on every rank, three client threads
    store = ThetaStore(RESIDENT + 8, D, device=CPU, mesh=mesh)
    store.put_many(_res_ids(), arrays["resident"])
    srv = KernelServer(model, _config(), store=store, **kw)
    answers = []
    if front:
        answers = _clients(srv, _res_ids(), queries, clients=3,
                           requests=8, seed=1)
    out["resident"] = dict(_finish(srv, store), answers=answers)

    # paged: REGISTRY ids through PAGED_SLOTS slots; one coalesced flush
    # pages through in deferred rounds, an unknown id fails alone, then
    # two clients; the template's dirty theta is written back
    reg = ModelRegistry(regdir, device=CPU)
    store = ThetaStore(PAGED_SLOTS, D, device=CPU, mesh=mesh)
    srv = KernelServer(model, _config(), registry=reg, store=store,
                       autostart=False, **kw)
    answers, unknown = [], None
    if front:
        rng = np.random.default_rng(3)
        reqs = []
        for i in range(10):
            mid = "nope" if i == 5 else _reg_ids()[i]
            x = queries[i:i + int(rng.integers(1, 4))]
            reqs.append((mid, x, srv.submit(x, mid)))
        srv.start()
        for mid, x, f in reqs:
            if mid == "nope":
                try:
                    f.result(timeout=TIMEOUT)
                except KeyError as e:
                    unknown = repr(e)
                continue
            answers.append((mid, x, f.result(timeout=TIMEOUT)))
        answers += _clients(srv, _reg_ids(), queries, clients=2,
                            requests=6, seed=30)
    out["paged"] = dict(_finish(srv, store), answers=answers,
                        unknown=unknown)

    # hot swap under fire: two clients on "u" while the front publishes
    store = ThetaStore(8, D, device=CPU, mesh=mesh)
    srv = KernelServer(model, _config(0.5), store=store, **kw)
    answers, refused, last = [], None, None
    versions = arrays["swap"]
    xq = queries[:4]
    if front:
        srv.publish("u", versions[0])
        stop_fire = threading.Event()
        failures = []

        def fire():
            try:
                while not stop_fire.is_set():
                    answers.append(("u", xq, srv.submit(xq, "u").result(
                        timeout=TIMEOUT)))
            except Exception as e:  # noqa: BLE001 - asserted below
                failures.append(e)

        threads = [threading.Thread(target=fire) for _ in range(2)]
        for t in threads:
            t.start()
        for v in versions[1:]:
            time.sleep(0.01)
            srv.publish("u", v)
        time.sleep(0.01)
        stop_fire.set()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not failures, failures[:1]
        last = srv.predict(xq, "u")
    else:
        refused = _refused(srv)
    out["swap"] = dict(_finish(srv, store), answers=answers, last=last,
                       refused=refused)

    # oversize: one 70-row request, sliced into 32 + 32 + 6 (padded to 8)
    store = ThetaStore(4, D, device=CPU, mesh=mesh)
    srv = KernelServer(model, _config(), store=store, **kw)
    answers = []
    if front:
        srv.publish("big", arrays["big"])
        x = queries[:70]
        answers = [("big", x, srv.predict(x, "big"))]
    out["oversize"] = dict(_finish(srv, store), answers=answers)

    out["threads"] = sorted(t.name for t in threading.enumerate()
                            if t.name.startswith("kernel-server"))
    return out


def _broadcasts(rank):
    """`broadcast_ranks` of values that fit its first message and of a
    value that needs a second (5000 float64, ~40 kB), as each rank
    received them, with the messages each took."""
    rng = np.random.default_rng(9)
    values = [("short", [1, None]), {"x": rng.normal(size=5000)},
              rng.normal(size=(3, 7)).astype(np.float32)]
    got = []
    for v in values:
        before = sharding.TRAFFIC["broadcasts"]
        got.append((sharding.broadcast_ranks(
            v if rank == 0 else None, dist.group.WORLD, torch.device(CPU)),
            sharding.TRAFFIC["broadcasts"] - before))
    return values, got


def _spy_collectives():
    """Record, for every collective this process makes from here on, its
    thread's name and whether a store call or a featurizer check is
    under way on that thread: [(kind, thread, inside)]."""
    calls, local = [], threading.local()

    def inside(fn):
        def wrapped(*args, **kw):
            depth = getattr(local, "depth", 0)
            local.depth = depth + 1
            try:
                return fn(*args, **kw)
            finally:
                local.depth = depth
        return wrapped

    def spy(kind, fn):
        def wrapped(*args, **kw):
            calls.append((kind, threading.current_thread().name,
                          getattr(local, "depth", 0) > 0))
            return fn(*args, **kw)
        return wrapped

    for name in ("put", "put_many", "ensure", "evict", "lookup_batch"):
        setattr(ThetaStore, name, inside(getattr(ThetaStore, name)))
    KernelServer._check_compatible = inside(KernelServer._check_compatible)
    sharding.gather_ranks = spy("gather", sharding.gather_ranks)
    sharding.broadcast_ranks = spy("broadcast", sharding.broadcast_ranks)
    return calls


def _rank_main(rank, world, store, split, npz, out, regdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    try:
        arrays = dict(np.load(npz))
        mesh = make_host_mesh(*MESH, device=CPU, group=dist.group.WORLD,
                              split=split)
        res = {"broadcast": _broadcasts(rank)}
        calls = _spy_collectives()
        res.update(serve_cases(rank, mesh, arrays, regdir))
        res["collectives"] = calls
        res["traffic"] = dict(sharding.TRAFFIC)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _idle_then_fail(rank, world, store, npz, out):
    """The short-timeout spawn: the front idles past the group's timeout,
    then is answered; then the follower raises in its next bucket call."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=SHORT_TIMEOUT)
    arrays = dict(np.load(npz))
    mesh = make_host_mesh(*MESH, device=CPU, group=dist.group.WORLD,
                          split=(2, 1))
    srv = KernelServer(_model(arrays), _config(), mesh=mesh, device=CPU,
                       heartbeat_s=HEARTBEAT_S)
    x = arrays["queries"][:3]
    if rank == 0:
        time.sleep(IDLE_S)
        answer = srv.predict(x)
        torch.save({"answer": answer, "t": time.time()},
                   os.path.join(out, "front.pt"))
        srv.predict(x)      # the follower fails in this one
        return

    real, calls = srv._score_all, []

    def failing(*args):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("the follower fails mid-serve")
        return real(*args)

    srv._score_all = failing
    srv.stop()               # raises the follower loop's error


def _outcome(call, timeout):
    """What `call` returned or raised on a thread of its own, or "hung"
    if it had not ended after `timeout` seconds."""
    box = []

    def run():
        try:
            box.append(("ok", call()))
        except Exception as e:  # noqa: BLE001 - recorded
            box.append(("raised", repr(e)))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=timeout)
    return box[0] if box else ("hung", None)


def _publish_after_a_follower_fails(rank, world, store, npz, out, mode):
    """The short-timeout spawn of a publish across a lost follower: the
    follower's first broadcast raises, its process ends; then the front
    publishes alone ("alone", until one fails) or a publish coalesced
    behind a request ("coalesced"). Each rank writes what it saw."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=SHORT_TIMEOUT)
    arrays = dict(np.load(npz))
    mesh = make_host_mesh(*MESH, device=CPU, group=dist.group.WORLD,
                          split=(2, 1))
    model = _model(arrays)
    if rank != 0:
        def lost(*args):
            raise RuntimeError("the follower is lost")

        sharding.broadcast_ranks = lost
    srv = KernelServer(model, _config(500.0), mesh=mesh, device=CPU,
                       store=ThetaStore(4, model.num_features, device=CPU,
                                        mesh=mesh),
                       heartbeat_s=60.0)
    if rank != 0:
        try:
            srv.stop()
        except RuntimeError as e:
            torch.save(repr(e), os.path.join(out, "follower.pt"))
        return
    deadline = time.time() + TIMEOUT
    while not os.path.exists(os.path.join(out, "follower.pt")):
        assert time.time() < deadline, "the follower never failed"
        time.sleep(0.05)
    time.sleep(1.0)          # its process ends, and its sockets close
    wait = 3 * SHORT_TIMEOUT.total_seconds()
    outcomes = []
    theta = arrays["big"]
    if mode == "alone":
        while len(outcomes) < 5 and (not outcomes
                                     or outcomes[-1][0] == "ok"):
            outcomes.append(_outcome(lambda: srv.publish("u", theta), wait))
    else:
        fut = srv.submit(arrays["queries"][:3])
        outcomes.append(_outcome(lambda: srv.publish("u", theta), wait))
        outcomes.append(_outcome(lambda: fut.result(), wait))
    try:
        srv.stop()
    except RuntimeError:
        pass
    torch.save(outcomes, os.path.join(out, "front.pt"))


# ---------------------------------------------------------------------------
# Fixtures: the inputs, the ranked runs, the one-process answers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The reference's base model and the thetas as arrays (every rank
    loads the same file), a registry of REGISTRY variants written by the
    port, and the reference's model."""
    from repro.api import FitConfig as JFitConfig
    from repro.api import KRRConfig as JKRRConfig
    from repro.api import fit as jax_fit

    jm = jax_fit(JFitConfig(
        krr=JKRRConfig(num_agents=4, samples_per_agent=30, num_features=16,
                       lam=1e-2, rho=0.5, seed=0),
        algorithm="coke", censor_v=0.5, censor_mu=0.97,
        num_iters=30)).to_model()
    arrays = {f"model_{k}": np.asarray(v)
              for k, v in jm._array_tree().items() if k != "thetas"}
    theta = arrays["model_theta"]
    D = theta.shape[0]
    rng = np.random.default_rng(17)

    def around(n):
        return (theta + rng.normal(scale=0.1, size=(n, D))).astype(
            np.float32)

    arrays.update(resident=around(RESIDENT), registry=around(REGISTRY),
                  swap=around(SWAP_VERSIONS), big=around(1)[0],
                  queries=rng.uniform(size=(96, jm.input_dim)).astype(
                      np.float32))
    tmp = tmp_path_factory.mktemp("serve_ranks")
    npz = str(tmp / "inputs.npz")
    np.savez(npz, **arrays)
    model = _model(arrays)
    reg = ModelRegistry(str(tmp / "registry"), device=CPU)
    for mid, th in zip(_reg_ids(), arrays["registry"]):
        reg.publish(mid, model.replace(theta=torch.from_numpy(th)))
    return npz, arrays, reg.root, jm


_RANKED: dict = {}


def _ranked(split_name, inputs, tmp_path_factory):
    """Every rank's results of one split, from one spawn (made once),
    and the registry directory it served from."""
    if split_name not in _RANKED:
        npz, _, root, _ = inputs
        split = SPLITS[split_name]
        world = split[0] * split[1]
        tmp = tmp_path_factory.mktemp(f"serve_{split_name}")
        regdir = str(tmp / "registry")
        shutil.copytree(root, regdir)
        mp.start_processes(_rank_main, args=(world, str(tmp / "store"),
                                             split, npz, str(tmp), regdir),
                           nprocs=world, join=True, start_method="spawn")
        _RANKED[split_name] = (
            [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(world)], regdir)
    return _RANKED[split_name]


@pytest.fixture(scope="module", params=list(SPLITS))
def ranked(request, inputs, tmp_path_factory):
    return (request.param,) + _ranked(request.param, inputs,
                                      tmp_path_factory)


def _thetas_of(case, arrays):
    """{id: theta} a case's requests are scored against (the hot swap's
    versions as "u#k")."""
    if case == "resident":
        return dict(zip(_res_ids(), arrays["resident"]))
    if case == "paged":
        return dict(zip(_reg_ids(), arrays["registry"]))
    if case == "swap":
        return {f"u#{k}": v for k, v in enumerate(arrays["swap"])}
    if case == "oversize":
        return {"big": arrays["big"]}
    return {}


def one_process_answers(case, arrays, reqs):
    """The one-process (2, 4) mesh server's answer to each (id, x) alone,
    at its own row count (max_delay_ms=0: every request its own flush)."""
    mesh = make_host_mesh(*MESH, device=CPU)
    model = _model(arrays)
    thetas = _thetas_of(case, arrays)
    if case == "single":
        srv = KernelServer(model, _config(0.0), mesh=mesh, device=CPU)
    else:
        store = ThetaStore(len(thetas) + 1, model.num_features, device=CPU,
                           mesh=mesh)
        store.put_many(list(thetas), np.stack(list(thetas.values())))
        srv = KernelServer(model, _config(0.0), mesh=mesh, store=store,
                           device=CPU)
    with srv:
        return [srv.predict(x, mid) for mid, x in reqs]


def _reference_answers(case, arrays, jm, reqs):
    """The reference's `repro.serve.KernelServer` on the same arrays."""
    from repro.serve import KernelServeConfig as JKernelServeConfig
    from repro.serve import KernelServer as JKernelServer
    from repro.serve import ThetaStore as JThetaStore

    cfg = JKernelServeConfig(backend="fused", max_delay_ms=0.0,
                             buckets=BUCKETS)
    thetas = _thetas_of(case, arrays)
    if case == "single":
        srv = JKernelServer(model=jm, config=cfg)
    else:
        store = JThetaStore(len(thetas) + 1, jm.num_features)
        store.put_many(list(thetas), np.stack(list(thetas.values())))
        srv = JKernelServer(model=jm, store=store, config=cfg)
    try:
        return [np.asarray(srv.predict(x, mid)) for mid, x in reqs]
    finally:
        srv.stop()


_ONE: dict = {}


def _one(case, arrays, reqs):
    """One-process answers, cached by request."""
    out = []
    for mid, x in reqs:
        key = (case, mid, x.tobytes())
        if key not in _ONE:
            _ONE[key] = one_process_answers(case, arrays, [(mid, x)])[0]
        out.append(_ONE[key])
    return out


def _requests(case, res):
    """(id, x) of a case's answers as the one-process server is asked
    them (the hot swap's answers are held to every version)."""
    return [(mid, x) for mid, x, _ in res[case]["answers"]]


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [c for c in CASES if c != "swap"])
def test_every_answer_is_the_one_process_servers(ranked, inputs, case):
    """Each answer the front got, bitwise the one-process mesh server's
    answer to the same request alone; followers got none."""
    name, ranks, _ = ranked
    arrays = inputs[1]
    front = ranks[0][case]
    assert front["answers"], (name, case)
    want = _one(case, arrays, _requests(case, ranks[0]))
    for (mid, _, got), w in zip(front["answers"], want):
        np.testing.assert_array_equal(got, w, err_msg=f"{name}:{case}:{mid}")
    for res in ranks[1:]:
        assert res[case]["answers"] == []


def test_hot_swap_is_atomic_per_bucket(ranked, inputs):
    """Every answer under fire is bitwise the one-process answer of
    exactly one published version (old or new, never torn between
    blocks), and the last publish serves once it returned."""
    name, ranks, _ = ranked
    arrays = inputs[1]
    swap = ranks[0]["swap"]
    xq = arrays["queries"][:4]
    refs = _one("swap", arrays, [(f"u#{k}", xq)
                                 for k in range(SWAP_VERSIONS)])
    assert len(swap["answers"]) > 0
    for _, _, out in swap["answers"]:
        assert sum(np.array_equal(out, r) for r in refs) == 1, name
    np.testing.assert_array_equal(swap["last"], refs[-1])


@pytest.mark.parametrize("case", ["resident", "paged", "swap", "oversize"])
def test_every_follower_ends_with_the_fronts_store(ranked, case):
    """Every rank's store ends with the front's resident ids (LRU order)
    and stats, and its server ran the front's bucket calls."""
    name, ranks, _ = ranked
    want = ranks[0][case]
    assert want["server"]["batches"] > 0
    for r, res in enumerate(ranks[1:], 1):
        got = res[case]
        assert got["resident"] == want["resident"], (name, case, r)
        assert got["stats"] == want["stats"], (name, case, r)
        assert got["server"] == want["server"], (name, case, r)


def test_paging_faults_evicts_and_writes_back_once(ranked, inputs):
    """The paged store faulted, evicted and wrote the template's dirty
    theta back: into the front's registry, once, with the template's
    bits (the followers replay the front's version and write nothing)."""
    name, ranks, regdir = ranked
    arrays = inputs[1]
    stats = ranks[0]["paged"]["stats"]
    assert stats["faults"] > 0 and stats["evictions"] > 0, name
    assert stats["writebacks"] == 1, name
    reg = ModelRegistry(regdir, device=CPU)
    assert reg.versions("default") == [1]
    np.testing.assert_array_equal(reg.load("default").theta.numpy(),
                                  arrays["model_theta"])
    assert reg.load("default").meta["published_via"] == "ThetaStore.evict"


def test_an_unknown_id_fails_alone(ranked):
    """'nope' in a coalesced flush fails its own future with KeyError;
    the other nine requests of that flush are answered."""
    name, ranks, _ = ranked
    paged = ranks[0]["paged"]
    assert paged["unknown"] is not None and "nope" in paged["unknown"]
    assert len(paged["answers"]) == 9 + 2 * 6, name


def test_the_oversize_request_is_sliced_into_buckets(ranked):
    """70 rows: three bucket calls (32, 32, 6 padded to 8) on every rank."""
    name, ranks, _ = ranked
    for res in ranks:
        s = res["oversize"]["server"]
        assert (s["batches"], s["rows"], s["padded_rows"]) == (3, 70, 2), \
            name


def test_followers_refuse_requests_and_publishes(ranked):
    name, ranks, _ = ranked
    assert ranks[0]["swap"]["refused"] is None
    for res in ranks[1:]:
        for what, msg in res["swap"]["refused"].items():
            assert msg is not None and "only the front" in msg, \
                (name, what)


def test_stop_ends_every_ranks_server(ranked):
    """No server thread outlives its stop() on any rank; every rank made
    the same number of broadcasts (the front's commands)."""
    name, ranks, _ = ranked
    assert all(res["threads"] == [] for res in ranks), name
    counts = {res["traffic"]["broadcasts"] for res in ranks}
    assert len(counts) == 1 and counts.pop() > 0, name


def test_broadcast_ranks_carries_short_and_long_values(ranked):
    """Every rank gets rank 0's value, whether its pickle fits the first
    message or needs the second."""
    name, ranks, _ = ranked
    for res in ranks:
        values, got = res["broadcast"]
        assert [n for _, n in got] == [1, 2, 1], name
        for want, (g, _) in zip(values, got):
            if isinstance(want, dict):
                np.testing.assert_array_equal(g["x"], want["x"])
            elif isinstance(want, np.ndarray):
                assert g.dtype == want.dtype
                np.testing.assert_array_equal(g, want)
            else:
                assert g == want, name


def test_collectives_run_on_the_server_threads_only(ranked):
    """Every broadcast and gather of the serving cases ran on the front's
    collector or a follower's loop (none on a client's, a publisher's or
    the main thread), none inside a store call or a featurizer check;
    every rank made the same sequence of kinds."""
    name, ranks, _ = ranked
    want = {"kernel-server"} | ({"kernel-server-follower"}
                                if len(ranks) > 1 else set())
    for r, res in enumerate(ranks):
        calls = res["collectives"]
        assert calls, (name, r)
        assert {t for _, t, _ in calls} <= want, (name, r)
        assert not any(inside for _, _, inside in calls), (name, r)
        assert [k for k, _, _ in calls] == \
            [k for k, _, _ in ranks[0]["collectives"]], (name, r)


@pytest.mark.parametrize("case", CASES)
def test_the_one_process_server_is_the_reference_server(
        inputs, tmp_path_factory, case):
    """The one-process mesh server's answers (which every rank's equal)
    within 1e-5 of the reference's KernelServer on the same arrays, at
    the W4 split's requests (every split sends the same ones)."""
    ranks, _ = _ranked("W4", inputs, tmp_path_factory)
    arrays, jm = inputs[1], inputs[3]
    if case == "swap":
        reqs = [(f"u#{k}", arrays["queries"][:4])
                for k in range(SWAP_VERSIONS)]
    else:
        reqs = _requests(case, ranks[0])
    got = _one(case, arrays, reqs)
    want = _reference_answers(case, arrays, jm, reqs)
    for (mid, _), g, w in zip(reqs, got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL,
                                   err_msg=f"{case}:{mid}")


def test_idle_past_the_timeout_then_a_failing_follower_fails_the_spawn(
        inputs, tmp_path):
    """W = 2 with a group timeout of SHORT_TIMEOUT: after IDLE_S seconds
    of silence (past that timeout) the front is answered, bitwise the
    one-process server; then a follower raising in its bucket call fails
    the spawn well inside the timeout, not a hang."""
    npz, arrays = inputs[0], inputs[1]
    with pytest.raises(mp.ProcessRaisedException,
                       match="mid-serve|across ranks"):
        mp.start_processes(_idle_then_fail,
                           args=(2, str(tmp_path / "store"), npz,
                                 str(tmp_path)),
                           nprocs=2, join=True, start_method="spawn")
    failed_at = time.time()
    front = torch.load(tmp_path / "front.pt", weights_only=False)
    x = arrays["queries"][:3]
    np.testing.assert_array_equal(front["answer"],
                                  _one("single", arrays, [(None, x)])[0])
    assert failed_at - front["t"] < SHORT_TIMEOUT.total_seconds()


@pytest.mark.parametrize("mode", ("alone", "coalesced"))
def test_a_publish_across_a_lost_follower_fails_and_does_not_hang(
        inputs, tmp_path, mode):
    """W = 2 with a group timeout of SHORT_TIMEOUT: once a follower is
    lost, a publish on the front (alone, or coalesced behind a request
    into the same collector round) raises RuntimeError, and the request
    with it, instead of leaving its caller waiting."""
    mp.start_processes(_publish_after_a_follower_fails,
                       args=(2, str(tmp_path / "store"), inputs[0],
                             str(tmp_path), mode),
                       nprocs=2, join=True, start_method="spawn")
    assert "the follower is lost" in torch.load(
        tmp_path / "follower.pt", weights_only=False)
    outcomes = torch.load(tmp_path / "front.pt", weights_only=False)
    assert ("hung", None) not in outcomes, outcomes
    failed = outcomes[-2:] if mode == "coalesced" else outcomes[-1:]
    for kind, what in failed:
        assert kind == "raised" and "across ranks" in what, outcomes
