"""A mesh under gossip and under personalization in the port (`fit(mesh=)`
with exec="gossip", churn or a learned collaboration graph; the gossip
table's gather and the graph's top-k on blocked tensors) on the CPU,
against the reference.

The reference's own sharded runs of these configurations cannot run on
this jax: spmd with the gradient primal stops in `ShardingTypeError:
Contracting dimensions are sharded`, spmd with CG and the simulator's
Cholesky under gossip in a vmap "inconsistent axis specs" ValueError, the
simulator's CG under gossip in a gather ShardingTypeError. So, as in
tests/test_torch_sharding.py, the port's sharded runs are held to the
reference's UNSHARDED runs on the same carried-across problem, on meshes
(1, 4), (2, 2) and (2, 4) of `make_host_mesh(..., device="cpu")`.

Tolerances: comms and bits exact everywhere. Under gossip theta within
1e-5 with the gradient primal and 1e-4 with CG (the port's simulator CG
tolerance). Under personalization the learned graph's support exact at
every refresh and theta within 1e-3 relative, the reference's own
tolerance between two personalized runs (tests/test_torch_personalize.py
says why). The layout's own contracts are bitwise: the gossip gather on a
batch-cut x equals the plain gather, the personalized warmup prefix on a
mesh equals the sharded static run, and no chunk loop gathers a blocked
tensor whole (`sharding.unshard`).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ChurnSchedule as JChurn
from repro.api import FitConfig as JFitConfig
from repro.api import KRRConfig as JKRRConfig
from repro.api import Personalization as JPersonalization
from repro.api import build_problem as jax_build_problem
from repro.api import fit as jax_fit
from repro.core import gossip as JG
from repro.core import personalize as JP

from repro_torch import convert
from repro_torch.api import (ChurnSchedule, FitConfig, KRRConfig,
                             Personalization, fit)
from repro_torch.core import gossip as G
from repro_torch.core import graph as port_graph
from repro_torch.core import personalize as P
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_host_mesh

torch.set_num_threads(2)

CPU = "cpu"
TOL = 1e-5         # the gradient primal
CG_TOL = 1e-4      # the CG primal
PZ_RTOL = 1e-3     # a personalized fit's theta, relative
MESHES = ((1, 4), (2, 2), (2, 4))

# gossip: an 8-agent ring, D = 64 (16 features a model block at 4)
KRR_G = dict(num_agents=8, samples_per_agent=20, num_features=64, lam=1e-2,
             rho=0.1, seed=0)
GOSSIP = dict(graph="ring", censor_v=0.3, censor_mu=0.97, num_iters=20,
              exec="gossip")
CHURN = dict(leave=((5, 2),), join=((12, 2),))
EXECS = {"participation": dict(participation=0.5),
         "size": dict(gossip_size=3),
         "churn": dict(participation=0.5, churn=CHURN)}
#: backend -> its primal; the fused backend on a mesh runs the ring
#: runtime (K3 once per block), held to the reference's spmd fit
PRIMALS = {"simulator": "cg", "spmd": "cg", "fused": "gradient"}

# personalization: tests/test_personalize.py's clustered workload
KRR_P = dict(dataset="heterogeneous", num_agents=12, samples_per_agent=60,
             num_tasks=3, num_features=32, lam=1e-3, rho=0.1, censor_v=0.3,
             censor_mu=0.97, seed=0)
PZ = dict(k=3, every=5, warmup=15)
PZ_ITERS = 28                 # refreshes at iterations 16, 21 and 26
REFRESHES = (16, 21, 26)
PZ_EXECS = {"sync": {}, "gossip": dict(exec="gossip", participation=0.5)}


def _np(a):
    a = sharding.unshard(a)
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _carry(jprob):
    return convert.problem_from_numpy(
        np.asarray(jprob.feats), np.asarray(jprob.labels),
        np.asarray(jprob.adjacency), jprob.lam, jprob.rho, device=CPU)


def _cfgs(krr, **kw):
    """(reference FitConfig, port FitConfig) of the same knobs; `churn` and
    `pz` dicts become each package's objects."""
    jkw, tkw = dict(kw), dict(kw)
    if "churn" in kw:
        jkw["churn"], tkw["churn"] = JChurn(**kw["churn"]), \
            ChurnSchedule(**kw["churn"])
    if "pz" in kw:
        pz = jkw.pop("pz")
        tkw.pop("pz")
        jkw["personalization"] = JPersonalization(**pz)
        tkw["personalization"] = Personalization(**pz)
    return (JFitConfig(krr=JKRRConfig(**krr), **jkw),
            FitConfig(krr=KRRConfig(**krr), **tkw))


def _assert_comms(ref_h, port_h, err):
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(_np(port_h[k]), np.asarray(ref_h[k]),
                                      err_msg=f"{err}:{k}")


@pytest.fixture(scope="module")
def gossip_problem():
    jprob = jax_build_problem(_cfgs(KRR_G, **GOSSIP)[0]).problem
    return jprob, _carry(jprob)


@pytest.fixture(scope="module")
def pz_problem():
    jprob = jax_build_problem(_cfgs(KRR_P, graph="ring")[0]).problem
    return jprob, _carry(jprob)


_REFS: dict = {}


def _reference(key, jcfg, jprob):
    """The reference's unsharded fit, made once per configuration (every
    mesh is held to the same run)."""
    if key not in _REFS:
        _REFS[key] = jax_fit(jcfg, problem=jprob)
    return _REFS[key]


# ---------------------------------------------------------------------------
# The layout's gossip gather and the graph's top-k on blocked tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data,model", MESHES + ((4, 2), (2, 3)))
@pytest.mark.parametrize("family", ["ring", "erdos_renyi", "full"])
def test_gather_sum_on_a_batch_cut_x_is_bitwise_the_plain_one(family, data,
                                                              model):
    """NeighborTable.gather_sum on a blocked x, (N, D) and (N,), with
    churn's alive-weighted rows: every row bitwise the plain gather (the
    sum over K is one left fold in both), also where K > 2."""
    N, D = 12, 24
    A = {"ring": lambda: port_graph.ring(N),
         "erdos_renyi": lambda: port_graph.erdos_renyi(N, 0.4, seed=2),
         "full": lambda: port_graph.fully_connected(N)}[family]().adjacency
    table = G.NeighborTable.from_adjacency(A)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    alive = torch.from_numpy(rng.uniform(size=N) > 0.25)
    mesh = make_host_mesh(data, model, device=CPU)
    for weights in (table.nmask, table._weights(alive)):
        for xx in (x, x[:, 3].contiguous()):
            bx = sharding.shard_features(xx, mesh, N)
            assert isinstance(bx, sharding.Blocked)
            got = table.gather_sum(bx, weights)
            assert isinstance(got, sharding.Blocked)
            assert got.kinds == bx.kinds
            assert torch.equal(sharding.unshard(got),
                               table.gather_sum(xx, weights))
    # the plain gather is the reference's, within 1e-6
    jt = JG.NeighborTable.from_adjacency(A)
    np.testing.assert_allclose(
        _np(table.gather_sum(x, table.nmask)),
        np.asarray(jt.nbr_sum(jnp.asarray(x.numpy()))), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("data,model", MESHES)
@pytest.mark.parametrize("affinity,scale", [("rbf", 0.0), ("rbf", 2.0),
                                            ("cosine", 0.0)])
def test_topk_neighbors_on_a_blocked_theta_keeps_the_ranking(affinity, scale,
                                                             data, model):
    """topk_neighbors on a blocked (N, D) theta (|t|^2 and the dots psummed
    over the feature blocks) at a non-tied input: the plain call's and the
    reference's indices, weights within 1e-6; and the mutual graph's
    support equal."""
    N, D, k = 12, 32, 3
    rng = np.random.default_rng(5)
    t = rng.normal(size=(N, D)).astype(np.float32)
    t64 = t.astype(np.float64)
    d2 = ((t64[:, None] - t64[None]) ** 2).sum(-1) + np.diag(
        np.full(N, np.inf))
    gaps = np.diff(np.sort(d2, axis=1)[:, :k + 1], axis=1)
    assert gaps.min() > 1e-3 * d2[np.isfinite(d2)].max()   # not tied
    mesh = make_host_mesh(data, model, device=CPU)
    bt = sharding.shard_features(torch.from_numpy(t), mesh, N)
    idx, w = P.topk_neighbors(bt, k, affinity, scale)
    pidx, pw = P.topk_neighbors(torch.from_numpy(t), k, affinity, scale)
    jidx, jw = JP.topk_neighbors(jnp.asarray(t), k, affinity, scale)
    assert isinstance(idx, torch.Tensor) and isinstance(w, torch.Tensor)
    assert torch.equal(idx, pidx)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), pw.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    pz = Personalization(k=k, affinity=affinity, scale=scale)
    assert torch.equal(P.learned_adjacency(pz, bt) > 0,
                       P.learned_adjacency(pz, torch.from_numpy(t)) > 0)


# ---------------------------------------------------------------------------
# Gossip on a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("backend", sorted(PRIMALS))
@pytest.mark.parametrize("exec_", sorted(EXECS))
@pytest.mark.parametrize("alg", ["coke", "dkla"])
def test_gossip_on_a_mesh_matches_the_unsharded_reference(
        alg, exec_, backend, mesh, gossip_problem):
    """Participation sampling, a fixed gossip size and churn (leave and
    rejoin) on each backend: comms and bits exact, theta within 1e-5
    (gradient) or 1e-4 (CG). Churn on the fused backend raises the
    reference's ValueError, on a mesh as without one."""
    jprob, tprob = gossip_problem
    kw = dict(GOSSIP, algorithm=alg, backend=backend,
              primal=PRIMALS[backend], **EXECS[exec_])
    jcfg, tcfg = _cfgs(KRR_G, **kw)
    tmesh = make_host_mesh(*mesh, device=CPU)
    if backend == "fused" and exec_ == "churn":
        with pytest.raises(ValueError) as ref_err:
            jax_fit(jcfg, problem=jprob)
        with pytest.raises(ValueError) as port_err:
            fit(tcfg, problem=tprob, device=CPU, mesh=tmesh)
        assert str(port_err.value) == str(ref_err.value)
        return
    ref_backend = "spmd" if backend == "fused" else backend
    ref = _reference(("gossip", alg, exec_, ref_backend, PRIMALS[backend]),
                     jcfg.replace(backend=ref_backend), jprob)
    port = fit(tcfg, problem=tprob, device=CPU, mesh=tmesh)
    err = f"{alg}:{exec_}:{backend}:{mesh}"
    _assert_comms(ref.history, port.history, err)
    assert 0 < int(port.history["comms"][-1]) < 8 * GOSSIP["num_iters"]
    assert isinstance(port.theta, torch.Tensor)
    np.testing.assert_allclose(
        _np(port.theta), np.asarray(ref.theta), rtol=0,
        atol=TOL if PRIMALS[backend] == "gradient" else CG_TOL,
        err_msg=f"{err}:theta")


# ---------------------------------------------------------------------------
# Personalization on a mesh
# ---------------------------------------------------------------------------

def _record_refreshes(monkeypatch):
    """{iteration: learned graph} of every refresh the port's fit makes."""
    seen = {}
    real = P.maybe_update

    def spy(pz, thetas, k, adjacency):
        out = real(pz, thetas, k, adjacency)
        if P.should_update(pz, k):
            assert isinstance(out, torch.Tensor)   # the graph stays whole
            seen[k] = out.clone()
        return out
    monkeypatch.setattr(P, "maybe_update", spy)
    return seen


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("exec_", sorted(PZ_EXECS))
@pytest.mark.parametrize("backend", ["simulator", "spmd"])
def test_personalization_on_a_mesh_matches_the_unsharded_reference(
        backend, exec_, mesh, pz_problem, monkeypatch):
    """A personalized COKE fit (CG) on the clustered workload, sync and
    gossip at 0.5, three refreshes: the learned graph's support at every
    refresh equal to the reference's unsharded run's (the reference cut at
    that iteration), comms and bits exact, theta within 1e-3 relative."""
    jprob, tprob = pz_problem
    kw = dict(graph="ring", algorithm="coke", primal="cg", backend=backend,
              pz=PZ, **PZ_EXECS[exec_])
    jcfg, tcfg = _cfgs(KRR_P, num_iters=PZ_ITERS, **kw)
    refs = {k: _reference(("pz", backend, exec_, n),
                          jcfg.replace(num_iters=n), jprob)
            for k, n in zip(REFRESHES, REFRESHES[:-1] + (PZ_ITERS,))}
    seen = _record_refreshes(monkeypatch)
    port = fit(tcfg, problem=tprob, device=CPU,
               mesh=make_host_mesh(*mesh, device=CPU))
    err = f"{backend}:{exec_}:{mesh}"
    assert sorted(seen) == list(REFRESHES), err
    for k in REFRESHES:
        np.testing.assert_array_equal(
            seen[k].numpy() > 0, np.asarray(refs[k].learned_adjacency) > 0,
            err_msg=f"{err}:support@{k}")
    ref = refs[REFRESHES[-1]]
    _assert_comms(ref.history, port.history, err)
    assert torch.equal(port.learned_adjacency, seen[REFRESHES[-1]])
    want = np.asarray(ref.theta)
    np.testing.assert_allclose(_np(port.theta), want, rtol=0,
                               atol=PZ_RTOL * max(1.0, np.abs(want).max()),
                               err_msg=f"{err}:theta")


@pytest.mark.parametrize("backend", ["simulator", "spmd"])
def test_personalized_warmup_prefix_is_bitwise_the_sharded_static_run(
        backend, pz_problem):
    """On a (2, 4) mesh the warmup iterations of a personalized fit are
    bitwise the static fit's, history for history, as without a mesh."""
    _, tprob = pz_problem
    mesh = make_host_mesh(2, 4, device=CPU)
    kw = dict(graph="ring", algorithm="coke", primal="cg", backend=backend,
              exec="gossip", participation=0.5)
    W = PZ["warmup"]
    static = fit(_cfgs(KRR_P, num_iters=W, **kw)[1], problem=tprob,
                 device=CPU, mesh=mesh)
    pz = fit(_cfgs(KRR_P, num_iters=W + 3, pz=PZ, **kw)[1], problem=tprob,
             device=CPU, mesh=mesh)
    for key, h in static.history.items():
        assert torch.equal(pz.history[key][:W], h), key


# ---------------------------------------------------------------------------
# No chunk loop gathers a blocked tensor whole
# ---------------------------------------------------------------------------

#: backend -> the fits its case runs on a (2, 4) mesh: every gossip and
#: personalization path the backend admits
NO_UNSHARD = {
    "simulator": (dict(exec="gossip", participation=0.5, churn=CHURN),
                  dict(exec="gossip", participation=0.5, pz=PZ)),
    "spmd": (dict(exec="gossip", gossip_size=3, churn=CHURN),
             dict(exec="gossip", participation=0.5, pz=PZ)),
    "fused": (dict(exec="gossip", participation=0.5, primal="gradient"),),
}


@pytest.mark.parametrize("backend", sorted(NO_UNSHARD))
def test_no_chunk_loop_unshards(backend, pz_problem, monkeypatch):
    """sharding.unshard raises while `_chunked_scan` runs: every gossip
    and personalized iteration on a mesh goes through the layout's named
    collectives, and the one gather is fit's, after the loop."""
    fit_mod = importlib.import_module("repro_torch.api.fit")
    _, tprob = pz_problem
    real_scan, calls = fit_mod._chunked_scan, []

    def boom(*a, **k):
        raise AssertionError("unshard inside a chunk loop")

    def guarded(*a, **k):
        calls.append(1)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sharding, "unshard", boom)
            return real_scan(*a, **k)
    monkeypatch.setattr(fit_mod, "_chunked_scan", guarded)
    mesh = make_host_mesh(2, 4, device=CPU)
    for extra in NO_UNSHARD[backend]:
        kw = dict(dict(graph="ring", algorithm="coke", primal="cg",
                       backend=backend, num_iters=20, chunk_size=7), **extra)
        res = fit(_cfgs(KRR_P, **kw)[1], problem=tprob, device=CPU,
                  mesh=mesh)
        assert isinstance(res.theta, torch.Tensor)
        assert int(res.history["comms"][-1]) > 0
    assert len(calls) == len(NO_UNSHARD[backend])
