"""The port's personalization (`repro_torch.core.personalize`, the phased
fit driver, the learned-graph branches of the solvers, the ring runtime
and the sweep, `FitResult.to_models`) against the reference's, on the CPU.

Both packages run the reference's featurized problem or stream, carried
across with `repro_torch.convert`, on the reference's small clustered
workload (tests/test_personalize.py: N=12 on a ring, 60 samples, 3 tasks,
D=32, Personalization(k=3, every=5, warmup=15)).

Tolerances. comms and bits exactly equal everywhere; the learned graph's
support exactly equal. Where both sides take the same thetas (the graph
functions, one to three ring-runtime steps) the indices are equal and the
weights and iterates within 1e-6. Over a whole personalized fit the
thetas are held to 1e-3 relative and the learned weights to 1e-3, the
reference's own tolerance for two personalized runs
(tests/test_personalize.py, simulator against spmd): each refresh ranks
and weighs distances d2 = |t_i|^2 + |t_j|^2 - 2 t_i.t_j, which cancel,
and the next iterations amplify the difference. Measured on the port
alone: a 1e-7 relative perturbation of Phi moves its final thetas by
2.5e-4 relative (warmup 0) and its learned weights by 4e-4. The warmup
prefix, the all-warmup runs and the streams are held as static runs are
(1e-5; 1e-4 where CG runs, the port's simulator CG tolerance). The port's
own contracts are bitwise: the warmup prefix equals the static run at the
same primal, participation 1.0 gossip equals sync, a chunked run equals
an unchunked one, each sweep lane's comms and bits equal its own fit's.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, hnp, settings, st
from torch.utils._python_dispatch import TorchDispatchMode

from repro.api import FitConfig as JFitConfig
from repro.api import KRRConfig as JKRRConfig
from repro.api import Personalization as JPersonalization
from repro.api import build_problem as jax_build_problem
from repro.api import build_stream as jax_build_stream
from repro.api import fit as jax_fit
from repro.api import fit_stream as jax_fit_stream
from repro.api import heterogeneous as jax_heterogeneous
from repro.api import sweep as jax_sweep
from repro.core import personalize as JP
from repro.distributed import consensus as jax_cns
from repro.optim import optimizers as jax_opt

from repro_torch import convert
from repro_torch.api import (FitConfig, KernelModel, KRRConfig,
                             Personalization, build_problem, fit,
                             fit_stream, graph_recovery, heterogeneous,
                             sweep)
from repro_torch.core import personalize as P
from repro_torch.distributed import consensus as port_cns
from repro_torch.optim import optimizers as port_opt

torch.set_num_threads(2)

TOL = 1e-5
CG_TOL = 1e-4
GRAPH_TOL = 1e-6
PZ_RTOL = 1e-3
KRR = dict(dataset="heterogeneous", num_agents=12, samples_per_agent=60,
           num_tasks=3, num_features=32, lam=1e-3, rho=0.1, censor_v=0.3,
           censor_mu=0.97, seed=0)
BASE = dict(graph="ring", num_iters=40, primal="cg")
PZ = dict(k=3, every=5, warmup=15)
STREAM = dict(graph="ring", num_iters=30, primal="auto", online_batch=6,
              online_lr=0.3)
STREAM_PZ = dict(k=2, every=4, warmup=10)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _cfgs(pz=None, krr=None, **kw):
    """(reference FitConfig, port FitConfig) of the same knobs; `pz` a dict
    of Personalization knobs."""
    krr = dict(KRR, **(krr or {}))
    return (JFitConfig(krr=JKRRConfig(**krr), **kw,
                       personalization=None if pz is None
                       else JPersonalization(**pz)),
            FitConfig(krr=KRRConfig(**krr), **kw,
                      personalization=None if pz is None
                      else Personalization(**pz)))


def _carry(jprob):
    return convert.problem_from_numpy(
        np.asarray(jprob.feats), np.asarray(jprob.labels),
        np.asarray(jprob.adjacency), jprob.lam, jprob.rho, device="cpu")


@pytest.fixture(scope="module")
def built():
    """(reference BuiltProblem, port copy of its problem)."""
    jb = jax_build_problem(_cfgs(**BASE)[0])
    return jb, _carry(jb.problem)


@pytest.fixture(scope="module")
def stream():
    js = jax_build_stream(_cfgs(algorithm="online_coke", **STREAM)[0]).stream
    return js, convert.stream_from_numpy(
        np.asarray(js.feats), np.asarray(js.labels),
        np.asarray(js.adjacency), js.lam, js.rho, device="cpu")


def _assert_comms(ref_h, port_h, err):
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(_np(port_h[k]), np.asarray(ref_h[k]),
                                      err_msg=f"{err}:{k}")


def _assert_theta(ref, port, rtol, err):
    want = np.asarray(ref)
    np.testing.assert_allclose(_np(port), want, rtol=0,
                               atol=rtol * max(1.0, np.abs(want).max()),
                               err_msg=f"{err}:theta")


def _assert_graph(ref_a, port_a, atol, err):
    a, b = np.asarray(ref_a), _np(port_a)
    np.testing.assert_array_equal(b > 0, a > 0, err_msg=f"{err}:support")
    np.testing.assert_allclose(b, a, rtol=0, atol=atol,
                               err_msg=f"{err}:weights")


# ---------------------------------------------------------------------------
# the clustered non-IID generator and the problem it builds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_heterogeneous_is_bitwise_the_reference(seed):
    kw = dict(num_agents=9, num_tasks=3, samples_per_agent=40, seed=seed)
    a, b = jax_heterogeneous(**kw), heterogeneous(**kw)
    for f in ("x", "y", "x_test", "y_test", "cluster"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                      err_msg=f)
        assert getattr(b, f).dtype == getattr(a, f).dtype, f
    assert (b.num_tasks, b.name) == (a.num_tasks, a.name)
    np.testing.assert_array_equal(b.cluster, np.arange(9) % 3)


@pytest.mark.parametrize("kw", [dict(num_agents=4, num_tasks=5),
                                dict(num_agents=4, num_tasks=0)])
def test_heterogeneous_errors_are_the_reference(kw):
    with pytest.raises(ValueError) as ref_err:
        jax_heterogeneous(**kw)
    with pytest.raises(ValueError) as port_err:
        heterogeneous(**kw)
    assert str(port_err.value) == str(ref_err.value)


def test_built_problem_carries_the_reference_arrays_and_clusters(built):
    jb = built[0]
    tb = build_problem(_cfgs(**BASE)[1], device="cpu")
    np.testing.assert_array_equal(tb.clusters, jb.clusters)
    np.testing.assert_array_equal(tb.clusters, np.arange(12) % 3)
    np.testing.assert_array_equal(_np(tb.problem.labels),
                                  np.asarray(jb.problem.labels))
    np.testing.assert_array_equal(_np(tb.x_test), np.asarray(jb.x_test))
    np.testing.assert_array_equal(_np(tb.problem.adjacency),
                                  np.asarray(jb.problem.adjacency))
    assert build_problem(_cfgs(**BASE, krr=dict(dataset="synthetic"))[1],
                         device="cpu").clusters is None


# ---------------------------------------------------------------------------
# learning the graph
# ---------------------------------------------------------------------------

AFFINITIES = {"rbf-auto": ("rbf", 0.0), "rbf-fixed": ("rbf", 2.0),
              "cosine": ("cosine", 0.0)}


def _seeded(n):
    """Seeded float thetas whose ranking gaps are far above fp32 noise,
    checked in float64: among each row's 5 best, relative d2 gaps and
    cosine gaps > 100 ulps, and where a row's 5 best reach the clip at 0,
    none of its cosines lies within 1e-4 below it (the zeros then tie
    exactly, in index order)."""
    rng = np.random.default_rng(0)
    if n > 32:
        # groups of 6, each on its own axis at 3; member j of a group sits
        # at 0.5 (j + 1) along its own second axis, so each row's 5 best
        # are its group mates, ranked with wide gaps (small norms: little
        # cancellation in |t_i|^2 + |t_j|^2 - 2 t_i.t_j)
        group, member = np.arange(n) // 6, np.arange(n) % 6
        t = np.concatenate([3.0 * np.eye(group[-1] + 1)[group],
                            np.eye(6)[member] * 0.5 * (member + 1.0)[:, None]],
                           axis=1).astype(np.float32)
    else:
        t = rng.standard_normal((n, 7)).astype(np.float32)
    t64 = t.astype(np.float64)
    d2 = ((t64[:, None] - t64[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    s = np.sort(d2, axis=1)[:, :5]
    assert np.min(np.diff(s, axis=1) / s[:, 1:]) > 100 * 2.0**-23
    u = t64 / np.linalg.norm(t64, axis=1, keepdims=True)
    c = u @ u.T
    np.fill_diagonal(c, -np.inf)
    cs = -np.sort(-np.clip(c, 0, 1), axis=1)[:, :5]
    gaps = -np.diff(cs, axis=1)
    assert np.all((gaps > 100 * 2.0**-23) | (cs[:, 1:] == 0))
    reach = cs[:, -1] == 0
    assert not np.any((c[reach] > -1e-4) & (c[reach] <= 0))
    return t


def _both_graphs(thetas, k, affinity, scale):
    j_idx, j_w = JP.topk_neighbors(jnp.asarray(thetas), k, affinity, scale)
    t_idx, t_w = P.topk_neighbors(torch.tensor(thetas), k, affinity, scale)
    jA = JP.learned_adjacency(JPersonalization(k=k, affinity=affinity,
                                               scale=scale),
                              jnp.asarray(thetas))
    tA = P.learned_adjacency(Personalization(k=k, affinity=affinity,
                                             scale=scale),
                             torch.tensor(thetas))
    return (np.asarray(j_idx), np.asarray(j_w), np.asarray(jA)), \
        (_np(t_idx), _np(t_w), _np(tA))


@pytest.mark.parametrize("n", [9, 300])
@pytest.mark.parametrize("aff", sorted(AFFINITIES))
def test_topk_and_adjacency_match_the_reference(n, aff):
    """N=300 makes three row blocks (two of 128, the last padded with
    clamped rows and trimmed)."""
    affinity, scale = AFFINITIES[aff]
    thetas = _seeded(n)
    (ji, jw, jA), (ti, tw, tA) = _both_graphs(thetas, 3, affinity, scale)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=GRAPH_TOL)
    _assert_graph(jA, tA, GRAPH_TOL, aff)


@pytest.mark.parametrize("case", ["zeros", "duplicated", "integer"])
@pytest.mark.parametrize("aff", sorted(AFFINITIES))
def test_ties_break_to_the_lower_index_as_in_the_reference(case, aff):
    """All-zero thetas (every pair ties: rbf takes the k lowest-index
    peers, cosine scores 0 everywhere and keeps no edge), duplicated rows,
    and small-integer thetas (exact distances, ties in most rows)."""
    affinity, scale = AFFINITIES[aff]
    rng = np.random.default_rng(5)
    if case == "zeros":
        thetas = np.zeros((10, 6), np.float32)
    elif case == "duplicated":
        thetas = np.repeat(rng.standard_normal((4, 6)), 3, axis=0)[
            rng.permutation(12)].astype(np.float32)
    else:
        thetas = rng.integers(-2, 3, (150, 4)).astype(np.float32)
    (ji, jw, jA), (ti, tw, tA) = _both_graphs(thetas, 3, affinity, scale)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=GRAPH_TOL)
    _assert_graph(jA, tA, GRAPH_TOL, f"{case}-{aff}")
    if case == "zeros":   # agents 0-3 form the only mutual clique
        np.testing.assert_array_equal(
            ti[:5], [[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2], [0, 1, 2]])
        assert (tA > 0).sum() == (12 if affinity == "rbf" else 0)


def test_graph_over_lanes_is_each_lanes_graph():
    """The (G, N, D) form gives one graph per lane, each its lane's own."""
    rng = np.random.default_rng(2)
    lanes = rng.standard_normal((3, 20, 5)).astype(np.float32)
    for aff, (affinity, scale) in AFFINITIES.items():
        pz = Personalization(k=3, affinity=affinity, scale=scale)
        stacked = P.learned_adjacency(pz, torch.tensor(lanes))
        assert tuple(stacked.shape) == (3, 20, 20)
        for g in range(3):
            one = P.learned_adjacency(pz, torch.tensor(lanes[g]))
            np.testing.assert_allclose(_np(stacked[g]), _np(one), rtol=0,
                                       atol=GRAPH_TOL, err_msg=aff)
            np.testing.assert_array_equal(_np(stacked[g]) > 0,
                                          _np(one) > 0)


@settings(max_examples=25, deadline=None)
@given(thetas=hnp.arrays(np.float32, (9, 7),
                         elements=st.floats(-5.0, 5.0, width=32)),
       k=st.integers(1, 4),
       affinity=st.sampled_from(("rbf", "cosine")),
       scale=st.sampled_from((0.0, 0.5, 2.0)))
def test_adjacency_invariants(thetas, k, affinity, scale):
    """The reference's property test on the port: symmetric, no self
    loops, row degrees <= k, weights in [0, 1]."""
    pz = Personalization(k=k, affinity=affinity, scale=scale)
    A = _np(P.learned_adjacency(pz, torch.tensor(thetas)))
    np.testing.assert_array_equal(A, A.T, err_msg="not symmetric")
    np.testing.assert_array_equal(np.diag(A), 0.0, err_msg="self loops")
    assert int(np.max(np.sum(A > 0, axis=1))) <= k
    assert float(A.min()) >= 0.0 and float(A.max()) <= 1.0 + 1e-6


@pytest.mark.parametrize("k", [0, 6])
def test_topk_rejects_bad_k_like_the_reference(k):
    with pytest.raises(ValueError) as ref_err:
        JP.topk_neighbors(jnp.ones((6, 4)), k)
    with pytest.raises(ValueError) as port_err:
        P.topk_neighbors(torch.ones((6, 4)), k)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("warmup,every", [(10, 5), (0, 1), (0, 7), (3, 4)])
def test_refresh_cadence_is_the_reference(warmup, every):
    pz = dict(k=2, every=every, warmup=warmup)
    want = [k for k in range(1, 61)
            if bool(JP.should_update(JPersonalization(**pz), k))]
    got = [k for k in range(1, 61)
           if P.should_update(Personalization(**pz), k)]
    assert got == want
    if (warmup, every) == (10, 5):
        assert got[:4] == [11, 16, 21, 26]


def test_graph_recovery_is_the_reference():
    rng = np.random.default_rng(0)
    clusters = np.arange(12) % 3
    centers = 10.0 * rng.normal(size=(3, 16))
    thetas = (centers[clusters] + 0.1 * rng.normal(size=(12, 16))).astype(
        np.float32)
    noisy = rng.standard_normal((12, 16)).astype(np.float32)
    for th in (thetas, noisy):
        jA = JP.learned_adjacency(JPersonalization(k=3), jnp.asarray(th))
        tA = P.learned_adjacency(Personalization(k=3), torch.tensor(th))
        want = float(JP.graph_recovery(jA, clusters))
        assert abs(float(graph_recovery(tA, clusters)) - want) <= 1e-6
    assert float(graph_recovery(P.learned_adjacency(
        Personalization(k=3), torch.tensor(thetas)), clusters)) == 1.0
    assert float(graph_recovery(torch.zeros((12, 12)), clusters)) == 0.0


class _Shapes(TorchDispatchMode):
    """Records the output shape and dtype of every op."""

    def __init__(self):
        super().__init__()
        self.outputs = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.outputs.add((tuple(o.shape), o.dtype))
        return out


@pytest.mark.parametrize("affinity", ["rbf", "cosine"])
def test_topk_makes_no_dense_nn_tensor_at_512(affinity):
    """The scaling contract: at N=512 `topk_neighbors` makes no (N, N)
    tensor (its tiles are (128, 512)); `learned_adjacency`'s scatter does
    make the dense graph, so the detector is live."""
    n = 512
    th = torch.tensor(np.random.default_rng(1).standard_normal(
        (n, 32)).astype(np.float32))
    with _Shapes() as rec:
        P.topk_neighbors(th, 5, affinity)
    assert not any(s == (n, n) for s, _ in rec.outputs)
    assert ((128, n), torch.float32) in rec.outputs
    with _Shapes() as rec:
        P.learned_adjacency(Personalization(k=5, affinity=affinity), th)
    assert ((n, n), torch.float32) in rec.outputs


# ---------------------------------------------------------------------------
# fit: against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup", [0, 15, 100])
@pytest.mark.parametrize("exec_", ["sync", "gossip"])
@pytest.mark.parametrize("backend", ["simulator", "spmd"])
def test_personalized_fit_matches_the_reference(built, backend, exec_,
                                                warmup):
    kw = dict(BASE, backend=backend, exec=exec_)
    if exec_ == "gossip":
        kw["participation"] = 0.5
    jcfg, tcfg = _cfgs(pz=dict(PZ, warmup=warmup), **kw)
    ref = jax_fit(jcfg, problem=built[0].problem)
    port = fit(tcfg, problem=built[1], device="cpu")
    err = f"{backend}-{exec_}-w{warmup}"
    assert set(port.history) == set(ref.history) and \
        "per_agent_mse" in port.history, err
    _assert_comms(ref.history, port.history, err)
    live = warmup < BASE["num_iters"]
    W = min(warmup, BASE["num_iters"])
    for k in ("train_mse", "consensus_gap", "per_agent_mse"):
        a, b = np.asarray(ref.history[k]), _np(port.history[k])
        assert b.shape == a.shape, (err, k)
        np.testing.assert_allclose(b[:W], a[:W], rtol=CG_TOL, atol=CG_TOL,
                                   err_msg=f"{err}:{k} prefix")
        np.testing.assert_allclose(b, a, rtol=PZ_RTOL, atol=PZ_RTOL,
                                   err_msg=f"{err}:{k}")
    _assert_theta(ref.theta, port.theta, PZ_RTOL if live else CG_TOL, err)
    _assert_graph(ref.learned_adjacency, port.learned_adjacency,
                  PZ_RTOL if live else 0.0, err)
    A = _np(port.learned_adjacency)
    np.testing.assert_array_equal(A, A.T)
    np.testing.assert_array_equal(np.diag(A), 0.0)
    assert int(np.max(np.sum(A > 0, axis=1))) <= (PZ["k"] if live else 2)


@pytest.mark.parametrize("backend", ["simulator", "spmd"])
def test_warmup_prefix_is_bitwise_the_static_run(built, backend):
    """In the port itself: iterations 1..warmup of a personalized fit are
    bitwise the personalization=None run at the same primal (CG), every
    shared history key; it then parts from it."""
    _, static = _cfgs(**BASE, backend=backend)
    _, pers = _cfgs(pz=PZ, **BASE, backend=backend)
    a = fit(static, problem=built[1], device="cpu")
    b = fit(pers, problem=built[1], device="cpu")
    w = PZ["warmup"]
    for k in a.history:
        assert torch.equal(a.history[k][:w], b.history[k][:w]), k
    assert float(torch.max(torch.abs(a.history["train_mse"][w:]
                                     - b.history["train_mse"][w:]))) > 0.0
    assert a.learned_adjacency is None


@pytest.mark.parametrize("backend", ["simulator", "spmd"])
def test_all_warmup_run_is_bitwise_the_static_run(built, backend):
    """warmup >= num_iters: the static run, bitwise, with a zero-length
    live phase that still attaches the (starting) graph."""
    _, static = _cfgs(**BASE, backend=backend)
    _, pers = _cfgs(pz=dict(PZ, warmup=100), **BASE, backend=backend)
    a = fit(static, problem=built[1], device="cpu")
    b = fit(pers, problem=built[1], device="cpu")
    for k in a.history:
        assert torch.equal(a.history[k], b.history[k]), k
    assert torch.equal(a.theta, b.theta)
    assert torch.equal(b.learned_adjacency, built[1].adjacency)


@pytest.mark.parametrize("chunk", [7, 15, 1])
@pytest.mark.parametrize("backend", ["simulator", "spmd"])
def test_chunked_run_crossing_the_boundary_is_bitwise(built, backend, chunk):
    """Chunks that end inside, exactly on and across the warmup -> live
    boundary give the unchunked run's histories and theta, bitwise."""
    _, cfg = _cfgs(pz=PZ, **BASE, backend=backend)
    mono = fit(cfg, problem=built[1], device="cpu")
    chunked = fit(cfg.replace(chunk_size=chunk), problem=built[1],
                  device="cpu")
    for k in mono.history:
        assert torch.equal(mono.history[k], chunked.history[k]), k
    assert torch.equal(mono.theta, chunked.theta)
    assert torch.equal(mono.learned_adjacency, chunked.learned_adjacency)


@pytest.mark.parametrize("backend", ["simulator", "spmd"])
def test_degenerate_gossip_is_bitwise_personalized_sync(built, backend):
    """participation=1.0 gossip with a live learned graph is bitwise the
    synchronous personalized run (the dense masked step collapses)."""
    _, cfg = _cfgs(pz=PZ, **BASE, backend=backend)
    sync = fit(cfg, problem=built[1], device="cpu")
    gos = fit(cfg.replace(exec="gossip", participation=1.0),
              problem=built[1], device="cpu")
    for k in sync.history:
        assert torch.equal(sync.history[k], gos.history[k]), k
    assert torch.equal(sync.theta, gos.theta)
    assert torch.equal(sync.learned_adjacency, gos.learned_adjacency)


def test_simulator_and_spmd_learn_the_same_graph(built):
    """The port's two backends: equal comms and bits, equal graph support,
    thetas within the personalized tolerance."""
    _, cfg = _cfgs(pz=PZ, **BASE)
    sim = fit(cfg, problem=built[1], device="cpu")
    spmd = fit(cfg.replace(backend="spmd"), problem=built[1], device="cpu")
    _assert_comms(sim.history, spmd.history, "sim-spmd")
    _assert_graph(_np(sim.learned_adjacency), spmd.learned_adjacency,
                  PZ_RTOL, "sim-spmd")
    _assert_theta(_np(sim.theta), spmd.theta, PZ_RTOL, "sim-spmd")


# ---------------------------------------------------------------------------
# fit_stream and sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exec_", ["sync", "gossip"])
@pytest.mark.parametrize("backend", ["simulator", "spmd"])
@pytest.mark.parametrize("alg", ["online_dkla", "online_coke", "qc_odkla"])
def test_personalized_stream_matches_the_reference(stream, alg, backend,
                                                   exec_):
    kw = dict(STREAM, algorithm=alg, backend=backend, exec=exec_)
    if exec_ == "gossip":
        kw["participation"] = 0.5
    jcfg, tcfg = _cfgs(pz=STREAM_PZ, **kw)
    ref = jax_fit_stream(jcfg, stream=stream[0])
    port = fit_stream(tcfg, stream=stream[1], device="cpu")
    err = f"{alg}-{backend}-{exec_}"
    assert set(port.history) == set(ref.history), err
    assert "per_agent_mse" not in port.history
    _assert_comms(ref.history, port.history, err)
    for k in ("instant_mse", "consensus_gap"):
        np.testing.assert_allclose(_np(port.history[k]),
                                   np.asarray(ref.history[k]), rtol=CG_TOL,
                                   atol=CG_TOL, err_msg=f"{err}:{k}")
    _assert_theta(ref.theta, port.theta, CG_TOL, err)
    _assert_graph(ref.learned_adjacency, port.learned_adjacency, CG_TOL, err)


@pytest.mark.parametrize("alg", ["online_coke", "coke"])
def test_stream_prefix_is_bitwise_the_static_stream(stream, built, alg):
    """fit_stream (online_coke) and a batch fit of an online solver keep
    the prefix pin too."""
    if alg == "online_coke":
        _, static = _cfgs(algorithm=alg, **STREAM)
        _, pers = _cfgs(pz=STREAM_PZ, algorithm=alg, **STREAM)
        a = fit_stream(static, stream=stream[1], device="cpu")
        b = fit_stream(pers, stream=stream[1], device="cpu")
    else:
        _, static = _cfgs(**dict(STREAM, algorithm="online_coke",
                                 primal="auto"))
        _, pers = _cfgs(pz=STREAM_PZ, **dict(STREAM, algorithm="online_coke",
                                             primal="auto"))
        a = fit(static, problem=built[1], device="cpu")
        b = fit(pers, problem=built[1], device="cpu")
        assert "per_agent_mse" in b.history
    w = STREAM_PZ["warmup"]
    for k in a.history:
        assert torch.equal(a.history[k][:w], b.history[k][:w]), k
    assert b.learned_adjacency is not None


CELLS = [(0.3, 0.97), (0.5, 0.95)]


@pytest.mark.parametrize("warmup", [0, 8, 100],
                         ids=["no-warmup", "mid-run", "all-warmup"])
def test_personalized_sweep_matches_reference_and_own_fits(built, warmup):
    kw = dict(BASE, num_iters=20)
    jcfg, tcfg = _cfgs(pz=dict(PZ, warmup=warmup), **kw)
    ref = jax_sweep(jcfg, CELLS, problem=built[0].problem)
    port = sweep(tcfg, CELLS, problem=built[1], device="cpu")
    assert set(port.history) == set(ref.history)
    assert tuple(port.history["per_agent_mse"].shape) == (2, 20, 12)
    _assert_comms(ref.history, port.history, f"sweep w{warmup}")
    _assert_theta(ref.thetas, port.thetas,
                  PZ_RTOL if warmup < 20 else CG_TOL, f"sweep w{warmup}")
    for i, (v, mu) in enumerate(CELLS):
        own = fit(tcfg.replace(censor_v=v, censor_mu=mu), problem=built[1],
                  device="cpu")
        for k in ("comms", "bits"):
            assert torch.equal(port.history[k][i], own.history[k]), (i, k)
        _assert_theta(_np(own.theta), port.thetas[i], TOL, f"lane {i}")


def test_all_warmup_sweep_is_bitwise_the_static_sweep(built):
    kw = dict(BASE, num_iters=15)
    _, static = _cfgs(**kw)
    _, warm = _cfgs(pz=dict(PZ, warmup=50), **kw)
    a = sweep(static, CELLS, problem=built[1], device="cpu")
    b = sweep(warm, CELLS, problem=built[1], device="cpu")
    for k in a.history:
        assert torch.equal(a.history[k], b.history[k]), k
    assert torch.equal(a.thetas, b.thetas)


def test_twin_sweep_lanes_give_the_same_bits(built):
    _, cfg = _cfgs(pz=dict(PZ, warmup=0), **dict(BASE, num_iters=20))
    sw = sweep(cfg, [CELLS[0], CELLS[0]], problem=built[1], device="cpu")
    for k in sw.history:
        assert torch.equal(sw.history[k][0], sw.history[k][1]), k
    assert torch.equal(sw.thetas[0], sw.thetas[1])


# ---------------------------------------------------------------------------
# the ring runtime's dense hook: three steps against the reference
# ---------------------------------------------------------------------------

def _weighted(n, seed):
    rng = np.random.default_rng(seed)
    w = np.triu(rng.uniform(0.1, 1.0, (n, n)) * (rng.uniform(size=(n, n))
                                                 < 0.5), 1)
    return (w + w.T).astype(np.float32)


@pytest.mark.parametrize("exact", [False, True], ids=["gradient", "cg"])
def test_consensus_update_dense_matches_the_reference(built, exact):
    """consensus_update(adjacency=) with a weighted graph, three steps,
    the gradient step and the CG primal_solve, with a gossip mask."""
    from repro.api.backends import _cg_primal_solve as jax_cg
    from repro_torch.api.backends import _cg_primal_solve as port_cg
    n, d = 12, 32
    A = _weighted(n, 3)
    grads0 = np.random.default_rng(4).standard_normal((n, d)).astype(
        np.float32)
    part = np.arange(n) % 3 != 1
    out = []
    for cns, opt, arr, solve, prob in (
            (jax_cns, jax_opt, jnp.asarray, jax_cg, built[0].problem),
            (port_cns, port_opt, torch.tensor, port_cg, built[1])):
        ccfg = cns.ConsensusConfig(strategy="coke", rho=0.1, censor_v=0.05)
        ocfg = opt.OptConfig(kind="sgd", lr=0.1)
        p = {"theta": arr(np.zeros((n, d), np.float32))}
        st = cns.init_consensus_state(ccfg, ocfg, p)
        for i in range(3):
            p, st, m = cns.consensus_update(
                ccfg, ocfg, p, {"theta": arr(grads0)}, st,
                primal_solve=solve(prob, 1e-8, 64) if exact else None,
                adjacency=arr(A), participate=arr(part) if i else None)
        out.append((p, st, m))
    (jp, jst, jm), (tp, tst, tm) = out
    assert int(tst["comms"]) == int(jst["comms"])
    assert float(tm["bits"]) == float(jm["bits"])
    for got, want in ((tp["theta"], jp["theta"]),
                      (tst["theta_hat"]["theta"], jst["theta_hat"]["theta"]),
                      (tst["gamma"]["theta"], jst["gamma"]["theta"])):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=GRAPH_TOL)
    # the circulant cache is carried untouched
    assert tst["nbr_left"]["theta"] is tst["theta_hat"]["theta"] or \
        torch.equal(tst["nbr_left"]["theta"], torch.zeros((n, d)))


@pytest.mark.parametrize("eta", [None, 0.5])
def test_stream_update_dense_matches_the_reference(stream, eta):
    """stream_update(adjacency=) with a weighted graph over three rounds,
    the gradient step and QC-ODKLA's linearized step."""
    js, ts = stream
    n = js.feats.shape[1]
    A = _weighted(n, 6)
    out = []
    for cns, arr, s in ((jax_cns, jnp.asarray, js),
                        (port_cns, torch.tensor, ts)):
        ccfg = cns.ConsensusConfig(rho=0.1)
        theta = arr(np.zeros((n, s.feats.shape[-1]), np.float32))
        st = cns.init_stream_state(ccfg, theta)
        p = {"theta": theta}
        for r in range(3):
            p, st, m = cns.stream_update(
                ccfg, p, st, s.feats[r], s.labels[r], lam=s.lam, lr=0.3,
                eta=eta, adjacency=arr(A))
        out.append((p, st, m))
    (jp, jst, jm), (tp, tst, tm) = out
    assert int(tst["comms"]) == int(jst["comms"])
    for got, want in ((tp["theta"], jp["theta"]),
                      (tst["theta_hat"], jst["theta_hat"]),
                      (tst["gamma"], jst["gamma"])):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=GRAPH_TOL)
    assert abs(float(tm["instant_mse"]) - float(jm["instant_mse"])) <= 1e-6


# ---------------------------------------------------------------------------
# deploying per agent
# ---------------------------------------------------------------------------

class _Registry:
    """A duck-typed model registry: publish(model_id, model) -> version."""

    def __init__(self):
        self.models = {}

    def publish(self, model_id, model):
        self.models.setdefault(model_id, []).append(model)
        return len(self.models[model_id])


def test_to_models_to_model_publish_and_meta_round_trip(built, tmp_path):
    jcfg, tcfg = _cfgs(pz=PZ, **BASE)
    tb = build_problem(tcfg, device="cpu")
    port = fit(tcfg, problem=tb.problem, device="cpu")
    with pytest.raises(ValueError, match="personalized") as port_err:
        port.to_model(tb.rff_params)
    with pytest.raises(ValueError) as ref_err:
        jax_fit(jcfg, problem=built[0].problem).to_model(
            built[0].rff_params)
    assert str(port_err.value) == str(ref_err.value)
    models = port.to_models(tb.rff_params)
    assert len(models) == KRR["num_agents"]
    x = tb.x_test[5][:7]
    for i, m in enumerate(models):
        assert m.meta["agent"] == i
        assert m.meta["personalization"] == {
            "k": 3, "every": 5, "warmup": 15, "affinity": "rbf",
            "scale": 0.0}
        assert torch.equal(m.theta, port.theta[i])
    want = tb.feats_test[5][:7] @ port.theta[5]
    np.testing.assert_allclose(_np(models[5].predict(x, backend="fused")),
                               _np(want), rtol=1e-5, atol=1e-6)
    path = str(tmp_path / "agent5")
    models[5].save(path)
    back = KernelModel.load(path, device="cpu")
    assert back.meta == json.loads(json.dumps(models[5].meta))
    assert back.meta["agent"] == 5 and back.meta["personalization"]["k"] == 3
    assert torch.equal(back.predict(x), models[5].predict(x))
    assert torch.equal(back.theta, models[5].theta)
    reg = _Registry()
    published = port.publish_models(reg, prefix="pz",
                                    rff_params=tb.rff_params)
    assert published == [(f"pz-{i:03d}", 1) for i in range(12)]
    assert torch.equal(reg.models["pz-004"][0].theta, port.theta[4])
    # a consensus fit deploys per agent too, without the knobs
    plain = fit(tcfg.replace(personalization=None), problem=tb.problem,
                device="cpu").to_models(tb.rff_params)
    assert "personalization" not in plain[0].meta


def test_personalized_evaluate_per_agent_matches_the_plain_product(built):
    """Each per-agent model's evaluate on its own agent's test rows (the
    deploy path chip_smoke.py runs through K1): the plain product's MSE."""
    _, tcfg = _cfgs(pz=PZ, **BASE)
    tb = build_problem(tcfg, device="cpu")
    port = fit(tcfg, problem=tb.problem, device="cpu")
    for i, m in enumerate(port.to_models(tb.rff_params)):
        got = m.evaluate(tb.x_test[i], tb.y_test[i], backend="fused")
        pred = tb.feats_test[i] @ port.theta[i]
        want = float(torch.mean((tb.y_test[i] - pred) ** 2))
        assert abs(got["test_mse"] - want) <= 1e-5 * want, i


# ---------------------------------------------------------------------------
# the acceptance experiment, admission and validation
# ---------------------------------------------------------------------------

def test_personalized_beats_consensus_and_recovers_clusters():
    """The reference's acceptance experiment in miniature, in the port: on
    the clustered data the personalized fit beats consensus on mean
    per-agent test MSE at equal bits, and its graph is intra-cluster."""
    _, cfg = _cfgs(**dict(BASE, num_iters=120),
                   krr=dict(censor_v=0.0, rho=0.01))
    tb = build_problem(cfg, device="cpu")
    cons = fit(cfg, problem=tb.problem, device="cpu")
    pers = fit(cfg.replace(personalization=Personalization(
        k=3, every=5, warmup=20)), problem=tb.problem, device="cpu")
    assert torch.equal(cons.history["bits"], pers.history["bits"])

    def per_agent_mse(theta):
        pred = torch.einsum("nsd,nd->ns", tb.feats_test, theta)
        return float(torch.mean((tb.labels_test - pred) ** 2))

    mse_cons = per_agent_mse(torch.mean(cons.theta, dim=0).expand(
        cons.theta.shape))
    mse_pers = per_agent_mse(pers.theta)
    assert mse_pers < mse_cons, (mse_pers, mse_cons)
    assert float(graph_recovery(pers.learned_adjacency, tb.clusters)) > 0.6


ADMISSION = {
    "fused": dict(backend="fused"),
    "cholesky": dict(primal="cholesky"),
    "solver": dict(algorithm="cta", comm=None),
}


@pytest.mark.parametrize("case", sorted(ADMISSION))
def test_admission_errors_are_the_reference(built, case):
    jcfg, tcfg = _cfgs(pz=PZ, **dict(BASE, **ADMISSION[case]))
    with pytest.raises(ValueError) as ref_err:
        jax_fit(jcfg, problem=built[0].problem)
    with pytest.raises(ValueError) as port_err:
        fit(tcfg, problem=built[1], device="cpu")
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("case", ["topology", "churn", "type"])
def test_config_errors_are_the_reference(case):
    from repro.api import ChurnSchedule as JChurn
    from repro.api import TopologySchedule as JTopo

    from repro_torch.api import ChurnSchedule, TopologySchedule
    n = KRR["num_agents"]
    jkw, tkw = dict(BASE), dict(BASE)
    jkw["personalization"] = JPersonalization(**PZ)
    tkw["personalization"] = Personalization(**PZ)
    if case == "topology":
        jkw["topology"] = JTopo.circulant_cycle(n, [(1,)])
        tkw["topology"] = TopologySchedule.circulant_cycle(n, [(1,)])
    elif case == "churn":
        for kw, c in ((jkw, JChurn), (tkw, ChurnSchedule)):
            kw.update(exec="gossip", churn=c(leave=((5, 1),)))
    else:
        jkw["personalization"] = tkw["personalization"] = object()
    with pytest.raises(ValueError) as ref_err:
        JFitConfig(krr=JKRRConfig(**KRR), **jkw)
    with pytest.raises(ValueError) as port_err:
        FitConfig(krr=KRRConfig(**KRR), **tkw)
    if case == "type":   # the same message, naming the port's class
        assert str(port_err.value) == str(ref_err.value).replace(
            "repro.core", "repro_torch.core")
    else:
        assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("kw", [dict(k=0), dict(affinity="euclid"),
                                dict(every=0), dict(warmup=-1),
                                dict(scale=-1.0)])
def test_personalization_validation_is_the_reference(kw):
    with pytest.raises(ValueError) as ref_err:
        JPersonalization(**kw)
    with pytest.raises(ValueError) as port_err:
        Personalization(**kw)
    assert str(port_err.value) == str(ref_err.value)


def test_learned_adjacency_is_none_without_personalization(built):
    _, cfg = _cfgs(**dict(BASE, num_iters=3))
    for backend in ("simulator", "spmd"):
        res = fit(cfg.replace(backend=backend), problem=built[1],
                  device="cpu")
        assert res.learned_adjacency is None
        assert "per_agent_mse" not in res.history
    assert dataclasses.replace(Personalization(), k=4).k == 4
