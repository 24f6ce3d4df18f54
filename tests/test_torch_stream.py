"""The port's streaming family (`fit_stream`, `KernelModel.partial_fit`,
online_dkla / online_coke / qc_odkla on the simulator and spmd, and
`core.online`) against the reference's, on the CPU.

Both packages run the reference's featurized stream, carried across with
`repro_torch.convert.stream_from_numpy` (the RFF draws differ at a seed);
the raw stream generator is numpy and equal by construction. Tolerances
are the reference's own (tests/test_stream.py): comms and bits exactly
equal, the instantaneous MSE within 1e-6 and theta within 1e-5; the
contracts between the port's own runs (the qc_odkla identity chain
against online_coke, chunked against unchunked) bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Censor as JCensor
from repro.api import Chain as JChain
from repro.api import Drop as JDrop
from repro.api import FitConfig as JFitConfig
from repro.api import KRRConfig as JKRRConfig
from repro.api import Quantize as JQuantize
from repro.api import build_problem as jax_build_problem
from repro.api import build_stream as jax_build_stream
from repro.api import fit as jax_fit
from repro.api import fit_stream as jax_fit_stream
from repro.api import stream_from_arrays as jax_stream_from_arrays
from repro.core import online as jax_online
from repro.distributed import consensus as jax_cns
from repro.core.graph import ring as jax_ring
from repro.data import synthetic as jax_synth

from repro_torch import convert
from repro_torch.api import (Censor, Chain, Drop, FitConfig, KRRConfig,
                             Quantize, StreamProblem, TopologySchedule,
                             build_stream, fit, fit_stream, get_solver,
                             stream_from_arrays)
from repro_torch.core import online
from repro_torch.core.graph import ring
from repro_torch.data import synthetic as port_synth
from repro_torch.distributed import consensus as port_cns

torch.set_num_threads(2)

TOL = 1e-5
MSE_TOL = 1e-6
ROUNDS = 40
KRR = dict(num_agents=6, samples_per_agent=50, num_features=16, lam=1e-2,
           rho=0.1, seed=0)
BASE = dict(algorithm="online_coke", graph="ring", censor_v=0.3,
            censor_mu=0.99, num_iters=ROUNDS, online_batch=8,
            online_lr=0.3)
ALGS = ("online_dkla", "online_coke", "qc_odkla")
#: policy variants: the config's censor, the full chain, QC-ODKLA's eta
VARIANTS = {
    "censor": {},
    "chain": dict(censor_v=None, censor_mu=None, comm="full"),
    "eta": dict(qc_eta=2.0),
}


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _cfg(side, **over):
    kw = dict(BASE, **over)
    if kw.get("comm") == "full":
        kw["comm"] = (JChain([JCensor(0.3, 0.99), JQuantize(5.0),
                              JDrop(0.1)]) if side == "ref" else
                      Chain([Censor(0.3, 0.99), Quantize(5.0), Drop(0.1)]))
    if side == "ref":
        return JFitConfig(krr=JKRRConfig(**KRR), **kw)
    return FitConfig(krr=KRRConfig(**KRR), **kw)


def _carry(js):
    return convert.stream_from_numpy(
        np.asarray(js.feats), np.asarray(js.labels),
        np.asarray(js.adjacency), js.lam, js.rho, device="cpu")


@pytest.fixture(scope="module")
def built():
    """The reference's built stream and the port's carried copy."""
    jb = jax_build_stream(_cfg("ref"))
    return jb, _carry(jb.stream)


def _assert_match(ref, port, err, tol=TOL):
    assert set(port.history) == set(ref.history), err
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(_np(port.history[k]),
                                      np.asarray(ref.history[k]),
                                      err_msg=f"{err}:{k}")
    for k in ("instant_mse", "train_mse", "consensus_gap"):
        np.testing.assert_allclose(_np(port.history[k]),
                                   np.asarray(ref.history[k]),
                                   atol=MSE_TOL, rtol=0,
                                   err_msg=f"{err}:{k}")
    np.testing.assert_allclose(_np(port.theta), np.asarray(ref.theta),
                               atol=tol, rtol=0, err_msg=f"{err}:theta")


def _assert_bitwise(a, b, err):
    assert set(a.history) == set(b.history), err
    for k in a.history:
        assert torch.equal(a.history[k], b.history[k]), f"{err}:{k}"
    assert torch.equal(a.theta, b.theta), err


# ---------------------------------------------------------------------------
# Generators and StreamProblem construction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", port_synth.STREAM_KINDS)
def test_stream_generator_equals_the_reference(kind):
    a = port_synth.stream_synthetic(kind=kind, num_rounds=12, num_agents=3,
                                    batch=4, seed=1)
    b = jax_synth.stream_synthetic(kind=kind, num_rounds=12, num_agents=3,
                                   batch=4, seed=1)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    assert (a.kind, a.name, a.num_rounds, a.num_agents, a.batch,
            a.input_dim) == (b.kind, b.name, 12, 3, 4, 5)


def test_stream_problem_rounds_wrap_and_validate(built):
    jb, ts = built
    assert isinstance(ts, StreamProblem)
    assert tuple(ts.feats.shape) == (ROUNDS, 6, 8, 16)
    assert (ts.num_rounds, ts.num_agents, ts.batch,
            ts.feature_dim) == (ROUNDS, 6, 8, 16)
    f, y = ts.round_batch(ROUNDS + 3)
    assert torch.equal(f, ts.feats[3]) and torch.equal(y, ts.labels[3])
    rff = convert.rff_params_from_numpy(np.asarray(jb.rff_params.omega),
                                        np.asarray(jb.rff_params.bias),
                                        device="cpu")
    errs = []
    for make in (lambda: jax_stream_from_arrays(
            jb.rff_params, np.zeros((4, 3, 2)), np.zeros((4, 3, 2)),
            jax_ring(3), lam=0.1, rho=0.1),
            lambda: stream_from_arrays(rff, np.zeros((4, 3, 2)),
                                       np.zeros((4, 3, 2)), ring(3),
                                       lam=0.1, rho=0.1)):
        with pytest.raises(ValueError) as e:
            make()
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_stream_from_arrays_featurizes_as_the_reference(built):
    """The raw stream through the port's featurizer on the reference's RFF
    arrays: the reference's featurized stream within 1e-6."""
    jb, ts = built
    rff = convert.rff_params_from_numpy(np.asarray(jb.rff_params.omega),
                                        np.asarray(jb.rff_params.bias),
                                        device="cpu")
    mine = stream_from_arrays(rff, jb.dataset.x, jb.dataset.y,
                              jb.graph.adjacency, lam=ts.lam, rho=ts.rho)
    np.testing.assert_allclose(_np(mine.feats), _np(ts.feats), atol=1e-6,
                               rtol=0)
    assert torch.equal(mine.labels, ts.labels)
    assert torch.equal(mine.adjacency, ts.adjacency)


def test_build_stream_draws_its_own_features():
    cfg = _cfg("port", num_iters=12)
    b = build_stream(cfg, device="cpu")
    assert tuple(b.stream.feats.shape) == (12, 6, 8, 16)
    ref = jax_build_stream(_cfg("ref", num_iters=12))
    np.testing.assert_array_equal(b.dataset.x, ref.dataset.x)
    np.testing.assert_array_equal(b.graph.adjacency, ref.graph.adjacency)
    r = fit_stream(cfg, device="cpu")
    assert tuple(r.history["instant_mse"].shape) == (12,)
    assert r.to_model().num_features == 16


# ---------------------------------------------------------------------------
# fit_stream against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("backend", ["simulator", "spmd"])
def test_fit_stream_matches_the_reference(backend, alg, variant, built):
    over = dict(VARIANTS[variant], algorithm=alg, backend=backend)
    if variant == "eta" and alg != "qc_odkla":
        over.pop("qc_eta")   # online_dkla/online_coke read no eta
    jb, ts = built
    ref = jax_fit_stream(_cfg("ref", **over), stream=jb.stream)
    port = fit_stream(_cfg("port", **over), stream=ts, device="cpu")
    _assert_match(ref, port, f"{backend}:{alg}:{variant}")


@pytest.mark.parametrize("backend", ["simulator", "spmd"])
def test_qc_odkla_identity_chain_is_online_coke_bit_for_bit(backend, built):
    _, ts = built
    coke = fit_stream(_cfg("port", backend=backend), stream=ts,
                      device="cpu")
    ident = Chain([Censor(0.3, 0.99), Quantize(bits=float("inf")),
                   Drop(p=0.0)])
    qc = fit_stream(_cfg("port", backend=backend, algorithm="qc_odkla",
                         censor_v=None, censor_mu=None, comm=ident),
                    stream=ts, device="cpu")
    _assert_bitwise(coke, qc, backend)
    assert 0 < int(coke.comms[-1]) < ROUNDS * KRR["num_agents"]


@pytest.mark.parametrize("alg", ALGS)
def test_simulator_and_spmd_agree(alg, built):
    _, ts = built
    sim = fit_stream(_cfg("port", algorithm=alg), stream=ts, device="cpu")
    spmd = fit_stream(_cfg("port", algorithm=alg, backend="spmd"),
                      stream=ts, device="cpu")
    assert set(sim.history) == set(spmd.history)
    for k in ("comms", "bits"):
        assert torch.equal(sim.history[k], spmd.history[k]), (alg, k)
    for k in ("instant_mse", "consensus_gap"):
        np.testing.assert_allclose(_np(sim.history[k]),
                                   _np(spmd.history[k]), atol=MSE_TOL)
    np.testing.assert_allclose(_np(sim.theta), _np(spmd.theta), atol=TOL)


@pytest.mark.parametrize("backend", ["simulator", "spmd"])
def test_chunked_fit_stream_equals_unchunked(backend, built):
    _, ts = built
    full = fit_stream(_cfg("port", backend=backend), stream=ts,
                      device="cpu")
    seen = []
    chunked = fit_stream(_cfg("port", backend=backend, chunk_size=16),
                         stream=ts, device="cpu",
                         progress_cb=lambda k, m: seen.append(k))
    assert seen == [16, 32, 40]
    _assert_bitwise(full, chunked, backend)


def test_online_dkla_strips_the_censor_but_keeps_compression(built):
    _, ts = built
    r = fit_stream(_cfg("port", algorithm="online_dkla", censor_v=None,
                        censor_mu=None,
                        comm=Chain([Censor(5.0, 0.999), Quantize(8)])),
                   stream=ts, device="cpu")
    N = KRR["num_agents"]
    assert int(r.comms[-1]) == ROUNDS * N
    assert int(r.bits[-1]) == ROUNDS * N * (KRR["num_features"] * 8 + 32)


@pytest.mark.parametrize("warm", ["(D,)", "(N, D)"])
@pytest.mark.parametrize("backend", ["simulator", "spmd"])
def test_warm_started_fit_stream_matches_the_reference(backend, warm,
                                                       built):
    jb, ts = built
    rng = np.random.default_rng(5)
    theta0 = rng.normal(size=(16,) if warm == "(D,)" else (6, 16)) * 0.1
    theta0 = theta0.astype(np.float32)
    ref = jax_fit_stream(_cfg("ref", backend=backend), stream=jb.stream,
                         theta0=jnp.asarray(theta0))
    port = fit_stream(_cfg("port", backend=backend), stream=ts,
                      theta0=torch.tensor(theta0), device="cpu")
    _assert_match(ref, port, f"{backend}:{warm}")


@pytest.mark.parametrize("case", ["batch-solver", "fused", "primal",
                                  "stream-into-fit", "topology"])
def test_fit_stream_misuse_raises_the_reference_words(case, built):
    jb, ts = built

    def call(side):
        run = jax_fit_stream if side == "ref" else fit_stream
        stream = jb.stream if side == "ref" else ts
        kw = {} if side == "ref" else dict(device="cpu")
        if case == "batch-solver":
            return run(_cfg(side, algorithm="coke"), stream=stream, **kw)
        if case == "fused":
            return run(_cfg(side, backend="fused"), stream=stream, **kw)
        if case == "primal":
            return run(_cfg(side, primal="cg"), stream=stream, **kw)
        if case == "stream-into-fit":
            return (jax_fit if side == "ref" else fit)(
                _cfg(side), problem=stream, **kw)
        if side == "ref":
            from repro.api import TopologySchedule as JTopologySchedule
            topo = JTopologySchedule.circulant_cycle(6, [(1,)])
        else:
            topo = TopologySchedule.circulant_cycle(6, [(1,)])
        return run(_cfg(side, topology=topo), stream=stream, **kw)

    errs = []
    for side in ("ref", "port"):
        with pytest.raises(ValueError) as e:
            call(side)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_fit_stream_admits_before_it_resolves_the_device():
    with pytest.raises(ValueError, match="batch algorithm"):
        fit_stream(_cfg("port", algorithm="coke"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fit_stream(_cfg("port"))


@pytest.mark.parametrize("alg", ALGS)
def test_fit_runs_the_streaming_solvers_on_a_batch_problem(alg):
    """fit() with a streaming solver on the simulator: round k is the
    rotating online_batch window over each agent's shard (here 35 train
    rows and windows of 8: some wrap), as in the reference."""
    jprob = jax_build_problem(_cfg("ref")).problem
    tprob = convert.problem_from_numpy(
        np.asarray(jprob.feats), np.asarray(jprob.labels),
        np.asarray(jprob.adjacency), jprob.lam, jprob.rho, device="cpu")
    ref = jax_fit(_cfg("ref", algorithm=alg), problem=jprob)
    port = fit(_cfg("port", algorithm=alg), problem=tprob, device="cpu")
    assert "instant_mse" in port.history
    _assert_match(ref, port, alg)


# ---------------------------------------------------------------------------
# partial_fit: the deploy -> refine loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """A batch COKE model of the reference, and the port's copy of it."""
    jm = jax_fit(JFitConfig(krr=JKRRConfig(**KRR), algorithm="coke",
                            graph="ring", censor_v=0.3, censor_mu=0.99,
                            num_iters=150)).to_model()
    arrays = {k: np.asarray(v) for k, v in jm._array_tree().items()}
    tm = convert.model_from_numpy(arrays, dict(
        mapping=jm.rff_params.mapping, bandwidth=jm.bandwidth,
        kernel=jm.kernel, meta=jm.meta), device="cpu")
    return jm, tm


def test_partial_fit_on_a_stream_matches_the_reference(built, models):
    jb, ts = built
    jm, tm = models
    over = dict(num_iters=20)
    ref_model, ref = jm.partial_fit(jb.stream, _cfg("ref", **over))
    port_model, port = tm.partial_fit(ts, _cfg("port", **over))
    _assert_match(ref, port, "stream")
    assert port_model.meta["warm_started"] is True
    assert port_model.meta["refined_from"] == tm.meta
    np.testing.assert_allclose(_np(port_model.thetas),
                               np.asarray(ref_model.thetas), atol=TOL)
    cold = fit_stream(_cfg("port", **over), stream=ts, device="cpu")
    # the first regret sample scores with the deployed model
    assert float(port.history["instant_mse"][0]) < float(
        cold.history["instant_mse"][0])


@pytest.mark.parametrize("config", ["default", "explicit"])
def test_partial_fit_on_raw_traffic_matches_the_reference(config, built,
                                                          models):
    """The raw (R, N, b, d) spelling: featurized with the model's own map,
    the graph from the config (or the model's provenance)."""
    jb, _ = built
    jm, tm = models
    x, y = jb.dataset.x[:10], jb.dataset.y[:10]
    if config == "default":
        ref_model, ref = jm.partial_fit(x, labels=y)
        port_model, port = tm.partial_fit(x, labels=y)
        assert port.config.algorithm == "online_coke"
        assert port.config.graph == "ring"
    else:
        heavy = dict(num_iters=10, krr=dict(KRR, lam=10.0))
        ref_model, ref = jm.partial_fit(x, labels=y, config=JFitConfig(
            krr=JKRRConfig(**heavy["krr"]), **dict(BASE, num_iters=10)))
        port_model, port = tm.partial_fit(x, labels=y, config=FitConfig(
            krr=KRRConfig(**heavy["krr"]), **dict(BASE, num_iters=10)))
    _assert_match(ref, port, config)
    assert port_model.meta["warm_started"] is True


@pytest.mark.parametrize("case", ["no-labels", "labels-twice", "bad-shape",
                                  "feature-dim", "agent-count"])
def test_partial_fit_misuse_raises_the_reference_words(case, built,
                                                       models):
    jb, ts = built
    jm, tm = models
    x, y = jb.dataset.x[:4], jb.dataset.y[:4]

    def call(side):
        m = jm if side == "ref" else tm
        stream = jb.stream if side == "ref" else ts
        if case == "no-labels":
            return m.partial_fit(x)
        if case == "labels-twice":
            return m.partial_fit(stream, labels=y)
        if case == "bad-shape":
            return m.partial_fit(np.zeros(5), labels=np.zeros(5))
        if case == "feature-dim":
            narrow = dataclasses.replace(
                stream, feats=stream.feats[..., :8])
            return m.partial_fit(narrow, (JFitConfig if side == "ref"
                                          else FitConfig)(
                krr=(JKRRConfig if side == "ref" else KRRConfig)(**KRR),
                **dict(BASE, num_iters=5)))
        few = dataclasses.replace(stream, feats=stream.feats[:, :3],
                                  labels=stream.labels[:, :3],
                                  adjacency=stream.adjacency[:3, :3])
        return m.partial_fit(few)

    errs = []
    for side in ("ref", "port"):
        with pytest.raises(ValueError) as e:
            call(side)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_partial_fit_default_config_inherits_the_circulant_offsets(built):
    """config=None refines on the graph the model was trained on, offsets
    included."""
    jb, _ = built
    circ = fit(FitConfig(krr=KRRConfig(**KRR), algorithm="coke",
                         graph="circulant", graph_offsets=(1, 2),
                         censor_v=0.3, censor_mu=0.99, num_iters=5),
               device="cpu").to_model()
    _, res = circ.partial_fit(jb.dataset.x[:4], labels=jb.dataset.y[:4])
    assert res.config.graph == "circulant"
    assert res.config.graph_offsets == (1, 2)
    assert tuple(res.history["instant_mse"].shape) == (4,)


# ---------------------------------------------------------------------------
# core.online
# ---------------------------------------------------------------------------

def _core_stream(seed=0, R=30, N=4, b=3, D=6):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(R, N, b, D)).astype(np.float32)
    labels = rng.normal(size=(R, N, b)).astype(np.float32)
    adj = ring(N).adjacency.astype(np.float32)
    return feats, labels, adj


@pytest.mark.parametrize("policy", ["none", "censor", "chain"])
def test_run_stream_matches_the_reference(policy):
    feats, labels, adj = _core_stream()
    pols = {"none": (None, None),
            "censor": (JCensor(0.5, 0.97), Censor(0.5, 0.97)),
            "chain": (JChain([JCensor(0.5, 0.97), JQuantize(6.0),
                              JDrop(0.2)]),
                      Chain([Censor(0.5, 0.97), Quantize(6.0), Drop(0.2)]))}
    jpol, tpol = pols[policy]
    kw = dict(lam=1e-2, rho=0.1, lr=0.2, num_rounds=30)
    jf, jl = jnp.asarray(feats), jnp.asarray(labels)
    out_r, mse_r, comms_r = jax_online.run_stream(
        jax_online.init_state(4, 6, policy=jpol), jnp.asarray(adj), jpol,
        batch_fn=lambda k: (jf[k], jl[k]), **kw)
    tf, tl = torch.tensor(feats), torch.tensor(labels)
    out_p, mse_p, comms_p = online.run_stream(
        online.init_state(4, 6, policy=tpol), torch.tensor(adj), tpol,
        batch_fn=lambda k: (tf[k], tl[k]), **kw)
    np.testing.assert_array_equal(_np(comms_p), np.asarray(comms_r))
    np.testing.assert_array_equal(_np(out_p.comm.bits),
                                  np.asarray(out_r.comm.bits))
    np.testing.assert_allclose(_np(mse_p), np.asarray(mse_r), atol=MSE_TOL)
    np.testing.assert_allclose(_np(out_p.theta), np.asarray(out_r.theta),
                               atol=TOL)


def test_run_stream_schedule_none_is_the_empty_chain():
    feats, labels, adj = (torch.tensor(a) for a in _core_stream())
    kw = dict(lam=1e-2, rho=0.1, lr=0.2, num_rounds=30,
              batch_fn=lambda k: (feats[k], labels[k]))
    out_n, mse_n, comms_n = online.run_stream(online.init_state(4, 6), adj,
                                              None, **kw)
    out_c, mse_c, comms_c = online.run_stream(
        online.init_state(4, 6, policy=Chain(())), adj, Chain(()), **kw)
    assert torch.equal(mse_n, mse_c) and torch.equal(comms_n, comms_c)
    assert torch.equal(out_n.theta, out_c.theta)
    assert torch.equal(out_n.comm.bits, out_c.comm.bits)


def test_run_stream_aligns_a_state_made_without_a_policy():
    feats, labels, adj = (torch.tensor(a) for a in _core_stream(seed=4))
    sched = Chain((Censor(0.3, 0.97),))
    out, mse, comms = online.run_stream(
        online.init_state(4, 6), adj, sched, lam=1e-2, rho=0.1, lr=0.2,
        num_rounds=20, batch_fn=lambda k: (feats[k], labels[k]))
    assert len(out.comm.stages) == 1 and tuple(mse.shape) == (20,)
    assert int(out.comms) == int(comms[-1])
    c = _np(comms)
    assert (np.diff(c) >= 0).all()
    z = torch.zeros((4, 6))
    bare = online.OnlineState(z, z, z, 0, torch.zeros((), dtype=torch.int32))
    stepped, _ = online.stream_step(bare, feats[0], labels[0], adj, sched,
                                    lam=1e-2, rho=0.1, lr=0.2)
    assert tuple(stepped.comm.bits.shape) == (4,)


@pytest.mark.parametrize("eta", [None, 10.0], ids=["gradient", "qc"])
def test_stream_update_adjacency_hook_matches_the_reference(eta):
    """The learned-graph hook (adjacency=) of the ring runtime's streaming
    round, which raised NotImplementedError before personalization was
    ported: a seeded symmetric weighted graph (one for rounds 1-6, another
    for 7-12, as a refresh swaps it), 12 rounds from seeded parameters,
    the gradient and QC-ODKLA steps: comms exact, theta, theta_hat and
    gamma within 1e-6; the circulant cache is carried untouched."""
    rng = np.random.default_rng(7)
    feats, labels, _ = _core_stream(seed=7)
    N, D = feats.shape[1], feats.shape[-1]
    theta0 = rng.standard_normal((N, D)).astype(np.float32)
    graphs = []
    for _ in range(2):
        w = np.triu(rng.uniform(0.1, 1.0, (N, N))
                    * (rng.uniform(size=(N, N)) < 0.6), 1)
        graphs.append((w + w.T).astype(np.float32))
    out = []
    for cns, arr, chain in (
            (jax_cns, jnp.asarray, JChain((JCensor(0.05, 0.97),))),
            (port_cns, torch.tensor, Chain((Censor(0.05, 0.97),)))):
        ccfg = cns.ConsensusConfig(rho=0.1)
        p = {"theta": arr(theta0)}
        st = cns.init_stream_state(ccfg, p["theta"], comm=chain)
        cache = st["nbr_left"]
        for k in range(12):
            p, st, _ = cns.stream_update(ccfg, p, st, arr(feats[k]),
                                         arr(labels[k]), lam=1e-2, lr=0.2,
                                         eta=eta, comm=chain,
                                         adjacency=arr(graphs[k // 6]))
        assert st["nbr_left"] is cache
        out.append((p, st))
    (jp, jst), (tp, tst) = out
    assert int(tst["comms"]) == int(jst["comms"])
    for got, want in ((tp["theta"], jp["theta"]),
                      (tst["theta_hat"], jst["theta_hat"]),
                      (tst["gamma"], jst["gamma"])):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("hook", ["participate", "alive"])
def test_stream_update_gossip_hooks_match_the_reference(hook):
    """The gossip (participate) and churn (alive / joined) hooks of the
    ring runtime's streaming round, which raised NotImplementedError
    before gossip was ported, over 12 rounds of seeded masks (agent 2
    leaving at round 4 and rejoining at round 8 under churn): comms exact,
    theta, theta_hat and gamma within 1e-6."""
    rng = np.random.default_rng(5)
    feats, labels, _ = _core_stream(seed=5)
    N, D = feats.shape[1], feats.shape[-1]
    theta0 = rng.standard_normal((N, D)).astype(np.float32)
    out = []
    for cns, arr, chain in (
            (jax_cns, jnp.asarray, JChain((JCensor(0.05, 0.97),))),
            (port_cns, torch.tensor, Chain((Censor(0.05, 0.97),)))):
        ccfg = cns.ConsensusConfig(rho=0.1)
        p = {"theta": arr(theta0)}
        st = cns.init_stream_state(ccfg, p["theta"], comm=chain)
        masks = np.random.default_rng(9)
        for k in range(12):
            extra = {}
            if hook == "participate":
                extra["participate"] = arr(masks.random(N) < 0.6)
            else:
                alive = np.ones(N, bool)
                alive[2] = not 4 <= k + 1 < 8
                extra["alive"] = arr(alive)
                if k + 1 == 8:
                    extra["joined"] = arr(np.arange(N) == 2)
            p, st, _ = cns.stream_update(ccfg, p, st, arr(feats[k]),
                                         arr(labels[k]), lam=1e-2, lr=0.2,
                                         comm=chain, **extra)
        out.append((p, st))
    (jp, jst), (tp, tst) = out
    assert int(tst["comms"]) == int(jst["comms"])
    for got, want in ((tp["theta"], jp["theta"]),
                      (tst["theta_hat"], jst["theta_hat"]),
                      (tst["gamma"], jst["gamma"])):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)


def test_streaming_solvers_carry_the_reference_flags():
    for name in ALGS:
        s = get_solver(name)
        assert s.streaming and s.stream_backends == ("simulator", "spmd")
        assert s.backends == ("simulator",)
