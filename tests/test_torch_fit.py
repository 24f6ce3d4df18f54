"""The port's slice as a whole against the JAX reference, on the CPU.

Both packages get the same inputs: the datasets are numpy (exactly equal
by construction), and the port is handed the reference's features and RFF
arrays through `repro_torch.convert` (the two packages' RFF draws differ at
the same seed). The port's fit runs with device="cpu", where its kernel
wrappers run their plain PyTorch versions.

The reference side of the megakernel fit comparison is
`fit(backend="fused")` with the reference's own `_MEGASTEP_USE_KERNEL =
False` switch, which runs the blockwise `coke_megastep_ref` the reference
pins bit-identical to its megakernel (the megakernel's wrapper cannot build
on jax 0.9.0: see ROADMAP.md Queue 3), and the reference simulator at
primal="gradient", inner_steps=1, which the reference pins to the fused
path. The ring runtime (spmd, and the fused fallback through
`coke_fused_update` on a non-quadratic loss) is held against the
reference's same fits directly: its Pallas kernel runs in interpret mode
on the CPU.

Tolerances: comms and bits are integer-valued and must match exactly;
trajectories and theta to 1e-5, the reference's own fused-vs-simulator
tolerance (tests/test_fused_megakernel.py).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Censor as JCensor
from repro.api import Chain as JChain
from repro.api import FitConfig as JFitConfig
from repro.api import KernelModel as JKernelModel
from repro.api import KRRConfig as JKRRConfig
from repro.api import backends as jax_backends
from repro.api import build_problem as jax_build_problem
from repro.api import fit as jax_fit
from repro.core import graph as jax_graph
from repro.core.admm import make_problem as jax_make_problem
from repro.data import synthetic as jax_synth

import repro_torch.api.problems as port_problems
from repro_torch import convert
from repro_torch.core.admm import resolve_primal
from repro_torch.kernels.coke_update import coke_update as port_cu
from repro_torch.kernels.coke_update import ops as port_ops
from repro_torch.api import (Censor, Chain, Drop, FitConfig, KernelModel,
                             KRRConfig, Quantize, build_problem, fit)
from repro_torch.core import graph as port_graph
from repro_torch.data import synthetic as port_synth

torch.set_num_threads(2)

TOL = 1e-5
KRR = dict(num_agents=4, samples_per_agent=40, num_features=32, lam=1e-2,
           rho=0.1, seed=0)
# the reference battery's BASE config (tests/test_fused_megakernel.py)
BASE = dict(graph="ring", algorithm="coke", censor_v=0.3, censor_mu=0.97,
            num_iters=40, primal="gradient", inner_steps=1, inner_lr=0.05,
            backend="fused")


def _configs(**over):
    kw = {**BASE, **over}
    return (JFitConfig(krr=JKRRConfig(**KRR), **kw),
            FitConfig(krr=KRRConfig(**KRR), **kw))


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


@pytest.fixture(scope="module")
def built():
    """The reference's problem, and the port's copy of it."""
    jb = jax_build_problem(_configs()[0])
    p = jb.problem
    problem = convert.problem_from_numpy(
        np.asarray(p.feats), np.asarray(p.labels), np.asarray(p.adjacency),
        p.lam, p.rho, device="cpu")
    rff = convert.rff_params_from_numpy(
        np.asarray(jb.rff_params.omega), np.asarray(jb.rff_params.bias),
        jb.rff_params.mapping, device="cpu")
    return jb, problem, rff


@pytest.fixture(scope="module")
def reference_fits(built):
    """{alg: (reference fused fit, reference simulator fit)}."""
    jb = built[0]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_backends, "_MEGASTEP_USE_KERNEL", False)
        for alg in ("coke", "dkla"):
            jcfg = _configs(algorithm=alg)[0]
            out[alg] = (jax_fit(jcfg, problem=jb.problem),
                        jax_fit(jcfg.replace(backend="simulator"),
                                problem=jb.problem))
    return out


@pytest.fixture(scope="module")
def port_fits(built):
    problem = built[1]
    return {alg: fit(_configs(algorithm=alg)[1], problem=problem,
                     device="cpu")
            for alg in ("coke", "dkla")}


def _assert_history_match(ref, port, err):
    assert set(port.history) == set(ref.history), err
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(_np(port.history[k]),
                                      np.asarray(ref.history[k]),
                                      err_msg=f"{err}:{k}")
    for k in ("train_mse", "consensus_gap", "send_frac"):
        if k not in ref.history:     # cta records no send fraction
            continue
        np.testing.assert_allclose(_np(port.history[k]),
                                   np.asarray(ref.history[k]), rtol=TOL,
                                   atol=TOL, err_msg=f"{err}:{k}")
    np.testing.assert_allclose(_np(port.theta), np.asarray(ref.theta),
                               atol=TOL, rtol=0, err_msg=f"{err}:theta")


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def test_paper_synthetic_exactly_equal():
    a = jax_synth.paper_synthetic(num_agents=5, samples_per_agent=60, seed=3)
    b = port_synth.paper_synthetic(num_agents=5, samples_per_agent=60, seed=3)
    for f in ("x", "y", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("name", ["air_quality", "energy"])
def test_uci_standin_exactly_equal(name):
    a = jax_synth.uci_standin(name, num_agents=4, subsample=400)
    b = port_synth.uci_standin(name, num_agents=4, subsample=400)
    for f in ("x", "y", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("family", ["ring", "circulant", "erdos_renyi",
                                    "full"])
def test_graphs_exactly_equal(family):
    make = {
        "ring": lambda m: m.ring(7),
        "circulant": lambda m: m.circulant(9, (1, 3)),
        "erdos_renyi": lambda m: m.erdos_renyi(12, 0.3, seed=4),
        "full": lambda m: m.fully_connected(5),
    }[family]
    np.testing.assert_array_equal(make(port_graph).adjacency,
                                  make(jax_graph).adjacency)


def test_build_problem_with_carried_rff_matches_reference(built,
                                                          monkeypatch):
    """With the reference's omega/bias carried across, the port's
    build_problem gives the same data and graph and close features."""
    jb, _, rff = built
    monkeypatch.setattr(port_problems.rff, "draw_rff",
                        lambda *a, **k: rff)
    pb = build_problem(_configs()[1], device="cpu")
    p, q = jb.problem, pb.problem
    np.testing.assert_array_equal(_np(q.labels), np.asarray(p.labels))
    np.testing.assert_array_equal(_np(q.adjacency), np.asarray(p.adjacency))
    np.testing.assert_array_equal(_np(pb.x_test), np.asarray(jb.x_test))
    np.testing.assert_allclose(_np(q.feats), np.asarray(p.feats), atol=1e-6)
    np.testing.assert_allclose(_np(pb.feats_test), np.asarray(jb.feats_test),
                               atol=1e-6)
    assert (q.lam, q.rho, q.loss) == (p.lam, p.rho, p.loss)


@pytest.mark.parametrize("mapping", ["cos_bias", "cos_sin"])
def test_rff_kernels_match_reference(mapping):
    """approx_kernel (Eq. 11), exact_gaussian_kernel and featurize_jit
    (the port's plain featurize under the reference's name) on the
    reference's omega and bias: within 1e-5 of the largest entry."""
    from repro.core import rff as jax_rff

    from repro_torch.core import rff as port_rff
    rng = np.random.default_rng(7)
    omega = rng.normal(size=(5, 24)).astype(np.float32)
    bias = rng.uniform(0, 2 * np.pi, size=24).astype(np.float32)
    x = rng.uniform(size=(9, 5)).astype(np.float32)
    y = rng.uniform(size=(6, 5)).astype(np.float32)
    jp = jax_rff.RFFParams(jnp.asarray(omega), jnp.asarray(bias), mapping)
    tp = convert.rff_params_from_numpy(omega, bias, mapping, device="cpu")
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for got, want in (
            (port_rff.approx_kernel(tp, tx, ty),
             jax_rff.approx_kernel(jp, jnp.asarray(x), jnp.asarray(y))),
            (port_rff.exact_gaussian_kernel(tx, ty, 0.7),
             jax_rff.exact_gaussian_kernel(jnp.asarray(x), jnp.asarray(y),
                                           0.7)),
            (port_rff.featurize_jit(tp, tx),
             jax_rff.featurize_jit(jp, jnp.asarray(x)))):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    assert torch.equal(port_rff.featurize_jit(tp, tx),
                       port_rff.featurize(tp, tx))


def test_get_krr_config_matches_reference():
    from repro.configs import get_krr_config as jax_get_krr_config
    from repro.configs.coke_krr import PAPER_SETUPS as JAX_SETUPS

    from repro_torch.configs import get_krr_config
    for setup in JAX_SETUPS:
        assert dataclasses.asdict(get_krr_config(setup)) == \
            dataclasses.asdict(jax_get_krr_config(setup)), setup
    assert get_krr_config() == get_krr_config("synthetic")
    with pytest.raises(KeyError):
        get_krr_config("no-such-setup")


def test_build_problem_draws_its_own_rff_from_the_seed():
    """The port's draw is a torch.Generator draw: reproducible at a seed
    and on the shape the config asks for (not the reference's numbers)."""
    a = build_problem(_configs()[1], device="cpu")
    b = build_problem(_configs()[1], device="cpu")
    assert tuple(a.rff_params.omega.shape) == (5, 32)
    assert torch.equal(a.rff_params.omega, b.rff_params.omega)
    assert torch.equal(a.problem.feats, b.problem.feats)
    assert tuple(a.problem.feats.shape) == (4, 28, 32)


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alg,chunk", [
    ("coke", None), ("dkla", None), ("coke", 1), ("dkla", 1), ("coke", 3),
    ("dkla", 3)], ids=["coke", "dkla", "coke-chunk1", "dkla-chunk1",
                       "coke-chunk3", "dkla-chunk3"])
def test_fit_matches_reference_fused_and_simulator(alg, chunk, built,
                                                   reference_fits, port_fits):
    """The megakernel fit against the reference at every chunk size: its
    train MSE is K2's residual sum one iteration late, and the chunk's last
    iteration reads Phi again, so chunking moves where each value comes
    from but must not move the values (40 iterations; chunks of 3 leave a
    ragged last chunk of 1)."""
    fused, simulator = reference_fits[alg]
    port = port_fits[alg] if chunk is None else fit(
        _configs(algorithm=alg, chunk_size=chunk)[1], problem=built[1],
        device="cpu")
    _assert_history_match(fused, port, f"{alg}:fused")
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(_np(port.history[k]),
                                      np.asarray(simulator.history[k]))
    np.testing.assert_allclose(_np(port.theta), np.asarray(simulator.theta),
                               atol=TOL)
    comms = _np(port.comms)
    assert comms[-1] <= 4 * 40 if alg == "coke" else comms[-1] == 4 * 40


def test_censoring_saves_transmissions(port_fits):
    assert _np(port_fits["coke"].comms)[-1] < _np(port_fits["dkla"].comms)[-1]
    mse = _np(port_fits["coke"].train_mse)
    assert mse[-1] < mse[0] and np.isfinite(mse).all()


def test_chunked_fit_matches_monolithic(built, port_fits):
    seen = []
    cfg = _configs(chunk_size=15)[1]
    res = fit(cfg, problem=built[1], device="cpu",
              progress_cb=lambda n, m: seen.append((n, float(m["comms"]))))
    whole = port_fits["coke"]
    for k in whole.history:
        torch.testing.assert_close(res.history[k], whole.history[k],
                                   rtol=0, atol=0)
    assert [n for n, _ in seen] == [15, 30, 40]
    assert seen[-1][1] == float(whole.comms[-1])


def test_oracle_distance_matches_reference(built):
    jcfg, cfg = _configs(record_oracle_distance=True, num_iters=10)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_backends, "_MEGASTEP_USE_KERNEL", False)
        ref = jax_fit(jcfg, problem=built[0].problem)
    port = fit(cfg, problem=built[1], device="cpu")
    np.testing.assert_allclose(_np(port.history["dist_to_oracle"]),
                               np.asarray(ref.history["dist_to_oracle"]),
                               rtol=1e-4)


def test_zero_iterations_gives_empty_histories(built):
    res = fit(_configs(num_iters=0)[1], problem=built[1], device="cpu")
    assert res.history["comms"].shape == (0,)
    assert res.history["comms"].dtype == torch.int32
    assert float(res.theta.abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# deploy: predict, evaluate, artifacts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_predict_and_evaluate_match_reference(backend, built, port_fits,
                                              reference_fits):
    jb, _, rff = built
    jmodel = reference_fits["coke"][0].to_model(jb.rff_params)
    model = port_fits["coke"].to_model(rff)
    want = np.asarray(jmodel.predict(jb.x_test, backend="ref"))
    got = _np(model.predict(_np(jb.x_test), backend=backend))
    np.testing.assert_allclose(got, want, atol=TOL)
    jev = jmodel.evaluate(jb.x_test, jb.y_test)
    ev = model.evaluate(_np(jb.x_test), _np(jb.y_test), backend=backend)
    for k in ("test_mse", "consensus_mse", "rmse"):
        np.testing.assert_allclose(ev[k], jev[k], rtol=1e-4)
    got_b = _np(model.predict(_np(jb.x_test), backend=backend, batch_size=7))
    np.testing.assert_allclose(got_b, got, atol=1e-6)


def test_reference_artifact_loads_in_port(tmp_path, built, reference_fits):
    jb = built[0]
    jmodel = reference_fits["coke"][0].to_model(jb.rff_params)
    path = str(tmp_path / "coke")
    jmodel.save(path)
    model = KernelModel.load(path, device="cpu")
    assert model.meta == json.loads(json.dumps(jmodel.meta))
    np.testing.assert_array_equal(_np(model.theta), np.asarray(jmodel.theta))
    np.testing.assert_allclose(
        _np(model.predict(_np(jb.x_test), backend="fused")),
        np.asarray(jmodel.predict(jb.x_test)), atol=TOL)


def test_port_artifact_loads_in_reference(tmp_path, built, port_fits):
    jb, _, rff = built
    model = port_fits["dkla"].to_model(rff)
    path = str(tmp_path / "dkla")
    model.save(path)
    jmodel = JKernelModel.load(path)
    np.testing.assert_array_equal(np.asarray(jmodel.thetas),
                                  _np(model.thetas))
    np.testing.assert_allclose(np.asarray(jmodel.predict(jb.x_test)),
                               _np(model.predict(_np(jb.x_test))), atol=TOL)


def test_model_from_numpy_takes_reference_array_names(built, reference_fits):
    jb = built[0]
    jmodel = reference_fits["dkla"][0].to_model(jb.rff_params)
    arrays = {k: np.asarray(v) for k, v in jmodel._array_tree().items()}
    model = convert.model_from_numpy(arrays, {"bandwidth": 1.0},
                                     device="cpu")
    np.testing.assert_allclose(_np(model.predict(_np(jb.x_test))),
                               np.asarray(jmodel.predict(jb.x_test)),
                               atol=TOL)
    # the model is an nn.Module: its arrays are buffers, calling it predicts
    assert set(model.state_dict()) == set(arrays)
    assert torch.equal(model(_np(jb.x_test)), model.predict(_np(jb.x_test)))


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------

def test_port_imports_no_jax_and_no_reference():
    """A full CPU fit and predict through repro_torch leaves neither jax
    nor the reference package in sys.modules."""
    code = (
        "import sys\n"
        "from repro_torch.api import FitConfig, KRRConfig, build_problem, fit\n"
        "cfg = FitConfig(krr=KRRConfig(num_agents=4, samples_per_agent=20,"
        " num_features=16), backend='fused', graph='ring', primal='gradient',"
        " num_iters=3)\n"
        "b = build_problem(cfg, device='cpu')\n"
        "r = fit(cfg, problem=b.problem, device='cpu')\n"
        "r.to_model(b.rff_params).predict(b.x_test, backend='fused')\n"
        "fit(cfg.replace(backend='spmd', algorithm='cta'), problem=b.problem,"
        " device='cpu')\n"
        "import dataclasses, torch\n"
        "lab = torch.where(b.problem.labels > b.problem.labels.median(), 1.0,"
        " -1.0)\n"
        "p = dataclasses.replace(b.problem, labels=lab, loss='logistic')\n"
        "r = fit(cfg.replace(primal='auto'), problem=p, device='cpu')\n"
        "assert r.history['comms'].shape == (3,)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_entry_points_need_a_card_unless_asked_for_cpu(built, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    cfg = _configs()[1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit(cfg, problem=built[1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_problem(cfg)
    path = str(tmp_path / "m")
    fit(cfg.replace(num_iters=1), problem=built[1],
        device="cpu").to_model(built[2]).save(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KernelModel.load(path)


#: the config that raised NotImplementedError until a mesh ran under
#: gossip, now run on a (2, 4) mesh
MESH_CONFIGS = {
    "mesh-gossip": dict(exec="gossip", participation=0.5),
}


@pytest.mark.parametrize("case", sorted(MESH_CONFIGS))
def test_mesh_configs_match_the_unsharded_reference(case, built):
    """The megakernel config under gossip on a (2, 4) mesh: its gate keeps
    the reference's `mesh is None`, so the ring runtime runs, K3 once per
    block of the carry. Held to the reference's unsharded spmd fit (its
    own sharded run cannot run on this jax, ROADMAP.md): comms and bits
    exact, the rest within 1e-5."""
    from repro_torch.launch.mesh import make_host_mesh

    jcfg, tcfg = _configs(**MESH_CONFIGS[case])
    ref = jax_fit(jcfg.replace(backend="spmd"), problem=built[0].problem)
    port = fit(tcfg, problem=built[1], device="cpu",
               mesh=make_host_mesh(2, 4, device="cpu"))
    _assert_history_match(ref, port, case)


@pytest.mark.parametrize("backend", ["simulator", "spmd"])
def test_heterogeneous_personalized_fit_matches_the_reference(backend):
    """The heterogeneous dataset and a personalized fit, which raised
    NotImplementedError before personalization was ported: the port
    builds the reference's arrays (bitwise) and, on the reference's
    features, fits a personalized COKE with comms and bits exactly equal,
    the learned graph's support equal and theta within 1e-3 relative (the
    reference's own tolerance between two personalized runs;
    tests/test_torch_personalize.py says why)."""
    from repro.api import Personalization as JPersonalization

    from repro_torch.api import Personalization
    krr = dict(KRR, dataset="heterogeneous", num_tasks=2)
    kw = dict(graph="ring", algorithm="coke", censor_v=0.3, censor_mu=0.97,
              num_iters=30, primal="cg", backend=backend)
    jcfg = JFitConfig(krr=JKRRConfig(**krr), **kw,
                      personalization=JPersonalization(k=1, every=4,
                                                       warmup=10))
    tcfg = FitConfig(krr=KRRConfig(**krr), **kw,
                     personalization=Personalization(k=1, every=4,
                                                     warmup=10))
    jb = jax_build_problem(jcfg)
    tb = build_problem(tcfg, device="cpu")
    np.testing.assert_array_equal(_np(tb.problem.labels),
                                  np.asarray(jb.problem.labels))
    np.testing.assert_array_equal(tb.clusters, jb.clusters)
    ref = jax_fit(jcfg, problem=jb.problem)
    port = fit(tcfg, problem=convert.problem_from_numpy(
        np.asarray(jb.problem.feats), np.asarray(jb.problem.labels),
        np.asarray(jb.problem.adjacency), jb.problem.lam, jb.problem.rho,
        device="cpu"), device="cpu")
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(_np(port.history[k]),
                                      np.asarray(ref.history[k]))
    np.testing.assert_array_equal(_np(port.learned_adjacency) > 0,
                                  np.asarray(ref.learned_adjacency) > 0)
    want = np.asarray(ref.theta)
    np.testing.assert_allclose(_np(port.theta), want, rtol=0,
                               atol=1e-3 * max(1.0, np.abs(want).max()))


#: configs that raised NotImplementedError before Quantize, Drop and
#: topology schedules were ported, now run against the reference
FORMERLY_OUT_OF_SLICE = {
    "quantize": dict(censor_v=None, censor_mu=None,
                     comm=("Chain", (("Censor", 0.3, 0.97),
                                     ("Quantize", 5)))),
    "drop": dict(censor_v=None, censor_mu=None,
                 comm=("Chain", (("Drop", 0.1),))),
    # N=4 has one non-degenerate circulant; the simulator cycles a ring
    # and the complete graph (test_torch_topology.py cycles at N=6)
    "topology-simulator": dict(backend="simulator", topology="ring|full"),
    "topology-spmd": dict(backend="spmd", topology=((1,),)),
    "topology-fused": dict(topology=((1,),)),
}


def _both_kw(case):
    """(reference kw, port kw) of a FORMERLY_OUT_OF_SLICE case."""
    from repro.api import Drop as JDrop
    from repro.api import Quantize as JQuantize
    from repro.api import TopologySchedule as JTopologySchedule
    from repro_torch.core.graph import TopologySchedule

    jkw, tkw = dict(FORMERLY_OUT_OF_SLICE[case]), dict(
        FORMERLY_OUT_OF_SLICE[case])
    if "comm" in jkw:
        make = {"Censor": (JCensor, Censor), "Quantize": (JQuantize,
                                                          Quantize),
                "Drop": (JDrop, Drop)}
        stages = jkw["comm"][1]
        jkw["comm"] = JChain([make[n][0](*a) for n, *a in stages])
        tkw["comm"] = Chain([make[n][1](*a) for n, *a in stages])
    n = KRR["num_agents"]
    if jkw.get("topology") == "ring|full":
        graphs = [jax_graph.ring(n), jax_graph.fully_connected(n)]
        jkw["topology"] = JTopologySchedule.from_graphs(graphs)
        tkw["topology"] = convert.topology_from_reference(
            np.asarray(jkw["topology"].adjacencies), device="cpu")
    elif "topology" in jkw:
        jkw["topology"] = JTopologySchedule.circulant_cycle(n,
                                                            jkw["topology"])
        tkw["topology"] = TopologySchedule.circulant_cycle(n,
                                                           tkw["topology"])
    return {**BASE, **jkw}, {**BASE, **tkw}


@pytest.mark.parametrize("case", sorted(FORMERLY_OUT_OF_SLICE))
def test_chain_and_schedule_configs_match_the_reference(case, built,
                                                        monkeypatch):
    """Quantize and Drop on the megakernel path, a schedule on spmd: comms
    and bits exact, the rest within 1e-5; a schedule on the fused backend
    raises the reference's ValueError (its fallback's kernel takes a fixed
    degree)."""
    monkeypatch.setattr(jax_backends, "_MEGASTEP_USE_KERNEL", False)
    jkw, tkw = _both_kw(case)
    if case == "topology-fused":
        with pytest.raises(ValueError) as ref_err:
            jax_fit(JFitConfig(krr=JKRRConfig(**KRR), **jkw),
                    problem=built[0].problem)
        with pytest.raises(ValueError) as port_err:
            fit(FitConfig(krr=KRRConfig(**KRR), **tkw), problem=built[1],
                device="cpu")
        assert "static" in str(port_err.value)
        assert str(port_err.value) == str(ref_err.value)
        return
    ref = jax_fit(JFitConfig(krr=JKRRConfig(**KRR), **jkw),
                  problem=built[0].problem)
    port = fit(FitConfig(krr=KRRConfig(**KRR), **tkw), problem=built[1],
               device="cpu")
    _assert_history_match(ref, port, case)


#: gossip configs that raised NotImplementedError before gossip was
#: ported, now run against the reference
GOSSIP_CONFIGS = {
    "spmd-gossip": dict(backend="spmd", exec="gossip", participation=0.5),
    "gossip": dict(exec="gossip", participation=0.5),
}


@pytest.mark.parametrize("case", sorted(GOSSIP_CONFIGS))
def test_gossip_configs_match_the_reference(case, built, monkeypatch):
    """Gossip at participation 0.5 on spmd and on the megakernel path (the
    reference through its unfused switch): comms and bits exact, the rest
    within 1e-5."""
    monkeypatch.setattr(jax_backends, "_MEGASTEP_USE_KERNEL", False)
    jcfg, tcfg = _configs(**GOSSIP_CONFIGS[case])
    ref = jax_fit(jcfg, problem=built[0].problem)
    port = fit(tcfg, problem=built[1], device="cpu")
    _assert_history_match(ref, port, case)


def test_fused_rejects_a_non_circulant_graph(built):
    """As in the reference: the fused ring runtime validates the graph."""
    p = built[1]
    er = port_graph.erdos_renyi(4, 0.9, seed=1).adjacency
    problem = dataclasses.replace(p, adjacency=torch.tensor(er,
                                                            dtype=p.feats.dtype))
    with pytest.raises(ValueError, match="circulant"):
        fit(_configs()[1], problem=problem, device="cpu")


# ---------------------------------------------------------------------------
# the ring runtime: the spmd backend and the fused fallback through K3
# ---------------------------------------------------------------------------

# A censor threshold under which COKE sends some broadcasts but not all on
# the classification losses at this size (v=0.3, mu=0.97 sends none there),
# so the masked broadcast is exercised; 20 iterations.
CLS = dict(censor_v=0.03, censor_mu=0.8, num_iters=20)


def _sign_labels(labels):
    y = np.asarray(labels)
    return np.where(y > np.median(y), 1.0, -1.0).astype(np.float32)


@pytest.fixture(scope="module")
def cls_problems(built):
    """{loss: (reference problem, port problem)} on +-1 labels."""
    p = built[0].problem
    lab = _sign_labels(p.labels)
    out = {}
    for loss in ("logistic", "hinge"):
        out[loss] = (
            jax_make_problem(p.feats, jnp.asarray(lab), jax_graph.ring(4),
                             p.lam, p.rho, loss=loss),
            convert.problem_from_numpy(np.asarray(p.feats), lab,
                                       np.asarray(p.adjacency), p.lam, p.rho,
                                       loss=loss, device="cpu"))
    return out


def _cfg_kw(alg, **over):
    kw = {**BASE, "algorithm": alg, **over}
    if alg == "cta":   # cta threads no comm policy; its default stepsize
        # 0.9 diverges on this problem
        kw.update(censor_v=None, censor_mu=None, cta_lr=0.05)
    return kw


def _fit_both(jprob, tprob, **kw):
    ref = jax_fit(JFitConfig(krr=JKRRConfig(**KRR), **kw), problem=jprob)
    port = fit(FitConfig(krr=KRRConfig(**KRR), **kw), problem=tprob,
               device="cpu")
    return ref, port


@pytest.mark.parametrize("alg", ["coke", "dkla", "cta"])
def test_spmd_fit_matches_reference(alg, built):
    ref, port = _fit_both(built[0].problem, built[1],
                          **_cfg_kw(alg, backend="spmd"))
    _assert_history_match(ref, port, f"{alg}:spmd")
    comms = _np(port.comms)
    if alg == "coke":
        assert 0 < comms[-1] < 4 * 40
    else:
        assert comms[-1] == 4 * 40
    if alg == "cta":
        np.testing.assert_array_equal(
            _np(port.bits), comms.astype(np.float32) * 32 * 32)


@pytest.mark.parametrize("backend", ["fused", "spmd"])
@pytest.mark.parametrize("alg", ["coke", "dkla"])
@pytest.mark.parametrize("loss", ["logistic", "hinge"])
def test_ring_runtime_on_a_classification_loss_matches_reference(
        loss, alg, backend, cls_problems, monkeypatch):
    """The fused fallback (K3 on every iteration) and the spmd runtime on
    the non-quadratic losses, against the reference's same fits."""
    jprob, tprob = cls_problems[loss]
    port_cu.FUSED_UPDATE_LAUNCHES = 0
    ref, port = _fit_both(jprob, tprob,
                          **_cfg_kw(alg, backend=backend, **CLS))
    _assert_history_match(ref, port, f"{loss}:{alg}:{backend}")
    comms = _np(port.comms)
    if alg == "coke":
        assert 0 < comms[-1] < 4 * 20
    else:
        assert comms[-1] == 4 * 20
    # on CPU tensors the wrappers count no launch: they ran the plain version
    assert port_cu.FUSED_UPDATE_LAUNCHES == 0


@pytest.mark.parametrize("alg", ["coke", "dkla"])
def test_spmd_matches_the_fused_megakernel_fit(alg, built, port_fits):
    """The port's two runtimes against each other on the quadratic loss:
    the one-step spmd update is the megakernel's iteration in another
    arithmetic order."""
    spmd = fit(_configs(algorithm=alg, backend="spmd")[1], problem=built[1],
               device="cpu")
    _assert_history_match(port_fits[alg], spmd, f"{alg}:spmd-vs-fused")


def test_fused_routes_by_loss(built, cls_problems, monkeypatch):
    """The megakernel takes the quadratic loss; a logistic problem falls
    back to the ring runtime (K3), as the reference's gate does."""
    seen = []
    real = port_ops.coke_fused_update
    monkeypatch.setattr(port_ops, "coke_fused_update",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    cfg = _configs(num_iters=5)[1]
    fit(cfg, problem=built[1], device="cpu")
    assert not seen
    fit(cfg.replace(primal="auto"), problem=cls_problems["logistic"][1],
        device="cpu")
    assert len(seen) == 5


def test_cg_on_a_classification_loss_raises_value_error(cls_problems):
    """As in the reference's resolve_primal: CG solves normal equations a
    logistic or hinge loss does not have."""
    with pytest.raises(ValueError, match="normal equations"):
        resolve_primal("cg", 32, "logistic")
    assert resolve_primal("auto", 4096, "hinge") == "gradient"
    assert resolve_primal("auto", 4096, "quadratic") == "cg"
    assert resolve_primal("auto", 2048, "quadratic") == "cholesky"
    for backend in ("fused", "spmd"):
        with pytest.raises(ValueError, match="normal equations"):
            fit(_configs(primal="cg", backend=backend)[1],
                problem=cls_problems["hinge"][1], device="cpu")


@pytest.mark.parametrize("case", ["cta-fused", "cta-comm", "cta-cg"])
def test_solver_admission_raises_the_reference_value_error(case, built):
    """The reference's capability rules for a solver that is not an ADMM
    solver; the port gives the same messages."""
    kw = _cfg_kw("cta", backend="spmd")
    kw.update({"cta-fused": dict(backend="fused"), "cta-comm": {},
               "cta-cg": dict(primal="cg")}[case])
    jkw, tkw = dict(kw), dict(kw)
    if case == "cta-comm":
        jkw["comm"] = JChain([JCensor(0.3, 0.97)])
        tkw["comm"] = Chain([Censor(0.3, 0.97)])
    with pytest.raises(ValueError) as ref_err:
        jax_fit(JFitConfig(krr=JKRRConfig(**KRR), **jkw),
                problem=built[0].problem)
    with pytest.raises(ValueError) as port_err:
        fit(FitConfig(krr=KRRConfig(**KRR), **tkw), problem=built[1],
            device="cpu")
    assert str(port_err.value) == str(ref_err.value)
