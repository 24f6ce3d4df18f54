"""Time-varying topologies (`repro_torch.core.graph.TopologySchedule`) on
the simulator and the spmd ring runtime, against the reference's
`tests/test_comm.py` schedule cases, on the CPU.

Both packages fit one schedule: the reference's adjacency stack and
offsets carried over by `convert.topology_from_reference`, on the
reference's problem carried over by `convert.problem_from_numpy`. Comms and
bits must be equal exactly, theta within 1e-5; errors carry the reference's
messages word for word."""
import numpy as np
import pytest
import torch

from repro.api import FitConfig as JFitConfig
from repro.api import KRRConfig as JKRRConfig
from repro.api import TopologySchedule as JTopologySchedule
from repro.api import build_problem as jax_build_problem
from repro.api import fit as jax_fit
from repro.core import graph as jax_graph

from repro_torch import convert
from repro_torch.api import FitConfig, KRRConfig, fit
from repro_torch.core import graph as port_graph
from repro_torch.core.graph import TopologySchedule

torch.set_num_threads(2)

TOL = 1e-5
# the reference's RING6 configuration (tests/test_comm.py), 40 iterations
KRR = dict(num_agents=6, samples_per_agent=40, num_features=32, lam=1e-2,
           rho=0.1, seed=0)
RING6 = dict(graph="ring", algorithm="coke", censor_v=0.3, censor_mu=0.97,
             num_iters=40, primal="gradient", inner_steps=1, inner_lr=0.05)
CYCLE = [(1,), (1, 2)]


@pytest.fixture(scope="module")
def ring6():
    jp = jax_build_problem(JFitConfig(krr=JKRRConfig(**KRR),
                                      **RING6)).problem
    return jp, convert.problem_from_numpy(
        np.asarray(jp.feats), np.asarray(jp.labels),
        np.asarray(jp.adjacency), jp.lam, jp.rho, device="cpu")


def _schedules(variants=CYCLE):
    jt = JTopologySchedule.circulant_cycle(6, variants)
    return jt, convert.topology_from_reference(
        np.asarray(jt.adjacencies), jt.offsets, device="cpu")


def _fit_both(ring6, jtopo, ttopo, **over):
    kw = {**RING6, **over}
    ref = jax_fit(JFitConfig(krr=JKRRConfig(**KRR), topology=jtopo, **kw),
                  problem=ring6[0])
    port = fit(FitConfig(krr=KRRConfig(**KRR), topology=ttopo, **kw),
               problem=ring6[1], device="cpu")
    return ref, port


def _assert_match(ref, port, tol=TOL):
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(port.history[k].numpy(),
                                      np.asarray(ref.history[k]), err_msg=k)
    np.testing.assert_allclose(port.train_mse.numpy(),
                               np.asarray(ref.train_mse), rtol=tol, atol=tol)
    np.testing.assert_allclose(port.theta.numpy(), np.asarray(ref.theta),
                               atol=tol, rtol=0)


def test_topology_schedule_cycles_graphs():
    jt, topo = _schedules()
    built = TopologySchedule.circulant_cycle(6, CYCLE)
    assert topo.num_graphs == 2 and topo.num_agents == 6
    assert topo.offsets == jt.offsets == built.offsets
    assert (topo.index(1), topo.index(2), topo.index(3)) == (0, 1, 0)
    for k in range(1, 6):
        assert topo.index(k) == int(jt.index(k))
        np.testing.assert_array_equal(topo.at(k).numpy(),
                                      np.asarray(jt.at(k)))
    np.testing.assert_array_equal(built.adjacencies.numpy(),
                                  np.asarray(jt.adjacencies))
    assert built.adjacencies.dtype == torch.float32
    graphs = [port_graph.ring(6), port_graph.fully_connected(6)]
    np.testing.assert_array_equal(
        TopologySchedule.from_graphs(graphs).adjacencies.numpy(),
        np.asarray(JTopologySchedule.from_graphs(
            [jax_graph.ring(6), jax_graph.fully_connected(6)]).adjacencies))


@pytest.mark.parametrize("backend", ["simulator", "spmd"])
def test_single_graph_schedule_matches_static(backend, ring6):
    """A one-graph cycle of the static ring is the static fit (the
    reference's tolerance: theta within 1e-6, comms equal); on spmd the
    schedule fetches the neighbours again each step instead of reading the
    cache."""
    static = fit(FitConfig(krr=KRRConfig(**KRR), backend=backend, **RING6),
                 problem=ring6[1], device="cpu")
    _, topo = _schedules([(1,)])
    sched = fit(FitConfig(krr=KRRConfig(**KRR), backend=backend,
                          topology=topo, **RING6),
                problem=ring6[1], device="cpu")
    np.testing.assert_allclose(sched.theta.numpy(), static.theta.numpy(),
                               atol=1e-6, rtol=0)
    assert torch.equal(sched.comms, static.comms)


@pytest.mark.parametrize("backend", ["simulator", "spmd"])
def test_time_varying_topology_matches_the_reference(backend, ring6):
    jt, topo = _schedules()
    ref, port = _fit_both(ring6, jt, topo, backend=backend)
    _assert_match(ref, port)


def test_time_varying_topology_simulator_spmd_parity(ring6):
    """The port's simulator and spmd runs of one schedule (the reference's
    `assert_fit_parity(..., exact=("comms", "bits"), theta_atol=1e-5)`)."""
    _, topo = _schedules()
    runs = [fit(FitConfig(krr=KRRConfig(**KRR), backend=b, topology=topo,
                          **RING6), problem=ring6[1], device="cpu")
            for b in ("simulator", "spmd")]
    for k in ("comms", "bits"):
        assert torch.equal(runs[0].history[k], runs[1].history[k]), k
    np.testing.assert_allclose(runs[0].theta.numpy(), runs[1].theta.numpy(),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("primal", ["auto", "cg"])
def test_time_varying_topology_exact_primals(primal, ring6):
    """The per-graph Cholesky stack ("auto" at D=32) and CG on the
    simulator; CG on spmd too. Denser intermittent connectivity still
    converges, and each run matches the reference."""
    jt, topo = _schedules()
    over = dict(primal=primal, inner_steps=50)
    backends = ["simulator"] + (["spmd"] if primal == "cg" else [])
    for backend in backends:
        ref, port = _fit_both(ring6, jt, topo, backend=backend, **over)
        _assert_match(ref, port, tol=1e-4 if primal == "cg" else TOL)
        assert float(port.train_mse[-1]) < float(port.train_mse[0])


def test_erdos_renyi_schedule_on_the_simulator(ring6):
    """A schedule without offsets (general graphs) runs on the simulator."""
    graphs = [jax_graph.erdos_renyi(6, 0.5, seed=s) for s in (1, 2, 3)]
    jt = JTopologySchedule.from_graphs(graphs)
    topo = convert.topology_from_reference(np.asarray(jt.adjacencies),
                                           device="cpu")
    ref, port = _fit_both(ring6, jt, topo, backend="simulator")
    _assert_match(ref, port)


ERRORS = {
    # spmd needs per-graph offsets
    "offsets": (dict(backend="spmd"), dict(offsets=False)),
    # +-3 on N=6 alias one neighbour
    "degenerate": (dict(backend="spmd"), dict(variants=[(1, 3)])),
    # the fused fallback's kernel takes a fixed degree
    "static": (dict(backend="fused"), {}),
    # cta follows no schedule
    "topology": (dict(algorithm="cta", backend="simulator", censor_v=None,
                      censor_mu=None), {}),
    # a schedule over another agent count
    "agents": (dict(backend="simulator"), dict(variants=[(1,)], n=5)),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_schedule_errors_match_the_reference(case, ring6):
    over, sched = ERRORS[case]
    jt = JTopologySchedule.circulant_cycle(sched.get("n", 6),
                                           sched.get("variants", CYCLE))
    if not sched.get("offsets", True):
        jt = JTopologySchedule(adjacencies=jt.adjacencies)
    topo = convert.topology_from_reference(np.asarray(jt.adjacencies),
                                           jt.offsets, device="cpu")
    kw = {**RING6, **over}
    with pytest.raises(ValueError) as ref_err:
        jax_fit(JFitConfig(krr=JKRRConfig(**KRR), topology=jt, **kw),
                problem=ring6[0])
    with pytest.raises(ValueError) as port_err:
        fit(FitConfig(krr=KRRConfig(**KRR), topology=topo, **kw),
            problem=ring6[1], device="cpu")
    assert str(port_err.value) == str(ref_err.value)
    assert case in str(port_err.value)
