"""The port's `sweep` (a policy grid as one lane-batched simulator loop)
against the reference's vmapped `sweep`, on the CPU.

Both packages fit the reference's featurized problem, carried across with
`repro_torch.convert`. Tolerances are the reference's own for a sweep
against individual fits (tests/test_model.py, tests/test_comm.py): every
cell's comms and bits histories exactly equal; train_mse within 1e-6;
theta within 1e-5, 1e-4 where a cell quantizes (the quantizer's levels
amplify an lsb of the solves); the CG primal's theta within 1e-4 and its
train MSE within rtol 1e-4 (tests/test_torch_simulator.py); evaluate
within 1e-6, and select the same cell.

The port's own contracts: a G-lane sweep equals G port fits (comms and
bits exactly), a G-key draw equals G single draws bit for bit, and a
LaneChain round equals each cell's Chain round bit for bit.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro.api import Censor as JCensor
from repro.api import Chain as JChain
from repro.api import Drop as JDrop
from repro.api import FitConfig as JFitConfig
from repro.api import KRRConfig as JKRRConfig
from repro.api import Quantize as JQuantize
from repro.api import TopologySchedule as JTopologySchedule
from repro.api import build_problem as jax_build_problem
from repro.api import capabilities as jcap
from repro.api import sweep as jax_sweep
from repro.api.registry import get_solver as jax_get_solver
from repro.core import graph as jax_graph

from repro_torch import convert
from repro_torch.api import (Censor, Chain, Drop, FitConfig, KRRConfig,
                             Quantize, fit, sweep)
from repro_torch.api import model as model_mod
from repro_torch.core import comm as comm_mod
from repro_torch.core import prng

# the module, not the `fit` function the package re-exports under its name
fit_mod = importlib.import_module("repro_torch.api.fit")

torch.set_num_threads(2)

INF = float("inf")
TOL = 1e-5
Q_TOL = 1e-4        # cells with a finite Quantize stage
CG_TOL = 1e-4       # the CG primal: theta; train MSE relative
MSE_TOL = 1e-6
KRR = dict(num_agents=4, samples_per_agent=40, num_features=32, lam=1e-2,
           rho=0.1, seed=0)
BASE = dict(graph="ring", algorithm="coke", num_iters=40, censor_v=None,
            censor_mu=None)

_MAKE = {"Censor": (JCensor, Censor), "Quantize": (JQuantize, Quantize),
         "Drop": (JDrop, Drop)}


def _chain(side, stages):
    i = 0 if side == "ref" else 1
    return (JChain if i == 0 else Chain)(
        [_MAKE[n][i](*a, **kw) for n, a, kw in stages])


#: case -> (config knobs, grid cells); a cell is a numeric tuple or a
#: chain spec ((stage name, args, kwargs), ...)
CASES = {
    "pairs": ({}, [(0.3, 0.97), (0.05, 0.9), (1.0, 0.99)]),
    # the widths of benchmarks/paper_comm_cost.py's bits curve
    "triples-inf": ({}, [(0.3, 0.97, INF), (0.3, 0.97, 4.0),
                         (0.05, 0.9, INF), (0.05, 0.9, 4.0)]),
    "deterministic-quantize": ({}, [
        (("Censor", (0.3, 0.97), {}),
         ("Quantize", (b,), dict(stochastic=False)))
        for b in (4.0, INF, 6.0)]),
    "drop": ({}, [(("Censor", (v, 0.97), {}), ("Drop", (p,), {}))
                  for v, p in ((0.3, 0.0), (0.3, 0.2), (0.05, 0.5))]),
    "full-chain": ({}, [(("Censor", (v, 0.97), {}), ("Quantize", (b,), {}),
                         ("Drop", (0.1,), {}))
                        for v, b in ((0.3, 5.0), (0.05, INF), (0.3, 5.0))]),
    "dkla": (dict(algorithm="dkla"), [(0.3, 0.97, 4.0), (0.05, 0.9, INF)]),
    "cta": (dict(algorithm="cta", cta_lr=0.3), [(0.3, 0.97), (0.05, 0.9)]),
    "oracle": (dict(algorithm="ridge_oracle", num_iters=2),
               [(0.3, 0.97), (0.05, 0.9)]),
    "cg": (dict(primal="cg"), [(0.3, 0.97), (0.05, 0.9)]),
    "gradient": (dict(primal="gradient", inner_steps=3, inner_lr=0.05),
                 [(0.3, 0.97), (0.01, 0.9)]),
    "topology": (dict(topology="ring|full"), [(0.3, 0.97), (0.05, 0.9)]),
}


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _cells(side, grid):
    return [c if _numeric(c) else _chain(side, c) for c in grid]


def _numeric(cell):
    return all(isinstance(x, float) for x in cell)


def _stochastic(cell) -> bool:
    """Does the cell quantize stochastically at a finite width?"""
    if _numeric(cell):
        return len(cell) == 3 and bool(np.isfinite(cell[2]))
    return any(n == "Quantize" and np.isfinite(a[0])
               and kw.get("stochastic", True) for n, a, kw in cell)


def _theta_tol(cell, knobs):
    """theta's tolerance for one cell, None for a stochastic quantizer's.
    There an lsb of the iterates can move a rounding to the next level
    (the draws are equal), after which the trajectories part by a level
    step: the reference's own tests/test_comm.py holds such sweep cells to
    their comms and bits alone, and so do these tests."""
    if _stochastic(cell):
        return None
    if knobs.get("primal") == "cg":
        return CG_TOL
    quantizes = (len(cell) == 3 and np.isfinite(cell[2])) if _numeric(
        cell) else any(n == "Quantize" and np.isfinite(a[0])
                       for n, a, _ in cell)
    return Q_TOL if quantizes else TOL


def _knobs(side, knobs):
    kw = dict(BASE, **knobs)
    if kw.get("topology") == "ring|full":
        graphs = [jax_graph.ring(4), jax_graph.fully_connected(4)]
        sched = JTopologySchedule.from_graphs(graphs)
        kw["topology"] = sched if side == "ref" else \
            convert.topology_from_reference(np.asarray(sched.adjacencies),
                                            device="cpu")
    return kw


@pytest.fixture(scope="module")
def built():
    """The reference's built problem and the port's carried problem and
    RFF map."""
    jb = jax_build_problem(JFitConfig(krr=JKRRConfig(**KRR), **BASE))
    jp = jb.problem
    tp = convert.problem_from_numpy(
        np.asarray(jp.feats), np.asarray(jp.labels),
        np.asarray(jp.adjacency), jp.lam, jp.rho, device="cpu")
    rff = convert.rff_params_from_numpy(np.asarray(jb.rff_params.omega),
                                        np.asarray(jb.rff_params.bias),
                                        device="cpu")
    return jb, tp, rff


def _sweep_both(built, knobs, grid):
    jb, tp, _ = built
    ref = jax_sweep(JFitConfig(krr=JKRRConfig(**KRR), **_knobs("ref", knobs)),
                    _cells("ref", grid), problem=jb.problem)
    port = sweep(FitConfig(krr=KRRConfig(**KRR), **_knobs("port", knobs)),
                 _cells("port", grid), problem=tp, device="cpu")
    return ref, port


@pytest.mark.parametrize("case", sorted(CASES))
def test_sweep_matches_the_reference(case, built):
    knobs, grid = CASES[case]
    ref, port = _sweep_both(built, knobs, grid)
    G, iters = len(grid), knobs.get("num_iters", BASE["num_iters"])
    assert len(port) == G
    assert set(port.history) == set(ref.history)
    for k in ("comms", "bits"):
        assert tuple(port.history[k].shape) == (G, iters)
        np.testing.assert_array_equal(_np(port.history[k]),
                                      np.asarray(ref.history[k]),
                                      err_msg=f"{case}:{k}")
    cg = knobs.get("primal") == "cg"
    checked = 0
    for g, cell in enumerate(grid):
        tol = _theta_tol(cell, knobs)
        if tol is None:
            continue
        checked += 1
        mse_p = _np(port.history["train_mse"][g])
        mse_r = np.asarray(ref.history["train_mse"][g])
        if cg:
            np.testing.assert_allclose(mse_p, mse_r, rtol=CG_TOL)
        else:
            np.testing.assert_allclose(mse_p, mse_r, atol=MSE_TOL, rtol=0)
        np.testing.assert_allclose(_np(port.thetas[g]),
                                   np.asarray(ref.thetas[g]), atol=tol,
                                   rtol=0, err_msg=f"{case}:{g}")
    assert checked, case
    np.testing.assert_allclose(_np(port.censors), np.asarray(ref.censors))


def test_coarse_quantizer_comms_and_bits_match_the_reference(built):
    """2-bit cells (one level each side): a rounding flip there moves the
    trajectory by a whole level, and fits of the two packages, or the
    reference's own sweep against its fits, part by far more than an lsb;
    as the reference's tests/test_comm.py holds its stochastic cells, the
    comms and bits histories stay exactly equal."""
    ref, port = _sweep_both(built, {}, [(0.3, 0.97, 2.0), (0.05, 0.9, 2.0),
                                        (0.05, 0.9, INF)])
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(_np(port.history[k]),
                                      np.asarray(ref.history[k]))


@pytest.mark.parametrize("case", ["pairs", "triples-inf", "drop"])
def test_evaluate_and_select_match_the_reference(case, built):
    jb, _, rff = built
    ref, port = _sweep_both(built, *CASES[case])
    for x, y in ((jb.x_test, jb.y_test),
                 (np.asarray(jb.x_test).reshape(-1, 5),
                  np.asarray(jb.y_test).reshape(-1))):
        ev_r = ref.evaluate(x, y, rff_params=jb.rff_params)
        ev_p = port.evaluate(np.asarray(x), np.asarray(y), rff_params=rff)
        assert set(ev_p) == set(ev_r)
        exact = [g for g, c in enumerate(CASES[case][1])
                 if _theta_tol(c, {}) is not None]
        np.testing.assert_allclose(_np(ev_p["test_mse"])[exact],
                                   np.asarray(ev_r["test_mse"])[exact],
                                   atol=MSE_TOL, rtol=0)
        for k in ("comms", "bits"):
            np.testing.assert_array_equal(_np(ev_p[k]), np.asarray(ev_r[k]))
        for gap in (0.01, 10.0):
            i_r, _ = ref.select(x, y, max_mse_gap=gap,
                                rff_params=jb.rff_params)
            i_p, m = port.select(np.asarray(x), np.asarray(y),
                                 max_mse_gap=gap, rff_params=rff)
            assert i_p == i_r, (case, gap)
            assert torch.equal(m.thetas, port.thetas[i_p])


def test_config_list_sweep_matches_the_reference(built):
    jb, tp, _ = built
    cells = [(0.3, 0.97), (0.05, 0.9), (0.5, 0.99)]
    ref = jax_sweep([JFitConfig(krr=JKRRConfig(**KRR), graph="ring",
                                num_iters=40, censor_v=v, censor_mu=mu)
                     for v, mu in cells], problem=jb.problem)
    port = sweep([FitConfig(krr=KRRConfig(**KRR), graph="ring",
                            num_iters=40, censor_v=v, censor_mu=mu)
                  for v, mu in cells], problem=tp, device="cpu")
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(_np(port.history[k]),
                                      np.asarray(ref.history[k]))
    np.testing.assert_allclose(_np(port.thetas), np.asarray(ref.thetas),
                               atol=TOL, rtol=0)
    assert port.cell_config(1).comm == Chain((Censor(0.05, 0.9),))


@pytest.mark.parametrize("case", ["pairs", "triples-inf", "full-chain",
                                  "cg", "topology", "dkla"])
def test_lanes_equal_individual_port_fits(case, built, monkeypatch):
    """The port's own contract: lane g of a sweep is the fit of cell g:
    comms and bits exactly, every draw bitwise (lane g of each batched
    draw is the fit's draw), theta within the sweep tolerance."""
    _, tp, _ = built
    knobs, grid = CASES[case]
    draws = []
    real = prng.uniform

    def recording(key, shape, device="cpu"):
        u = real(key, shape, device)
        draws.append(u)
        return u

    monkeypatch.setattr(prng, "uniform", recording)
    sw = sweep(FitConfig(krr=KRRConfig(**KRR), **_knobs("port", knobs)),
               _cells("port", grid), problem=tp, device="cpu")
    lane_draws, draws[:] = list(draws), []
    for g, cell in enumerate(grid):
        res = fit(sw.cell_config(g), problem=tp, device="cpu")
        for k in ("comms", "bits"):
            np.testing.assert_array_equal(_np(sw.history[k][g]),
                                          _np(res.history[k]),
                                          err_msg=f"{case}:{g}:{k}")
        fit_draws, draws[:] = list(draws), []
        # per draw shape (a Quantize's (N, D), a Drop's (N,)) the fit's
        # draws in order are lane g of the sweep's; a fit at bits=inf
        # draws nothing for its Quantize, where the lanes still draw
        for shape in {tuple(u.shape) for u in fit_draws}:
            mine = [u for u in fit_draws if tuple(u.shape) == shape]
            lane = [u[g] for u in lane_draws if tuple(u.shape[1:]) == shape]
            assert len(mine) == len(lane), (case, g, shape)
            for a, b in zip(mine, lane):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        tol = _theta_tol(cell, knobs)
        if tol is not None:
            np.testing.assert_allclose(_np(sw.thetas[g]), _np(res.theta),
                                       atol=tol, rtol=0)


def test_lane_sweep_runs_one_iteration_per_step(built, monkeypatch):
    """One solver step per grid iteration, whatever G: the lanes are one
    batch, not G fits in turn."""
    _, tp, _ = built
    from repro_torch.api import solvers

    steps = []
    real = solvers.COKESolver.step

    def counting(self, *a, **k):
        steps.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(solvers.COKESolver, "step", counting)
    sweep(FitConfig(krr=KRRConfig(**KRR), **BASE),
          [(0.3, 0.97), (0.1, 0.9), (0.05, 0.8), (0.5, 0.99)],
          problem=tp, device="cpu")
    assert len(steps) == BASE["num_iters"]


@pytest.mark.parametrize("shape", [(5,), (3, 7), (2, 3, 4)])
def test_lane_keys_draw_what_single_keys_draw(shape):
    keys = [prng.fold_in(prng.PRNGKey(s), 2**31 + 7 * s) for s in range(6)]
    batched = torch.tensor(keys, dtype=torch.int64)
    bits = prng.random_bits(batched, shape)
    u = prng.uniform(batched, shape)
    assert tuple(u.shape) == (6,) + shape
    for g, key in enumerate(keys):
        assert torch.equal(bits[g], prng.random_bits(key, shape))
        assert torch.equal(u[g].view(torch.int32),
                           prng.uniform(key, shape).view(torch.int32))


def test_fold_in_lanes_equals_fold_in():
    keys = np.array([prng.fold_in(prng.PRNGKey(s), s + 1)
                     for s in range(5)], dtype=np.int64)
    data = np.array([0, 1, 2**32 - 1, 12345])
    out = prng.fold_in_lanes(keys[None], data[:, None])
    assert out.shape == (4, 5, 2)
    for b, d in enumerate(data):
        for g in range(5):
            assert tuple(out[b, g]) == prng.fold_in(tuple(keys[g]), int(d))
    with pytest.raises(OverflowError):
        prng.fold_in_lanes(keys, 2**32)


def test_lane_chain_round_equals_each_cell_round():
    """LaneChain.apply against each cell's Chain.apply over rounds that
    cross two host blocks of thresholds and keys: every output bitwise."""
    cells = [Chain([Censor(0.5, 0.97), Quantize(4.0), Drop(0.2)]),
             Chain([Censor(0.1, 0.9), Quantize(INF), Drop(0.0)]),
             Chain([Censor(0.5, 0.97), Quantize(4.0), Drop(0.2)]),
             Chain([Censor(0.0, 0.9), Quantize(2.0), Drop(0.5)])]
    lanes = comm_mod.stack_policies(cells)
    G, N, D = len(cells), 5, 12
    rng = np.random.default_rng(0)
    state = lanes.init_state(N)
    states = [c.init_state(N) for c in cells]
    assert np.array_equal(state.key, [c.chain_key() for c in cells])
    prev = torch.zeros(G, N, D)
    for k in range(1, comm_mod.LANE_BLOCK + 40):
        theta = torch.tensor(rng.normal(size=(G, N, D)) * 0.1,
                             dtype=torch.float32)
        hat, send, state = lanes.apply(theta, prev, k, state)
        for g, c in enumerate(cells):
            h1, s1, states[g] = c.apply(theta[g], prev[g], k, states[g])
            assert torch.equal(h1, hat[g]), (k, g)
            assert torch.equal(s1, send[g]), (k, g)
            assert torch.equal(states[g].bits, state.bits[g]), (k, g)
        prev = hat


def test_dkla_lanes_zero_every_threshold_once():
    lanes = comm_mod.stack_policies([(Censor(0.5, 0.9),),
                                     (Censor(0.2, 0.8),)])
    dkla = comm_mod.uncensored(lanes)
    assert dkla is comm_mod.uncensored(lanes)
    assert isinstance(dkla, comm_mod.LaneChain)
    np.testing.assert_array_equal(dkla.stages[0].v, [0.0, 0.0])
    np.testing.assert_array_equal(dkla.chain_key(), [
        comm_mod.uncensored(Chain((Censor(v, mu),))).chain_key()
        for v, mu in ((0.5, 0.9), (0.2, 0.8))])


def test_sweep_cells_draw_independent_drop_randomness():
    """The reference's tests/test_comm.py contract: distinct cells draw
    independent link drops."""
    theta = torch.ones((1, 256, 4)).expand(2, 256, 4)
    hat = torch.zeros((2, 256, 4))
    lanes = comm_mod.stack_policies([Chain([Drop(p=0.3)]),
                                     Chain([Drop(p=0.6)])])
    out, _, _ = lanes.apply(theta, hat, 1, lanes.init_state(256))
    a, b = _np(torch.all(out == 1.0, dim=-1))
    assert (a & ~b).sum() > 0
    assert (~a & b).sum() > 0


def test_sweep_cells_draw_independent_quantize_randomness():
    """Cells differing only in the censor threshold get their own rounding
    stream; identical cells stay identical."""
    gen = torch.Generator().manual_seed(3)
    theta = torch.randn((8, 64), generator=gen)
    cells = [Chain([Censor(0.5, 0.97), Quantize(4.0)]),
             Chain([Censor(0.6, 0.97), Quantize(4.0)]),
             Chain([Censor(0.5, 0.97), Quantize(4.0)])]
    lanes = comm_mod.stack_policies(cells)
    out, _, _ = lanes.apply(theta.expand(3, 8, 64), torch.zeros(3, 8, 64),
                            1, lanes.init_state(8))
    assert not torch.equal(out[0], out[1])
    assert torch.equal(out[0], out[2])


def _reference_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["mixed-structures", "static-seed",
                                  "numeric-length", "not-a-cell", "no-grid",
                                  "grid-and-list", "empty", "config-list",
                                  "spmd", "streaming"])
def test_sweep_value_errors_are_the_reference_words(case, built):
    jb, tp, _ = built

    def call(side):
        F, K = (JFitConfig, JKRRConfig) if side == "ref" else (FitConfig,
                                                               KRRConfig)
        run = jax_sweep if side == "ref" else sweep
        kw = {} if side == "ref" else dict(device="cpu")
        prob = jb.problem if side == "ref" else tp
        base = F(krr=K(**KRR), **BASE)
        q = JQuantize if side == "ref" else Quantize
        ch = JChain if side == "ref" else Chain
        if case == "mixed-structures":
            return run(base, ((0.5, 0.97), (0.5, 0.97, 4.0)), problem=prob,
                       **kw)
        if case == "static-seed":
            return run(base, [ch([q(4.0, seed=1)]), ch([q(4.0, seed=2)])],
                       problem=prob, **kw)
        if case == "numeric-length":
            return run(base, [(0.5, 0.97, 4.0, 1.0)], problem=prob, **kw)
        if case == "not-a-cell":
            return run(base, [3.0], problem=prob, **kw)
        if case == "no-grid":
            return run(base, problem=prob, **kw)
        if case == "grid-and-list":
            return run([base], [(0.5, 0.9)], problem=prob, **kw)
        if case == "empty":
            return run(base, (), problem=prob, **kw)
        if case == "config-list":
            return run([base, base.replace(num_iters=10)], problem=prob,
                       **kw)
        if case == "spmd":
            return run(base.replace(backend="spmd"), [(0.5, 0.9)],
                       problem=prob, **kw)
        return run(base.replace(algorithm="online_coke"), [(0.5, 0.9)],
                   problem=prob, **kw)

    if case == "spmd":
        # the reference's sweep raises its own spelling of this rule before
        # it consults its table; the port consults the table first, so its
        # text is the table's (tests/test_torch_capabilities.py)
        config = JFitConfig(krr=JKRRConfig(**KRR),
                            **dict(BASE, backend="spmd"))
        ref = _reference_error(lambda: jcap.check_sweep(
            config, jax_get_solver("coke")))
    else:
        ref = _reference_error(lambda: call("ref"))
    assert _reference_error(lambda: call("port")) == ref


def test_sweep_admits_before_it_resolves_the_device():
    """No device given: a config the table rejects raises its ValueError
    on any machine; an admitted one needs a card."""
    with pytest.raises(ValueError, match="simulator"):
        sweep(FitConfig(krr=KRRConfig(**KRR), **dict(BASE, backend="spmd")),
              [(0.5, 0.9)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sweep(FitConfig(krr=KRRConfig(**KRR), **BASE), [(0.5, 0.9)])


def test_evaluate_featurizes_once(built, monkeypatch):
    """One featurization per evaluate, whatever G: the fused backend runs
    K1 once for the whole grid."""
    jb, _, rff = built
    _, port = _sweep_both(built, *CASES["pairs"])
    calls = []
    real = model_mod.featurize_fused

    def counting(params, x):
        calls.append(tuple(x.shape))
        return real(params, x)

    monkeypatch.setattr(model_mod, "featurize_fused", counting)
    ev_f = port.evaluate(np.asarray(jb.x_test), np.asarray(jb.y_test),
                         backend="fused", rff_params=rff)
    ev_r = port.evaluate(np.asarray(jb.x_test), np.asarray(jb.y_test),
                         rff_params=rff)
    assert len(calls) == 1
    np.testing.assert_allclose(_np(ev_f["test_mse"]), _np(ev_r["test_mse"]),
                               atol=MSE_TOL, rtol=0)


def test_select_ranks_bits_then_comms_then_index(built):
    jb, tp, rff = built
    x, y = np.asarray(jb.x_test), np.asarray(jb.y_test)
    grid = ((0.5, 0.97, INF), (0.5, 0.97, 4.0), (0.5, 0.97, 4.0),
            (0.5, 0.97, 4.0))
    sw = sweep(FitConfig(krr=KRRConfig(**KRR), **BASE), grid, problem=tp,
               device="cpu")
    # three identical 4-bit cells tie on bits and comms: the first wins
    assert sw.select(x, y, max_mse_gap=10.0, rff_params=rff)[0] == 1
    G, T = sw.history["bits"].shape
    tied = dataclasses.replace(sw, history=dict(
        sw.history, bits=torch.ones((G, T)), comms=torch.ones(
            (G, T), dtype=torch.int32)))
    assert tied.select(x, y, max_mse_gap=100.0, rff_params=rff)[0] == 0
    no_bits = dataclasses.replace(sw, history={
        k: v for k, v in sw.history.items() if k != "bits"})
    ev = no_bits.evaluate(x, y, rff_params=rff)
    assert "bits" not in ev
    comms = _np(ev["comms"])
    idx, _ = no_bits.select(x, y, max_mse_gap=10.0, rff_params=rff)
    assert idx == int(np.flatnonzero(comms == comms.min())[0])


def test_select_raises_when_no_cell_qualifies(built):
    jb, tp, rff = built
    sw = sweep(FitConfig(krr=KRRConfig(**KRR), **BASE), [(0.5, 0.9)],
               problem=tp, device="cpu")
    broken = dataclasses.replace(sw, thetas=torch.full_like(sw.thetas,
                                                            float("nan")))
    with pytest.raises(ValueError, match="no sweep cell qualifies"):
        broken.select(np.asarray(jb.x_test), np.asarray(jb.y_test),
                      rff_params=rff)


def test_models_export_every_cell():
    """A sweep that builds its own problem exports models with its RFF
    map; cell_config round-trips the cell's policy."""
    cells = [Chain([Censor(0.5, 0.97), Quantize(4.0)]),
             Chain([Censor(0.1, 0.99), Quantize(8.0)])]
    sw = sweep(FitConfig(krr=KRRConfig(**dict(KRR, num_agents=3)),
                         **dict(BASE, num_iters=5)), cells, device="cpu")
    models = sw.models()
    assert len(models) == 2
    for i, m in enumerate(models):
        assert torch.equal(m.thetas, sw.thetas[i])
        assert sw.cell_config(i).comm == cells[i]
        assert m.meta["comm"] == cells[i].describe()


def test_phased_runner_hands_carries_across_phase_boundaries():
    """A two-phase plan driven in chunks that end before, on and after the
    boundary: histories concatenate and the enter transform runs once."""
    def make_runner(tag):
        def chunk_fn(carry, n):
            vals = torch.arange(carry, carry + n)
            return carry + n, {"k": vals, "phase": torch.full((n,), tag)}
        return 0, chunk_fn, lambda c: c

    entered = []

    def enter(carry):
        entered.append(carry)
        return carry + 100

    plan = ((1, 5, None), (2, 4, enter))
    carry0, chunk_fn, _ = fit_mod._phased_runner(make_runner, plan)
    carry, hist = fit_mod._chunked_scan(chunk_fn, carry0, 9, 3, None)
    assert entered == [5]
    assert hist["phase"].tolist() == [1] * 5 + [2] * 4
    assert hist["k"].tolist() == [0, 1, 2, 3, 4, 105, 106, 107, 108]
    assert carry == 109
    ctx = fit_mod.SolveContext(comm=Chain(()))
    one = fit_mod.phase_plan(ctx, 7, None)
    assert one == ((ctx, 7, None),)
