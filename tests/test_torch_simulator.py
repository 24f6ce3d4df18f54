"""The port's simulator backend and exact primals against the JAX reference,
on the CPU.

Both packages get the same inputs: numpy arrays made from a seed, or the
reference's problem carried across with `repro_torch.convert` (the two
packages' RFF draws differ at the same seed). The port runs with
device="cpu".

Tolerances (the reference's own, `tests/test_big_d.py` and
`tests/test_fused_megakernel.py`): comms and bits are integer-valued and
exact everywhere; the Cholesky and gradient primals' theta and
trajectories within 1e-5; the CG primal's theta within 1e-4 and its
train MSE within rtol 1e-4 (64 CG steps in another summation order drift
further than one triangular solve); CG across backends within 2e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FitConfig as JFitConfig
from repro.api import KRRConfig as JKRRConfig
from repro.api import build_problem as jax_build_problem
from repro.api import fit as jax_fit
from repro.core import admm as jax_admm
from repro.core import cta as jax_cta
from repro.core import graph as jax_graph
from repro.core import ridge as jax_ridge
from repro.core.admm import make_problem as jax_make_problem
from repro.core.censor import CensorSchedule as JCensorSchedule
from repro.distributed import consensus as jax_cns
from repro.optim import optimizers as jax_opt

from repro_torch import convert
from repro_torch.api import FitConfig, KRRConfig, fit, get_solver
from repro_torch.api import backends as port_backends
from repro_torch.api.registry import Solver, list_solvers
from repro_torch.core import admm as port_admm
from repro_torch.core import cta as port_cta
from repro_torch.core import graph as port_graph
from repro_torch.core import ridge as port_ridge
from repro_torch.core.censor import CensorSchedule
from repro_torch.distributed import consensus as port_cns
from repro_torch.kernels.coke_update import coke_update as port_cu
from repro_torch.kernels.coke_update import ops as port_ops
from repro_torch.optim import optimizers as port_opt

torch.set_num_threads(2)

TOL = 1e-5          # Cholesky and gradient primals: theta, trajectories
CG_TOL = 1e-4       # CG primal: theta; train MSE relative
CG_BACKEND_TOL = 2e-4   # CG across backends (tests/test_big_d.py)

KRR = dict(num_agents=4, samples_per_agent=40, num_features=32, lam=1e-2,
           rho=0.1, seed=0)
BASE = dict(graph="ring", algorithm="coke", censor_v=0.3, censor_mu=0.97,
            num_iters=40, backend="simulator")
# tests/test_big_d.py's RING problem: N=4, T=28 train rows, D=512
RING_KRR = dict(KRR, num_features=512)
# a censor threshold under which COKE sends some but not all broadcasts on
# the logistic loss at this size
CLS = dict(censor_v=0.03, censor_mu=0.8, num_iters=20)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _carry(jprob, loss=None):
    return convert.problem_from_numpy(
        np.asarray(jprob.feats), np.asarray(jprob.labels),
        np.asarray(jprob.adjacency), jprob.lam, jprob.rho,
        loss=loss or jprob.loss, device="cpu")


def _fit_both(jprob, tprob, krr=KRR, **kw):
    ref = jax_fit(JFitConfig(krr=JKRRConfig(**krr), **kw), problem=jprob)
    port = fit(FitConfig(krr=KRRConfig(**krr), **kw), problem=tprob,
               device="cpu")
    return ref, port


def _assert_match(ref, port, err, tol=TOL, mse_rtol=None):
    """comms and bits exact; theta within `tol`; train_mse and
    consensus_gap within `tol` (or train_mse within `mse_rtol`)."""
    assert set(port.history) == set(ref.history), err
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(_np(port.history[k]),
                                      np.asarray(ref.history[k]),
                                      err_msg=f"{err}:{k}")
    if mse_rtol is None:
        for k in ("train_mse", "consensus_gap"):
            np.testing.assert_allclose(_np(port.history[k]),
                                       np.asarray(ref.history[k]),
                                       rtol=tol, atol=tol,
                                       err_msg=f"{err}:{k}")
    else:
        np.testing.assert_allclose(_np(port.history["train_mse"]),
                                   np.asarray(ref.history["train_mse"]),
                                   rtol=mse_rtol, err_msg=f"{err}:train_mse")
    np.testing.assert_allclose(_np(port.theta), np.asarray(ref.theta),
                               atol=tol, rtol=0, err_msg=f"{err}:theta")


@pytest.fixture(scope="module")
def small():
    """(reference problem, port problem) on a 4-agent ring, D=32."""
    jprob = jax_build_problem(JFitConfig(krr=JKRRConfig(**KRR),
                                         **BASE)).problem
    return jprob, _carry(jprob)


@pytest.fixture(scope="module")
def ring512():
    jprob = jax_build_problem(JFitConfig(krr=JKRRConfig(**RING_KRR),
                                         **BASE)).problem
    return jprob, _carry(jprob)


@pytest.fixture(scope="module")
def logistic(small):
    jprob = small[0]
    y = np.asarray(jprob.labels)
    lab = np.where(y > np.median(y), 1.0, -1.0).astype(np.float32)
    jlog = jax_make_problem(jprob.feats, jnp.asarray(lab),
                            jax_graph.ring(4), jprob.lam, jprob.rho,
                            loss="logistic")
    return jlog, _carry(jlog)


def _arrays(seed, n=3, t=30, d=16):
    """Seeded numpy inputs for one primal call: (phi, y, adjacency,
    gamma, theta_ref, nbr_sum, theta0)."""
    rng = np.random.default_rng(seed)
    phi = (0.3 * rng.standard_normal((n, t, d))).astype(np.float32)
    y = rng.standard_normal((n, t)).astype(np.float32)
    adj = np.asarray(jax_graph.ring(n).adjacency, np.float32) if n > 2 \
        else np.ones((n, n), np.float32) - np.eye(n, dtype=np.float32)
    vecs = [(0.1 * rng.standard_normal((n, d))).astype(np.float32)
            for _ in range(4)]
    return (phi, y, adj, *vecs)


def _both_problems(phi, y, adj, lam=1e-2, rho=0.1, loss="quadratic"):
    jprob = jax_admm.Problem(jnp.asarray(phi), jnp.asarray(y),
                             jnp.asarray(adj), lam, rho, loss)
    tprob = convert.problem_from_numpy(phi, y, adj, lam, rho, loss=loss,
                                       device="cpu")
    return jprob, tprob


# ---------------------------------------------------------------------------
# the simulator fit, every solver and primal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("primal", ["cholesky", "cg", "gradient"])
@pytest.mark.parametrize("alg", ["coke", "dkla"])
def test_simulator_fit_matches_reference(alg, primal, small):
    """40 iterations on the quadratic loss (the gradient primal at its
    default 50 inner steps)."""
    ref, port = _fit_both(*small, **dict(BASE, algorithm=alg,
                                         primal=primal))
    if primal == "cg":
        _assert_match(ref, port, f"{alg}:{primal}", tol=CG_TOL,
                      mse_rtol=CG_TOL)
    else:
        _assert_match(ref, port, f"{alg}:{primal}")
    comms = _np(port.comms)
    if alg == "coke":
        assert 0 < comms[-1] < 4 * 40
    else:
        assert comms[-1] == 4 * 40


@pytest.mark.parametrize("alg", ["coke", "dkla"])
def test_simulator_logistic_gradient_primal_matches_reference(alg,
                                                              logistic):
    """primal="auto" resolves to the gradient primal on the logistic loss;
    5 inner steps, 20 iterations."""
    ref, port = _fit_both(*logistic, **dict(BASE, algorithm=alg,
                                            inner_steps=5, **CLS))
    _assert_match(ref, port, f"logistic:{alg}")
    comms = _np(port.comms)
    assert (0 < comms[-1] < 4 * 20) if alg == "coke" else comms[-1] == 80


def test_simulator_cta_matches_reference(small):
    kw = dict(BASE, algorithm="cta", censor_v=None, censor_mu=None)
    ref, port = _fit_both(*small, **kw)
    _assert_match(ref, port, "cta")
    np.testing.assert_array_equal(_np(port.bits),
                                  _np(port.comms).astype(np.float32) * 32 * 32)


def test_ridge_oracle_matches_reference(small):
    """The oracle is one fp32 solve of a system whose fp32 error is itself
    ~1e-5: the reference is 9.7e-6 from the float64 solve here. Both are
    held within 2e-5 of that solve and of each other."""
    kw = dict(BASE, algorithm="ridge_oracle", censor_v=None,
              censor_mu=None, num_iters=2)
    ref, port = _fit_both(*small, **kw)
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(_np(port.history[k]),
                                      np.asarray(ref.history[k]))
    assert _np(port.comms).tolist() == [0, 0]
    np.testing.assert_allclose(_np(port.train_mse), np.asarray(ref.train_mse),
                               rtol=1e-4)
    phi = np.asarray(small[0].feats, np.float64)
    y = np.asarray(small[0].labels, np.float64)
    n, t, d = phi.shape
    a, b = phi.reshape(-1, d), y.reshape(-1)
    exact = np.linalg.solve(a.T @ a / t + small[0].lam * np.eye(d),
                            a.T @ b / t)
    for theta in (_np(port.theta), np.asarray(ref.theta)):
        np.testing.assert_allclose(theta, np.broadcast_to(exact, (n, d)),
                                   atol=2e-5)
    np.testing.assert_allclose(_np(port.theta), np.asarray(ref.theta),
                               atol=2e-5)


@pytest.mark.parametrize("alg", ["coke", "dkla"])
def test_default_config_on_the_erdos_renyi_graph_matches_reference(alg):
    """`fit(FitConfig(...))` at the paper's defaults (N=20 on an
    Erdos-Renyi p=0.3 graph, L=100, primal="auto" -> Cholesky, v=1,
    mu=0.95, lam=5e-5), reduced: 50 samples per agent (35 train rows)
    instead of 500 and 100 iterations instead of 1000.

    At lam=5e-5 the fp32 (21a) systems leave each fp32 implementation
    ~1e-5 from the float64 trajectory (the reference's DKLA 1.02e-5 here),
    so two of them differ by up to twice that: theta is held within 2e-5
    of the reference, and the port's distance from the float64 run
    (the port on float64 inputs) to at most 1.5x the reference's own.
    comms and bits exact; train MSE within 1e-5."""
    krr = dict(samples_per_agent=50)
    jb = jax_build_problem(JFitConfig(krr=JKRRConfig(**krr)))
    tprob = _carry(jb.problem)
    ref = jax_fit(JFitConfig(krr=JKRRConfig(**krr), algorithm=alg,
                             num_iters=100), problem=jb.problem)
    cfg = FitConfig(krr=KRRConfig(**krr), algorithm=alg, num_iters=100)
    port = fit(cfg, problem=tprob, device="cpu")
    assert not np.array_equal(_np(tprob.adjacency),
                              _np(port_graph.ring(20).adjacency))
    _assert_match(ref, port, f"default:{alg}", tol=2e-5)
    np.testing.assert_allclose(_np(port.train_mse),
                               np.asarray(ref.train_mse), rtol=TOL, atol=TOL)
    f64 = fit(cfg, problem=dataclasses.replace(
        tprob, feats=tprob.feats.double(), labels=tprob.labels.double(),
        adjacency=tprob.adjacency.double()), device="cpu")
    np.testing.assert_array_equal(_np(f64.comms), _np(port.comms))
    exact = _np(f64.theta)
    ref_err = np.abs(np.asarray(ref.theta) - exact).max()
    assert np.abs(_np(port.theta) - exact).max() <= 1.5 * ref_err


@pytest.fixture(scope="module")
def paper_fits():
    """{alg: (reference fit, port fit, port fit on float64 inputs)} at the
    paper's own call, `fit(FitConfig(algorithm=alg))`, unreduced: N=20 on
    the Erdos-Renyi graph, 350 train rows per agent, L=100, Cholesky, 1000
    iterations; the reference's problem carried across."""
    jprob = jax_build_problem(JFitConfig()).problem
    tprob = _carry(jprob)
    t64 = dataclasses.replace(tprob, feats=tprob.feats.double(),
                              labels=tprob.labels.double(),
                              adjacency=tprob.adjacency.double())
    return {alg: (jax_fit(JFitConfig(algorithm=alg), problem=jprob),
                  fit(FitConfig(algorithm=alg), problem=tprob, device="cpu"),
                  fit(FitConfig(algorithm=alg), problem=t64, device="cpu"))
            for alg in ("coke", "dkla")}


@pytest.mark.parametrize("alg", ["coke", "dkla"])
def test_paper_default_fit_matches_reference_to_fp32_resolution(
        alg, paper_fits):
    """Over 1000 iterations at lam=5e-5 the fp32 rounding of either package
    carries theta ~2e-4 from the float64 trajectory (the reference's DKLA
    2.68e-4, COKE 2.48e-4), so two fp32 runs agree to ~4e-4, not 1e-5.
    Held: all 20 000 send decisions (comms, bits) exact; the train MSE
    within rtol 1e-4; the port's theta no further from the float64 run
    than the reference's is."""
    ref, port, f64 = paper_fits[alg]
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(_np(port.history[k]),
                                      np.asarray(ref.history[k]))
    np.testing.assert_array_equal(_np(f64.comms), _np(port.comms))
    np.testing.assert_allclose(_np(port.train_mse), np.asarray(ref.train_mse),
                               rtol=1e-4)
    exact = _np(f64.theta)
    ref_err = np.abs(np.asarray(ref.theta) - exact).max()
    port_err = np.abs(_np(port.theta) - exact).max()
    assert port_err <= ref_err, (port_err, ref_err)
    np.testing.assert_allclose(_np(port.theta), np.asarray(ref.theta),
                               atol=2 * ref_err)


def test_paper_default_coke_saves_broadcasts_like_the_reference(paper_fits):
    """COKE sends fewer broadcasts than DKLA's 20 000. At 1000 iterations
    neither has converged (lam=5e-5), and COKE's final train MSE is 2.8 %
    above DKLA's in the reference; the port gives the same ratio to 1e-4."""
    ratio = {}
    for i, pkg in enumerate(("reference", "port")):
        coke, dkla = (paper_fits[a][i] for a in ("coke", "dkla"))
        assert int(coke.comms[-1]) < int(dkla.comms[-1]) == 20000
        ratio[pkg] = float(coke.train_mse[-1]) / float(dkla.train_mse[-1])
    assert 1.0 < ratio["reference"] < 1.05
    np.testing.assert_allclose(ratio["port"], ratio["reference"], rtol=1e-4)


def test_simulator_oracle_distance_matches_reference(small):
    kw = dict(BASE, record_oracle_distance=True, num_iters=10)
    ref, port = _fit_both(*small, **kw)
    np.testing.assert_allclose(_np(port.history["dist_to_oracle"]),
                               np.asarray(ref.history["dist_to_oracle"]),
                               rtol=1e-4)
    d = _np(port.history["dist_to_oracle"])
    assert d[-1] < d[0]


def test_simulator_chunked_fit_matches_monolithic(small):
    seen = []
    cfg = FitConfig(krr=KRRConfig(**KRR), **dict(BASE, chunk_size=15))
    whole = fit(cfg.replace(chunk_size=None), problem=small[1], device="cpu")
    res = fit(cfg, problem=small[1], device="cpu",
              progress_cb=lambda n, m: seen.append(n))
    for k in whole.history:
        torch.testing.assert_close(res.history[k], whole.history[k],
                                   rtol=0, atol=0)
    assert seen == [15, 30, 40]


@pytest.mark.parametrize("alg", ["coke", "cta", "ridge_oracle"])
def test_simulator_zero_iterations_gives_empty_histories(alg, small):
    kw = dict(BASE, algorithm=alg, num_iters=0)
    if alg != "coke":
        kw.update(censor_v=None, censor_mu=None)
    ref, port = _fit_both(*small, **kw)
    assert set(port.history) == set(ref.history)
    for k, v in port.history.items():
        assert v.shape == (0,)
        assert str(v.dtype).split(".")[-1] == str(ref.history[k].dtype)
    assert float(port.theta.abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# the pieces: primals, coke_step, cta_step, ridge, graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("maxiter", [3, 64])
def test_primal_cg_is_the_vmapped_jax_cg_with_a_converged_agent(maxiter):
    """`_primal_cg` against the reference's (jax.scipy.sparse.linalg.cg
    under jax.vmap) on one batch where agent 0 starts converged (b = 0 and
    x0 = 0, so r0 = 0): its row stays bitwise x0, no NaN appears (its
    alpha would be 0/0), and the others follow the reference within 1e-4
    after 3 steps and after the full 64."""
    phi, y, adj, gamma, t_ref, nbr, theta0 = _arrays(0, n=3)
    y[0] = 0.0
    for v in (gamma, t_ref, nbr, theta0):
        v[0] = 0.0
    jprob, tprob = _both_problems(phi, y, adj)
    want = np.asarray(jax_admm._primal_cg(
        jprob, jnp.asarray(gamma), jnp.asarray(t_ref), jnp.asarray(nbr),
        theta0=jnp.asarray(theta0), maxiter=maxiter))
    got = _np(port_admm._primal_cg(
        tprob, torch.tensor(gamma), torch.tensor(t_ref), torch.tensor(nbr),
        theta0=torch.tensor(theta0), maxiter=maxiter))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_array_equal(got[0], theta0[0])
    np.testing.assert_array_equal(want[0], theta0[0])
    np.testing.assert_allclose(got, want, atol=CG_TOL, rtol=0)


def test_primal_cg_hoisted_terms_give_the_per_call_values():
    phi, y, adj, gamma, t_ref, nbr, theta0 = _arrays(1)
    _, tprob = _both_problems(phi, y, adj)
    args = [torch.tensor(a) for a in (gamma, t_ref, nbr)]
    a = port_admm._primal_cg(tprob, *args, theta0=torch.tensor(theta0))
    b = port_admm._primal_cg(tprob, *args, theta0=torch.tensor(theta0),
                             terms=port_admm.primal_terms(tprob))
    assert torch.equal(a, b)


def test_ridge_factors_and_closed_form_match_reference():
    phi, y, adj, gamma, t_ref, nbr, _ = _arrays(2)
    jprob, tprob = _both_problems(phi, y, adj)
    jchol = jax_admm._ridge_factors(jprob)
    chol = port_admm._ridge_factors(tprob)
    np.testing.assert_allclose(_np(chol), np.asarray(jchol), atol=1e-6)
    want = jax_admm._primal_closed_form(jprob, jchol, jnp.asarray(gamma),
                                        jnp.asarray(t_ref), jnp.asarray(nbr))
    got = port_admm._primal_closed_form(tprob, chol, torch.tensor(gamma),
                                        torch.tensor(t_ref),
                                        torch.tensor(nbr))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL)
    # the solve satisfies (21a): A theta = rhs
    n, t, d = phi.shape
    deg = adj.sum(1)
    for i in range(n):
        a = (2 / t) * phi[i].T.astype(np.float64) @ phi[i] + (
            2 * 1e-2 / n + 2 * 0.1 * deg[i]) * np.eye(d)
        rhs = (2 / t) * phi[i].T @ y[i] - gamma[i] + 0.1 * (
            deg[i] * t_ref[i] + nbr[i])
        np.testing.assert_allclose(a @ _np(got)[i], rhs, atol=1e-5)


def test_primal_gradient_matches_reference():
    phi, y, adj, gamma, t_ref, nbr, theta0 = _arrays(3)
    for loss in ("quadratic", "logistic"):
        yy = y if loss == "quadratic" else np.sign(y).astype(np.float32)
        jprob, tprob = _both_problems(phi, yy, adj, loss=loss)
        want = jax_admm._primal_gradient(
            jprob, 7, 0.1, jnp.asarray(theta0), jnp.asarray(gamma),
            jnp.asarray(t_ref), jnp.asarray(nbr))
        got = port_admm._primal_gradient(
            tprob, 7, 0.1, torch.tensor(theta0), torch.tensor(gamma),
            torch.tensor(t_ref), torch.tensor(nbr))
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL,
                                   err_msg=loss)


@pytest.mark.parametrize("mode", ["auto-cholesky", "auto-gradient", "cg"])
def test_coke_step_matches_reference(mode):
    """Three iterations of `coke_step` on an Erdos-Renyi graph from the
    same state: "auto" with a factor stack runs the closed form, without
    one the gradient primal; "cg" the matrix-free solve."""
    rng = np.random.default_rng(4)
    n, t, d = 6, 20, 12
    phi = (0.3 * rng.standard_normal((n, t, d))).astype(np.float32)
    y = rng.standard_normal((n, t)).astype(np.float32)
    adj = np.asarray(jax_graph.erdos_renyi(n, 0.5, seed=2).adjacency,
                     np.float32)
    jprob, tprob = _both_problems(phi, y, adj)
    jpol, pol = JCensorSchedule(0.05, 0.9), CensorSchedule(0.05, 0.9)
    jst = jax_admm.init_state(jprob, policy=jpol)
    st = port_admm.init_state(tprob, policy=pol)
    jchol = chol = None
    if mode == "auto-cholesky":
        jchol, chol = (jax_admm._ridge_factors(jprob),
                       port_admm._ridge_factors(tprob))
    primal = "cg" if mode == "cg" else "auto"
    for _ in range(3):
        jst = jax_admm.coke_step(jprob, jpol, jst, jchol, inner_steps=10,
                                 primal=primal)
        st = port_admm.coke_step(tprob, pol, st, chol, inner_steps=10,
                                 primal=primal)
    assert st.step == int(jst.step) == 3
    assert int(st.comms) == int(jst.comms)
    np.testing.assert_array_equal(_np(st.comm.bits),
                                  np.asarray(jst.comm.bits))
    tol = CG_TOL if mode == "cg" else TOL
    for f in ("theta", "theta_hat", "gamma"):
        np.testing.assert_allclose(_np(getattr(st, f)),
                                   np.asarray(getattr(jst, f)), atol=tol,
                                   err_msg=f)


@pytest.mark.parametrize("mode", ["cholesky-stack", "gradient"])
def test_coke_step_with_a_topology_matches_reference(mode):
    """Four iterations of `coke_step` under a two-graph schedule (an
    Erdos-Renyi graph and a ring): with the (M, N, D, D) factor stack the
    step picks the active graph's factors, without it the gradient primal
    runs on the active graph."""
    rng = np.random.default_rng(5)
    n, t, d = 6, 20, 12
    phi = (0.3 * rng.standard_normal((n, t, d))).astype(np.float32)
    y = rng.standard_normal((n, t)).astype(np.float32)
    graphs = [jax_graph.erdos_renyi(n, 0.5, seed=2), jax_graph.ring(n)]
    jtopo = jax_graph.TopologySchedule.from_graphs(graphs)
    topo = convert.topology_from_reference(np.asarray(jtopo.adjacencies),
                                           device="cpu")
    jprob, tprob = _both_problems(phi, y, np.asarray(graphs[0].adjacency,
                                                     np.float32))
    jpol, pol = JCensorSchedule(0.05, 0.9), CensorSchedule(0.05, 0.9)
    jst = jax_admm.init_state(jprob, policy=jpol)
    st = port_admm.init_state(tprob, policy=pol)
    jchol = chol = None
    if mode == "cholesky-stack":
        jchol = jax.vmap(lambda a: jax_admm._ridge_factors(
            dataclasses.replace(jprob, adjacency=a)))(jtopo.adjacencies)
        chol = torch.stack([port_admm._ridge_factors(
            dataclasses.replace(tprob, adjacency=a))
            for a in topo.adjacencies])
        np.testing.assert_allclose(_np(chol), np.asarray(jchol), atol=TOL)
    for _ in range(4):
        jst = jax_admm.coke_step(jprob, jpol, jst, jchol, inner_steps=10,
                                 topology=jtopo)
        st = port_admm.coke_step(tprob, pol, st, chol, inner_steps=10,
                                 topology=topo)
    assert int(st.comms) == int(jst.comms)
    np.testing.assert_array_equal(_np(st.comm.bits),
                                  np.asarray(jst.comm.bits))
    for f in ("theta", "theta_hat", "gamma"):
        np.testing.assert_allclose(_np(getattr(st, f)),
                                   np.asarray(getattr(jst, f)), atol=TOL,
                                   err_msg=f)


def test_cta_step_matches_reference():
    phi, y, adj, *_ = _arrays(5, n=5)
    jprob, tprob = _both_problems(phi, y, adj)
    w = jax_graph.metropolis_weights(jax_graph.Graph(adjacency=adj))
    jst, st = jax_cta.init_state(jprob), port_cta.init_state(tprob)
    for _ in range(4):
        jst = jax_cta.cta_step(jprob, jnp.asarray(w, jnp.float32), 0.5, jst)
        st = port_cta.cta_step(tprob, torch.tensor(w, dtype=torch.float32),
                               0.5, st)
    assert (st.step, int(st.comms)) == (int(jst.step), int(jst.comms)) \
        == (4, 20)
    np.testing.assert_allclose(_np(st.theta), np.asarray(jst.theta),
                               atol=TOL)


@pytest.mark.parametrize("family", ["ring", "erdos_renyi", "circulant"])
def test_metropolis_weights_equal_reference(family):
    make = {"ring": lambda m: m.ring(7),
            "erdos_renyi": lambda m: m.erdos_renyi(12, 0.3, seed=4),
            "circulant": lambda m: m.circulant(9, (1, 3))}[family]
    w = port_graph.metropolis_weights(make(port_graph))
    np.testing.assert_array_equal(
        w, jax_graph.metropolis_weights(make(jax_graph)))
    np.testing.assert_allclose(w.sum(0), 1.0, atol=1e-12)
    np.testing.assert_allclose(w.sum(1), 1.0, atol=1e-12)


@pytest.mark.parametrize("family", ["ring", "erdos_renyi", "circulant"])
def test_admissible_rho_equals_reference(family):
    """The Theorem-2 bound: the same float from the same numpy algebra,
    and the reference's ValueError where no rho is admissible."""
    make = {"ring": lambda m: m.ring(8),
            "erdos_renyi": lambda m: m.erdos_renyi(12, 0.3, seed=4),
            "circulant": lambda m: m.circulant(9, (1, 3))}[family]
    for kw in (dict(m_R=0.5, M_R=2.0), dict(m_R=0.1, M_R=1.0, nu=3.0,
                                            eta1=2.0, eta2=0.5)):
        assert port_graph.admissible_rho(make(port_graph), **kw) == \
            jax_graph.admissible_rho(make(jax_graph), **kw), kw
    assert port_graph.Graph(make(jax_graph).adjacency).sigma_terms() == \
        make(jax_graph).sigma_terms()
    bad = dict(m_R=1e-9, M_R=1e3, eta3=1e6)
    with pytest.raises(ValueError) as ref_err:
        jax_graph.admissible_rho(make(jax_graph), **bad)
    with pytest.raises(ValueError) as port_err:
        port_graph.admissible_rho(make(port_graph), **bad)
    assert str(port_err.value) == str(ref_err.value)


#: tests/test_deprecations.py's configuration
LEGACY_KRR = dict(num_agents=4, samples_per_agent=30, num_features=8,
                  lam=1e-2, rho=0.5, seed=3)


@pytest.fixture(scope="module")
def legacy():
    jb = jax_build_problem(JFitConfig(krr=JKRRConfig(**LEGACY_KRR)))
    return jb, _carry(jb.problem)


def _warned(fn):
    with pytest.warns(DeprecationWarning) as rec:
        out = fn()
    return out, [str(w.message) for w in rec
                 if issubclass(w.category, DeprecationWarning)]


@pytest.mark.parametrize("schedule", ["coke", "dkla"])
def test_deprecated_admm_run_warns_and_matches_reference(schedule, legacy):
    """core.admm.run: the reference's DeprecationWarning text, then fit's
    run of the legacy loop: comms exact, theta and the trajectories
    within 1e-5 of the reference's shim, and bitwise the port's own fit."""
    jb, tprob = legacy
    jsch, tsch = ((JCensorSchedule(0.4, 0.96), CensorSchedule(0.4, 0.96))
                  if schedule == "coke" else
                  (jax_admm.dkla_schedule(), port_admm.dkla_schedule()))
    assert (tsch.v, tsch.mu) == (jsch.v, jsch.mu)
    want, jmsg = _warned(lambda: jax_admm.run(jb.problem, jsch, 25))
    got, msg = _warned(lambda: port_admm.run(tprob, tsch, 25))
    assert msg == jmsg and "repro.api.fit" in msg[0]
    np.testing.assert_array_equal(_np(got.comms), np.asarray(want.comms))
    for k in ("train_mse", "consensus_gap"):
        np.testing.assert_allclose(_np(getattr(got, k)),
                                   np.asarray(getattr(want, k)), rtol=TOL,
                                   atol=TOL, err_msg=k)
    np.testing.assert_allclose(_np(got.state.theta),
                               np.asarray(want.state.theta), atol=TOL)
    own = fit(FitConfig(krr=KRRConfig(**LEGACY_KRR), algorithm="coke",
                        comm=tsch, num_iters=25, primal="cholesky"),
              problem=tprob, device="cpu")
    assert torch.equal(got.train_mse, own.history["train_mse"])
    assert torch.equal(got.state.theta, own.theta)


def test_deprecated_cta_run_warns_and_matches_reference(legacy):
    jb, tprob = legacy
    want, jmsg = _warned(lambda: jax_cta.run(jb.problem, jb.graph, lr=0.85,
                                             num_iters=25))
    got, msg = _warned(lambda: port_cta.run(
        tprob, port_graph.Graph(np.asarray(jb.graph.adjacency)), lr=0.85,
        num_iters=25))
    assert msg == jmsg and "algorithm='cta'" in msg[0]
    np.testing.assert_array_equal(_np(got.comms), np.asarray(want.comms))
    np.testing.assert_allclose(_np(got.train_mse),
                               np.asarray(want.train_mse), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(_np(got.state.theta),
                               np.asarray(want.state.theta), atol=TOL)


@pytest.fixture(scope="module")
def kernel_matrix():
    rng = np.random.default_rng(6)
    x = rng.random((40, 3))
    sq = ((x[:, None] - x[None]) ** 2).sum(-1)
    # bandwidth 0.05: K's condition number ~50, Eq. (37)'s system's ~900
    return np.exp(-sq / 0.05).astype(np.float32), \
        rng.standard_normal(40).astype(np.float32)


def test_kernel_ridge_matches_reference(kernel_matrix):
    K, y = kernel_matrix
    want = np.asarray(jax_ridge.kernel_ridge(jnp.asarray(K), jnp.asarray(y),
                                             1e-2, 10))
    got = _np(port_ridge.kernel_ridge(torch.tensor(K), torch.tensor(y),
                                      1e-2, 10))
    # one fp32 solve of a system conditioned ~900: ~1e-4 of max|alpha|
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_effective_degrees_and_sufficient_features_match_reference(
        kernel_matrix):
    K, _ = kernel_matrix
    for lam in (1e-3, 1e-1):
        np.testing.assert_allclose(
            float(port_ridge.effective_degrees_of_freedom(torch.tensor(K),
                                                          lam)),
            float(jax_ridge.effective_degrees_of_freedom(jnp.asarray(K),
                                                         lam)), rtol=1e-5)
        np.testing.assert_allclose(
            port_ridge.sufficient_features(torch.tensor(K), lam),
            jax_ridge.sufficient_features(jnp.asarray(K), lam), rtol=1e-5)


# ---------------------------------------------------------------------------
# the CG primal on the ring runtimes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["spmd", "fused"])
@pytest.mark.parametrize("alg", ["coke", "dkla"])
def test_ring_runtime_cg_fit_matches_reference(alg, backend, ring512):
    """primal="cg" on spmd and on the fused backend's fallback, against the
    reference's same fits on tests/test_big_d.py's RING problem, and
    against the port's simulator CG fit (2e-4 across backends, as the
    reference holds its own)."""
    kw = dict(BASE, algorithm=alg, primal="cg", backend=backend)
    ref, port = _fit_both(*ring512, krr=RING_KRR, **kw)
    _assert_match(ref, port, f"{alg}:{backend}", tol=CG_TOL,
                  mse_rtol=CG_TOL)
    sim = fit(FitConfig(krr=KRRConfig(**RING_KRR),
                        **dict(kw, backend="simulator")),
              problem=ring512[1], device="cpu")
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(_np(sim.history[k]),
                                      _np(port.history[k]))
    np.testing.assert_allclose(_np(sim.theta), _np(port.theta),
                               atol=CG_BACKEND_TOL)


def test_cg_matches_cholesky_on_the_simulator(ring512):
    """The reference's own pin (tests/test_big_d.py), on the port."""
    cfg = FitConfig(krr=KRRConfig(**RING_KRR), **BASE)
    chol = fit(cfg.replace(primal="cholesky"), problem=ring512[1],
               device="cpu")
    cg = fit(cfg.replace(primal="cg"), problem=ring512[1], device="cpu")
    np.testing.assert_array_equal(_np(chol.comms), _np(cg.comms))
    np.testing.assert_allclose(_np(chol.theta), _np(cg.theta), atol=CG_TOL)
    np.testing.assert_allclose(_np(chol.train_mse), _np(cg.train_mse),
                               rtol=CG_TOL)


def test_fused_cg_never_enters_the_megakernel_or_k3(small, monkeypatch):
    """The megakernel gate admits only the gradient primal: a fused CG fit
    runs the ring runtime's exact solve, which launches neither K2 nor
    K3."""
    entered, k3 = [], []
    monkeypatch.setattr(port_backends, "_megastep_chunk",
                        lambda *a, **k: entered.append(1))
    real = port_ops.coke_fused_update
    monkeypatch.setattr(port_ops, "coke_fused_update",
                        lambda *a, **k: k3.append(1) or real(*a, **k))
    port_cu.LAUNCHES = 0
    res = fit(FitConfig(krr=KRRConfig(**KRR),
                        **dict(BASE, backend="fused", primal="cg",
                               num_iters=5)),
              problem=small[1], device="cpu")
    assert not entered and not k3
    assert "send_frac" in res.history and res.comms.shape == (5,)


@pytest.mark.parametrize("backend", ["spmd", "fused"])
def test_auto_primal_past_the_cg_crossover_runs_cg(backend):
    """primal="auto" at D = 2049 resolves to CG on the ring runtimes, as in
    the reference: the same fit as primal="cg", and the reference's."""
    rng = np.random.default_rng(0)
    phi = rng.random((4, 2, 2049), dtype=np.float32) * 0.05
    y = rng.random((4, 2), dtype=np.float32)
    adj = np.asarray(jax_graph.ring(4).adjacency, np.float32)
    jprob, tprob = _both_problems(phi, y, adj)
    kw = dict(BASE, backend=backend, primal="auto", num_iters=5)
    ref, port = _fit_both(jprob, tprob, **kw)
    _assert_match(ref, port, f"auto:{backend}", tol=CG_TOL, mse_rtol=CG_TOL)
    cg = fit(FitConfig(krr=KRRConfig(**KRR), **dict(kw, primal="cg")),
             problem=tprob, device="cpu")
    for k in port.history:
        torch.testing.assert_close(port.history[k], cg.history[k], rtol=0,
                                   atol=0)


def test_consensus_update_primal_solve_matches_reference():
    """The ring runtime's primal_solve hook: the solve replaces the
    optimizer step (whose state stays as it was) on both packages."""
    n, d = 5, 8
    rng = np.random.default_rng(7)
    theta = (0.1 * rng.standard_normal((n, d))).astype(np.float32)
    out = []
    for cns, opt, arr in ((jax_cns, jax_opt, jnp.asarray),
                          (port_cns, port_opt, torch.tensor)):
        ccfg = cns.ConsensusConfig(strategy="coke", rho=0.1, censor_v=0.01,
                                   censor_mu=0.9)
        ocfg = opt.OptConfig(kind="sgd", lr=0.1)
        p = {"theta": arr(theta)}
        st = cns.init_consensus_state(ccfg, ocfg, p)

        def solve(params, theta_hat, gamma, nbr_sum, deg):
            return {"theta": 0.5 * params["theta"] + 0.1 * nbr_sum["theta"]
                    - 0.2 * gamma["theta"] + 0.01 * deg}

        for _ in range(3):
            p, st, m = cns.consensus_update(ccfg, ocfg, p, p, st,
                                            primal_solve=solve)
        out.append((p, st, m))
    (jp, jst, jm), (tp, tst, tm) = out
    np.testing.assert_allclose(_np(tp["theta"]), np.asarray(jp["theta"]),
                               atol=TOL)
    assert int(tst["comms"]) == int(jst["comms"])
    np.testing.assert_array_equal(_np(tm["bits"]), np.asarray(jm["bits"]))
    np.testing.assert_allclose(_np(tst["gamma"]["theta"]),
                               np.asarray(jst["gamma"]["theta"]), atol=TOL)


# ---------------------------------------------------------------------------
# admission and registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["cg-logistic", "cholesky-logistic",
                                  "cholesky-spmd", "cholesky-fused",
                                  "cta-cg", "oracle-cholesky"])
def test_simulator_admission_raises_the_reference_value_error(case, small,
                                                              logistic):
    """The reference's ValueErrors, message for message."""
    kw = dict(BASE, num_iters=2)
    prob = small
    if case.endswith("logistic"):
        kw["primal"] = case.split("-")[0]
        prob = logistic
    elif case.startswith("cholesky"):
        kw.update(primal="cholesky", backend=case.split("-")[1])
    else:
        kw.update(algorithm="cta" if case == "cta-cg" else "ridge_oracle",
                  primal=case.split("-")[1], censor_v=None, censor_mu=None)
    errs = []
    for run in (lambda: jax_fit(JFitConfig(krr=JKRRConfig(**KRR), **kw),
                                problem=prob[0]),
                lambda: fit(FitConfig(krr=KRRConfig(**KRR), **kw),
                            problem=prob[1], device="cpu")):
        with pytest.raises(ValueError) as e:
            run()
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_registry_runs_every_ported_solver_behind_the_contract():
    names = list_solvers()
    assert {"coke", "dkla", "cta", "ridge_oracle"} <= set(names)
    for name in names:
        s = get_solver(name)
        assert isinstance(s, Solver), name
        assert "simulator" in s.backends
    for name in ("online_coke", "online_dkla", "qc_odkla"):
        assert name in names
        assert get_solver(name).streaming


def test_simulator_still_raises_for_unported_axes(small):
    """The axes that raised on the simulator now run on a (2, 4) mesh:
    a synchronous fit (which raised before sharding was ported) and a
    gossip fit (which raised until a mesh ran under gossip) are layout
    changes of the reference's unsharded runs: comms and bits exact,
    theta and the trajectories within this file's tolerance (the Cholesky
    primal, which gathers each agent block's features for its factor)."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(2, 4, device="cpu")
    for name, kw in (("mesh:cholesky", dict(BASE, primal="cholesky")),
                     ("mesh:gossip", dict(BASE, primal="cholesky",
                                          exec="gossip",
                                          participation=0.5))):
        ref = jax_fit(JFitConfig(krr=JKRRConfig(**KRR), **kw),
                      problem=small[0])
        port = fit(FitConfig(krr=KRRConfig(**KRR), **kw), problem=small[1],
                   device="cpu", mesh=mesh)
        _assert_match(ref, port, name)


def test_simulator_personalization_matches_reference(small):
    """A personalized fit on the simulator, which raised NotImplementedError
    before personalization was ported: with warmup 5 of 40 iterations,
    comms and bits exact, the first five iterations within this file's
    tolerance, the learned graph's support equal and theta within 1e-3
    relative after the refreshes (the reference's own tolerance between
    two personalized runs; tests/test_torch_personalize.py says why)."""
    from repro.api import Personalization as JPersonalization

    from repro_torch.api import Personalization
    kw = dict(BASE, primal="cg")
    ref = jax_fit(JFitConfig(krr=JKRRConfig(**KRR), **kw,
                             personalization=JPersonalization(
                                 k=1, every=3, warmup=5)),
                  problem=small[0])
    port = fit(FitConfig(krr=KRRConfig(**KRR), **kw,
                         personalization=Personalization(k=1, every=3,
                                                         warmup=5)),
               problem=small[1], device="cpu")
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(_np(port.history[k]),
                                      np.asarray(ref.history[k]))
    np.testing.assert_allclose(_np(port.history["train_mse"])[:5],
                               np.asarray(ref.history["train_mse"])[:5],
                               rtol=CG_TOL, atol=CG_TOL)
    np.testing.assert_array_equal(_np(port.learned_adjacency) > 0,
                                  np.asarray(ref.learned_adjacency) > 0)
    want = np.asarray(ref.theta)
    np.testing.assert_allclose(_np(port.theta), want, rtol=0,
                               atol=1e-3 * max(1.0, np.abs(want).max()))


def test_simulator_gossip_matches_reference(small):
    """exec="gossip" at participation 0.5 on the simulator, which raised
    NotImplementedError before gossip was ported: comms and bits exact,
    theta within 1e-5 (the primals' own tolerances above)."""
    ref, port = _fit_both(small[0], small[1],
                          **dict(BASE, exec="gossip", participation=0.5))
    _assert_match(ref, port, "simulator gossip")


def test_dataclass_problem_degrees_follow_the_adjacency(small):
    tprob = small[1]
    np.testing.assert_array_equal(_np(tprob.degrees),
                                  np.asarray(small[0].degrees))
    er = dataclasses.replace(tprob, adjacency=torch.tensor(
        jax_graph.erdos_renyi(4, 0.9, seed=1).adjacency,
        dtype=torch.float32))
    assert _np(er.degrees).tolist() == np.asarray(
        jax_graph.erdos_renyi(4, 0.9, seed=1).adjacency).sum(1).tolist()
