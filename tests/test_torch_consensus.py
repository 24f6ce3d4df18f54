"""The port's ring consensus runtime against the JAX reference, on the CPU.

`repro_torch.distributed.consensus` is held against
`repro.distributed.consensus` step by step, for dkla, coke and cta, with
the fused kernel on (K3's plain version here; the reference's Pallas kernel
in interpret mode) and off; and the pieces it is built from: the losses,
the backends' local gradients, the sgd optimizer and the agent-stacked
comm adapters. Inputs are made with numpy from a seed and handed to both.

Tolerances: send decisions, comms and bits are exact; parameters and duals
are fp32 elementwise chains of a few terms, held to 1e-5 absolute at
values of order one; gradients of a mean over T samples to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import backends as jax_backends
from repro.core import comm as jax_comm
from repro.core import losses as jax_losses
from repro.core.admm import make_problem as jax_make_problem
from repro.core.graph import ring as jax_ring
from repro.distributed import consensus as jax_cns
from repro.optim import optimizers as jax_opt

from repro_torch import convert
from repro_torch.api import backends as port_backends
from repro_torch.core import comm as port_comm
from repro_torch.core import losses as port_losses
from repro_torch.distributed import consensus as port_cns
from repro_torch.kernels.coke_update import coke_update as port_cu
from repro_torch.optim import optimizers as port_opt

torch.set_num_threads(2)

TOL = 1e-5
GRAD_TOL = 1e-6
N, D = 5, 24


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# losses and local gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss", ["quadratic", "logistic", "hinge"])
def test_losses_and_risks_match_reference(loss):
    rng = np.random.default_rng(0)
    y = np.sign(rng.standard_normal(50)).astype(np.float32)
    y_hat = (3 * rng.standard_normal(50)).astype(np.float32)
    y_hat[:5] = y[:5]          # hinge ties: 1 - y*y_hat == 0
    np.testing.assert_allclose(
        _np(port_losses.LOSSES[loss](torch.tensor(y), torch.tensor(y_hat))),
        np.asarray(jax_losses.LOSSES[loss](jnp.asarray(y), jnp.asarray(y_hat))),
        rtol=1e-6, atol=1e-6)
    feats = rng.standard_normal((4, 30, 8)).astype(np.float32)
    labels = np.sign(rng.standard_normal((4, 30))).astype(np.float32)
    theta = rng.standard_normal(8).astype(np.float32)
    want = jax_losses.local_empirical_risk(jnp.asarray(theta),
                                           jnp.asarray(feats[0]),
                                           jnp.asarray(labels[0]), 0.01, loss)
    got = port_losses.local_empirical_risk(torch.tensor(theta),
                                           torch.tensor(feats[0]),
                                           torch.tensor(labels[0]), 0.01, loss)
    assert got.shape == ()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)


def test_hinge_splits_the_gradient_at_a_tie_like_the_reference():
    y, y_hat = np.float32(1.0), np.float32(1.0)
    want = jax.grad(lambda v: jax_losses.hinge(y, v))(y_hat)
    x = torch.tensor(y_hat, requires_grad=True)
    port_losses.hinge(torch.tensor(y), x).backward()
    assert float(x.grad) == float(want) == -0.5


@pytest.mark.parametrize("loss", ["quadratic", "logistic", "hinge"])
def test_local_grads_match_reference(loss):
    rng = np.random.default_rng(1)
    feats = (rng.standard_normal((N, 30, D)) / np.sqrt(D)).astype(np.float32)
    y = rng.standard_normal((N, 30)).astype(np.float32)
    if loss != "quadratic":
        y = np.sign(y)
    theta = rng.standard_normal((N, D)).astype(np.float32)
    adj = np.asarray(jax_ring(N).adjacency)
    jp = jax_make_problem(jnp.asarray(feats), jnp.asarray(y), jax_ring(N),
                          0.3, 0.1, loss=loss)
    tp = convert.problem_from_numpy(feats, y, adj, 0.3, 0.1, loss=loss,
                                    device="cpu")
    want = np.asarray(jax_backends._local_grads(jp, jnp.asarray(theta)))
    got = port_backends._local_grads(tp, torch.tensor(theta))
    assert not got.requires_grad
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=GRAD_TOL)


# ---------------------------------------------------------------------------
# the sgd optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("momentum,clip", [(0.0, 0.0), (0.9, 0.0),
                                           (0.0, 0.5), (0.9, 0.5)])
def test_sgd_matches_reference(momentum, clip):
    """Three steps of opt_update + apply_updates on a two-leaf tree."""
    rng = np.random.default_rng(2)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(6).astype(np.float32)}
    jcfg = jax_opt.OptConfig(kind="sgd", lr=0.1, momentum=momentum,
                             grad_clip=clip)
    tcfg = port_opt.OptConfig(kind="sgd", lr=0.1, momentum=momentum,
                              grad_clip=clip)
    jp, tp = _j(params), _t(params)
    js, ts = jax_opt.init_opt_state(jcfg, jp), port_opt.init_opt_state(tcfg, tp)
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        ju, js = jax_opt.opt_update(jcfg, _j(g), js, jp)
        tu, ts = port_opt.opt_update(tcfg, _t(g), ts, tp)
        jp, tp = jax_opt.apply_updates(jp, ju), port_opt.apply_updates(tp, tu)
        for k in params:
            np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6)
        assert int(ts["count"]) == int(js["count"])
        assert set(ts) == set(js)


def test_adamw_is_not_ported_yet():
    assert port_opt.OptConfig().kind == "sgd"     # the default runs
    port_opt.init_opt_state(port_opt.OptConfig(), {"a": torch.zeros(3)})
    with pytest.raises(NotImplementedError, match="item 15"):
        port_opt.init_opt_state(port_opt.OptConfig(kind="adamw"),
                                {"a": torch.zeros(3)})


# ---------------------------------------------------------------------------
# agent-stacked comm adapters
# ---------------------------------------------------------------------------

def test_flatten_and_apply_tree_match_reference():
    rng = np.random.default_rng(3)
    tree = {"b": rng.standard_normal((N, 2, 3)).astype(np.float32),
            "a": rng.standard_normal((N, 4)).astype(np.float32)}
    # per-agent perturbations from far below to far above h(3) = 0.36
    size = np.array([0.01, 0.05, 0.2, 0.5, 1.0])
    prev = {k: (v + size.reshape((N,) + (1,) * (v.ndim - 1))
                * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in tree.items()}
    jflat, _ = jax_comm.flatten_agents(_j(tree))
    tflat, leaves = port_comm.flatten_agents(_t(tree))
    np.testing.assert_array_equal(_np(tflat), np.asarray(jflat))
    back = port_comm.unflatten_agents(tflat, leaves, _t(tree))
    for k in tree:
        np.testing.assert_array_equal(_np(back[k]), tree[k])
    jchain = jax_comm.Chain((jax_comm.Censor(0.5, 0.9),))
    tchain = port_comm.Chain((port_comm.Censor(0.5, 0.9),))
    jh, jsend, jst = jax_comm.apply_tree(jchain, _j(tree), _j(prev), 3,
                                         jchain.init_state(N))
    th, tsend, tst = port_comm.apply_tree(tchain, _t(tree), _t(prev), 3,
                                          tchain.init_state(N))
    np.testing.assert_array_equal(_np(tsend), np.asarray(jsend))
    assert 0 < int(np.sum(np.asarray(jsend))) < N
    np.testing.assert_array_equal(_np(tst.bits), np.asarray(jst.bits))
    for k in tree:
        np.testing.assert_array_equal(_np(th[k]), np.asarray(jh[k]))


def test_single_leaf_flattens_without_a_copy():
    x = torch.randn(N, D)
    flat, _ = port_comm.flatten_agents({"theta": x})
    assert flat.data_ptr() == x.data_ptr()


# ---------------------------------------------------------------------------
# consensus_update, step by step
# ---------------------------------------------------------------------------

def _configs(strategy, fused, offsets):
    k = len(offsets)
    kw = dict(strategy=strategy, rho=0.3, censor_v=0.6, censor_mu=0.93,
              offsets=offsets, mix_weight=k / (2.0 * k + 1.0),
              use_fused_kernel=fused)
    return jax_cns.ConsensusConfig(**kw), port_cns.ConsensusConfig(**kw)


@pytest.mark.parametrize("offsets", [(1,), (1, 2)], ids=["ring", "circ"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("strategy", ["coke", "dkla", "cta"])
def test_consensus_update_matches_reference_step_by_step(strategy, fused,
                                                         offsets):
    jccfg, tccfg = _configs(strategy, fused, offsets)
    jopt = jax_opt.OptConfig(kind="sgd", lr=0.1)
    topt = port_opt.OptConfig(kind="sgd", lr=0.1)
    rng = np.random.default_rng(5)
    theta0 = {"theta": np.zeros((N, D), np.float32)}
    jp, tp = _j(theta0), _t(theta0)
    js = jax_cns.init_consensus_state(jccfg, jopt, jp)
    ts = port_cns.init_consensus_state(tccfg, topt, tp)
    assert set(ts) == set(js)
    sent = 0
    for _ in range(12):
        g = {"theta": rng.standard_normal((N, D)).astype(np.float32)}
        jp, js, jm = jax_cns.consensus_update(jccfg, jopt, jp, _j(g), js)
        tp, ts, tm = port_cns.consensus_update(tccfg, topt, tp, _t(g), ts)
        assert set(tm) == set(jm)
        assert int(ts["comms"]) == int(js["comms"])
        assert ts["step"] == int(js["step"])
        np.testing.assert_allclose(_np(tp["theta"]), np.asarray(jp["theta"]),
                                   rtol=0, atol=TOL)
        if strategy == "cta":
            continue
        for k in ("theta_hat", "gamma", "nbr_left", "nbr_right"):
            np.testing.assert_allclose(_np(ts[k]["theta"]),
                                       np.asarray(js[k]["theta"]),
                                       rtol=0, atol=TOL, err_msg=k)
        np.testing.assert_array_equal(_np(ts["comm"].bits),
                                      np.asarray(js["comm"].bits))
        np.testing.assert_array_equal(_np(tm["bits"]), np.asarray(jm["bits"]))
        np.testing.assert_array_equal(_np(tm["send_frac"]),
                                      np.asarray(jm["send_frac"]))
        sent = int(ts["comms"])
    if strategy == "coke":        # the masked broadcast is exercised
        assert 0 < sent < 12 * N
    np.testing.assert_allclose(_np(port_cns.consensus_gap(tp)),
                               np.asarray(jax_cns.consensus_gap(jp)),
                               rtol=1e-5)


def test_fused_flag_launches_k3_once_per_step_and_only_for_admm(monkeypatch):
    """use_fused_kernel sends each ADMM step's augmented gradient through
    coke_fused_update exactly once; cta never calls it."""
    from repro_torch.kernels.coke_update import ops as port_ops

    calls = []
    real = port_ops.coke_fused_update
    monkeypatch.setattr(port_ops, "coke_fused_update",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    topt = port_opt.OptConfig(kind="sgd", lr=0.1)
    for strategy, want in (("coke", 3), ("cta", 0)):
        calls.clear()
        _, ccfg = _configs(strategy, True, (1, 2))
        p = {"theta": torch.zeros(N, D)}
        st = port_cns.init_consensus_state(ccfg, topt, p)
        for _ in range(3):
            p, st, _ = port_cns.consensus_update(
                ccfg, topt, p, {"theta": torch.randn(N, D)}, st)
        assert len(calls) == want
        assert all(c == {"rho": 0.3, "deg": 4.0} for c in calls)
    assert port_cu.FUSED_UPDATE_LAUNCHES == 0   # CPU: the plain version


def test_stack_params_and_state_layout():
    p = port_cns.stack_params({"theta": torch.arange(3.0)}, 4)
    assert tuple(p["theta"].shape) == (4, 3)
    assert torch.equal(p["theta"][2], torch.arange(3.0))
    ccfg = port_cns.ConsensusConfig(strategy="coke", offsets=(1, 3))
    assert ccfg.degree == 4.0 and ccfg.is_admm
    assert ccfg.comm_chain().describe() == "censor(v=1.0,mu=0.99)"
    assert port_cns.ConsensusConfig(strategy="dkla").comm_chain().stages == ()
    st = port_cns.init_consensus_state(
        ccfg, port_opt.OptConfig(kind="sgd", momentum=0.5), p)
    assert tuple(st["opt"]["count"].shape) == (4,)
    assert tuple(st["opt"]["m"]["theta"].shape) == (4, 3)
    assert st["nbr_left"]["theta"] is st["theta_hat"]["theta"]


# ---------------------------------------------------------------------------
# what raises
# ---------------------------------------------------------------------------

_HOOKS = {
    # gossip: agents 1 and 3 sleep in every one of the three steps
    "participate": lambda: dict(participate=np.arange(N) % 2 == 0),
    "adjacency": lambda: dict(adjacency=np.asarray(jax_ring(N).adjacency,
                                                   np.float32)),
    # churn: agent 2 is dead and agent 1 restarts cold in every step
    "alive": lambda: dict(alive=np.arange(N) != 2,
                          joined=np.arange(N) == 1),
    "schedule": lambda: dict(ccfg=dict(offset_schedule=((1,), (2,)))),
}


#: hooks the port runs (the rest raise NotImplementedError for now)
_PORTED_HOOKS = ("schedule", "participate", "alive", "adjacency")


def _call_both(strategy, fused, hook):
    """Call both packages' consensus_update with one hook, three steps from
    seeded parameters; return each package's exception, or its
    (params, state) where the calls ran."""
    extra = _HOOKS[hook]()
    ccfg_kw = extra.pop("ccfg", {})
    theta0 = np.random.default_rng(3).standard_normal((N, D)).astype(
        np.float32)
    out = []
    for cns, opt, arr in ((jax_cns, jax_opt, jnp.asarray),
                          (port_cns, port_opt, torch.tensor)):
        ccfg = cns.ConsensusConfig(strategy=strategy, use_fused_kernel=fused,
                                   censor_v=0.05, **ccfg_kw)
        ocfg = opt.OptConfig(kind="sgd", lr=0.1)
        p = {"theta": arr(np.zeros((N, D), np.float32))}
        st = cns.init_consensus_state(ccfg, ocfg, p)
        g = {"theta": arr(theta0)}
        try:
            for _ in range(3):
                p, st, _ = cns.consensus_update(
                    ccfg, ocfg, p, g, st,
                    **{k: arr(v) for k, v in extra.items()})
            out.append((p, st))
        except (ValueError, NotImplementedError) as e:
            out.append(e)
    return out


@pytest.mark.parametrize("hook", sorted(_HOOKS))
@pytest.mark.parametrize("strategy,fused", [("coke", False), ("coke", True),
                                            ("cta", False)])
def test_unported_hooks_raise_like_the_reference(strategy, fused, hook):
    """Where the reference raises ValueError the port raises the same
    ValueError; where the reference runs, the port runs a ported hook (the
    offset schedule, gossip participation, churn, a dense adjacency) to the
    reference's values and raises NotImplementedError, naming the
    ROADMAP.md item, for the others."""
    ref, port = _call_both(strategy, fused, hook)
    if isinstance(ref, ValueError):
        assert type(port) is ValueError and str(port) == str(ref)
    elif hook in _PORTED_HOOKS:
        assert not isinstance(port, Exception), port
        (jp, jst), (tp, tst) = ref, port
        assert int(tst["comms"]) == int(jst["comms"])
        pairs = [(tp["theta"], jp["theta"])]
        if "theta_hat" in jst:   # cta carries no broadcast or dual
            pairs += [(tst["theta_hat"]["theta"], jst["theta_hat"]["theta"]),
                      (tst["gamma"]["theta"], jst["gamma"]["theta"])]
        for got, want in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6)
        np.testing.assert_array_equal(
            tst["opt"]["count"].numpy(), np.asarray(jst["opt"]["count"]))
    else:
        assert isinstance(port, NotImplementedError)
        assert "ROADMAP.md Queue 1 item" in str(port)


def test_exact_primal_and_deep_net_strategies_raise_not_implemented():
    opt = port_opt.OptConfig(kind="sgd", lr=0.1)
    p = {"theta": torch.zeros(N, D)}
    for strategy in ("allreduce", "coke_et"):
        ccfg = port_cns.ConsensusConfig(strategy=strategy)
        with pytest.raises(NotImplementedError, match="item 15"):
            port_cns.consensus_update(ccfg, opt, p, p,
                                      port_cns.init_consensus_state(ccfg, opt,
                                                                    p))
