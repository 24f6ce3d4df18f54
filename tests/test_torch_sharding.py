"""Big-D feature sharding in the port (`repro_torch.distributed.sharding`,
`repro_torch.launch.mesh`, `fit(mesh=)`, `KernelModel.shard`,
`ThetaStore(mesh=)`, `KernelServer(mesh=)`) on the CPU, against the
reference.

The spec rules are held to the reference's, spec for spec, on
`jax.sharding.AbstractMesh` (the reference's rules run there without
devices). The reference's own sharded fit cannot run on this jax (its CG
matvec raises ShardingTypeError, `tests/test_big_d.py::
test_sharded_fit_and_predict_match_unsharded`), so the port's sharded runs
are held to the contract that test states against the reference's
UNSHARDED runs: a sharded fit is a pure layout change, with comms and bits
exact, theta within 1e-5 and predictions within 1e-5, at that test's own
configuration (N=4, 40 rows, D=64, CG, 30 iterations). The meshes are
`make_host_mesh(data, model, device="cpu")`: every cell is the CPU.
"""
import dataclasses
import importlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.api as japi
from repro.api import FitConfig as JFitConfig
from repro.api import KRRConfig as JKRRConfig
from repro.api import build_problem as jax_build_problem
from repro.api import fit as jax_fit
from repro.distributed import sharding as jsh
from repro.launch import mesh as jmesh
from repro.serve import KernelServeConfig as JKernelServeConfig
from repro.serve import KernelServer as JKernelServer

import repro_torch.api as tapi
from repro_torch import convert
from repro_torch.api import FitConfig, KernelModel, KRRConfig, fit
from repro_torch.core import rff
from repro_torch.distributed import sharding
from repro_torch.kernels.coke_update import ops as k3_ops
from repro_torch.kernels.coke_update.coke_update import coke_fused_update
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve import KernelServeConfig, KernelServer, ThetaStore

torch.set_num_threads(2)

CPU = "cpu"
TOL = 1e-5           # tests/test_big_d.py's sharded-parity tolerance
TIMEOUT = 60
MESHES = ((1, 1), (2, 4), (4, 2), (1, 3))

# tests/test_big_d.py's _SHARD_SCRIPT configuration
KRR = dict(num_agents=4, samples_per_agent=40, num_features=64, lam=1e-2,
           rho=0.1, seed=0)
SHARD = dict(graph="ring", algorithm="coke", censor_v=0.3, censor_mu=0.97,
             num_iters=30, primal="cg")


def _np(a):
    a = sharding.unshard(a)
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _amesh(data, model):
    return AbstractMesh((data, model), ("data", "model"))


# ---------------------------------------------------------------------------
# The spec rules against the reference's
# ---------------------------------------------------------------------------

LEAF_SHAPES = ((), (4,), (8,), (6,), (4, 64), (8, 64), (4, 66), (6, 64),
               (8, 3, 64), (4, 40, 64), (4, 40, 66), (5, 40, 12), (4, 1))


@pytest.mark.parametrize("data,model", MESHES)
def test_feature_spec_equals_the_reference(data, model):
    tm, jm = make_host_mesh(data, model, device=CPU), _amesh(data, model)
    for n in (4, 8):
        for shape in LEAF_SHAPES:
            want = jsh.feature_spec(shape, jm, n)
            got = sharding.feature_spec(shape, tm, n)
            assert tuple(got) == tuple(want), (shape, n)
    tree = {"theta": np.zeros((4, 64)), "step": 3,
            "bits": np.zeros((4,))}
    got = sharding.feature_specs(tree, tm, 4)
    assert got["step"] == 3
    assert tuple(got["theta"]) == tuple(jsh.feature_spec((4, 64), jm, 4))


@pytest.mark.parametrize("data,model", MESHES)
def test_theta_stack_and_batch_specs_equal_the_reference(data, model):
    tm, jm = make_host_mesh(data, model, device=CPU), _amesh(data, model)
    for shape in ((8, 64), (8, 66), (1024, 12), (3, 4096), (16,)):
        assert tuple(sharding.theta_stack_spec(shape, tm)) == \
            tuple(jsh.theta_stack_spec(shape, jm)), shape
    import jax
    leaves = [(32, 5), (30, 5), (32,), (12,), (1024,), (4, 7, 3)]
    want = jsh.batch_specs(None, tuple(
        jax.ShapeDtypeStruct(s, jnp.float32) for s in leaves), jm)
    got = sharding.batch_specs(None, tuple(torch.zeros(s) for s in leaves),
                               tm)
    assert [tuple(g) for g in got] == [tuple(w) for w in want]


@pytest.mark.parametrize("data,model", MESHES)
def test_model_shard_specs_equal_the_reference(data, model):
    """The specs `KernelModel.shard` places by, as the reference's
    `api/model.py:104-139` forms them with its own `_div` and
    `batch_axes` (omega and bias split L, theta D, thetas also agents),
    for cos_bias and for cos_sin (L and 2L divide differently)."""
    tm, jm = make_host_mesh(data, model, device=CPU), _amesh(data, model)
    g = torch.Generator().manual_seed(0)
    for mapping, D, n in (("cos_bias", 64, 4), ("cos_bias", 66, 6),
                          ("cos_sin", 12, 4), ("cos_sin", 16, 3)):
        p = rff.draw_rff(g, 5, D, mapping=mapping)
        m = KernelModel(p, torch.zeros(D), torch.zeros(n, D)).shard(tm)
        L = p.omega.shape[1]
        spec_feat = jsh._div(L, jm, "model")
        feat = jsh._div(D, jm, "model")
        lead = jsh._div(n, jm, jmesh.batch_axes(jm))
        want = {"omega": (None, spec_feat), "bias": (spec_feat,),
                "theta": (feat,), "thetas": (lead, feat)}
        for name, spec in want.items():
            t = getattr(m, name)
            got = tuple(t.spec) if isinstance(t, sharding.Blocked) \
                else (None,) * t.ndim
            assert got == tuple(jsh.P(*spec)), (mapping, D, name)


def test_batch_axes_and_num_agents_equal_the_reference():
    for data, model in MESHES:
        tm, jm = make_host_mesh(data, model, device=CPU), _amesh(data, model)
        assert tmesh.batch_axes(tm) == jmesh.batch_axes(jm)
        assert tmesh.num_agents(tm) == jmesh.num_agents(jm)
        assert tm.shape == dict(jm.shape)
    pod = tmesh.Mesh(np.full((2, 2, 3), torch.device("cpu"), dtype=object),
                     ("pod", "data", "model"))
    jpod = AbstractMesh((2, 2, 3), ("pod", "data", "model"))
    assert tmesh.batch_axes(pod) == jmesh.batch_axes(jpod)
    assert tmesh.num_agents(pod) == jmesh.num_agents(jpod) == 4
    assert tuple(sharding.feature_spec((4, 9), pod, 4)) == \
        tuple(jsh.feature_spec((4, 9), jpod, 4))


def test_make_host_mesh_runs_on_the_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_host_mesh(2, 4)
    m = make_host_mesh(2, 4, device=CPU)
    assert m.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="devices"):
        make_host_mesh(2, 2, devices=["cpu"] * 3)


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------

def _specs_for(shape, mesh):
    """Every spec the layout takes for `shape` on `mesh`: each dim uncut,
    or cut over the batch axes or "model" where it divides."""
    ext = {"data": tmesh.num_agents(mesh), "model": mesh.shape["model"]}
    out = [()]
    for s in shape:
        out = [o + (e,) for o in out for e in (None, "data", "model")
               if e is None or s % ext[e] == 0]
    return [sharding.P(*o) for o in out
            if len([e for e in o if e]) == len({e for e in o if e})]


@pytest.mark.parametrize("data,model", MESHES)
def test_shard_then_unshard_is_bitwise_the_input(data, model):
    mesh = make_host_mesh(data, model, device=CPU)
    rng = np.random.default_rng(0)
    for shape in ((8, 12), (4, 6, 12), (12,), (3, 5)):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        for spec in _specs_for(shape, mesh):
            b = sharding.shard(x, mesh, spec)
            assert torch.equal(sharding.unshard(b), x), spec
            if isinstance(b, sharding.Blocked):
                for t in b.blocks.values():
                    assert t.is_contiguous()
                # a replicated axis holds one tensor per device: the
                # blocks are the cut extents, not the cells
                cut = [e for e in spec if e is not None]
                want = 1
                for e in cut:
                    want *= tmesh.num_agents(mesh) if e == "data" \
                        else mesh.shape["model"]
                assert len(b.blocks) == want, spec


def test_psum_model_adds_in_ascending_block_order():
    """Four model partials whose fp32 sum depends on the order: the psum
    is the left fold 0, 1, 2, 3 (and the rows' own values are summed in
    the blocks, not re-associated)."""
    mesh = make_host_mesh(1, 4, device=CPU)
    vals = [1e8, 1.0, -1e8, 1.0]
    parts = torch.tensor(vals, dtype=torch.float32).reshape(1, 4, 1)
    p = sharding.Blocked(mesh, sharding.P(None), (1,), parts, partial=True)
    want = torch.tensor([0.0])
    for v in vals:
        want = want + torch.tensor([v])
    got = sharding.psum_model(p)
    assert torch.equal(got, want)
    assert float(got) == 1.0            # not the exact sum 2.0
    # a reduction over the cut feature dim is the same fold
    x = torch.tensor([[1e8, 1.0, -1e8, 1.0]])
    s = torch.sum(sharding.shard(x, mesh, sharding.P(None, "model")), dim=-1)
    assert torch.equal(s, want)


@pytest.mark.parametrize("data,model", ((2, 4), (4, 2), (1, 3)))
def test_collectives_and_elementwise_match_the_plain_ops(data, model):
    mesh = make_host_mesh(data, model, device=CPU)
    rng = np.random.default_rng(1)
    N, T, D = 8, 5, 12

    def t(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x, y, phi, A = t(N, D), t(N, D), t(N, T, D), t(N, N)
    bx = sharding.shard_features(x, mesh, N)
    by = sharding.shard_features(y, mesh, N)
    bphi = sharding.shard(phi, mesh, sharding.problem_specs(
        dataclasses.make_dataclass("Pb", ["num_agents", "feature_dim"])(
            N, D), mesh)[0])
    bA = sharding.shard(A, mesh, sharding.P("data" if N % data == 0
                                            else None, None))
    for shift in (1, -1, 3, -5, 8):
        assert torch.equal(_t(torch.roll(bx, shift, 0)),
                           torch.roll(x, shift, 0)), shift
    assert torch.equal(_t(bA @ bx), A @ x)
    assert torch.equal(_t(A @ bx), A @ x)
    u = torch.rand(N, D, generator=torch.Generator().manual_seed(0))
    assert torch.equal(_t(torch.where(u < bx, bx * 2 - 1.0, by)),
                       torch.where(u < x, x * 2 - 1.0, y))
    close = dict(rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(_t(torch.einsum("ntd,nd->nt", bphi, bx)),
                               torch.einsum("ntd,nd->nt", phi, x), **close)
    torch.testing.assert_close(_t(torch.sum(bx * by, dim=-1)),
                               torch.sum(x * y, dim=-1), **close)
    torch.testing.assert_close(_t(torch.mean(bx, 0, keepdim=True)),
                               torch.mean(x, 0, keepdim=True), **close)
    assert torch.equal(_t(torch.amax(torch.abs(bx), dim=-1, keepdim=True)),
                       torch.amax(torch.abs(x), dim=-1, keepdim=True))
    torch.testing.assert_close(_t(torch.linalg.norm(bx - by, dim=-1)),
                               torch.linalg.norm(x - y, dim=-1), **close)
    assert int(torch.sum(_t(bx) > 0, dim=-1, dtype=torch.int32).sum()) == \
        int(torch.sum(torch.sum(bx > 0, dim=-1, dtype=torch.int32)))
    assert torch.equal(_t(sharding.all_gather(bx, "model")), x)
    # an operation with no rule raises, naming it, never a silent gather
    with pytest.raises(NotImplementedError, match="cumsum"):
        torch.cumsum(bx, dim=-1)


def _t(a):
    return sharding.unshard(a)


@pytest.mark.parametrize("data,model", ((2, 4), (1, 4)))
def test_k3_once_per_block_matches_the_unsharded_update(data, model):
    """The fused fallback's K3 on a sharded carry (the plain version
    here): g_aug bitwise the unsharded update's, xi^2 the psum of the
    blocks' partials within fp32 rounding."""
    mesh = make_host_mesh(data, model, device=CPU)
    rng = np.random.default_rng(2)
    ops = [torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
           for _ in range(5)]
    theta, hat, gamma, grad, half = ops
    g, xi = coke_fused_update(theta, hat, gamma, grad, half, half, rho=0.1,
                              deg=2.0)
    blocked = [sharding.shard_features(o, mesh, 4) for o in ops]
    bg, bxi = k3_ops.coke_update_blocks(*blocked[:4], blocked[4],
                                        blocked[4], rho=0.1, deg=2.0)
    assert torch.equal(_t(bg), g)
    torch.testing.assert_close(_t(bxi), xi, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
@pytest.mark.parametrize("clip", [0.5, 1e3], ids=["binding", "loose"])
def test_grad_clip_on_a_mesh_matches_the_unsharded_reference(kind, clip):
    """Per-agent gradient clipping on a blocked tree (the reference vmaps
    `opt_update`, which clips each agent row by its global norm): five
    coke `consensus_update` rounds on a (2, 4) mesh against the
    reference's unsharded calls, each row's norm the psum of its feature
    blocks' partials. Comms and send fractions exact, params and duals
    within "Sharded sums"' 1e-5."""
    from repro.distributed import consensus as jax_cns
    from repro.optim import optimizers as jax_opt

    from repro_torch.distributed import consensus as port_cns
    from repro_torch.optim import optimizers as port_opt
    n, d = 4, 64
    rng = np.random.default_rng(14)
    kw = dict(strategy="coke", rho=0.05, censor_v=0.02, censor_mu=0.9)
    jccfg, tccfg = (jax_cns.ConsensusConfig(**kw),
                    port_cns.ConsensusConfig(**kw))
    okw = dict(kind=kind, lr=0.05, grad_clip=clip)
    jopt, topt = jax_opt.OptConfig(**okw), port_opt.OptConfig(**okw)
    x0 = rng.normal(size=(n, d)).astype(np.float32)
    mesh = make_host_mesh(2, 4, device=CPU)
    jp = {"theta": jnp.asarray(x0)}
    js = jax_cns.init_consensus_state(jccfg, jopt, jp)
    tp = {"theta": torch.from_numpy(x0)}
    ts = sharding.shard_features(
        port_cns.init_consensus_state(tccfg, topt, tp), mesh, n)
    tp = sharding.shard_features(tp, mesh, n)
    assert isinstance(tp["theta"], sharding.Blocked)
    sends = []
    for _ in range(5):
        g = (3.0 * rng.normal(size=(n, d))).astype(np.float32)
        jp, js, jm = jax_cns.consensus_update(jccfg, jopt, jp,
                                              {"theta": jnp.asarray(g)}, js)
        tp, ts, tm = port_cns.consensus_update(
            tccfg, topt, tp, sharding.shard_features(
                {"theta": torch.from_numpy(g)}, mesh, n), ts)
        assert float(tm["send_frac"]) == float(jm["send_frac"])
        assert int(ts["comms"]) == int(js["comms"])
        sends.append(float(tm["send_frac"]))
        np.testing.assert_allclose(_np(tp["theta"]), np.asarray(jp["theta"]),
                                   rtol=0, atol=TOL)
        for k in ("theta_hat", "gamma"):
            np.testing.assert_allclose(_np(ts[k]["theta"]),
                                       np.asarray(js[k]["theta"]), rtol=0,
                                       atol=TOL, err_msg=k)
    assert 0 < sum(sends)


# ---------------------------------------------------------------------------
# fit(mesh=) against the reference's unsharded fit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shard_problem():
    """tests/test_big_d.py's sharded-test problem, and the port's copy."""
    jprob = jax_build_problem(JFitConfig(krr=JKRRConfig(**KRR),
                                         **SHARD)).problem
    return jprob, convert.problem_from_numpy(
        np.asarray(jprob.feats), np.asarray(jprob.labels),
        np.asarray(jprob.adjacency), jprob.lam, jprob.rho, device=CPU)


def _reference(jprob, **kw):
    return jax_fit(JFitConfig(krr=JKRRConfig(**KRR), **dict(SHARD, **kw)),
                   problem=jprob)


def _port(tprob, mesh, **kw):
    return fit(FitConfig(krr=KRRConfig(**KRR), **dict(SHARD, **kw)),
               problem=tprob, device=CPU, mesh=mesh)


def _assert_layout_change(ref, port, err, theta=True):
    """comms and bits exact, theta within 1e-5 (tests/test_big_d.py)."""
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(_np(port.history[k]),
                                      np.asarray(ref.history[k]),
                                      err_msg=f"{err}:{k}")
    assert set(port.history) == set(ref.history), err
    assert isinstance(port.theta, torch.Tensor)
    if theta:
        np.testing.assert_allclose(_np(port.theta), np.asarray(ref.theta),
                                   atol=TOL, rtol=0, err_msg=f"{err}:theta")


@pytest.mark.parametrize("backend", ["simulator", "spmd"])
def test_sharded_fit_matches_the_unsharded_reference(shard_problem,
                                                     backend):
    jprob, tprob = shard_problem
    ref = _reference(jprob, backend=backend)
    port = _port(tprob, make_host_mesh(2, 4, device=CPU), backend=backend)
    _assert_layout_change(ref, port, backend)
    assert port.history["comms"][-1] > 0


def test_sharded_fused_fit_takes_k3_against_the_reference_spmd(
        shard_problem, monkeypatch):
    """fused with the gradient primal on a mesh: the megakernel's gate
    keeps the reference's `mesh is None`, so the ring runtime runs with K3
    once per block of the carry, as the reference's fused backend would
    fall back to its spmd runtime."""
    from repro_torch.api import backends as port_backends

    jprob, tprob = shard_problem
    calls = []
    real = k3_ops.coke_fused_update

    def counted(*a, **kw):
        calls.append(tuple(a[0].shape))
        return real(*a, **kw)
    monkeypatch.setattr(k3_ops, "coke_fused_update", counted)
    monkeypatch.setattr(port_backends, "coke_megastep", None)
    ref = _reference(jprob, backend="spmd", primal="gradient")
    port = _port(tprob, make_host_mesh(2, 4, device=CPU), backend="fused",
                 primal="gradient")
    _assert_layout_change(ref, port, "fused")
    assert len(calls) == 8 * SHARD["num_iters"]
    assert set(calls) == {(2, 16)}


def test_sharded_logistic_fused_fit_matches_the_reference(shard_problem):
    jprob, _ = shard_problem
    y = np.asarray(jprob.labels)
    lab = np.where(y > np.median(y), 1.0, -1.0).astype(np.float32)
    jlog = dataclasses.replace(jprob, labels=jnp.asarray(lab),
                               loss="logistic")
    tlog = convert.problem_from_numpy(
        np.asarray(jlog.feats), lab, np.asarray(jlog.adjacency), jlog.lam,
        jlog.rho, loss="logistic", device=CPU)
    kw = dict(primal="gradient", censor_v=0.03, censor_mu=0.8,
              num_iters=20)
    ref = _reference(jlog, backend="spmd", **kw)
    port = _port(tlog, make_host_mesh(2, 4, device=CPU), backend="fused",
                 **kw)
    _assert_layout_change(ref, port, "fused:logistic")


@pytest.mark.parametrize("backend", ["simulator", "spmd"])
def test_sharded_chain_fit_keeps_the_reference_bits(shard_problem, backend):
    """Censor, Quantize(8), Drop(0.05) on a mesh: each draw is made once
    over the unsharded shape and split into the blocks, so comms and bits
    equal the reference's unsharded chain fit. On the simulator one
    stochastic rounding flips between iterations 20 and 30 (the sharded
    psum moves an innovation by an ulp; ROADMAP.md "Differences by
    design"): theta is held over the first 20 iterations, the bits over
    all 30."""
    jprob, tprob = shard_problem
    jchain = japi.Chain([japi.Censor(0.3, 0.97), japi.Quantize(8),
                         japi.Drop(0.05)])
    tchain = tapi.Chain([tapi.Censor(0.3, 0.97), tapi.Quantize(8),
                         tapi.Drop(0.05)])
    mesh = make_host_mesh(2, 4, device=CPU)
    kw = dict(backend=backend, censor_v=None, censor_mu=None)
    ref = _reference(jprob, comm=jchain, **kw)
    port = _port(tprob, mesh, comm=tchain, **kw)
    _assert_layout_change(ref, port, f"chain:{backend}",
                          theta=backend == "spmd")
    if backend == "simulator":
        ref20 = _reference(jprob, comm=jchain, num_iters=20, **kw)
        port20 = _port(tprob, mesh, comm=tchain, num_iters=20, **kw)
        _assert_layout_change(ref20, port20, "chain:simulator:20")


def test_feature_dim_that_does_not_divide_stays_whole():
    """D = 66 on a 4-wide model axis: the feature dim is replicated, the
    agent dim still cut over data; the fit is the reference's."""
    krr = dict(KRR, num_features=66)
    jprob = jax_build_problem(JFitConfig(krr=JKRRConfig(**krr),
                                         **SHARD)).problem
    tprob = convert.problem_from_numpy(
        np.asarray(jprob.feats), np.asarray(jprob.labels),
        np.asarray(jprob.adjacency), jprob.lam, jprob.rho, device=CPU)
    mesh = make_host_mesh(2, 4, device=CPU)
    fs, _, _ = sharding.problem_specs(tprob, mesh)
    assert tuple(fs) == ("data", None, None)
    ref = jax_fit(JFitConfig(krr=JKRRConfig(**krr),
                             **dict(SHARD, backend="spmd")), problem=jprob)
    port = fit(FitConfig(krr=KRRConfig(**krr), **dict(SHARD,
                                                      backend="spmd")),
               problem=tprob, device=CPU, mesh=mesh)
    _assert_layout_change(ref, port, "D=66")


def test_data_axis_one_against_two(shard_problem):
    """(1, 4) and (2, 4) meshes: the same run to fp32 rounding, comms and
    bits equal (the agent cut moves no sum)."""
    _, tprob = shard_problem
    kw = dict(backend="simulator", primal="cholesky")
    one = _port(tprob, make_host_mesh(1, 4, device=CPU), **kw)
    two = _port(tprob, make_host_mesh(2, 4, device=CPU), **kw)
    for k in ("comms", "bits"):
        assert torch.equal(one.history[k], two.history[k])
    torch.testing.assert_close(one.theta, two.theta, rtol=0, atol=TOL)


def test_topology_schedule_and_gradient_primal_on_a_mesh():
    """A TopologySchedule on the simulator (Cholesky, a factor stack per
    graph, gathered per agent block) and spmd, and the simulator's
    gradient primal, against the reference's unsharded runs."""
    from repro.core.graph import TopologySchedule as JTS

    from repro_torch.core.graph import TopologySchedule as TS
    krr = dict(KRR, num_agents=8)
    kw = dict(SHARD, num_iters=12)
    jprob = jax_build_problem(JFitConfig(krr=JKRRConfig(**krr),
                                         **kw)).problem
    tprob = convert.problem_from_numpy(
        np.asarray(jprob.feats), np.asarray(jprob.labels),
        np.asarray(jprob.adjacency), jprob.lam, jprob.rho, device=CPU)
    mesh = make_host_mesh(2, 4, device=CPU)
    for backend, extra in (("simulator", dict(primal="cholesky")),
                           ("spmd", {}),
                           ("simulator", dict(primal="gradient",
                                              inner_steps=3))):
        topo = "gradient" not in extra.values()
        jx = dict(kw, backend=backend, **extra)
        tx = dict(jx)
        if topo:
            jx["topology"] = JTS.circulant_cycle(8, [(1,), (1, 2)])
            tx["topology"] = TS.circulant_cycle(8, [(1,), (1, 2)])
        ref = jax_fit(JFitConfig(krr=JKRRConfig(**krr), **jx), problem=jprob)
        port = fit(FitConfig(krr=KRRConfig(**krr), **tx), problem=tprob,
                   device=CPU, mesh=mesh)
        _assert_layout_change(ref, port, f"{backend}:{extra}")


def test_cta_oracle_and_online_solvers_on_a_mesh(shard_problem):
    """The other batch solvers through fit(mesh=): cta on both backends,
    the ridge oracle (it gathers Phi: the centralized solve) and the
    online family over the rotating window, against the reference."""
    jprob, tprob = shard_problem
    mesh = make_host_mesh(2, 4, device=CPU)
    for backend, alg, n in (("simulator", "cta", 10), ("spmd", "cta", 10),
                            ("simulator", "ridge_oracle", 1),
                            ("simulator", "online_coke", 10)):
        kw = dict(algorithm=alg, primal="auto", num_iters=n,
                  backend=backend, cta_lr=0.3)
        ref = _reference(jprob, **kw)
        port = _port(tprob, mesh, **kw)
        _assert_layout_change(ref, port, f"{backend}:{alg}",
                              theta=alg != "ridge_oracle")
        if alg == "ridge_oracle":   # the closed form's own tolerance
            np.testing.assert_allclose(_np(port.theta),
                                       np.asarray(ref.theta), atol=1e-4)


@pytest.mark.parametrize("backend", ["simulator", "spmd"])
def test_fit_places_the_problem_once(shard_problem, monkeypatch, backend):
    """fit(mesh=) blocks Phi once, before any runner is made: every
    runner of a scheduled fit reads the same blocks, and a problem the
    caller placed already is used as it is (no second copy of Phi)."""
    fit_mod = importlib.import_module("repro_torch.api.fit")
    from repro_torch.core.graph import TopologySchedule as TS
    _, tprob = shard_problem
    mesh = make_host_mesh(2, 4, device=CPU)
    seen = []
    for name in ("_simulator_runner", "consensus_runner"):
        real = getattr(fit_mod, name)

        def spy(*a, _real=real, **k):
            seen.append(a[1] if _real.__name__ == "_simulator_runner"
                        else a[2])
            return _real(*a, **k)
        monkeypatch.setattr(fit_mod, name, spy)
    cfg = FitConfig(krr=KRRConfig(**KRR), **dict(
        SHARD, num_iters=4, backend=backend,
        topology=TS.circulant_cycle(4, [(1,), (1,)])))
    placed = sharding.shard_problem(tprob, mesh)
    for prob in (tprob, placed):
        seen.clear()
        fit(cfg, problem=prob, device=CPU, mesh=mesh)
        assert seen and all(isinstance(p.feats, sharding.Blocked)
                            for p in seen)
        assert len({id(p.feats) for p in seen}) == 1
    assert seen[0].feats is placed.feats


def test_a_mesh_over_several_devices_is_not_laid_out():
    """A process drives one card: a mesh whose own cells (every cell,
    without a group) lie on two devices is refused where it is built, and
    by the layout."""
    with pytest.raises(ValueError, match="one process per card"):
        tmesh.Mesh(np.array([[torch.device(CPU), torch.device("meta")]],
                            dtype=object), ("data", "model"))
    mesh = tmesh.Mesh.__new__(tmesh.Mesh)
    mesh.distinct_devices = lambda: [CPU, torch.device("meta")]
    with pytest.raises(ValueError, match="one process per card"):
        sharding.mesh_device(mesh)


def test_mesh_devices_must_be_the_fit_device(shard_problem):
    _, tprob = shard_problem
    cfg = FitConfig(krr=KRRConfig(**KRR), **dict(SHARD, num_iters=1))
    odd = tmesh.Mesh(np.full((1, 1), torch.device("cuda", 0), dtype=object),
                     ("data", "model")) if torch.cuda.is_available() else None
    if odd is None:
        odd = tmesh.Mesh.__new__(tmesh.Mesh)
        odd.distinct_devices = lambda: [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="fit runs on cpu"):
        fit(cfg, problem=tprob, device=CPU, mesh=odd)


# ---------------------------------------------------------------------------
# Deploy and serve
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(shard_problem):
    """(reference KernelModel, port copy) of the sharded-test fit."""
    jb = jax_build_problem(JFitConfig(krr=JKRRConfig(**KRR), **SHARD))
    jm = jax_fit(JFitConfig(krr=JKRRConfig(**KRR), **SHARD),
                 problem=jb.problem).to_model(jb.rff_params)
    tm = convert.model_from_numpy(
        {k: np.asarray(v) for k, v in jm._array_tree().items()},
        {"mapping": jm.rff_params.mapping, "bandwidth": jm.bandwidth},
        device=CPU)
    return jm, tm, np.asarray(jb.x_test).reshape(
        -1, jb.x_test.shape[-1])[:40], jb


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_sharded_model_scores_as_the_reference(models, backend):
    jm, tm, x, jb = models
    sm = tm.shard(make_host_mesh(2, 4, device=CPU))
    assert isinstance(sm.theta, sharding.Blocked)
    np.testing.assert_allclose(_np(sm.predict(x, backend=backend)),
                               np.asarray(jm.predict(x, backend=backend)),
                               atol=TOL)
    np.testing.assert_allclose(
        _np(sm.predict(x, backend=backend, agent=1)),
        np.asarray(jm.predict(x, backend=backend, agent=1)), atol=TOL)
    xa = np.asarray(jb.x_test)[:, :7]
    ya = np.asarray(jb.y_test)[:, :7]
    got, want = sm.evaluate(xa, ya, backend=backend), \
        jm.evaluate(xa, ya, backend=backend)
    for k in ("test_mse", "consensus_mse"):
        assert abs(got[k] - float(want[k])) <= TOL * max(1.0, float(want[k]))
    np.testing.assert_allclose(_np(got["per_agent_mse"]),
                               np.asarray(want["per_agent_mse"]), atol=TOL)
    rows = np.random.default_rng(3).normal(size=(40, 64)).astype(np.float32)
    np.testing.assert_allclose(
        _np(sm.score_rows(x, rows, backend=backend)),
        np.asarray(jm.score_rows(x, rows, backend=backend)), atol=TOL)
    # the artifact saves whole
    assert sm._array_tree()["theta"].shape == (64,)


def test_cos_sin_model_pairs_its_halves():
    """cos_sin with L = 6 (does not divide 4: omega whole) and D = 12
    (divides: theta cut). The cos and sin halves of one omega column are
    not one theta block; phi is made whole and cut as theta is."""
    g = np.random.default_rng(4)
    omega = g.normal(size=(5, 6)).astype(np.float32)
    bias = g.uniform(size=6).astype(np.float32)
    theta = g.normal(size=12).astype(np.float32)
    thetas = g.normal(size=(4, 12)).astype(np.float32)
    jm = japi.KernelModel(
        rff_params=__import__("repro.core.rff", fromlist=["RFFParams"])
        .RFFParams(omega=jnp.asarray(omega), bias=jnp.asarray(bias),
                   mapping="cos_sin"),
        theta=jnp.asarray(theta), thetas=jnp.asarray(thetas))
    tm = convert.model_from_numpy(
        {"omega": omega, "bias": bias, "theta": theta, "thetas": thetas},
        {"mapping": "cos_sin"}, device=CPU)
    sm = tm.shard(make_host_mesh(2, 4, device=CPU))
    assert not isinstance(sm.omega, sharding.Blocked)
    assert tuple(sm.theta.spec) == ("model",)
    x = g.normal(size=(9, 5)).astype(np.float32)
    np.testing.assert_allclose(_np(sm.predict(x)), np.asarray(jm.predict(x)),
                               atol=TOL)
    rows = g.normal(size=(9, 12)).astype(np.float32)
    np.testing.assert_allclose(_np(sm.score_rows(x, rows)),
                               np.asarray(jm.score_rows(x, rows)), atol=TOL)
    with pytest.raises(ValueError, match="cos_bias"):
        sm.predict(x, backend="fused")


def _theta(d, seed):
    return np.random.default_rng(seed).normal(size=d).astype(np.float32)


def test_sharded_store_lru_pin_fault_and_copy_on_write():
    """The store's semantics on a (2, 4) mesh, as on one block: LRU
    order, pins, faults, dirty writeback of a gathered (whole) row, and
    copy on write: a snapshot's blocks never change under a put."""
    mesh = make_host_mesh(2, 4, device=CPU)
    backing = {"x": (np.full(8, 9.0, np.float32), 3)}
    published = {}

    def writeback(mid, theta, version):
        assert isinstance(theta, torch.Tensor) and theta.shape == (8,)
        published[mid] = _np(theta).copy()
        return (version or 0) + 1

    store = ThetaStore(3, 8, device=CPU, mesh=mesh,
                       fault=lambda mid: backing[mid], writeback=writeback)
    for name in ("a", "b", "c"):
        store.put(name, _theta(8, ord(name)))
    snap, slots, _ = store.lookup_batch(["a", "b"])
    kept = {k: t.clone() for k, t in snap.blocks.items()}
    store.ensure("a")
    store.pin("b")
    store.put("d", _theta(8, 1), dirty=True)     # evicts c (b is pinned)
    assert store.resident() == ["b", "a", "d"]
    store.unpin("b")
    store.put_many(["a", "e"], np.stack([_theta(8, 7), _theta(8, 8)]))
    for k, t in snap.blocks.items():             # the snapshot held still
        assert torch.equal(t, kept[k])
    np.testing.assert_array_equal(_np(snap)[slots[0]], _theta(8, ord("a")))
    now, s2, _ = store.lookup_batch(["d", "a", "e"])   # d becomes LRU
    np.testing.assert_array_equal(
        _np(now)[s2], np.stack([_theta(8, 1), _theta(8, 7), _theta(8, 8)]))
    store.ensure("x")                            # evicts dirty d: writeback
    np.testing.assert_array_equal(published["d"], _theta(8, 1))
    assert store.version_of("x") == 3 and store.stats()["writebacks"] == 1
    assert isinstance(store.stack, sharding.Blocked)
    assert all(t.shape == (3, 2) for t in store.stack.blocks.values())


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_sharded_server_answers_bitwise_score_rows(models, backend):
    """KernelServer(mesh=): every answer bitwise the sharded model's
    score_rows at the request's own row count, within 1e-5 of the
    reference KernelServer(model) (its default 1x1 mesh), single- and
    multi-tenant; the buckets are rounded up to the batch extent."""
    jm, tm, x, _ = models
    mesh = make_host_mesh(2, 4, device=CPU)
    sm = tm.shard(mesh)
    cfg = dict(backend=backend, buckets=(3, 8, 32))
    with JKernelServer(jm, JKernelServeConfig(**cfg)) as jsrv:
        jwant = np.asarray(jsrv.predict(x))
    with KernelServer(sm, KernelServeConfig(**cfg), mesh=mesh,
                      device=CPU) as srv:
        assert srv._buckets == (4, 8, 32)
        got = srv.predict(x)
    np.testing.assert_allclose(got, jwant, atol=TOL)
    np.testing.assert_allclose(got, _np(tm.predict(x, backend=backend)),
                               atol=TOL)
    store = ThetaStore(4, 64, device=CPU, mesh=mesh)
    thetas = [_theta(64, 10 + i) for i in range(3)]
    with KernelServer(sm, KernelServeConfig(**cfg), mesh=mesh, store=store,
                      device=CPU) as srv:
        for i, th in enumerate(thetas):
            srv.publish(f"m{i}", th)
        reqs = [(f"m{i % 3}", x[i:i + 1 + i % 4]) for i in range(12)]
        reqs.append(("m1", x[:3]))
    srv = KernelServer(sm, KernelServeConfig(**cfg), mesh=mesh, store=store,
                       device=CPU, autostart=False)
    futs = [srv.submit(xx, mid) for mid, xx in reqs]
    srv.start()
    outs = [f.result(timeout=TIMEOUT) for f in futs]
    alone = srv.submit(x[:3], "m1").result(timeout=TIMEOUT)
    srv.stop()
    for (mid, xx), out in zip(reqs, outs):
        th = np.broadcast_to(thetas[int(mid[1])], (xx.shape[0], 64))
        np.testing.assert_array_equal(
            out, _np(sm.score_rows(xx, th, backend=backend)), err_msg=mid)
        np.testing.assert_allclose(
            out, np.asarray(jm.score_rows(xx, th, backend=backend)),
            atol=TOL)
    # one request alone, bitwise the same request inside a full bucket
    np.testing.assert_array_equal(alone, outs[-1])


def test_hot_swap_under_fire_on_a_mesh(models):
    """Publishes on a sharded store while clients score: every answer is
    exactly one published version's sharded score_rows, none torn
    between blocks of two versions."""
    _, tm, x, _ = models
    mesh = make_host_mesh(2, 4, device=CPU)
    sm = tm.shard(mesh)
    xq = x[:4]
    versions = [_theta(64, 50 + k) for k in range(6)]
    refs = [_np(sm.score_rows(xq, np.broadcast_to(v, (4, 64))))
            for v in versions]
    server = KernelServer(sm, KernelServeConfig(max_delay_ms=0.5),
                          mesh=mesh, device=CPU,
                          store=ThetaStore(8, 64, device=CPU, mesh=mesh))
    server.publish("u", versions[0])
    results, failures = [], []

    def client():
        for _ in range(20):
            try:
                results.append(server.submit(xq, "u").result(
                    timeout=TIMEOUT))
            except Exception as e:  # noqa: BLE001 - recorded and asserted
                failures.append(e)

    threads = [threading.Thread(target=client) for _ in range(3)]
    for t in threads:
        t.start()
    for v in versions[1:]:
        server.publish("u", v)
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    server.stop()
    assert not failures and len(results) == 60
    for out in results:
        assert any(np.array_equal(out, r) for r in refs), "torn read"


def test_sharded_scorer_with_a_feature_dim_that_does_not_divide():
    """D = 66 on a (2, 4) mesh: theta and the stack stay whole, only the
    bucket's rows are cut; answers bitwise the sharded score_rows, within
    1e-5 of the unsharded model."""
    g = torch.Generator().manual_seed(5)
    p = rff.draw_rff(g, 5, 66)
    m = KernelModel(p, torch.randn(66, generator=g))
    mesh = make_host_mesh(2, 4, device=CPU)
    sm = m.shard(mesh)
    assert not isinstance(sm.theta, sharding.Blocked)
    x = np.random.default_rng(6).uniform(size=(10, 5)).astype(np.float32)
    rows = np.random.default_rng(7).normal(size=(10, 66)).astype(np.float32)
    for backend in ("ref", "fused"):
        np.testing.assert_allclose(
            _np(sm.score_rows(x, rows, backend=backend)),
            _np(m.score_rows(x, rows, backend=backend)), atol=TOL)
    store = ThetaStore(4, 66, device=CPU, mesh=mesh)
    assert isinstance(store.stack, torch.Tensor)
    with KernelServer(sm, KernelServeConfig(backend="fused"), mesh=mesh,
                      store=store, device=CPU) as srv:
        srv.publish("a", rows[0])
        out = srv.predict(x[:3], "a")
    np.testing.assert_array_equal(out, _np(sm.score_rows(
        x[:3], np.broadcast_to(rows[0], (3, 66)), backend="fused")))
