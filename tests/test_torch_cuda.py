"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card, and the LM's prefill through K4 there. These need a CUDA card
and skip elsewhere; the file imports only torch, numpy and repro_torch, so
it runs on a machine without jax:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: fp32 with another summation order than cuBLAS or the plain
softmax; bf16 within an ulp of bf16 (see the comments beside each).
"""
import math

import numpy as np
import pytest
import torch

import dataclasses

from repro_torch.api import FitConfig, KRRConfig, build_problem, fit
from repro_torch.kernels.coke_update import coke_update as k2
from repro_torch.kernels.coke_update.ref import (coke_megastep_ref,
                                                 coke_update_ref,
                                                 xi_sq_in_kernel_order)
from repro_torch.kernels.flash_attention import flash_attention as k4
from repro_torch.kernels.flash_attention import flash_attention_bwd as k7
from repro_torch.kernels.flash_attention.ops import gqa_flash
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rff import rff as k1
from repro_torch.kernels.rff.ref import rff_ref

# phi: the kernel's fmaf chain and cuBLAS round the projection x @ omega
# (|.| < ~20 for x in [0, 1], d <= 96) differently; cos passes a few ulps
# of it on, times sqrt(2/L) <= 0.25
RFF_ATOL = 1e-5
# theta', xi_sq: fp32 sums of T*D products in another order
MEGA_RTOL = 1e-5

RFF_SHAPES = [(64, 5, 32), (300, 77, 100), (128, 96, 200), (33, 13, 50),
              (1000, 5, 513),
              # M = 1; M not a multiple of the 4-row tile
              (1, 5, 4096), (1001, 5, 4096),
              # L one past a strip: 4096 columns at d = 5 (bulk), 252 at
              # d = 96 (bulk at 256, 4-byte at 253)
              (257, 5, 4100), (300, 96, 256), (1000, 96, 253),
              # d = 96 at L = 4096: 17 strips of 252 columns
              (1001, 96, 4096),
              # the predict shape: 30 000 held-out rows, one whole-row strip
              (30000, 5, 4096)]
MEGA_SHAPES = [(4, 40, 32, (1,)), (2, 33, 513, (1,)), (8, 64, 100, (1, 2)),
               (3, 17, 128, (1,)), (5, 128, 256, (2,)), (20, 350, 4096, (1,)),
               # block ranges that cross agent boundaries (875 stages of 8
               # rows over 132 blocks)
               (7, 1000, 256, (1,)),
               # more agents than SMs, small T and D
               (200, 5, 64, (1, 3)),
               # T = 1: one short stage per agent
               (6, 1, 128, (1,)),
               # wide D: the widest instance, 64 columns a thread
               (3, 8, 16384, (1,)),
               # the widest D the earlier two-launch design took on an H100
               # (3 D 4 bytes <= 232448), unaligned: two one-row stages
               (2, 5, 19370, (1,)),
               # unaligned D over several stages per agent
               (4, 50, 1001, (1,))]
# K3: g_aug is formed in the plain expression's order with round-to-nearest
# intrinsics, so it may differ from the plain version only where a compiler
# contracted a product into an FMA: a few ulps of the largest term. xi_sq
# is an fp32 sum over D in another order.
UPDATE_ULPS = 4 * 2.0**-23
UPDATE_XI_RTOL = 1e-5
UPDATE_SHAPES = [(1, 1, 2.0), (3, 513, 2.0), (7, 1000, 4.0), (3, 512, 4.0),
                 (20, 4096, 2.0),
                 # the streaming shape: clusters of 8 blocks of 8192 features
                 (20, 65536, 2.0),
                 # ragged D over a cluster of 8: the last block 487 features
                 (20, 4099, 2.0),
                 # N = 1: one cluster of 8 blocks on the whole card
                 (1, 8192, 4.0),
                 # N above the SM count: clusters of one block
                 (200, 1024, 2.0)]


@pytest.fixture
def cuda():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there")
    return torch.device("cuda")


def _gen(device, seed=0):
    return torch.Generator(device=device).manual_seed(seed)


@pytest.mark.parametrize("T,d,L", RFF_SHAPES, ids=str)
def test_rff_kernel_matches_plain(cuda, T, d, L):
    g = _gen(cuda)
    x = torch.rand((T, d), generator=g, device=cuda)
    omega = torch.randn((d, L), generator=g, device=cuda)
    bias = torch.rand((L,), generator=g, device=cuda) * (2 * math.pi)
    before = k1.LAUNCHES
    got = k1.rff_cos_bias(x, omega, bias)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1
    torch.testing.assert_close(got, rff_ref(x, omega, bias), rtol=0,
                               atol=RFF_ATOL)


@pytest.mark.parametrize("T,d,L,instance", [
    (1000, 5, 4096, "bulk"), (1001, 96, 4096, "bulk"),
    (1000, 5, 513, "4-byte"), (1000, 96, 253, "4-byte")], ids=str)
def test_rff_kernel_is_deterministic(cuda, T, d, L, instance):
    """Each output is written once by one thread in a fixed order: two
    calls give the same bits, in both instances."""
    g = _gen(cuda, 2)
    x = torch.rand((T, d), generator=g, device=cuda)
    omega = torch.randn((d, L), generator=g, device=cuda)
    bias = torch.rand((L,), generator=g, device=cuda) * (2 * math.pi)
    first = k1.rff_cos_bias(x, omega, bias)
    assert k1.rff_staging(L, first) == instance
    assert k1.rff_device_plan(T, d, L, first).instance == instance
    second = k1.rff_cos_bias(x, omega, bias)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_rff_cosine_is_cosf_on_every_fp32_value(cuda):
    """The kernel writes cosf's fast path out without its branch; on all
    2^32 bit patterns its cosine gives cosf's bits."""
    assert k1.rff_cos_mismatches(cuda) == (0, None)


def test_rff_too_large_d_raises_before_any_launch(cuda):
    x = torch.rand((4, 7000), device=cuda)
    omega = torch.randn((7000, 16), device=cuda)
    bias = torch.rand((16,), device=cuda)
    before = k1.LAUNCHES
    with pytest.raises(ValueError, match="too large"):
        k1.rff_cos_bias(x, omega, bias)
    assert k1.LAUNCHES == before


def _mega_operands(cuda, n, t, d, seed=1, misalign=False):
    g = _gen(cuda, seed)
    theta, hat = (torch.randn((n, d), generator=g, device=cuda)
                  for _ in range(2))
    gamma = 0.1 * torch.randn((n, d), generator=g, device=cuda)
    if misalign:   # contiguous, but 4 bytes off 16-byte alignment
        phi = torch.randn(n * t * d + 1, generator=g,
                          device=cuda)[1:].view(n, t, d)
    else:
        phi = torch.randn((n, t, d), generator=g, device=cuda)
    y = torch.randn((n, t), generator=g, device=cuda)
    return theta, hat, gamma, phi, y


def _check_megastep(cuda, n, t, d, offsets, misalign=False):
    theta, hat, gamma, phi, y = _mega_operands(cuda, n, t, d,
                                               misalign=misalign)
    kw = dict(rho=0.3, lam=1e-2, lr=0.05, offsets=offsets)
    want = coke_megastep_ref(theta, hat, gamma, phi, y,
                             return_resid_sq=True, **kw)
    rsq = torch.full((n,), float("nan"), device=cuda)
    before = k2.LAUNCHES
    got, xi = k2.coke_megastep(theta, hat, gamma, phi, y, resid_sq=rsq,
                               **kw)
    torch.cuda.synchronize()
    assert got is theta                       # written in place
    assert k2.LAUNCHES == before + k2.LAUNCHES_PER_CALL
    for w, o in zip(want, (got, xi, rsq)):
        scale = float(w.abs().max())
        torch.testing.assert_close(o, w, rtol=MEGA_RTOL,
                                   atol=MEGA_RTOL * scale)


@pytest.mark.parametrize("n,t,d,offsets", MEGA_SHAPES, ids=str)
def test_megastep_kernel_matches_plain(cuda, n, t, d, offsets):
    """theta', xi_sq and resid_sq against the plain version; D % 4 != 0
    takes the cp.async instance, the rest the bulk-copy one."""
    phi = torch.empty((n, t, d), device=cuda)
    assert k2.megastep_staging(phi) == ("bulk" if d % 4 == 0
                                        else "cp.async")
    _check_megastep(cuda, n, t, d, offsets)


@pytest.mark.parametrize("n,t,d", [(4, 40, 32), (7, 1000, 256),
                                   (20, 350, 4096)], ids=str)
def test_megastep_unaligned_phi_takes_the_cp_async_instance(cuda, n, t, d):
    phi = torch.empty(n * t * d + 1, device=cuda)[1:].view(n, t, d)
    assert k2.megastep_staging(phi) == "cp.async"
    _check_megastep(cuda, n, t, d, (1,), misalign=True)


@pytest.mark.parametrize("n,t,d,misalign", [
    (20, 350, 4096, False), (7, 1000, 256, False), (2, 33, 513, False),
    (20, 350, 4096, True)], ids=str)
def test_megastep_kernel_is_deterministic(cuda, n, t, d, misalign):
    """No floating-point atomics: two calls on the same inputs give the
    same bits, with and without the resid_sq output."""
    theta, hat, gamma, phi, y = _mega_operands(cuda, n, t, d, seed=3,
                                               misalign=misalign)
    kw = dict(rho=0.3, lam=1e-2, lr=0.05, offsets=(1,))
    outs = []
    for with_rsq in (False, True, True):
        rsq = torch.empty((n,), device=cuda) if with_rsq else None
        th, xi = k2.coke_megastep(theta.clone(), hat, gamma, phi, y,
                                  resid_sq=rsq, **kw)
        outs.append((th, xi, rsq))
    torch.cuda.synchronize()
    for th, xi, _ in outs[1:]:
        assert torch.equal(th, outs[0][0]) and torch.equal(xi, outs[0][1])
    assert torch.equal(outs[1][2], outs[2][2])


def test_megastep_too_wide_raises_before_any_launch(cuda):
    theta, hat, gamma, phi, y = _mega_operands(cuda, 2, 1, 20484)
    before = k2.LAUNCHES
    with pytest.raises(ValueError, match="too wide"):
        k2.coke_megastep(theta, hat, gamma, phi, y, rho=0.3, lam=1e-2,
                         lr=0.05)
    assert k2.LAUNCHES == before


def test_kernels_raise_on_operands_they_do_not_take(cuda):
    x = torch.rand((8, 5), device=cuda)
    omega = torch.randn((5, 16), device=cuda)
    bias = torch.rand((16,), device=cuda)
    with pytest.raises(TypeError):
        k1.rff_cos_bias(x.double(), omega.double(), bias.double())
    with pytest.raises(ValueError):
        k1.rff_cos_bias(x, omega.t().contiguous().t(), bias)


def test_small_fit_on_card_matches_cpu(cuda):
    """The whole slice on the card against its plain run on the CPU:
    equal comms and bits, theta and trajectories close."""
    cfg = FitConfig(krr=KRRConfig(num_agents=4, samples_per_agent=40,
                                  num_features=32, lam=1e-2, rho=0.1),
                    graph="ring", censor_v=0.3, censor_mu=0.97,
                    num_iters=40, primal="gradient", inner_lr=0.05,
                    backend="fused")
    built = build_problem(cfg, device="cpu")
    for alg in ("coke", "dkla"):
        c = cfg.replace(algorithm=alg)
        cpu = fit(c, problem=built.problem, device="cpu")
        gpu = fit(c, problem=built.problem, device=cuda)
        for k in ("comms", "bits"):
            np.testing.assert_array_equal(gpu.history[k].cpu().numpy(),
                                          cpu.history[k].numpy())
        torch.testing.assert_close(gpu.theta.cpu(), cpu.theta, rtol=0,
                                   atol=1e-5)
        model = gpu.to_model(built.rff_params.to(cuda))
        torch.testing.assert_close(
            model.predict(built.x_test, backend="fused").cpu(),
            model.predict(built.x_test, backend="ref").cpu(),
            rtol=0, atol=1e-5)


def _update_operands(cuda, n, d, seed=2, misalign=False):
    g = _gen(cuda, seed)
    out = []
    for _ in range(6):
        if misalign:   # contiguous, but 4 bytes off 16-byte alignment
            out.append(torch.randn(n * d + 1, generator=g,
                                   device=cuda)[1:].view(n, d))
        else:
            out.append(torch.randn((n, d), generator=g, device=cuda))
    return out


@pytest.mark.parametrize("misalign", [False, True], ids=["vec", "scalar"])
@pytest.mark.parametrize("n,d,deg", UPDATE_SHAPES, ids=str)
def test_fused_update_kernel_matches_plain(cuda, n, d, deg, misalign):
    ops = _update_operands(cuda, n, d, misalign=misalign)
    kw = dict(rho=0.37, deg=deg)
    want, want_xi = coke_update_ref(*ops, **kw)
    before = k2.FUSED_UPDATE_LAUNCHES
    got, xi = k2.coke_fused_update(*ops, **kw)
    torch.cuda.synchronize()
    assert k2.FUSED_UPDATE_LAUNCHES == before + 1      # one launch per call
    th, hat, gm, gr, l, r = ops
    scale = max(float(t.abs().max()) for t in (
        gr, 2.0 * 0.37 * deg * th, gm, 0.37 * (deg * hat + l + r)))
    torch.testing.assert_close(got, want, rtol=0, atol=UPDATE_ULPS * scale)
    torch.testing.assert_close(xi, want_xi, rtol=UPDATE_XI_RTOL,
                               atol=UPDATE_XI_RTOL * float(want_xi.max()))


@pytest.mark.parametrize("misalign", [False, True], ids=["vec", "scalar"])
@pytest.mark.parametrize("n,d,deg", UPDATE_SHAPES, ids=str)
def test_fused_update_one_neighbour_read_gives_the_two_read_bits(
        cuda, n, d, deg, misalign):
    """One tensor as both neighbour operands (read once by the kernel)
    gives the bits of the same values in two distinct tensors, and its
    xi_sq has the bits of the CPU emulation of the kernel's order."""
    ops = _update_operands(cuda, n, d, seed=3, misalign=misalign)
    aliased = ops[:5] + [ops[4]]
    distinct = ops[:5] + [ops[4].clone()]
    plan, vec, shared = k2.fused_update_launch(aliased)
    assert shared and not k2.fused_update_launch(distinct)[2]
    assert vec == (not misalign and d % 4 == 0)
    kw = dict(rho=0.37, deg=deg)
    got, xi = k2.coke_fused_update(*aliased, **kw)
    want, want_xi = k2.coke_fused_update(*distinct, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(xi, want_xi)
    emulated = xi_sq_in_kernel_order(ops[0].cpu(), ops[1].cpu(), plan,
                                     vec=vec)
    assert torch.equal(xi.cpu(), emulated)


@pytest.mark.parametrize("aliased", [False, True], ids=["two", "one"])
@pytest.mark.parametrize("misalign", [False, True], ids=["vec", "scalar"])
@pytest.mark.parametrize("n,d,deg", UPDATE_SHAPES, ids=str)
def test_fused_update_xi_sq_follows_its_order(cuda, n, d, deg, misalign,
                                              aliased):
    """xi_sq is finished on the card in a fixed order (thread steps, warp
    shuffle tree, warps, cluster ranks): bitwise the CPU emulation of that
    order, and two calls give the same bits."""
    ops = _update_operands(cuda, n, d, seed=4, misalign=misalign)
    if aliased:
        ops[5] = ops[4]
    plan, vec, _ = k2.fused_update_launch(ops)
    first = k2.coke_fused_update(*ops, rho=0.2, deg=deg)
    second = k2.coke_fused_update(*ops, rho=0.2, deg=deg)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    emulated = xi_sq_in_kernel_order(ops[0].cpu(), ops[1].cpu(), plan,
                                     vec=vec)
    assert torch.equal(first[1].cpu(), emulated)


@pytest.mark.parametrize("n,d", [(20, 4096), (20, 65536), (3, 513)],
                         ids=str)
def test_fused_update_graph_replay_gives_the_eager_bits(cuda, n, d):
    """A call is one launch with no scratch: captured in a CUDA graph and
    replayed, it gives the eager call's bits."""
    ops = _update_operands(cuda, n, d, seed=5)
    ops[5] = ops[4]
    eager = k2.coke_fused_update(*ops, rho=0.1, deg=2.0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k2.coke_fused_update(*ops, rho=0.1, deg=2.0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = k2.FUSED_UPDATE_LAUNCHES
    with torch.cuda.graph(graph):
        captured = k2.coke_fused_update(*ops, rho=0.1, deg=2.0)
    assert k2.FUSED_UPDATE_LAUNCHES == before + 1
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))


def test_fused_update_kernel_raises_on_operands_it_does_not_take(cuda):
    ops = _update_operands(cuda, 3, 40)
    with pytest.raises(TypeError):
        k2.coke_fused_update(*[o.double() for o in ops], rho=0.1)
    with pytest.raises(ValueError):
        k2.coke_fused_update(ops[0].t(), *[o.t() for o in ops[1:]], rho=0.1)


def _classification(problem, loss):
    labels = torch.where(problem.labels > problem.labels.median(), 1.0, -1.0)
    return dataclasses.replace(problem, labels=labels, loss=loss)


def test_ring_runtime_fits_on_card_match_cpu(cuda):
    """spmd fits (coke/dkla/cta) and fused-fallback fits on a logistic
    problem, card against CPU: equal comms and bits, theta close. Only the
    fused fallback launches K3, once per iteration."""
    cfg = FitConfig(krr=KRRConfig(num_agents=4, samples_per_agent=40,
                                  num_features=32, lam=1e-2, rho=0.1),
                    graph="ring", censor_v=0.03, censor_mu=0.8,
                    num_iters=20, primal="gradient", inner_lr=0.05,
                    cta_lr=0.05)
    built = build_problem(cfg, device="cpu")
    logistic = _classification(built.problem, "logistic")
    cases = [("spmd", alg, built.problem) for alg in ("coke", "dkla", "cta")]
    cases += [("fused", alg, logistic) for alg in ("coke", "dkla")]
    for backend, alg, problem in cases:
        c = cfg.replace(backend=backend, algorithm=alg)
        if alg == "cta":
            c = c.replace(censor_v=None, censor_mu=None)
        cpu = fit(c, problem=problem, device="cpu")
        before = (k2.FUSED_UPDATE_LAUNCHES, k2.LAUNCHES)
        gpu = fit(c, problem=problem, device=cuda)
        torch.cuda.synchronize()
        k3 = 20 if backend == "fused" else 0
        assert (k2.FUSED_UPDATE_LAUNCHES, k2.LAUNCHES) == (before[0] + k3,
                                                           before[1])
        for k in ("comms", "bits"):
            np.testing.assert_array_equal(gpu.history[k].cpu().numpy(),
                                          cpu.history[k].numpy())
        torch.testing.assert_close(gpu.theta.cpu(), cpu.theta, rtol=0,
                                   atol=1e-5)


def _kernel_launches():
    return (k1.LAUNCHES, k2.LAUNCHES, k2.FUSED_UPDATE_LAUNCHES, k4.LAUNCHES)


# the simulator on the card against the CPU. cuBLAS and cuSOLVER round in
# another order than ATen's CPU kernels, and 40 Cholesky iterations carry
# that to ~1e-5 (1.4e-5 on the H100 at this size): the card's theta is held
# to its distance from a float64 run, within twice the CPU's distance plus
# the reference's tolerance (Cholesky, CTA, the oracle 1e-5; the CG
# primal's 64 steps 1e-4); CG across backends 2e-4 (tests/test_big_d.py)
SIM_TOL = {"cholesky": 1e-5, "cg": 1e-4, "cta": 1e-5, "ridge_oracle": 1e-5}
SIM_CFG = FitConfig(krr=KRRConfig(num_agents=4, samples_per_agent=40,
                                  num_features=32, lam=1e-2, rho=0.1),
                    graph="ring", censor_v=0.3, censor_mu=0.97, num_iters=40,
                    backend="simulator")


def test_simulator_fits_on_card_match_cpu(cuda):
    """Every solver on the simulator, card against CPU: comms and bits
    equal; the card's theta no further from the float64 run than twice
    the CPU's plus SIM_TOL; no kernel launches (the simulator runs
    none)."""
    built = build_problem(SIM_CFG, device="cpu")
    p = built.problem
    p64 = dataclasses.replace(p, feats=p.feats.double(),
                              labels=p.labels.double(),
                              adjacency=p.adjacency.double())
    cases = [(alg, primal) for alg in ("coke", "dkla")
             for primal in ("cholesky", "cg")]
    cases += [("cta", "cta"), ("ridge_oracle", "ridge_oracle")]
    for alg, primal in cases:
        c = SIM_CFG.replace(algorithm=alg, record_oracle_distance=True)
        if alg in ("coke", "dkla"):
            c = c.replace(primal=primal)
        else:
            c = c.replace(censor_v=None, censor_mu=None)
        cpu = fit(c, problem=built.problem, device="cpu")
        before = _kernel_launches()
        gpu = fit(c, problem=built.problem, device=cuda)
        torch.cuda.synchronize()
        assert _kernel_launches() == before, (alg, primal)
        assert set(gpu.history) == set(cpu.history)
        for k in ("comms", "bits"):
            np.testing.assert_array_equal(gpu.history[k].cpu().numpy(),
                                          cpu.history[k].numpy())
        exact = fit(c, problem=p64, device="cpu").theta
        e_card = float((gpu.theta.cpu().double() - exact).abs().max())
        e_cpu = float((cpu.theta.double() - exact).abs().max())
        assert e_card <= 2 * e_cpu + SIM_TOL[primal], (alg, primal, e_card,
                                                       e_cpu)


def test_simulator_cg_agrees_with_spmd_and_fused_on_card(cuda):
    """primal="cg" (and "auto" past D = 2048, which resolves to it) on the
    simulator, spmd and fused backends, all on the card: comms and bits
    equal, theta within 2e-4; no kernel launches (the ring runtime's CG
    primal bypasses K3, the megakernel gate sends CG fits away from K2)."""
    for d, primal in ((512, "cg"), (2049, "auto")):
        c = SIM_CFG.replace(krr=dataclasses.replace(SIM_CFG.krr,
                                                    num_features=d),
                            primal=primal, num_iters=10)
        problem = build_problem(c, device=cuda).problem
        before = _kernel_launches()
        fits = {b: fit(c.replace(backend=b), problem=problem, device=cuda)
                for b in ("simulator", "spmd", "fused")}
        torch.cuda.synchronize()
        assert _kernel_launches() == before
        sim = fits["simulator"]
        for b in ("spmd", "fused"):
            for k in ("comms", "bits"):
                assert torch.equal(fits[b].history[k], sim.history[k]), (d, b)
            torch.testing.assert_close(fits[b].theta, sim.theta, rtol=0,
                                       atol=2e-4)


def test_simulator_cholesky_matches_cg_on_card(cuda):
    c = SIM_CFG.replace(krr=dataclasses.replace(SIM_CFG.krr,
                                                num_features=512))
    problem = build_problem(c, device=cuda).problem
    chol = fit(c.replace(primal="cholesky"), problem=problem, device=cuda)
    cg = fit(c.replace(primal="cg"), problem=problem, device=cuda)
    assert torch.equal(chol.comms, cg.comms)
    torch.testing.assert_close(chol.theta, cg.theta, rtol=0, atol=1e-4)


def test_simulator_primal_cg_does_not_sync_the_host(cuda):
    """The CG loop's stop test stays on the card: 64 steps with a per-agent
    mask, no read-back. A synchronizing call raises in this mode."""
    from repro_torch.core import admm
    c = SIM_CFG.replace(krr=dataclasses.replace(SIM_CFG.krr,
                                                num_features=256))
    problem = build_problem(c, device=cuda).problem
    g = _gen(cuda, 3)
    n, d = problem.num_agents, problem.feature_dim
    vecs = [0.1 * torch.randn((n, d), generator=g, device=cuda)
            for _ in range(4)]
    terms = admm.primal_terms(problem)
    deg = problem.degrees
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x = admm._primal_cg(problem, *vecs[:3], deg, theta0=vecs[3],
                            terms=terms)
        y = admm._primal_cg(problem, *vecs[:3], theta0=vecs[3])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(x).all()
    torch.testing.assert_close(x, y, rtol=0, atol=0)


def _chip_smoke():
    """chip_smoke.py as a module: its jax-pinned PRNG values (checked
    against jax on the CPU by tests/test_torch_prng.py)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_prng_on_card_is_bitwise_the_cpu_and_jax(cuda):
    """The threefry draws on the card: the CPU's bits, and jax's pinned
    values, for (4,), (20,), (20, 4096) and an odd size above 2^16."""
    from repro_torch.core import prng
    smoke = _chip_smoke()
    for seed, folds, shape, key_want, bits_want in smoke.JAX_PRNG_PINS:
        key = prng.PRNGKey(seed)
        for f in folds:
            key = prng.fold_in(key, f)
        assert key == key_want
        bits = prng.random_bits(key, shape, cuda).cpu()
        assert torch.equal(bits, prng.random_bits(key, shape, "cpu"))
        flat = bits.reshape(-1)
        assert {i: int(flat[i]) for i in bits_want} == bits_want
        u = prng.uniform(key, shape, cuda).cpu()
        assert torch.equal(u.view(torch.int32),
                           prng.uniform(key, shape, "cpu").view(torch.int32))
    u = prng.uniform(prng.fold_in(prng.PRNGKey(0), 3), (4,), cuda).cpu()
    assert tuple(int(v) for v in u.view(torch.int32)) == smoke.JAX_UNIFORM_PIN


THREEFRY_SIZES = [1, 20, 255, 256, 257, 512, 4097, 81920, 262145,
                  # more words than MAX_BLOCKS * THREADS: the grid-stride loop
                  1024 * 256 * 3 + 5]


@pytest.mark.parametrize("n", THREEFRY_SIZES)
def test_threefry_kernel_matches_plain(cuda, n):
    """K5, one launch per draw, bitwise its plain version: uniform floats
    and random_bits words, single keys and (G, 2) key tensors."""
    from repro_torch.core import prng
    from repro_torch.kernels.threefry import threefry as k5
    from repro_torch.kernels.threefry.ref import random_bits_ref, uniform_ref
    key = prng.fold_in(prng.PRNGKey(n), 2**32 - 1)
    cpu = torch.device("cpu")
    before = k5.LAUNCHES
    u = prng.uniform(key, (n,), cuda)
    bits = prng.random_bits(key, (n,), cuda)
    assert k5.LAUNCHES - before == 2
    assert u.dtype == torch.float32 and bits.dtype == torch.int64
    assert torch.equal(u.cpu().view(torch.int32),
                       uniform_ref(key, (n,), cpu).view(torch.int32))
    assert torch.equal(bits.cpu(), random_bits_ref(key, (n,), cpu))
    keys = [prng.fold_in(key, g) for g in range(8)]
    lanes = torch.tensor(keys, dtype=torch.int64, device=cuda)
    ul = prng.uniform(lanes, (n,), cuda).cpu()
    assert k5.LAUNCHES - before == 3
    want = uniform_ref(lanes.cpu(), (n,), cpu)
    assert torch.equal(ul.view(torch.int32), want.view(torch.int32))
    for g in (0, 7):
        assert torch.equal(ul[g].view(torch.int32),
                           uniform_ref(keys[g], (n,), cpu).view(torch.int32))


def test_threefry_kernel_raises_on_operands_it_does_not_take(cuda):
    from repro_torch.core import prng
    with pytest.raises(ValueError, match="int64"):
        prng.uniform(torch.zeros((3, 2), dtype=torch.int32, device=cuda),
                     (4,), cuda)
    with pytest.raises(ValueError, match="lie on"):
        prng.uniform(torch.zeros((3, 2), dtype=torch.int64), (4,), cuda)
    with pytest.raises(OverflowError):
        prng.uniform((2**32, 0), (4,), cuda)
    assert prng.uniform((1, 2), (0, 3), cuda).shape == (0, 3)


def test_chain_fits_on_card_match_cpu(cuda):
    """Chain([Censor, Quantize, Drop]) on the simulator, spmd, the
    megakernel path (K2 twice per iteration) and the fused fallback (K3
    once per iteration), card against CPU: comms and bits equal, every
    quantizer difference a rounding flip (the same draw between the two
    runs' fractional parts), theta within 1e-5 plus the flipped
    coordinates' steps (`chip_smoke.quantizer_flips`). The fit loops run
    with host syncs raising."""
    import importlib

    from repro_torch.api import Censor, Chain, Drop, Quantize
    fit_mod = importlib.import_module("repro_torch.api.fit")
    smoke = _chip_smoke()
    chain = Chain([Censor(0.3, 0.97), Quantize(bits=5, seed=7),
                   Drop(p=0.15, seed=11)])
    cfg = FitConfig(krr=KRRConfig(num_agents=4, samples_per_agent=40,
                                  num_features=32, lam=1e-2, rho=0.1),
                    graph="ring", comm=chain, num_iters=20,
                    primal="gradient", inner_steps=1, inner_lr=0.05)
    built = build_problem(cfg, device="cpu")
    logistic = _classification(built.problem, "logistic")
    cases = [(b, alg, built.problem) for b in ("simulator", "spmd", "fused")
             for alg in ("coke", "dkla")]
    cases += [("fused", alg, logistic) for alg in ("coke", "dkla")]
    real_scan = fit_mod._chunked_scan

    def strict_scan(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_scan(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    fit_mod._chunked_scan = strict_scan
    try:
        for backend, alg, prob in cases:
            c = cfg.replace(algorithm=alg, backend=backend)
            with smoke.QuantizerRecord() as rec_cpu:
                cpu = fit(c, problem=prob, device="cpu")
            before = (k2.LAUNCHES, k2.FUSED_UPDATE_LAUNCHES)
            with smoke.QuantizerRecord() as rec_gpu:
                gpu = fit(c, problem=prob, device=cuda)
            rose = (k2.LAUNCHES - before[0],
                    k2.FUSED_UPDATE_LAUNCHES - before[1])
            want = {("fused", "quadratic"): (40, 0),
                    ("fused", "logistic"): (0, 20)}.get((backend, prob.loss),
                                                        (0, 0))
            assert rose == want, (backend, alg, prob.loss, rose)
            for k in ("comms", "bits"):
                np.testing.assert_array_equal(gpu.history[k].cpu().numpy(),
                                              cpu.history[k].numpy())
            _, _, steps = smoke.quantizer_flips(rec_gpu, rec_cpu)
            torch.testing.assert_close(gpu.theta.cpu(), cpu.theta, rtol=0,
                                       atol=smoke.SMALL_THETA_TOL + steps)
    finally:
        fit_mod._chunked_scan = real_scan


def test_gossip_fits_on_card_match_cpu(cuda):
    """exec="gossip" at participation 0.5 on the simulator, spmd, the
    megakernel path (K2 twice per iteration, the mask after it) and the
    fused fallback (K3 once per iteration), and churn with the CG primal
    on the simulator and spmd, card against CPU, the fit loops with host
    syncs raising: comms and bits equal, theta within 1e-5 (the CG runs
    within 1e-4); the participation draw is one K5 launch per iteration."""
    from repro_torch.api import ChurnSchedule
    from repro_torch.kernels.threefry import threefry as k5
    smoke = _chip_smoke()
    cfg = FitConfig(krr=KRRConfig(num_agents=6, samples_per_agent=40,
                                  num_features=32, lam=1e-2, rho=0.1),
                    graph="ring", censor_v=0.3, censor_mu=0.97,
                    num_iters=20, primal="gradient", inner_steps=1,
                    inner_lr=0.05, exec="gossip", participation=0.5)
    built = build_problem(cfg, device="cpu")
    logistic = _classification(built.problem, "logistic")
    churn = ChurnSchedule(leave=((5, 2),), join=((12, 4), (15, 2)),
                          start_absent=(4,))
    cases = [(dict(backend=b, algorithm=a), built.problem, 1e-5)
             for b in ("simulator", "spmd", "fused") for a in ("coke",
                                                              "dkla")]
    cases += [(dict(backend="fused", algorithm=a), logistic, 1e-5)
              for a in ("coke", "dkla")]
    cases += [(dict(backend=b, primal="cg", churn=churn), built.problem,
               1e-4) for b in ("simulator", "spmd")]
    cases += [(dict(backend="spmd", gossip_size=3, churn=ChurnSchedule(
        slowdown=((1, 2.0),))), built.problem, 1e-5)]
    with smoke.StrictFits():
        for over, prob, tol in cases:
            c = cfg.replace(**over)
            cpu = fit(c, problem=prob, device="cpu")
            before = (k2.LAUNCHES, k2.FUSED_UPDATE_LAUNCHES, k5.LAUNCHES)
            gpu = fit(c, problem=prob, device=cuda)
            rose = (k2.LAUNCHES - before[0],
                    k2.FUSED_UPDATE_LAUNCHES - before[1],
                    k5.LAUNCHES - before[2])
            fused = c.backend == "fused"
            want = (40 if fused and prob.loss == "quadratic" else 0,
                    20 if fused and prob.loss == "logistic" else 0, 20)
            assert rose == want, (over, prob.loss, rose)
            for k in ("comms", "bits"):
                np.testing.assert_array_equal(gpu.history[k].cpu().numpy(),
                                              cpu.history[k].numpy())
            torch.testing.assert_close(gpu.theta.cpu(), cpu.theta, rtol=0,
                                       atol=tol)


def test_gossip_sweep_and_streams_on_card_match_cpu(cuda):
    """A gossip sweep (each lane its own participation draw, one K5
    launch per grid iteration for all lanes) and gossip streams with
    churn, card against CPU, the loops under set_sync_debug_mode("error"):
    comms and bits equal, theta within 1e-5."""
    from repro_torch.api import ChurnSchedule, build_stream, fit_stream, \
        sweep
    from repro_torch.kernels.threefry import threefry as k5
    smoke = _chip_smoke()
    base = FitConfig(krr=KRRConfig(num_agents=6, samples_per_agent=40,
                                   num_features=32, lam=1e-2, rho=0.1),
                     graph="ring", num_iters=30, censor_v=None,
                     censor_mu=None, exec="gossip", participation=0.5)
    built = build_problem(base, device="cpu")
    grid = [(0.3, 0.97), (0.3, 0.97), (0.05, 0.9)]
    cpu = sweep(base, grid, problem=built.problem, device="cpu")
    before = k5.LAUNCHES
    with smoke.StrictLoops():
        gpu = sweep(base, grid, problem=built.problem, device=cuda)
    assert k5.LAUNCHES - before == 30
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(gpu.history[k].cpu().numpy(),
                                      cpu.history[k].numpy())
    torch.testing.assert_close(gpu.thetas.cpu(), cpu.thetas, rtol=0,
                               atol=1e-5)
    scfg = FitConfig(krr=KRRConfig(num_agents=6, num_features=16, lam=1e-2,
                                   rho=0.1),
                     algorithm="qc_odkla", graph="ring", censor_v=0.2,
                     censor_mu=0.99, num_iters=40, online_batch=8,
                     exec="gossip", participation=0.4,
                     churn=ChurnSchedule(leave=((10, 1),),
                                         join=((25, 1),)))
    stream = build_stream(scfg, device="cpu").stream
    for backend in ("simulator", "spmd"):
        c = scfg.replace(backend=backend)
        cpu = fit_stream(c, stream=stream, device="cpu")
        with smoke.StrictLoops():
            gpu = fit_stream(c, stream=stream, device=cuda)
        for k in ("comms", "bits"):
            np.testing.assert_array_equal(gpu.history[k].cpu().numpy(),
                                          cpu.history[k].numpy())
        torch.testing.assert_close(gpu.theta.cpu(), cpu.theta, rtol=0,
                                   atol=1e-5)


def test_personalized_fits_on_card_match_cpu(cuda):
    """Personalized COKE (CG, a learned graph refreshed every 3 iterations
    after 5) on the simulator and spmd, sync and gossip, card against CPU,
    the fit loops with host syncs raising: comms and bits equal, the graph's
    support equal, theta within 1e-3 relative (two personalized runs of one
    problem: tests/test_torch_personalize.py says why); gossip draws one K5
    launch per iteration; no other kernel runs."""
    from repro_torch.api import Personalization
    from repro_torch.kernels.threefry import threefry as k5
    smoke = _chip_smoke()
    cfg = FitConfig(krr=KRRConfig(dataset="heterogeneous", num_agents=9,
                                  samples_per_agent=40, num_features=32,
                                  lam=1e-3, rho=0.05),
                    graph="ring", censor_v=0.3, censor_mu=0.97,
                    num_iters=20, primal="cg",
                    personalization=Personalization(k=2, every=3, warmup=5))
    built = build_problem(cfg, device="cpu")
    with smoke.StrictFits():
        for backend in ("simulator", "spmd"):
            for over in (dict(), dict(exec="gossip", participation=0.5)):
                c = cfg.replace(backend=backend, **over)
                cpu = fit(c, problem=built.problem, device="cpu")
                before = (k2.LAUNCHES, k2.FUSED_UPDATE_LAUNCHES,
                          k5.LAUNCHES)
                gpu = fit(c, problem=built.problem, device=cuda)
                rose = (k2.LAUNCHES - before[0],
                        k2.FUSED_UPDATE_LAUNCHES - before[1],
                        k5.LAUNCHES - before[2])
                assert rose == (0, 0, 20 if over else 0), (backend, rose)
                for k in ("comms", "bits"):
                    np.testing.assert_array_equal(
                        gpu.history[k].cpu().numpy(), cpu.history[k].numpy())
                np.testing.assert_array_equal(
                    gpu.learned_adjacency.cpu().numpy() > 0,
                    cpu.learned_adjacency.numpy() > 0)
                scale = max(1.0, float(cpu.theta.abs().max()))
                torch.testing.assert_close(gpu.theta.cpu(), cpu.theta,
                                           rtol=0, atol=1e-3 * scale)


def test_personalized_models_launch_k1_once_each(cuda):
    """to_models() on the card: each per-agent model's fused evaluate on
    its own test rows is one K1 launch, its MSE the plain product's within
    1e-5 relative; the per-agent meta round-trips save/load."""
    import tempfile

    from repro_torch.api import KernelModel, Personalization
    cfg = FitConfig(krr=KRRConfig(dataset="heterogeneous", num_agents=6,
                                  samples_per_agent=40, num_features=64,
                                  lam=1e-3, rho=0.05),
                    graph="ring", num_iters=12, primal="cg",
                    personalization=Personalization(k=2, every=3, warmup=4))
    built = build_problem(cfg, device=cuda)
    res = fit(cfg, problem=built.problem, device=cuda)
    models = res.to_models(built.rff_params)
    before = k1.LAUNCHES
    for i, m in enumerate(models):
        got = m.evaluate(built.x_test[i], built.y_test[i],
                         backend="fused")["test_mse"]
        pred = built.feats_test[i] @ res.theta[i]
        want = float(torch.mean((built.y_test[i] - pred) ** 2))
        assert abs(got - want) <= 1e-5 * want, i
    assert k1.LAUNCHES - before == len(models)
    with tempfile.TemporaryDirectory() as tmp:
        models[2].save(tmp + "/m")
        back = KernelModel.load(tmp + "/m", device=cuda)
    assert back.meta["agent"] == 2 and back.meta["personalization"]["k"] == 2
    assert torch.equal(back.predict(built.x_test[2]),
                       models[2].predict(built.x_test[2]))


def test_personalized_sweep_and_streams_on_card_match_cpu(cuda):
    """A personalized sweep (one learned graph per lane) and personalized
    gossip streams, card against CPU, the loops with host syncs raising:
    comms and bits equal, theta within 1e-3 relative."""
    from repro_torch.api import Personalization, build_stream, fit_stream, \
        sweep
    smoke = _chip_smoke()
    pz = Personalization(k=2, every=3, warmup=4)
    base = FitConfig(krr=KRRConfig(dataset="heterogeneous", num_agents=9,
                                   samples_per_agent=40, num_features=32,
                                   lam=1e-3, rho=0.05),
                     graph="ring", num_iters=20, primal="cg",
                     personalization=pz)
    built = build_problem(base, device="cpu")
    grid = [(0.3, 0.97), (0.3, 0.97), (0.05, 0.9)]
    cpu = sweep(base, grid, problem=built.problem, device="cpu")
    with smoke.StrictLoops():
        gpu = sweep(base, grid, problem=built.problem, device=cuda)
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(gpu.history[k].cpu().numpy(),
                                      cpu.history[k].numpy())
    scale = max(1.0, float(cpu.thetas.abs().max()))
    torch.testing.assert_close(gpu.thetas.cpu(), cpu.thetas, rtol=0,
                               atol=1e-3 * scale)
    scfg = FitConfig(krr=KRRConfig(num_agents=6, num_features=16, lam=1e-2,
                                   rho=0.1),
                     algorithm="online_coke", graph="ring", censor_v=0.2,
                     censor_mu=0.99, num_iters=40, online_batch=8,
                     exec="gossip", participation=0.5, personalization=pz)
    stream = build_stream(scfg, device="cpu").stream
    for backend in ("simulator", "spmd"):
        c = scfg.replace(backend=backend)
        cpu = fit_stream(c, stream=stream, device="cpu")
        with smoke.StrictLoops():
            gpu = fit_stream(c, stream=stream, device=cuda)
        for k in ("comms", "bits"):
            np.testing.assert_array_equal(gpu.history[k].cpu().numpy(),
                                          cpu.history[k].numpy())
        scale = max(1.0, float(cpu.theta.abs().max()))
        torch.testing.assert_close(gpu.theta.cpu(), cpu.theta, rtol=0,
                                   atol=1e-3 * scale)


def test_sweep_on_card_matches_cpu(cuda):
    """A policy grid as one lane-batched loop, card against CPU, with the
    loops under set_sync_debug_mode("error"): comms and bits equal, theta
    within 1e-5 plus the flipped roundings' steps; G keys in one draw give
    G single draws' bits; a fused evaluate of the grid is one K1 launch."""
    from repro_torch.api import sweep
    from repro_torch.core import prng
    smoke = _chip_smoke()
    keys = [prng.fold_in(prng.PRNGKey(s), s + 5) for s in range(5)]
    u = prng.uniform(torch.tensor(keys, device=cuda), (20, 4096), cuda)
    for g, key in enumerate(keys):
        assert torch.equal(u[g].cpu().view(torch.int32),
                           prng.uniform(key, (20, 4096)).view(torch.int32))
    base = FitConfig(krr=KRRConfig(num_agents=4, samples_per_agent=40,
                                   num_features=32, lam=1e-2, rho=0.1),
                     graph="ring", num_iters=40, censor_v=None,
                     censor_mu=None)
    built = build_problem(base, device="cpu")
    grids = [("coke", [(0.3, 0.97), (0.05, 0.9), (1.0, 0.99)]),
             ("coke", [(0.3, 0.97, float("inf")), (0.3, 0.97, 4.0)]),
             ("dkla", [(0.05, 0.9, 4.0), (0.05, 0.9, float("inf"))])]
    for alg, grid in grids:
        c = base.replace(algorithm=alg)
        with smoke.LaneQuantizerRecord() as rec_cpu:
            cpu = sweep(c, grid, problem=built.problem, device="cpu")
        with smoke.StrictLoops(), smoke.LaneQuantizerRecord() as rec_gpu:
            gpu = sweep(c, grid, problem=built.problem, device=cuda)
        for k in ("comms", "bits"):
            np.testing.assert_array_equal(gpu.history[k].cpu().numpy(),
                                          cpu.history[k].numpy())
        _, _, steps = smoke.quantizer_flips(rec_gpu, rec_cpu)
        torch.testing.assert_close(gpu.thetas.cpu(), cpu.thetas, rtol=0,
                                   atol=smoke.SMALL_THETA_TOL + steps)
    before = k1.LAUNCHES
    ev = gpu.evaluate(built.x_test, built.y_test, backend="fused",
                      rff_params=built.rff_params.to(cuda))
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1
    ref = gpu.evaluate(built.x_test, built.y_test,
                       rff_params=built.rff_params.to(cuda))
    torch.testing.assert_close(ev["test_mse"], ref["test_mse"], rtol=1e-4,
                               atol=0)


@pytest.mark.parametrize("backend", ["simulator", "spmd"])
def test_streams_on_card_match_cpu(cuda, backend):
    """The three online solvers over one stream with a Censor, Quantize,
    Drop chain, card against CPU, the rounds under
    set_sync_debug_mode("error"): comms and bits equal, theta within 1e-5
    plus the flipped roundings' steps; no fit kernel launches."""
    from repro_torch.api import (Censor, Chain, Drop, Quantize,
                                 build_stream, fit_stream)
    smoke = _chip_smoke()
    cfg = FitConfig(krr=KRRConfig(num_agents=6, num_features=16, lam=1e-2,
                                  rho=0.1),
                    graph="ring", num_iters=40, online_batch=8,
                    backend=backend, censor_v=None, censor_mu=None,
                    comm=Chain([Censor(0.3, 0.99), Quantize(5.0, seed=7),
                                Drop(0.1, seed=11)]))
    stream = build_stream(cfg, device="cpu").stream
    before = (k2.LAUNCHES, k2.FUSED_UPDATE_LAUNCHES)
    for alg in ("online_dkla", "online_coke", "qc_odkla"):
        c = cfg.replace(algorithm=alg,
                        qc_eta=2.0 if alg == "qc_odkla" else None)
        with smoke.QuantizerRecord() as rec_cpu:
            cpu = fit_stream(c, stream=stream, device="cpu")
        with smoke.StrictLoops(), smoke.QuantizerRecord() as rec_gpu:
            gpu = fit_stream(c, stream=stream, device=cuda)
        for k in ("comms", "bits"):
            np.testing.assert_array_equal(gpu.history[k].cpu().numpy(),
                                          cpu.history[k].numpy())
        _, _, steps = smoke.quantizer_flips(rec_gpu, rec_cpu)
        torch.testing.assert_close(gpu.theta.cpu(), cpu.theta, rtol=0,
                                   atol=smoke.SMALL_THETA_TOL + steps)
    assert (k2.LAUNCHES, k2.FUSED_UPDATE_LAUNCHES) == before


# K4: fp32 scores and an online softmax against the plain version's full
# softmax, both in fp32 (the reference's own tolerance, test_kernels.py);
# bf16 outputs may differ by an ulp of bf16 (2^-7 relative) after rounding
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# (B, H, KV, Sq, Sk, Dh, Dv, causal, window): ragged tails, GQA groups,
# Dh != Dv, Sq != Sk, windows, and rows that no key may see (the 7th).
# Then what the tensor-core tiling makes risky: head dims that are not a
# multiple of the MMA's k (16 bf16, 8 fp32), Dh = Dv = 256 (one block per
# SM in fp32), Sk below one key tile (32 fp32, 64 bf16) with a window, a
# length whose last cp.async stage is ragged (97 = 3 x 32 + 1 = 64 + 33),
# and odd head dims whose rows are not 16-byte aligned (element-wise
# staging instead of cp.async)
ATTN_SHAPES = [(1, 2, 2, 100, 100, 64, 64, True, 0),
               (2, 4, 2, 257, 257, 128, 128, True, 32),
               (1, 4, 1, 64, 200, 64, 64, False, 0),
               (2, 2, 2, 130, 70, 192, 128, True, 0),
               (1, 8, 2, 1024, 1024, 128, 128, True, 0),
               (1, 3, 3, 33, 33, 16, 16, False, 32),
               (1, 2, 2, 200, 20, 32, 32, True, 8),
               (1, 2, 1, 300, 300, 40, 40, True, 0),
               (1, 2, 2, 150, 150, 72, 24, False, 0),
               (1, 2, 1, 300, 300, 256, 256, True, 0),
               (1, 2, 2, 20, 20, 128, 128, True, 16),
               (1, 2, 2, 97, 97, 128, 128, False, 0),
               (1, 2, 2, 50, 50, 33, 17, True, 0),
               # the served models' new head dims: minicpm3-4b's MLA
               # (Dh 96 = 64 + 32, Dv 64) and deepseek-v2-lite-16b's (192 =
               # 128 + 64, Dv 128), KV = H; Mixtral's window over grouped
               # heads, past twice the window so it excludes whole key tiles
               (1, 4, 4, 130, 130, 96, 64, True, 0),
               (1, 4, 4, 257, 257, 192, 128, True, 0),
               (1, 8, 2, 300, 300, 128, 128, True, 64),
               # zamba2-2.7b's shared attention block: Dh = Dv = 80, KV = H
               (1, 4, 4, 300, 300, 80, 80, True, 0),
               # internvl2-1b's 14 query heads over 2 KV heads (a group of
               # 7), and seamless-m4t-medium's cross attention: no mask,
               # fewer decoder rows than encoder rows
               (1, 14, 2, 300, 300, 64, 64, True, 0),
               (1, 4, 4, 64, 300, 64, 64, False, 0)]


def _attn_operands(cuda, B, H, KV, Sq, Sk, Dh, Dv, dtype, seed=3):
    g = _gen(cuda, seed)
    q = torch.randn((B, H, Sq, Dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, KV, Sk, Dh), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, KV, Sk, Dv), generator=g, device=cuda).to(dtype)
    return q, k, v


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_flash_attention_kernel_matches_plain(cuda, shape, dtype, layout):
    B, H, KV, Sq, Sk, Dh, Dv, causal, window = shape
    q, k, v = _attn_operands(cuda, B, H, KV, Sq, Sk, Dh, Dv, dtype)
    want = attention_ref(q, k, v, causal=causal, window=window)
    before = k4.LAUNCHES
    if layout == "bhsd":
        got = k4.flash_attention(q, k, v, causal=causal, window=window)
    else:        # the model's layout, as views: no copy reaches the kernel
        got = gqa_flash(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal,
                        window=window).transpose(1, 2)
    torch.cuda.synchronize()
    assert k4.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=ATTN_TOL[dtype])


def test_flash_attention_long_rows_stay_within_the_fp32_tolerance(cuda):
    """4096-key causal rows of values with one sign down each channel (a
    mean per channel plus a quarter of unit noise, max|v| 5, as on zamba2's
    shared block), where sums that stayed in the tensor cores' accumulator
    across key tiles would drift toward zero: K4 within 2e-5 of the float64
    attention."""
    g = _gen(cuda, 32)
    B, H, S, D = 1, 2, 4096, 128
    q, k = (torch.randn((B, H, S, D), generator=g, device=cuda)
            for _ in range(2))
    v = torch.randn((B, H, 1, D), generator=g, device=cuda) + \
        0.25 * torch.randn((B, H, S, D), generator=g, device=cuda)
    v *= 5.0 / v.abs().max()
    got = k4.flash_attention(q, k, v, causal=True)
    s = (q.double() @ k.double().transpose(-1, -2)) / math.sqrt(D)
    s.masked_fill_(torch.ones((S, S), dtype=torch.bool,
                              device=cuda).triu(1), -math.inf)
    exact = torch.softmax(s, dim=-1) @ v.double()
    torch.testing.assert_close(got.double(), exact, rtol=0,
                               atol=ATTN_TOL[torch.float32])


def test_flash_attention_kernel_raises_on_operands_it_does_not_take(cuda):
    q, k, v = _attn_operands(cuda, 1, 2, 2, 16, 16, 32, 32, torch.float32)
    with pytest.raises(TypeError):
        k4.flash_attention(q.half(), k.half(), v.half())
    strided = torch.zeros((1, 2, 16, 64), device=cuda)[..., ::2]
    with pytest.raises(ValueError):       # last dim not contiguous
        k4.flash_attention(strided, strided, strided)
    big = torch.zeros((1, 2, 16, 257), device=cuda)
    with pytest.raises(ValueError):
        k4.flash_attention(big, big, big)
    with pytest.raises(ValueError):
        k4.flash_attention(q, k.cpu(), v)


def test_lm_on_card_launches_k4_once_per_layer(cuda):
    """Forward and prefill of the reduced qwen3 on the card: one K4 launch
    per layer each, and the CPU's logits (plain attention) within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config("qwen3-1.7b").reduced().with_overrides(num_kv_heads=2)
    gpu = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    cpu = M.LM(cfg, device="cpu")
    cpu.load_state_dict({n: t.cpu() for n, t in gpu.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 77)))
    before = k4.LAUNCHES
    got, _ = M.forward(gpu, cfg, {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert k4.LAUNCHES == before + cfg.num_layers
    want, _ = M.forward(cpu, cfg, {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    before = k4.LAUNCHES
    last, state = M.prefill_with_state(gpu, cfg, {"tokens": toks.to(cuda)},
                                       cache_len=96)
    torch.cuda.synchronize()
    assert k4.LAUNCHES == before + cfg.num_layers
    torch.testing.assert_close(last.cpu(), want[:, -1:], rtol=0, atol=1e-4)


# the reduced configs of every served family but qwen3's (above): dense GQA,
# MoE with Mixtral's window of 64, MLA, MLA with MoE
LM_FAMILY = ["granite-3-8b", "llama3-405b", "mixtral-8x7b", "minicpm3-4b",
             "deepseek-v2-lite-16b"]


@pytest.mark.parametrize("arch", LM_FAMILY)
def test_lm_family_served_on_card_matches_cpu(cuda, arch):
    """The reduced model served on the card and on the CPU from the same
    weights: equal greedy tokens from 96-token prompts (Mixtral decodes past
    its window in a rolling cache of 64), K4 once per layer of the card's
    prefill and never in decode, and the prefill's logits within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, ServeConfig
    cfg = get_config(arch).reduced()
    gpu = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    cpu = M.LM(cfg, device="cpu")
    cpu.load_state_dict({n: t.cpu() for n, t in gpu.state_dict().items()})
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 96))
    scfg = ServeConfig(max_new_tokens=8, cache_len=cfg.sliding_window or 104)
    before = k4.LAUNCHES
    got = Engine(cfg, gpu, scfg).generate(prompts)
    torch.cuda.synchronize()
    assert k4.LAUNCHES == before + cfg.num_layers
    np.testing.assert_array_equal(got, Engine(cfg, cpu, scfg).generate(
        prompts))
    toks = torch.as_tensor(prompts)
    last, _ = M.prefill_with_state(gpu, cfg, {"tokens": toks.to(cuda)}, 104)
    want, _ = M.prefill_with_state(cpu, cfg, {"tokens": toks}, 104)
    torch.testing.assert_close(last.cpu(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_models_served_on_card_match_cpu(cuda, arch):
    """The reduced SSM model and grouped hybrid served on the card and on
    the CPU from the same weights, at a prompt that is not a multiple of
    the 32-token chunk: equal greedy tokens, K4 once per application of
    the hybrid's shared block (never for the pure SSM model, never in
    decode), and the prefill's logits within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, ServeConfig
    cfg = get_config(arch).reduced()
    gpu = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    cpu = M.LM(cfg, device="cpu")
    cpu.load_state_dict({n: t.cpu() for n, t in gpu.state_dict().items()})
    S = 2 * 96 + 5
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, S))
    scfg = ServeConfig(max_new_tokens=8, cache_len=S + 8)
    apps = (cfg.num_layers // cfg.shared_attn_every
            if cfg.arch_type == "hybrid" else 0)
    before = k4.LAUNCHES
    got = Engine(cfg, gpu, scfg).generate(prompts)
    torch.cuda.synchronize()
    assert k4.LAUNCHES == before + apps
    np.testing.assert_array_equal(got, Engine(cfg, cpu, scfg).generate(
        prompts))
    toks = torch.as_tensor(prompts)
    last, _ = M.prefill_with_state(gpu, cfg, {"tokens": toks.to(cuda)}, S)
    want, _ = M.prefill_with_state(cpu, cfg, {"tokens": toks}, S)
    torch.testing.assert_close(last.cpu(), want, rtol=0, atol=1e-4)



@pytest.mark.parametrize("arch,S", [("internvl2-1b", 5),
                                    ("internvl2-1b", 40),
                                    ("seamless-m4t-medium", 40)])
def test_multimodal_models_served_on_card_match_cpu(cuda, arch, S):
    """The reduced VLM (prompts shorter and longer than its 8-row patch
    prefix) and the reduced enc-dec model (48 encoder frames) served on the
    card and on the CPU from the same weights and stub embeddings: equal
    greedy tokens; K4 once per layer of the VLM's prefill, once per
    encoder layer of the enc-dec generate (its prompt replay and decode
    run none), and the forward's logits within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, ServeConfig
    cfg = get_config(arch).reduced()
    gpu = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    cpu = M.LM(cfg, device="cpu")
    cpu.load_state_dict({n: t.cpu() for n, t in gpu.state_dict().items()})
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, (2, S))
    if cfg.is_encdec:
        key, rows, launches = "encoder_embeds", 48, cfg.encoder_layers
    else:
        key, rows, launches = "prefix_embeds", cfg.prefix_len, cfg.num_layers
    extra = {key: rng.normal(size=(2, rows, cfg.d_model)).astype(np.float32)}
    scfg = ServeConfig(max_new_tokens=8, cache_len=64)
    before = k4.LAUNCHES
    got = Engine(cfg, gpu, scfg, extra_batch=extra).generate(prompts)
    torch.cuda.synchronize()
    assert k4.LAUNCHES == before + launches
    np.testing.assert_array_equal(got, Engine(cfg, cpu, scfg,
                                              extra_batch=extra).generate(
        prompts))
    batch = {"tokens": torch.as_tensor(prompts),
             key: torch.from_numpy(extra[key])}
    with torch.inference_mode():
        last, _ = M.forward(gpu, cfg, {k: v.to(cuda) for k, v in
                                       batch.items()})
        want, _ = M.forward(cpu, cfg, batch)
    torch.testing.assert_close(last.cpu(), want, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# K7, the attention backward, and training through K4 and K7
# ---------------------------------------------------------------------------

# K7 against its plain version: fp32 sums over the keys (dQ) or the
# queries (dK, dV) in another order, P recomputed from K4's log-sum-exp:
# each gradient within 1e-4 of its largest magnitude
ATTN_BWD_RTOL = 1e-4
# (B, H, KV, Sq, Sk, D, causal, window): the training shape (B=8, S=64,
# qwen3's 16/8 heads of 128), the prefill shape, a window, an odd length,
# the reduced model's heads (Dh=64, H=4, KV=2); then the edges: a row no
# key may see (window, Sq > Sk), D not a multiple of 16, D = 256,
# non-causal, one KV head for 8 query heads; D not a multiple of the
# MMA's k = 8 (20) and D = 1, and lengths that end inside a 16-row
# fragment (17, 33). A trailing Dv where it differs from Dh (MLA):
# deepseek-v2-lite's training shape (192 / 128, width pair (256, 128)),
# minicpm3-4b's heads at a ragged length (96 / 64, (128, 64)) and the
# reduced models' 48 / 32 with a window
ATTN_BWD_SHAPES = [(8, 16, 8, 64, 64, 128, True, 0),
                   (2, 16, 8, 4096, 4096, 128, True, 0),
                   (2, 16, 8, 1000, 1000, 128, True, 256),
                   (3, 4, 2, 77, 77, 64, True, 0),
                   (8, 4, 2, 64, 64, 64, True, 0),
                   (1, 2, 2, 90, 40, 64, True, 16),
                   (2, 2, 1, 100, 100, 40, True, 0),
                   (1, 2, 2, 130, 130, 256, True, 0),
                   (2, 4, 4, 70, 50, 128, False, 0),
                   (1, 8, 1, 200, 200, 128, True, 64),
                   (2, 4, 2, 33, 33, 20, True, 0),
                   (2, 4, 2, 17, 17, 1, True, 0),
                   (1, 4, 2, 17, 17, 128, True, 0),
                   (1, 4, 2, 33, 33, 64, False, 0),
                   # zamba2's shared block, Dh = Dv = 80 on the width-128
                   # instances: the training shape, and a ragged length
                   (8, 32, 32, 64, 64, 80, True, 0),
                   (2, 4, 4, 300, 300, 80, True, 0),
                   (8, 16, 16, 64, 64, 192, True, 0, 128),
                   (2, 40, 40, 300, 300, 96, True, 0, 64),
                   (2, 4, 4, 77, 77, 48, True, 16, 32)]


def _bwd_operands(cuda, B, H, KV, Sq, Sk, D, Dv=None, seed=5):
    """(B, S, heads, Dh) q, k and (B, S, heads, Dv) v, dO (Dv defaults to
    Dh), as the model gives them."""
    Dv = D if Dv is None else Dv
    g = _gen(cuda, seed)
    q = torch.randn((B, Sq, H, D), generator=g, device=cuda)
    k = torch.randn((B, Sk, KV, D), generator=g, device=cuda)
    v = torch.randn((B, Sk, KV, Dv), generator=g, device=cuda)
    do = torch.randn((B, Sq, H, Dv), generator=g, device=cuda)
    return q, k, v, do


def _k4_with_lse(q, k, v, causal, window):
    B, Sq, H = q.shape[:3]
    lse = torch.empty((B, H, Sq), device=q.device)
    out = k4.launch(q, k, v, heads_dim=2, causal=causal, window=window,
                    lse=lse)
    return out, lse


@pytest.mark.parametrize("shape", ATTN_BWD_SHAPES, ids=str)
def test_flash_attention_bwd_kernel_matches_plain(cuda, shape):
    from repro_torch.kernels.flash_attention import flash_attention_bwd as k7
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    B, H, KV, Sq, Sk, D, causal, window = shape[:8]
    q, k, v, do = _bwd_operands(cuda, B, H, KV, Sq, Sk, D, *shape[8:])
    out, lse = _k4_with_lse(q, k, v, causal, window)
    before = k7.LAUNCHES
    got = k7.gqa_flash_bwd(q, k, v, out, do, lse, causal=causal,
                           window=window)
    torch.cuda.synchronize()
    assert k7.LAUNCHES == before + 1
    t = lambda x: x.transpose(1, 2)
    want = attention_bwd_ref(t(q), t(k), t(v), t(out), t(do), causal=causal,
                             window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = t(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        tol = ATTN_BWD_RTOL * float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=0, atol=tol, msg=name)


def _hold_bwd(cuda, shape, plan=None):
    """K7 with `plan` (the device's by default) against the plain
    backward at `shape`, within ATTN_BWD_RTOL of each gradient's max."""
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    B, H, KV, Sq, Sk, D, causal, window = shape[:8]
    q, k, v, do = _bwd_operands(cuda, B, H, KV, Sq, Sk, D, *shape[8:])
    out, lse = _k4_with_lse(q, k, v, causal, window)
    got = k7.gqa_flash_bwd(q, k, v, out, do, lse, causal=causal,
                           window=window, plan=plan)
    t = lambda x: x.transpose(1, 2)
    want = attention_bwd_ref(t(q), t(k), t(v), t(out), t(do), causal=causal,
                             window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = t(w)
        tol = ATTN_BWD_RTOL * float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=0, atol=tol, msg=name)


def test_flash_attention_bwd_training_shape_takes_small_tiles(cuda):
    """At the training shape (B=8, S=64, 16/8 heads of 128) the device's
    plan takes 16- or 32-row tiles, so that both passes' grids cover the
    SMs, and holds to the plain version."""
    shape = ATTN_BWD_SHAPES[0]
    q, k, _, _ = _bwd_operands(cuda, *shape[:6])
    plan = k7.device_plan(q, k)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan.kv.rows in (16, 32) and plan.q.rows in (16, 32)
    assert plan.kv.blocks >= sms and plan.q.blocks >= sms
    _hold_bwd(cuda, shape, plan)


@pytest.mark.parametrize("width,instance",
                         [(w, i) for w, ins in k7.INSTANCES.items()
                          for i in ins], ids=str)
def test_flash_attention_bwd_every_instance_matches_plain(cuda, width,
                                                          instance):
    """Each built instance, in both passes, at a ragged causal shape with
    a GQA group of 2 (D = width - 3: not a multiple of 8)."""
    shape = (2, 4, 2, 77, 77, width - 3, True, 0)
    plan = k7.AttentionBwdPlan(
        width, min(width, 128),
        k7.pass_plan(width, instance, True, 77, 2 * 2, width),
        k7.pass_plan(width, instance, False, 77, 2 * 4, width), width)
    _hold_bwd(cuda, shape, plan)


@pytest.mark.parametrize("pair,instance",
                         [(w, i) for w, ins in k7.PAIR_INSTANCES.items()
                          for i in ins], ids=str)
def test_flash_attention_bwd_every_pair_instance_matches_plain(cuda, pair,
                                                               instance):
    """Each instance of a width pair Dh > Dv, in both passes, at a ragged
    causal shape with a GQA group of 2 (each head dim its width - 3)."""
    wh, wv = pair
    shape = (2, 4, 2, 77, 77, wh - 3, True, 0, wv - 3)
    plan = k7.AttentionBwdPlan(
        wh, min(wh, 128),
        k7.pass_plan(wh, instance, True, 77, 2 * 2, wv),
        k7.pass_plan(wh, instance, False, 77, 2 * 4, wv), wv)
    _hold_bwd(cuda, shape, plan)


@pytest.mark.parametrize("dn,dv", [(128, 128), (64, 64), (32, 32)], ids=str)
def test_flash_attention_bwd_reads_mla_v_in_place(cuda, dn, dv):
    """MLA's v is a view of the latents' expansion (head stride dn + dv,
    the last dim contiguous): K7 reads it through its strides and gives
    the bits of the same values made contiguous (at deepseek-v2-lite's,
    minicpm3-4b's and the reduced models' widths)."""
    B, S, H, dr = 2, 100, 4, dn // 2
    g = _gen(cuda, 9)
    q, k = (torch.randn((B, S, H, dn + dr), generator=g, device=cuda)
            for _ in range(2))
    kv = torch.randn((B, S, H, dn + dv), generator=g, device=cuda)
    v = kv[..., dn:]
    assert not v.is_contiguous() and v.stride(3) == 1
    do = torch.randn((B, S, H, dv), generator=g, device=cuda)
    out, lse = _k4_with_lse(q, k, v, True, 0)
    before = k7.LAUNCHES
    got = k7.gqa_flash_bwd(q, k, v, out, do, lse, causal=True)
    want = k7.gqa_flash_bwd(q, k, v.contiguous(), out, do, lse, causal=True)
    torch.cuda.synchronize()
    assert k7.LAUNCHES == before + 2
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert got[2].shape == v.shape


def test_flash_attention_bwd_kernel_is_deterministic(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_bwd as k7
    q, k, v, do = _bwd_operands(cuda, 2, 16, 8, 300, 300, 128)
    out, lse = _k4_with_lse(q, k, v, True, 0)
    a = k7.gqa_flash_bwd(q, k, v, out, do, lse, causal=True)
    b = k7.gqa_flash_bwd(q, k, v, out, do, lse, causal=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_attention_bwd_raises_before_any_launch(cuda):
    """bf16 operands, and head dims whose widths K7 is not built for (Dh
    narrower than Dv), raise before K4 or K7 launches; Dh > Dv runs (held
    by ATTN_BWD_SHAPES' MLA cases)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd as k7
    before = (k4.LAUNCHES, k7.LAUNCHES)
    q, k, v, _ = _bwd_operands(cuda, 1, 2, 2, 16, 16, 32, 128)
    for args in ((q.bfloat16(), k.bfloat16(), v.bfloat16()), (q, k, v)):
        leaves = [a.detach().requires_grad_() for a in args]
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            gqa_flash(*leaves, causal=True)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            k7.gqa_flash_bwd(*args, args[0], args[0], None)
    assert (k4.LAUNCHES, k7.LAUNCHES) == before


@pytest.mark.parametrize("shape", [(8, 16, 8, 64, 64, 128, True, 0),
                                   (1, 2, 2, 90, 40, 64, True, 16),
                                   (2, 4, 2, 77, 77, 40, False, 0)], ids=str)
def test_flash_attention_lse_leaves_the_output_bits(cuda, shape):
    """K4 with the log-sum-exp gives the serving instance's output bits,
    and its L is the plain log-sum-exp within 1e-5 relative (+inf where no
    key may be seen)."""
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref
    B, H, KV, Sq, Sk, D, causal, window = shape
    q, k, v, _ = _bwd_operands(cuda, B, H, KV, Sq, Sk, D)
    plain = gqa_flash(q, k, v, causal=causal, window=window)
    out, lse = _k4_with_lse(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    want = attention_lse_ref(q.transpose(1, 2), k.transpose(1, 2),
                             causal=causal, window=window)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(lse[fin], want[fin], rtol=1e-5, atol=1e-5)


def test_training_through_k4_and_k7_matches_the_cpu(cuda):
    """The reduced qwen3 (grouped heads), 4 agents on a ring, coke with
    tests/test_system.py's censor (v=20, mu=0.5), 6 steps, on the card and
    on the CPU from the same weights, with and without K3: comms and
    send_frac equal, losses within 1e-4 relative; K4 and K7 once per layer
    per agent per step."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.distributed.consensus import ConsensusConfig
    from repro_torch.kernels.flash_attention import flash_attention_bwd as k7
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train.steps import agent_batch, make_train_step
    cfg = get_config("qwen3-1.7b").reduced().with_overrides(num_kv_heads=2)
    weights = M.param_dict(M.init_params(cfg, torch.Generator().manual_seed(0)))
    stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size,
                                           seq_len=48, global_batch=8,
                                           structure=0.9))
    for fused in (False, True):
        ccfg = ConsensusConfig(strategy="coke", rho=1e-3, censor_v=20.0,
                               censor_mu=0.5, use_fused_kernel=fused)
        runs = {}
        for dev in ("cpu", cuda):
            init_fn, step_fn, _ = make_train_step(cfg, OptConfig(lr=3e-3),
                                                  ccfg, num_agents=4)
            state = init_fn({n: t.to(dev) for n, t in weights.items()})
            before = (k4.LAUNCHES, k7.LAUNCHES)
            rows = []
            for i in range(6):
                toks, labels = stream.batch(i)
                b = agent_batch({"tokens": torch.as_tensor(toks, device=dev),
                                 "labels": torch.as_tensor(labels,
                                                           device=dev)}, 4)
                state, m = step_fn(state, b)
                rows.append((float(m["loss"]), int(m["comms"]),
                             float(m["send_frac"])))
            runs[str(dev)] = rows
            launched = (k4.LAUNCHES - before[0], k7.LAUNCHES - before[1])
            want = (0, 0) if dev == "cpu" else (6 * 4 * cfg.num_layers,) * 2
            assert launched == want
        cpu, card = runs["cpu"], runs[str(cuda)]
        assert [r[1:] for r in card] == [r[1:] for r in cpu]
        for (lc, _, _), (lg, _, _) in zip(card, cpu):
            assert abs(lc - lg) <= 1e-4 * abs(lg)


def _reduced_coke_run(dev, mesh=None, steps=6):
    """The reduced qwen3 (grouped heads), 4 agents, coke (v=20, mu=0.5),
    `steps` steps from the seeded weights, on `dev` (on `mesh`, SPMD):
    per step (loss, comms, send_frac), and the K4 and K7 launches."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.distributed.consensus import ConsensusConfig
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train.steps import agent_batch, make_train_step
    cfg = get_config("qwen3-1.7b").reduced().with_overrides(num_kv_heads=2)
    weights = M.param_dict(M.init_params(cfg, torch.Generator().manual_seed(0)))
    stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size,
                                           seq_len=48, global_batch=8,
                                           structure=0.9))
    init_fn, step_fn, _ = make_train_step(
        cfg, OptConfig(lr=3e-3), ConsensusConfig(
            strategy="coke", rho=1e-3, censor_v=20.0, censor_mu=0.5),
        num_agents=4, mesh=mesh)
    state = init_fn({n: t.to(dev) for n, t in weights.items()})
    before = (k4.LAUNCHES, k7.LAUNCHES)
    rows = []
    for i in range(steps):
        toks, labels = stream.batch(i)
        state, m = step_fn(state, agent_batch(
            {"tokens": torch.as_tensor(toks, device=dev),
             "labels": torch.as_tensor(labels, device=dev)}, 4))
        rows.append((float(m["loss"]), int(m["comms"]),
                     float(m["send_frac"])))
    return rows, (k4.LAUNCHES - before[0], k7.LAUNCHES - before[1])


def _card_train_rank(rank, world, store, out):
    """A rank of the test below: the reduced coke run on a (4, 1) mesh of
    `world` gloo ranks that share cuda:0."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_host_mesh(4, 1, device="cuda:0", group=dist.group.WORLD)
        rows, launches = _reduced_coke_run(torch.device("cuda:0"), mesh)
        torch.save({"rows": rows, "launches": launches,
                    "card_shared": mesh.card_shared},
                   f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_training_with_agents_on_ranks_sharing_the_card_matches_the_cpu(
        cuda, tmp_path):
    """The reduced coke run of the test above with its 4 agents on W = 2
    gloo ranks that share the card (two agents a rank; the large gathers
    by CUDA IPC), against the same run on the CPU in one process: comms
    and send_frac equal every step, losses within phase 20(d)'s 1e-4
    relative; every rank's steps bitwise its peer's; K4 and K7 once per
    layer per agent a rank holds per step."""
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    mp.start_processes(_card_train_rank, args=(2, str(tmp_path / "store"),
                                               str(tmp_path)),
                       nprocs=2, join=True, start_method="spawn")
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    cpu, launched = _reduced_coke_run(torch.device("cpu"))
    assert launched == (0, 0)
    layers = get_config("qwen3-1.7b").reduced().num_layers
    for res in ranks:
        assert res["card_shared"]
        assert res["rows"] == ranks[0]["rows"]
        assert res["launches"] == (6 * 2 * layers,) * 2
    card = ranks[0]["rows"]
    assert [r[1:] for r in card] == [r[1:] for r in cpu]
    for (lc, _, _), (lg, _, _) in zip(card, cpu):
        assert abs(lc - lg) <= 1e-4 * abs(lg)


def test_hybrid_training_through_k7_at_head_dim_80_matches_the_cpu(cuda):
    """The reduced zamba2 with its shared block at Dh = Dv = 80 (K7's
    width-128 instances), 4 agents on a ring, coke (v=20, mu=0.5), 4 steps
    on the card and on the CPU from the same weights: comms and send_frac
    equal, losses within 1e-4 relative; K4 and K7 once per shared-block
    application per agent per step."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.distributed.consensus import ConsensusConfig
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train.steps import agent_batch, make_train_step
    cfg = get_config("zamba2-2.7b").reduced().with_overrides(head_dim=80)
    apps = cfg.num_layers // cfg.shared_attn_every
    weights = M.param_dict(M.init_params(cfg, torch.Generator().manual_seed(0)))
    stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size,
                                           seq_len=48, global_batch=8,
                                           structure=0.9))
    ccfg = ConsensusConfig(strategy="coke", rho=1e-3, censor_v=20.0,
                           censor_mu=0.5)
    runs = {}
    for dev in ("cpu", cuda):
        init_fn, step_fn, _ = make_train_step(cfg, OptConfig(lr=3e-3), ccfg,
                                              num_agents=4)
        state = init_fn({n: t.to(dev) for n, t in weights.items()})
        before = (k4.LAUNCHES, k7.LAUNCHES)
        rows = []
        for i in range(4):
            toks, labels = stream.batch(i)
            b = agent_batch({"tokens": torch.as_tensor(toks, device=dev),
                             "labels": torch.as_tensor(labels, device=dev)},
                            4)
            state, m = step_fn(state, b)
            rows.append((float(m["loss"]), int(m["comms"]),
                         float(m["send_frac"])))
        runs[str(dev)] = rows
        launched = (k4.LAUNCHES - before[0], k7.LAUNCHES - before[1])
        assert launched == ((0, 0) if dev == "cpu" else (4 * 4 * apps,) * 2)
    cpu, card = runs["cpu"], runs[str(cuda)]
    assert [r[1:] for r in card] == [r[1:] for r in cpu]
    for (lc, _, _), (lg, _, _) in zip(card, cpu):
        assert abs(lc - lg) <= 1e-4 * abs(lg)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v2-lite-16b",
                                  "mixtral-8x7b"])
def test_moe_and_mla_training_through_k7_matches_the_cpu(cuda, arch,
                                                         monkeypatch):
    """The reduced MLA (Dh 48 / Dv 32) and MoE models, 4 agents on a ring,
    coke (v=20, mu=0.5), B=8 S=96 (Mixtral's window of 64 bites, and each
    agent's 192 tokens fill three MoE groups of 64): at each of 3 steps the
    card takes the CPU's state and runs that step and the next
    (`chip_smoke.card_cpu_hold`). Every MoE layer's expert indices and
    drop set equal the CPU's, comms and send_frac equal, losses within
    1e-4 relative; K4 and K7 once per layer per agent."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.distributed.consensus import ConsensusConfig
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    smoke = _chip_smoke()
    cfg = get_config(arch).reduced()
    weights = M.param_dict(M.init_params(cfg, torch.Generator().manual_seed(0)))
    stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size,
                                           seq_len=96, global_batch=8,
                                           structure=0.9))
    routes = []
    route = moe_mod.route

    def recorded(*args, **kw):
        r = route(*args, **kw)
        routes.append((r.expert_idx.cpu(), r.keep.cpu()))
        return r

    monkeypatch.setattr(moe_mod, "route", recorded)
    ccfg = ConsensusConfig(strategy="coke", rho=1e-3, censor_v=20.0,
                           censor_mu=0.5)
    before = (k4.LAUNCHES, k7.LAUNCHES)
    h = smoke.card_cpu_hold(cuda, cfg, weights, stream, ccfg, 4, 3,
                            routes=routes)
    # each agent's forward once per layer: 3 forced steps, 2 next, 3 free
    n = 4 * cfg.num_layers * (3 * 3 - 1)
    assert (k4.LAUNCHES - before[0], k7.LAUNCHES - before[1]) == (n, n)
    for card_routes, cpu_routes in h["routed"]:
        assert len(card_routes) == len(cpu_routes) == \
            (4 * cfg.num_layers if cfg.is_moe else 0)
        for (ei_c, keep_c), (ei, keep) in zip(card_routes, cpu_routes):
            assert torch.equal(ei_c, ei) and torch.equal(keep_c, keep)
    assert h["same"] and h["same_forced"]
    assert h["worst_step"] <= 1e-4 and h["worst_next"] <= 1e-4


@pytest.mark.parametrize("arch", ["internvl2-1b", "seamless-m4t-medium"])
def test_multimodal_training_through_k7_matches_the_cpu(cuda, arch):
    """The reduced VLM at 14 query heads over 2 KV heads (K7 sums groups of
    7) on its 8 patch rows + 88 tokens, and the reduced enc-dec model on
    80 frames + 48 tokens (the encoder without the mask, the cross
    attention at Sq < Sk, neither on a tile boundary), 4 agents on a
    ring, coke (v=20, mu=0.5), B=8, with the stub embeddings seeded
    normals made once on the CPU: at each of 3 steps the card takes the
    CPU's state and runs that step and the next
    (`chip_smoke.card_cpu_hold`). Comms and send_frac equal, losses
    within 1e-5 relative (chip_smoke's TRAIN_MOE_MLA_RTOL); K4 and K7 once
    per attention per agent's forward (one per layer; one per encoder
    layer and two per decoder layer)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.distributed.consensus import ConsensusConfig
    from repro_torch.models import model as M
    smoke = _chip_smoke()
    cfg = get_config(arch).reduced()
    g = torch.Generator().manual_seed(27)
    if cfg.is_encdec:
        frames, text = smoke.MM_TRAIN_ENC
        extra = {"encoder_embeds": torch.randn((8, frames, cfg.d_model),
                                               generator=g)}
        attentions = cfg.encoder_layers + 2 * cfg.num_layers
    else:
        cfg = cfg.with_overrides(num_heads=14, num_kv_heads=2)
        text = smoke.MM_TRAIN_VLM_TOKENS
        extra = {"prefix_embeds": torch.randn(
            (8, cfg.prefix_len, cfg.d_model), generator=g)}
        attentions = cfg.num_layers
    weights = M.param_dict(M.init_params(cfg, torch.Generator().manual_seed(0)))
    stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size,
                                           seq_len=text, global_batch=8,
                                           structure=0.9))
    ccfg = ConsensusConfig(strategy="coke", rho=1e-3, censor_v=20.0,
                           censor_mu=0.5)
    before = (k4.LAUNCHES, k7.LAUNCHES)
    h = smoke.card_cpu_hold(cuda, cfg, weights, stream, ccfg, 4, 3,
                            extra=extra)
    # each agent's forward: 3 forced steps, 2 next, 3 free
    n = 4 * attentions * (3 * 3 - 1)
    assert (k4.LAUNCHES - before[0], k7.LAUNCHES - before[1]) == (n, n)
    assert h["same"] and h["same_forced"]
    tol = smoke.TRAIN_MOE_MLA_RTOL
    assert h["worst_step"] <= tol and h["worst_next"] <= tol


# ---------------------------------------------------------------------------
# K6, the gathered row-dot, and many-model serving
# ---------------------------------------------------------------------------

# K6 sums D products in its own order (a chain of D/32 + 5 adds per row);
# the plain version in ATen's: within ROWDOT_RTOL of sum_k |phi theta|
ROWDOT_RTOL = 1e-5


def _rowdot_operands(cuda, b, m, d, seed=0):
    g = _gen(cuda, seed)
    phi = math.sqrt(2.0 / d) * torch.cos(
        6.3 * torch.rand((b, d), generator=g, device=cuda))
    stack = torch.randn((m, d), generator=g, device=cuda)
    slots = torch.randint(0, m, (b,), generator=g, device=cuda)
    return phi, stack, slots.to(torch.int32).cpu().numpy()


@pytest.mark.parametrize("d", [16, 4093, 4096])
@pytest.mark.parametrize("b", [1, 2, 31, 1024])
def test_rowdot_kernel_matches_plain(cuda, b, d):
    """Both instances (16-byte loads at D % 4 == 0, aligned; 4-byte
    otherwise) against the plain version, and the 4-byte instance on an
    unaligned copy of the same operands gives the 16-byte instance's
    bits: the two walk one order."""
    from repro_torch.kernels.rowdot import rowdot as k6
    from repro_torch.kernels.rowdot.ref import gather_rowdot_ref
    phi, stack, slots = _rowdot_operands(cuda, b, 300, d)
    before = k6.LAUNCHES
    got = k6.gather_rowdot(phi, stack, slots)
    torch.cuda.synchronize()
    assert k6.LAUNCHES == before + 1
    want = gather_rowdot_ref(phi, stack, torch.from_numpy(slots).to(cuda))
    scale = (phi * stack[torch.from_numpy(slots).long().to(cuda)]).abs() \
        .sum(-1)
    assert bool(((got - want).abs() <= ROWDOT_RTOL * scale).all())
    assert torch.equal(got, k6.gather_rowdot(phi, stack, slots))
    off_phi = torch.empty(b * d + 1, device=cuda)[1:].view(b, d)
    off_phi.copy_(phi)
    assert k6.staging(off_phi, stack) == "4-byte"
    assert torch.equal(k6.gather_rowdot(off_phi, stack, slots), got)


def test_rowdot_kernel_raises_on_operands_it_does_not_take(cuda):
    from repro_torch.kernels.rowdot import rowdot as k6
    phi, stack, slots = _rowdot_operands(cuda, 4, 6, 8)
    with pytest.raises(ValueError, match="host int32"):
        k6.gather_rowdot(phi, stack, torch.from_numpy(slots).to(cuda))
    with pytest.raises(ValueError, match="lies on"):
        k6.gather_rowdot(phi, stack.cpu(), slots)
    with pytest.raises(IndexError):
        k6.gather_rowdot(phi, stack, slots + 6)


def test_k1_then_k6_rows_do_not_depend_on_the_batch(cuda):
    """The multi-tenant scorer on the card (K1, then K6): rows scored at
    B = 1, 2, 31 give the bits of the same rows inside B = 1024, with the
    slots gathered or as (b, D) theta rows."""
    from repro_torch.api.model import score_rows
    from repro_torch.core.rff import RFFParams
    from repro_torch.kernels.rowdot import rowdot as k6
    g = _gen(cuda, 3)
    D = 4096
    params = RFFParams(omega=torch.randn((5, D), generator=g, device=cuda),
                       bias=2 * math.pi * torch.rand((D,), generator=g,
                                                     device=cuda))
    x = torch.rand((1024, 5), generator=g, device=cuda)
    stack = torch.randn((500, D), generator=g, device=cuda)
    slots = np.random.default_rng(0).integers(0, 500, 1024).astype(np.int32)
    before = (k1.LAUNCHES, k6.LAUNCHES)
    full = score_rows(params, x, stack, slots, backend="fused")
    torch.cuda.synchronize()
    assert (k1.LAUNCHES, k6.LAUNCHES) == (before[0] + 1, before[1] + 1)
    for lo, n in ((0, 1), (7, 2), (300, 31), (993, 31)):
        part = score_rows(params, x[lo:lo + n].contiguous(), stack,
                          slots[lo:lo + n], backend="fused")
        rows = stack[torch.from_numpy(slots[lo:lo + n]).long().to(cuda)]
        own = score_rows(params, x[lo:lo + n].contiguous(), rows,
                         backend="fused")
        assert torch.equal(part, full[lo:lo + n]), (lo, n)
        assert torch.equal(own, full[lo:lo + n]), (lo, n)


def test_multi_tenant_server_on_card_launches_k1_and_k6_per_bucket(cuda):
    """A short multi-tenant run on the card with backend="fused": one K1
    and one K6 launch per bucket call, every answer bitwise its model's
    score_rows at the request's own row count, and faults past a small
    store."""
    import tempfile

    from repro_torch.api import KernelModel
    from repro_torch.core.rff import RFFParams
    from repro_torch.kernels.rowdot import rowdot as k6
    from repro_torch.serve import (KernelServeConfig, KernelServer,
                                   ModelRegistry)
    g = _gen(cuda, 5)
    D = 256
    params = RFFParams(omega=torch.randn((5, D), generator=g, device=cuda),
                       bias=2 * math.pi * torch.rand((D,), generator=g,
                                                     device=cuda))
    base = KernelModel(params, torch.randn((D,), generator=g, device=cuda))
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        reg = ModelRegistry(tmp, device=cuda)
        thetas = {}
        for i in range(12):
            th = base.theta + 0.1 * torch.randn((D,), generator=g,
                                                device=cuda)
            reg.publish(f"m{i}", base.replace(theta=th))
            thetas[f"m{i}"] = th
        server = KernelServer(registry=reg, store_capacity=4,
                              config=KernelServeConfig(backend="fused",
                                                       max_delay_ms=2.0),
                              autostart=False, device=cuda)
        reqs = []
        for _ in range(40):
            mid = f"m{rng.integers(0, 12)}"
            x = rng.uniform(size=(int(rng.integers(1, 6)), 5)).astype(
                np.float32)
            reqs.append((mid, x, server.submit(x, mid)))
        before = (k1.LAUNCHES, k6.LAUNCHES)
        server.start()
        outs = [f.result(timeout=60) for _, _, f in reqs]
        server.stop()
        launched = (k1.LAUNCHES - before[0], k6.LAUNCHES - before[1])
        stats = server.stats()
        assert launched == (stats["batches"], stats["batches"])
        assert stats["store"]["faults"] > 0
        for (mid, x, _), out in zip(reqs, outs):
            rows = thetas[mid].expand(x.shape[0], D)
            want = base.score_rows(x, rows, backend="fused")
            assert np.array_equal(out, want.cpu().numpy()), mid


# ---------------------------------------------------------------------------
# Big-D sharding: the kernels once per block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,data,model", [(20, 4096, 2, 4),
                                            (8, 65536, 1, 4)], ids=str)
def test_fused_update_once_per_block_matches_plain(cuda, n, d, data, model):
    """K3 on a feature-sharded carry: one launch per block, each block's
    g_aug against the plain version on that block, and xi^2 as the psum
    of the blocks' partials against the plain unsharded xi^2."""
    from repro_torch.distributed import sharding
    from repro_torch.kernels.coke_update import ops as k3_ops
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data, model, device=cuda)
    ops = _update_operands(cuda, n, d, misalign=False)
    th, hat, gm, gr, half, _ = ops
    kw = dict(rho=0.37, deg=2.0)
    want, want_xi = coke_update_ref(th, hat, gm, gr, half, half, **kw)
    blocked = [sharding.shard_features(t, mesh, n)
               for t in (th, hat, gm, gr, half)]
    before = k2.FUSED_UPDATE_LAUNCHES
    got, xi = k3_ops.coke_update_blocks(*blocked, blocked[4], **kw)
    torch.cuda.synchronize()
    assert k2.FUSED_UPDATE_LAUNCHES == before + data * model
    for blk in got.blocks.values():
        assert blk.shape == (n // data, d // model)
    scale = max(float(t.abs().max()) for t in (
        gr, 2.0 * 0.37 * 2.0 * th, gm, 0.37 * (2.0 * hat + 2 * half)))
    torch.testing.assert_close(sharding.unshard(got), want, rtol=0,
                               atol=UPDATE_ULPS * scale)
    torch.testing.assert_close(sharding.unshard(xi), want_xi,
                               rtol=UPDATE_XI_RTOL,
                               atol=UPDATE_XI_RTOL * float(want_xi.max()))


@pytest.mark.parametrize("d_block", [1024, 16384])
def test_rowdot_on_a_column_block_matches_plain(cuda, d_block):
    """K6 on a contiguous (M, D/s) column block of a sharded stack, as a
    sharded bucket call runs it, against the plain version on the block;
    K1 on the matching feature block with the whole map's scale gives
    those columns of the whole map."""
    from repro_torch.distributed import sharding
    from repro_torch.kernels.rowdot import rowdot as k6
    from repro_torch.kernels.rowdot.ref import gather_rowdot_ref
    from repro_torch.launch.mesh import make_host_mesh
    D = 4 * d_block
    mesh = make_host_mesh(1, 4, device=cuda)
    g = _gen(cuda, 9)
    stack = torch.randn((300, D), generator=g, device=cuda)
    phi = torch.randn((64, D), generator=g, device=cuda)
    slots = np.random.default_rng(1).integers(0, 300, 64).astype(np.int32)
    bstack = sharding.shard_theta_stack(stack, mesh)
    bphi = sharding.shard(phi, mesh, sharding.P(None, "model"))
    for m in range(4):
        blk = sharding.local_block(bstack, 0, m)
        assert blk.is_contiguous() and blk.shape == (300, d_block)
        p = sharding.local_block(bphi, 0, m)
        before = k6.LAUNCHES
        got = k6.gather_rowdot(p, blk, slots)
        torch.cuda.synchronize()
        assert k6.LAUNCHES == before + 1
        want = gather_rowdot_ref(p, blk, torch.from_numpy(slots).to(cuda))
        scale = (p * blk[torch.from_numpy(slots).long().to(cuda)]).abs() \
            .sum(-1)
        assert bool(((got - want).abs() <= ROWDOT_RTOL * scale).all())
    x = torch.rand((257, 5), generator=g, device=cuda)
    om = torch.randn((5, D), generator=g, device=cuda)
    b = 2 * math.pi * torch.rand((D,), generator=g, device=cuda)
    cols = slice(d_block, 2 * d_block)
    part = k1.rff_cos_bias(x, om[:, cols].contiguous(), b[cols].contiguous(),
                           num_features=D)
    torch.testing.assert_close(part, rff_ref(x, om, b)[:, cols], rtol=0,
                               atol=RFF_ATOL)


def test_sharded_fit_and_serving_on_card_match_cpu(cuda):
    """fit(mesh=) on a (2, 4) card mesh against the same fit on a CPU
    mesh (CG on spmd, the fused fallback through K3 once per block), then
    the sharded model's fused predict: K1 once per feature block."""
    from repro_torch.distributed import sharding
    from repro_torch.kernels.rff import rff as k1mod
    from repro_torch.launch.mesh import make_host_mesh
    cfg = FitConfig(krr=KRRConfig(num_agents=4, samples_per_agent=40,
                                  num_features=256, lam=1e-2, rho=0.1,
                                  seed=0),
                    graph="ring", algorithm="coke", censor_v=0.3,
                    censor_mu=0.97, num_iters=10, primal="cg")
    built = build_problem(cfg, device="cpu")
    for backend, primal in (("spmd", "cg"), ("fused", "gradient")):
        c = cfg.replace(backend=backend, primal=primal)
        before = k2.FUSED_UPDATE_LAUNCHES
        card = fit(c, problem=built.problem, device=cuda,
                   mesh=make_host_mesh(2, 4, device=cuda))
        torch.cuda.synchronize()
        if backend == "fused":
            assert k2.FUSED_UPDATE_LAUNCHES == before + 8 * 10
        cpu = fit(c, problem=built.problem, device="cpu",
                  mesh=make_host_mesh(2, 4, device="cpu"))
        assert torch.equal(card.history["comms"].cpu(), cpu.history["comms"])
        assert torch.equal(card.history["bits"].cpu(), cpu.history["bits"])
        torch.testing.assert_close(card.theta.cpu(), cpu.theta, rtol=0,
                                   atol=1e-4)
    model = card.to_model(built.rff_params.to(cuda)).shard(
        make_host_mesh(2, 4, device=cuda))
    x = torch.rand((300, 5), device=cuda)
    before = k1mod.LAUNCHES
    got = model.predict(x, backend="fused")
    torch.cuda.synchronize()
    assert k1mod.LAUNCHES == before + 4
    want = card.to_model(built.rff_params.to(cuda)).predict(x, backend="ref")
    assert isinstance(model.theta, sharding.Blocked)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
