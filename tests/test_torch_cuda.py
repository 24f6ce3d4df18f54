"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. These need a CUDA card and skip elsewhere; the file imports
only torch, numpy and repro_torch, so it runs on a machine without jax:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: fp32 with another summation order than cuBLAS (see the
comments beside each).
"""
import math

import numpy as np
import pytest
import torch

import dataclasses

from repro_torch.api import FitConfig, KRRConfig, build_problem, fit
from repro_torch.kernels.coke_update import coke_update as k2
from repro_torch.kernels.coke_update.ref import (coke_megastep_ref,
                                                 coke_update_ref)
from repro_torch.kernels.rff import rff as k1
from repro_torch.kernels.rff.ref import rff_ref

# phi: the kernel's fmaf chain and cuBLAS round the projection x @ omega
# (|.| < ~20 for x in [0, 1], d <= 96) differently; cos passes a few ulps
# of it on, times sqrt(2/L) <= 0.25
RFF_ATOL = 1e-5
# theta', xi_sq: fp32 sums of T*D products in another order
MEGA_RTOL = 1e-5

RFF_SHAPES = [(64, 5, 32), (300, 77, 100), (128, 96, 200), (33, 13, 50),
              (1000, 5, 513)]
MEGA_SHAPES = [(4, 40, 32, (1,)), (2, 33, 513, (1,)), (8, 64, 100, (1, 2)),
               (3, 17, 128, (1,)), (5, 128, 256, (2,)), (20, 350, 4096, (1,))]
# K3: g_aug is formed in the plain expression's order with round-to-nearest
# intrinsics, so it may differ from the plain version only where a compiler
# contracted a product into an FMA: a few ulps of the largest term. xi_sq
# is an fp32 sum over D in another order.
UPDATE_ULPS = 4 * 2.0**-23
UPDATE_XI_RTOL = 1e-5
UPDATE_SHAPES = [(1, 1, 2.0), (3, 513, 2.0), (7, 1000, 4.0), (3, 512, 4.0),
                 (20, 4096, 2.0)]


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


@pytest.mark.parametrize("n,t,d,offsets", MEGA_SHAPES, ids=str)
def test_megastep_kernel_matches_plain(cuda, n, t, d, offsets):
    g = _gen(cuda, 1)
    theta, hat = (torch.randn((n, d), generator=g, device=cuda)
                  for _ in range(2))
    gamma = 0.1 * torch.randn((n, d), generator=g, device=cuda)
    phi = torch.randn((n, t, d), generator=g, device=cuda)
    y = torch.randn((n, t), generator=g, device=cuda)
    kw = dict(rho=0.3, lam=1e-2, lr=0.05, offsets=offsets)
    want, want_xi = coke_megastep_ref(theta, hat, gamma, phi, y, **kw)
    before = k2.LAUNCHES
    got, xi = k2.coke_megastep(theta, hat, gamma, phi, y, **kw)
    torch.cuda.synchronize()
    assert got is theta                       # written in place
    assert k2.LAUNCHES == before + k2.LAUNCHES_PER_CALL
    for w, o in ((want, got), (want_xi, xi)):
        scale = float(w.abs().max())
        torch.testing.assert_close(o, w, rtol=MEGA_RTOL,
                                   atol=MEGA_RTOL * scale)


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
