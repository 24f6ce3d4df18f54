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
                                                 coke_update_ref)
from repro_torch.kernels.flash_attention import flash_attention as k4
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
               (1, 2, 2, 50, 50, 33, 17, True, 0)]


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
