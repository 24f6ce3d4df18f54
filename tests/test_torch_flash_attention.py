"""The port's flash attention (K4) against the JAX reference, on the CPU.

On CPU tensors the port's `flash_attention` and `gqa_flash` run their
plain version (`ref.attention_ref`); they are held against the reference's
Pallas kernel in interpret mode (as tests/test_kernels.py runs it), its
`attention_ref` and, for the grouped layout, its `blockwise_attention`, on
the same numpy-made inputs. The CUDA kernel itself runs only on a card:
tests/test_torch_cuda.py compares it with the plain version there.

Tolerances: fp32 2e-5 absolute, the reference's own kernel-vs-oracle
tolerance (tests/test_kernels.py); bf16 3e-2, its bf16 tolerance (an ulp
of bf16 is 2^-7 relative, and the outputs of unit normals stay below ~3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention as jax_flash
from repro.kernels.flash_attention.ops import gqa_flash as jax_gqa_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models.attention import blockwise_attention

from repro_torch.kernels.flash_attention import flash_attention as port_fa
from repro_torch.kernels.flash_attention.ops import gqa_flash
from repro_torch.kernels.flash_attention.ref import attention_ref

torch.set_num_threads(2)

TOL = {"f32": 2e-5, "bf16": 3e-2}
JAX_DTYPE = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}


def _normals(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _pair(arr, dtype):
    """The same values for both packages, rounded to `dtype` by each."""
    return (jnp.asarray(arr).astype(JAX_DTYPE[dtype]),
            torch.from_numpy(arr).to(TORCH_DTYPE[dtype]))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# the reference's sweep (tests/test_kernels.py), in fp32 and bf16
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("Sq,Sk,blocks", [(128, 128, 64), (100, 100, 32),
                                          (257, 257, 128)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32),
                                           (False, 0)])
def test_flash_attention_matches_reference_kernel_and_oracle(
        Sq, Sk, blocks, causal, window, dtype):
    B, H, Dh = 2, 3, 16
    qn, kn, vn = _normals(4, (B, H, Sq, Dh), (B, H, Sk, Dh), (B, H, Sk, Dh))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (qn, kn, vn))
    before = port_fa.LAUNCHES
    got = port_fa.flash_attention(tq, tk, tv, causal=causal, window=window,
                                  block_q=blocks, block_k=blocks)
    assert port_fa.LAUNCHES == before            # CPU: the plain version
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (B, H, Sq, Dh)
    kernel = jax_flash(jq, jk, jv, causal=causal, window=window,
                       block_q=blocks, block_k=blocks)
    oracle = jax_ref(jq, jk, jv, causal=causal, window=window)
    for want in (kernel, oracle):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (8, 2)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_gqa_flash_matches_reference_grouped(H, KV, causal, window, dtype):
    """The model's layout with grouped heads: against the reference's
    gqa_flash (which repeats K and V, kernel in interpret mode) and its
    blockwise_attention (the jnp path of the model's prefill)."""
    B, S, Dh = 2, 96, 32
    qn, kn, vn = _normals(5, (B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (qn, kn, vn))
    got = gqa_flash(tq, tk, tv, causal=causal, window=window)
    assert got.shape == (B, S, H, Dh) and got.dtype == TORCH_DTYPE[dtype]
    kernel = jax_gqa_flash(jq, jk, jv, causal=causal, window=window,
                           block_q=32, block_k=32)
    pos = jnp.arange(S, dtype=jnp.int32)
    blockwise = blockwise_attention(jq, jk, jv, pos, pos, causal=causal,
                                    window=window, block_q=32, block_k=32)
    for want in (kernel, blockwise):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=TOL[dtype])


@pytest.mark.parametrize("Sq,Sk", [(70, 130), (130, 70), (1, 50)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0)])
def test_head_dims_and_lengths_that_differ(Sq, Sk, causal, window):
    """Dh != Dv and Sq != Sk (query i and key j at positions i and j, as in
    the reference), against the reference kernel and oracle."""
    B, H, Dh, Dv = 1, 2, 48, 24
    qn, kn, vn = _normals(6, (B, H, Sq, Dh), (B, H, Sk, Dh), (B, H, Sk, Dv))
    got = port_fa.flash_attention(*(torch.from_numpy(a) for a in (qn, kn, vn)),
                                  causal=causal, window=window)
    assert got.shape == (B, H, Sq, Dv)
    jargs = [jnp.asarray(a) for a in (qn, kn, vn)]
    kernel = jax_flash(*jargs, causal=causal, window=window, block_q=32,
                       block_k=32)
    oracle = jax_ref(*jargs, causal=causal, window=window)
    # with a window and Sq > Sk + window - 1 the last rows see no key: 0 in
    # the port (test_rows_no_key_may_see_are_zero), compared elsewhere
    seen = ~((np.arange(Sq) >= Sk + window - 1) & (window > 0))
    assert (got.numpy()[:, :, ~seen] == 0).all()
    for want in (kernel, oracle):
        np.testing.assert_allclose(got.numpy()[:, :, seen],
                                   np.asarray(want)[:, :, seen], rtol=0,
                                   atol=TOL["f32"])


# the VLM and enc-dec serving shapes (B, H, KV, Sq, Sk, Dh, Dv, causal,
# window), as in tests/test_torch_cuda.py::ATTN_SHAPES: internvl2-1b's 14
# query heads over 2 KV heads, causal; seamless-m4t-medium's cross
# attention, no mask, Sq != Sk
@pytest.mark.parametrize("shape", [(1, 14, 2, 300, 300, 64, 64, True, 0),
                                   (1, 4, 4, 64, 300, 64, 64, False, 0)],
                         ids=str)
def test_gqa_flash_matches_reference_at_the_multimodal_shapes(shape):
    """The model's layout, fp32: against the reference's gqa_flash (its
    Pallas kernel in interpret mode, K and V repeated) and its
    blockwise_attention."""
    B, H, KV, Sq, Sk, Dh, Dv, causal, window = shape
    qn, kn, vn = _normals(8, (B, Sq, H, Dh), (B, Sk, KV, Dh), (B, Sk, KV, Dv))
    got = gqa_flash(*(torch.from_numpy(a) for a in (qn, kn, vn)),
                    causal=causal, window=window)
    assert got.shape == (B, Sq, H, Dv)
    jq, jk, jv = (jnp.asarray(a) for a in (qn, kn, vn))
    kernel = jax_gqa_flash(jq, jk, jv, causal=causal, window=window,
                           block_q=64, block_k=64)
    blockwise = blockwise_attention(
        jq, jk, jv, jnp.arange(Sq, dtype=jnp.int32),
        jnp.arange(Sk, dtype=jnp.int32), causal=causal, window=window,
        block_q=64, block_k=64)
    for want in (kernel, blockwise):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL["f32"])


@pytest.mark.parametrize("causal", [True, False])
def test_rows_no_key_may_see_are_zero(causal):
    """With a window and Sq > Sk + window - 1, the last rows may see no key.
    The port (plain version and kernel alike) writes 0 there; the
    reference's attention_ref averages every key's value (a uniform softmax
    over -1e30 scores) and its padded kernel depends on the block size.
    Every other row agrees with the reference (ROADMAP Queue 3)."""
    B, H, Sq, Sk, D, window = 1, 2, 60, 20, 16, 8
    qn, kn, vn = _normals(7, (B, H, Sq, D), (B, H, Sk, D), (B, H, Sk, D))
    got = port_fa.flash_attention(*(torch.from_numpy(a) for a in (qn, kn, vn)),
                                  causal=causal, window=window).numpy()
    keyless = np.arange(Sq) >= Sk + window - 1
    assert keyless.sum() == Sq - (Sk + window - 1)
    assert (got[:, :, keyless] == 0).all()
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in (qn, kn, vn)),
                              causal=causal, window=window))
    np.testing.assert_allclose(got[:, :, ~keyless], want[:, :, ~keyless],
                               rtol=0, atol=TOL["f32"])
    np.testing.assert_allclose(want[:, :, keyless],
                               np.broadcast_to(vn.mean(axis=2, keepdims=True),
                                               want[:, :, keyless].shape),
                               rtol=0, atol=1e-5)


def test_attention_ref_groups_heads_without_repeat_by_the_caller():
    """The plain version takes KV < H heads itself (head h reads KV head
    h // (H // KV)), as the kernel does."""
    B, H, KV, S, D = 2, 6, 2, 40, 8
    qn, kn, vn = _normals(8, (B, H, S, D), (B, KV, S, D), (B, KV, S, D))
    got = attention_ref(*(torch.from_numpy(a) for a in (qn, kn, vn)))
    want = jax_ref(jnp.asarray(qn), jnp.repeat(jnp.asarray(kn), 3, axis=1),
                   jnp.repeat(jnp.asarray(vn), 3, axis=1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL["f32"])


def _qkv(dtype=torch.float32, H=2, KV=2, Dh=16, Dv=16):
    g = torch.Generator().manual_seed(0)
    return (torch.randn((1, H, 8, Dh), generator=g).to(dtype),
            torch.randn((1, KV, 8, Dh), generator=g).to(dtype),
            torch.randn((1, KV, 8, Dv), generator=g).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64],
                         ids=["f16", "f64"])
def test_dtypes_the_kernel_does_not_take_raise(dtype):
    for fn in (port_fa.flash_attention, gqa_flash):
        with pytest.raises(TypeError):
            fn(*_qkv(dtype))
    q, k, v = _qkv()
    with pytest.raises(TypeError):
        port_fa.flash_attention(q, k.to(torch.bfloat16), v)


@pytest.mark.parametrize("H,KV,Dh,Dv", [(2, 2, 257, 16), (2, 2, 16, 300),
                                        (3, 2, 16, 16)])
def test_head_dims_the_kernel_does_not_take_raise(H, KV, Dh, Dv):
    with pytest.raises(ValueError):
        port_fa.flash_attention(*_qkv(H=H, KV=KV, Dh=Dh, Dv=Dv))


def test_devices_and_arguments_the_kernel_does_not_take_raise():
    q, k, v = _qkv()
    with pytest.raises(ValueError):
        port_fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError):
        port_fa.flash_attention(q, k.to("meta"), v)
    with pytest.raises(ValueError):
        port_fa.flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError):
        port_fa.flash_attention(q, k, v, block_q=0)
    with pytest.raises(TypeError):
        port_fa.flash_attention(q, k, v, causal=1)
    with pytest.raises(ValueError):
        gqa_flash(q[0], k[0], v[0])


# ---- the CUDA kernel's fp32 design (3xTF32), emulated on the CPU ----------
#
# On the card the fp32 instance of K4 computes both products on TF32 tensor
# cores: each fp32 operand x is split into big = rna_tf32(x) and small, the
# rest x - big in TF32, and each product accumulates small*big + big*small
# (in an accumulator of their own) + big*big in fp32. The kernel truncates
# the rest (rz_tf32) where CUTLASS rounds it (rna_tf32); both are emulated.
# The tests below emulate that arithmetic in torch (a TF32 x TF32 product
# is exact in fp32, so an fp32 matmul of TF32-valued operands is the MMA's
# product) and the fragment maps the kernel relies on.

def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round the low 13 to nearest
    with ties away from zero (add half an ulp to the magnitude, truncate)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _rz_tf32(x: torch.Tensor) -> torch.Tensor:
    """TF32 by truncation: the low 13 mantissa bits cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor, small=_rz_tf32
               ) -> torch.Tensor:
    a_big, b_big = _rna_tf32(a), _rna_tf32(b)
    a_small, b_small = small(a - a_big), small(b - b_big)
    out = a_small @ b_big          # small terms first, as CUTLASS does
    out = out + a_big @ b_small
    return out + a_big @ b_big


def _mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _rna_tf32(a) @ _rna_tf32(b)


def _attention_with(mm, q, k, v, *, causal, window):
    """The kernel's arithmetic with products by `mm`: fp32 scores, masked
    to -inf, exp(s - m) with the fp32 running max, O = mm(P, V) / l."""
    Sq, Sk = q.shape[-2], k.shape[-2]
    s = mm(q, k.transpose(-1, -2)) * (1.0 / q.shape[-1] ** 0.5)
    qi = torch.arange(Sq)[:, None]
    kj = torch.arange(Sk)[None, :]
    valid = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        valid &= kj <= qi
    if window:
        valid &= kj > qi - window
    s = torch.where(valid, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = mm(p, v)
    return torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)


def test_tf32_roundings():
    one = 1.0 + 2.0**-10                          # the TF32 ulp above 1
    x = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11),   # ties: away
                      1.0 + 2.0**-11 - 2.0**-23,          # below: down
                      1.0 + 2.0**-11 + 2.0**-23, 3.0, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([one, -one, 1.0, one, 3.0, 0.0], dtype=torch.float32)
    assert torch.equal(_rna_tf32(x), want)
    r = torch.from_numpy(_normals(9, (1000,))[0])
    big = _rna_tf32(r)
    assert torch.equal(_rna_tf32(big), big)       # 10 mantissa bits kept
    assert float(((r - big).abs() / r.abs()).max()) <= 2.0**-11
    cut = _rz_tf32(r)
    assert torch.equal(_rz_tf32(cut), cut)
    assert bool((cut.abs() <= r.abs()).all())     # toward zero
    assert float(((r - cut).abs() / r.abs()).max()) < 2.0**-10
    # the split: big + small is x within 2^-21 relative (truncated small)
    small = _rz_tf32(r - big)
    assert float(((r - big - small).abs() / r.abs()).max()) <= 2.0**-21


# (Sq, Sk, Dh, Dv, causal, window): shapes of chip_smoke.py's K4 sweep
@pytest.mark.parametrize("small", [_rz_tf32, _rna_tf32],
                         ids=["small_rz_kernel", "small_rna_cutlass"])
@pytest.mark.parametrize("Sq,Sk,Dh,Dv,causal,window", [
    (100, 100, 64, 64, True, 0), (257, 257, 128, 128, True, 0),
    (257, 257, 128, 128, False, 32), (300, 700, 192, 128, False, 0),
    (700, 300, 128, 128, True, 0), (1024, 1024, 64, 64, True, 32)],
    ids=str)
def test_3xtf32_attention_meets_the_fp32_tolerance(Sq, Sk, Dh, Dv, causal,
                                                   window, small):
    """3xTF32 products give attention within the fp32 tolerance (2e-5) of
    the plain fp32 version, with the rest truncated (the kernel) or rounded
    (CUTLASS); single-pass TF32 does not, which is why the kernel takes
    three MMAs per product."""
    B, H = 1, 2
    qn, kn, vn = _normals(10, (B, H, Sq, Dh), (B, H, Sk, Dh), (B, H, Sk, Dv))
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    want = attention_ref(q, k, v, causal=causal, window=window)
    three = _attention_with(lambda a, b: _mm_3xtf32(a, b, small), q, k, v,
                            causal=causal, window=window)
    one = _attention_with(_mm_tf32, q, k, v, causal=causal, window=window)
    err3 = float((three - want).abs().max())
    err1 = float((one - want).abs().max())
    assert err3 <= TOL["f32"], err3
    assert err1 > TOL["f32"], err1


def _lanes():
    lane = np.arange(32)
    return lane // 4, lane % 4                    # g, t


def _c_fragments(c):
    """m16n8 C (D) fragment of each lane: c0..c3 = C[g][2t], C[g][2t+1],
    C[g+8][2t], C[g+8][2t+1]."""
    g, t = _lanes()
    return np.stack([c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t],
                     c[g + 8, 2 * t + 1]], axis=1)


def _mma_m16n8k8_tf32(a_frag, b_frag):
    """The tile product of one m16n8k8 TF32 MMA from its lanes' fragments:
    a0..a3 = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; b0, b1 =
    B[t][g], B[t+4][g]."""
    g, t = _lanes()
    a, b = np.zeros((16, 8)), np.zeros((8, 8))
    a[g, t], a[g + 8, t] = a_frag[:, 0], a_frag[:, 1]
    a[g, t + 4], a[g + 8, t + 4] = a_frag[:, 2], a_frag[:, 3]
    b[t, g], b[t + 4, g] = b_frag[:, 0], b_frag[:, 1]
    return a @ b


def _mma_m16n8k16_bf16(a_frag, b_frag):
    """The same for m16n8k16 bf16, each register a pair (lo, hi): a0..a3 =
    A[g][2t:2t+2], A[g+8][2t:2t+2], A[g][2t+8:2t+10], A[g+8][2t+8:2t+10];
    b0, b1 = B[2t:2t+2][g], B[2t+8:2t+10][g]."""
    g, t = _lanes()
    a, b = np.zeros((16, 16)), np.zeros((16, 8))
    for e in range(2):
        a[g, 2 * t + e], a[g + 8, 2 * t + e] = a_frag[:, 0, e], a_frag[:, 1, e]
        a[g, 2 * t + 8 + e] = a_frag[:, 2, e]
        a[g + 8, 2 * t + 8 + e] = a_frag[:, 3, e]
        b[2 * t + e, g], b[2 * t + 8 + e, g] = b_frag[:, 0, e], b_frag[:, 1, e]
    return a @ b


@pytest.mark.parametrize("mma", ["m16n8k8_tf32", "m16n8k16_bf16"])
def test_probabilities_stay_in_registers_between_the_products(mma):
    """The score MMA's C fragments feed the P V MMA's A fragments with no
    shuffle. tf32: a = (c0, c2, c1, c3) permutes the tile's 8 keys (logical
    k = t is key 2t, k = t + 4 is key 2t + 1), and V's B fragment is read
    from key rows 2t and 2t + 1. bf16: the C fragments of two n8 tiles,
    packed in pairs, are the A fragment of one k16 step, and V's B fragment
    is ldmatrix.trans's (keys 2t, 2t + 1 and 2t + 8, 2t + 9 of column g).
    Integer-valued tiles, so the product is exact in any order."""
    rng = np.random.default_rng(12)
    g, t = _lanes()
    if mma == "m16n8k8_tf32":
        p = rng.integers(-8, 9, (16, 8)).astype(np.float64)
        v = rng.integers(-8, 9, (8, 8)).astype(np.float64)
        c = _c_fragments(p)
        a_frag = c[:, [0, 2, 1, 3]]
        b_frag = np.stack([v[2 * t, g], v[2 * t + 1, g]], axis=1)
        got = _mma_m16n8k8_tf32(a_frag, b_frag)
    else:
        p = rng.integers(-8, 9, (16, 16)).astype(np.float64)
        v = rng.integers(-8, 9, (16, 8)).astype(np.float64)
        c0, c1 = _c_fragments(p[:, :8]), _c_fragments(p[:, 8:])
        a_frag = np.stack([c0[:, 0:2], c0[:, 2:4], c1[:, 0:2], c1[:, 2:4]],
                          axis=1)
        b_frag = np.stack([np.stack([v[2 * t, g], v[2 * t + 1, g]], 1),
                           np.stack([v[2 * t + 8, g], v[2 * t + 9, g]], 1)],
                          axis=1)
        got = _mma_m16n8k16_bf16(a_frag, b_frag)
    np.testing.assert_array_equal(got, p @ v)
    # and the output lands in the C fragments the accumulator holds
    np.testing.assert_array_equal(_c_fragments(got), _c_fragments(p @ v))


def _rz_fp32(x: np.ndarray) -> np.ndarray:
    """float64 values rounded to fp32 toward zero."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def _pv_row_sums(p: np.ndarray, v: np.ndarray, fold: bool) -> np.ndarray:
    """O = P V over rows of keys (p (rows, S), v (S, D) fp32) as K4's fp32
    instance sums it, each m16n8k8 MMA modelled as its exact sum rounded
    to fp32 toward zero (the tensor cores' accumulation): per k8 step of 8
    keys three MMAs, small terms first, in 32-key tiles. fold=False: one
    accumulator across every tile (the design before the fold); fold=True:
    a fragment zeroed for each tile, added to O in IEEE fp32 (the kernel's
    fmaf(o, corr, frag) with corr = 1)."""
    pb, vb = (_rna_tf32(torch.from_numpy(x)).numpy() for x in (p, v))
    ps, vs = (_rz_tf32(torch.from_numpy(x - b)).numpy()
              for x, b in ((p, pb), (v, vb)))
    o = np.zeros((p.shape[0], v.shape[1]), np.float32)
    for t0 in range(0, p.shape[1], 32):
        acc = np.zeros_like(o) if fold else o
        for k0 in range(t0, t0 + 32, 8):
            ks = slice(k0, k0 + 8)
            for a, b in ((ps, vb), (pb, vs), (pb, vb)):
                acc = _rz_fp32(acc.astype(np.float64) + a[:, ks].astype(
                    np.float64) @ b[ks].astype(np.float64))
        o = o + acc if fold else acc
    return o


def test_folding_each_key_tile_keeps_round_toward_zero_from_drifting():
    """Values of one sign down each channel (as on zamba2's shared block:
    max|v| 5, every output a sum of like-signed terms). With the MMAs'
    round-toward-zero sums, one accumulator across the row drifts toward
    zero with the row length, past the fp32 tolerance at 4096 keys; a
    fragment per key tile folded into O in IEEE fp32 keeps the error flat
    and far inside it."""
    rng = np.random.default_rng(32)
    err = {}
    for S in (512, 4096):
        s = rng.standard_normal((16, S)).astype(np.float32)
        p = np.exp(s - s.max(axis=1, keepdims=True)).astype(np.float32)
        v = rng.standard_normal((1, 16)) + 0.25 * rng.standard_normal(
            (S, 16))
        v = (v * (5.0 / np.abs(v).max())).astype(np.float32)
        exact = (p.astype(np.float64) @ v.astype(np.float64)) / p.astype(
            np.float64).sum(axis=1, keepdims=True)
        l = p.sum(axis=1, keepdims=True, dtype=np.float32)
        for fold in (False, True):
            d = _pv_row_sums(p, v, fold) / l - exact
            err[S, fold] = float(np.abs(d).max())
            if not fold:        # the drift is toward zero
                assert float((d * np.sign(exact)).mean()) < 0
    assert err[4096, False] > TOL["f32"]
    assert err[4096, False] > 4 * err[512, False]
    assert err[4096, True] <= 2 * err[512, True]
    assert err[4096, True] <= TOL["f32"] / 4


def _dv_step_sums(p: np.ndarray, do: np.ndarray, fold: bool) -> np.ndarray:
    """dV = P^T dO over streamed query rows (p (S, keys), do (S, D) fp32)
    as K7's dK/dV pass sums it: both operands split as the kernel splits
    them (big = x with its low 13 bits cleared, small = the rest, which the
    MMA reads truncated), each m16n8k8 MMA modelled as its exact sum rounded
    to fp32 toward zero, per k8 step of 8 queries three MMAs, small terms
    first, in 32-query streamed steps. fold=False: one accumulator across
    every step (the design before the fold); fold=True: a fragment zeroed
    for each step, added to dV in IEEE fp32."""
    pt, dt = torch.from_numpy(np.ascontiguousarray(p.T)), torch.from_numpy(do)
    pb, db = _rz_tf32(pt), _rz_tf32(dt)
    ps, ds = (_rz_tf32(x - b).numpy() for x, b in ((pt, pb), (dt, db)))
    pb, db = pb.numpy(), db.numpy()
    dv = np.zeros((p.shape[1], do.shape[1]), np.float32)
    for t0 in range(0, p.shape[0], 32):
        acc = np.zeros_like(dv) if fold else dv
        for k0 in range(t0, t0 + 32, 8):
            ks = slice(k0, k0 + 8)
            for a, b in ((ps, db), (pb, ds), (pb, db)):
                acc = _rz_fp32(acc.astype(np.float64) + a[:, ks].astype(
                    np.float64) @ b[ks].astype(np.float64))
        dv = dv + acc if fold else acc
    return dv


def test_folding_each_query_tile_keeps_k7s_dv_from_drifting():
    """K7's case of the fold: dV = P^T dO summed over the streamed query
    tiles, dO of one sign down each channel (max 5). One MMA accumulator
    across the rows drifts toward zero with the row count (~3e-5 of
    max|dV| at 4096 queries, as the card showed 6.6e-5 before the fold); a
    fragment per streamed tile folded in IEEE fp32 keeps the error flat,
    more than ten times smaller."""
    rng = np.random.default_rng(33)
    err = {}
    for S in (512, 4096):
        s = rng.standard_normal((S, 16)).astype(np.float32)
        p = np.exp(s - s.max(axis=0, keepdims=True)).astype(np.float32)
        do = rng.standard_normal((1, 16)) + 0.25 * rng.standard_normal(
            (S, 16))
        do = (do * (5.0 / np.abs(do).max())).astype(np.float32)
        exact = p.T.astype(np.float64) @ do.astype(np.float64)
        big = float(np.abs(exact).max())
        for fold in (False, True):
            d = _dv_step_sums(p, do, fold) - exact
            err[S, fold] = float(np.abs(d).max()) / big
            if not fold:        # the drift is toward zero
                assert float((d * np.sign(exact)).mean()) < 0
    assert err[4096, False] > 4 * err[512, False]
    assert err[4096, True] <= 2 * err[512, True]
    assert err[4096, True] <= err[4096, False] / 10
    assert err[4096, True] <= 1e-5
