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
