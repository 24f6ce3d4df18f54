"""The port's MLA attention (`repro_torch.models.attention`, the MLA half)
against the JAX reference's, on the CPU.

The reduced minicpm3-4b config (d_model 256, 4 heads, kv_lora_rank 64,
qk_nope 32, qk_rope 16, v_head 32; `reduced()` sets q_lora_rank=0) and the
same with q-LoRA (`with_overrides(q_lora_rank=32)`), with the reference's
`init_mla_params` weights carried into the port's `MLAAttention` by name.
On the CPU the port's prefill attention is K4's plain version on the
expanded heads (Dh = 48, Dv = 32); the reference runs its jnp
`blockwise_attention`. Decode is the absorbed form in both.

Tolerance: fp32 with other summation orders, as tests/test_torch_lm.py:
outputs and caches within 1e-5 of their largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn

from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models import blocks as blk

torch.set_num_threads(2)

RTOL = 1e-5
VARIANTS = {"direct": {}, "q_lora": {"q_lora_rank": 32},
            "window": {"sliding_window": 8}}


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


def _load(cfg, params):
    layer = attn.MLAAttention(cfg, device="cpu")
    layer.load_state_dict({n: torch.tensor(np.asarray(a))
                           for n, a in params.items()}, strict=True)
    return layer


def _pair(variant, **extra):
    kw = dict(VARIANTS[variant], **extra)
    jcfg = jax_get_config("minicpm3-4b").reduced().with_overrides(**kw)
    cfg = get_config("minicpm3-4b").reduced().with_overrides(**kw)
    jp = jattn.init_mla_params(jcfg, jax.random.PRNGKey(7))
    return jcfg, jp, cfg, _load(cfg, jp)


def _x(B, S, d, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


def _check_cache(got, want):
    _close(got.ckv, want.ckv)
    _close(got.krope, want.krope)
    np.testing.assert_array_equal(got.slot_positions.numpy(),
                                  np.asarray(want.slot_positions))


@pytest.mark.parametrize("cache_len", [None, 64, 16])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mla_forward_matches_reference(variant, cache_len):
    """The prefill output, and with cache_len the latent cache, full (64)
    and rolling (16)."""
    jcfg, jp, cfg, layer = _pair(variant)
    assert cfg.attn_kind == "mla" and cfg.q_lora_rank == jcfg.q_lora_rank
    B, S = 2, 29
    x, pos = _x(B, S, cfg.d_model), np.arange(S, dtype=np.int32)
    want = jattn.mla_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                             cache_len=cache_len)
    got = attn.mla_forward(layer, cfg, torch.from_numpy(x),
                           torch.from_numpy(pos), cache_len=cache_len)
    if cache_len is None:
        assert got.shape == (B, S, cfg.d_model)
        _close(got, want)
        return
    _close(got[0], want[0])
    _check_cache(got[1], want[1])


@pytest.mark.parametrize("cache_len", [64, 16])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mla_prefill_cache_matches_reference(variant, cache_len):
    jcfg, jp, cfg, layer = _pair(variant)
    S = 29
    x, pos = _x(2, S, cfg.d_model, seed=1), np.arange(S, dtype=np.int32)
    want = jattn.mla_prefill_cache(jp, jcfg, jnp.asarray(x),
                                   jnp.asarray(pos), cache_len)
    got = attn.mla_prefill_cache(layer, cfg, torch.from_numpy(x),
                                 torch.from_numpy(pos), cache_len)
    _check_cache(got, want)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mla_absorbed_decode_matches_reference_and_forward(variant):
    """Prefill 20 tokens into a cache of 24, then decode 10 more one at a
    time (the cache rolls over at position 24): each step's output and
    cache equal the reference's absorbed decode, and each output equals
    the port's own expanded forward over the whole sequence at that
    position (with the window, the forward sees only the window, as the
    rolling cache does)."""
    jcfg, jp, cfg, layer = _pair(variant)
    P, N, C = 20, 10, 24
    x = _x(2, P + N, cfg.d_model, seed=2)
    pos = np.arange(P + N, dtype=np.int32)
    jcache = jattn.mla_prefill_cache(jp, jcfg, jnp.asarray(x[:, :P]),
                                     jnp.asarray(pos[:P]), C)
    cache = attn.mla_prefill_cache(layer, cfg, torch.from_numpy(x[:, :P]),
                                   torch.from_numpy(pos[:P]), C)
    full = attn.mla_forward(layer, cfg, torch.from_numpy(x),
                            torch.from_numpy(pos))
    for t in range(P, P + N):
        want, jcache = jattn.mla_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                        jcache, jnp.asarray(t, jnp.int32))
        got, cache = attn.mla_decode(layer, cfg,
                                     torch.from_numpy(x[:, t:t + 1]), cache,
                                     t)
        _close(got, want)
        _check_cache(cache, jcache)
        if cfg.sliding_window or t < C:
            _close(got, full[:, t:t + 1].numpy())


def test_mla_decode_writes_the_cache_in_place():
    _, _, cfg, layer = _pair("direct")
    cache = blk.attn_empty_cache(cfg, 2, 8, torch.float32, "cpu")
    assert isinstance(cache, attn.MLACache)
    assert cache.ckv.shape == (2, 8, cfg.kv_lora_rank)
    assert cache.krope.shape == (2, 8, cfg.qk_rope_dim)
    ckv = cache.ckv
    _, out = attn.mla_decode(layer, cfg, torch.from_numpy(
        _x(2, 1, cfg.d_model)), cache, 11)
    assert out.ckv is ckv and bool(ckv[:, 3].abs().sum() > 0)
    assert out.slot_positions.tolist() == [-1, -1, -1, 11, -1, -1, -1, -1]


@pytest.mark.parametrize("variant", ["direct", "q_lora"])
def test_mla_padded_heads_are_exact_no_ops(variant):
    """tp_head_pad: the padded heads' wo rows are zero, in the port's own
    draw and in the reference's carried across, and the layer output
    equals the reference's."""
    jcfg, jp, cfg, layer = _pair(variant, tp_head_pad=3)
    assert cfg.padded_heads == 6 and cfg.num_heads == 4
    own = attn.init_mla_params(cfg, torch.Generator().manual_seed(0))
    assert own.wkv_b.shape == (cfg.kv_lora_rank, 6,
                               cfg.qk_nope_dim + cfg.v_head_dim)
    assert (own.wo[4:] == 0).all() and (own.wo[:4] != 0).any()
    assert (layer.wo[4:] == 0).all()
    S = 13
    x, pos = _x(1, S, cfg.d_model, seed=3), np.arange(S, dtype=np.int32)
    want = jattn.mla_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = attn.mla_forward(layer, cfg, torch.from_numpy(x),
                           torch.from_numpy(pos))
    _close(got, want)


@pytest.mark.parametrize("variant", ["direct", "q_lora"])
def test_own_draw_has_the_reference_shapes(variant):
    jcfg, _, cfg, _ = _pair(variant)
    shapes = jax.eval_shape(lambda key: jattn.init_mla_params(jcfg, key),
                            jax.random.PRNGKey(0))
    own = attn.init_mla_params(cfg, torch.Generator().manual_seed(0))
    assert {n: tuple(p.shape) for n, p in own.named_parameters()} == {
        n: tuple(s.shape) for n, s in shapes.items()}
