"""The port's Mamba2 (SSD) mixer against the JAX reference, on the CPU.

Inputs from numpy seeds; the mixer's weights are the reference's
`init_ssm_params` carried into the port's `SSM` module by name. The
reference scans whole chunks under `lax.scan`; the port runs every
elementwise pass over all chunks at once and loops only over the
recurrence and over groups of intra-chunk scores (`ssm.SSD_GROUP_ELEMS`,
shrunk here so that the groups hold one and several chunks).

Tolerance: fp32 with other summation orders (XLA's einsums and cumsum
against ATen's matmuls): ~1e-7 relative per op, so every output and state
is held to 1e-5 of its largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jax_ssm
from repro.models.common import ModelConfig as JaxModelConfig

from repro_torch.models import ssm
from repro_torch.models.common import ModelConfig

torch.set_num_threads(2)

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


def _ssd_inputs(B=2, S=70, H=3, P=4, N=5, seed=0):
    """x (B,S,H,P), dt (B,S,H) post-softplus, A (H,) negative, Bm and Cm
    (B,S,N), init_state (B,H,P,N): float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


# (S, chunk): chunks that divide S, that do not (a ragged last chunk), one
# chunk longer than S, and the reduced configs' chunk of 32 at 2 x 96 + 5
SSD_CASES = [(64, 16), (70, 16), (10, 32), (197, 32), (33, 8)]


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init_state"])
@pytest.mark.parametrize("S,chunk", SSD_CASES)
@pytest.mark.parametrize("group_elems", [None, 1], ids=["groups", "per-chunk"])
def test_ssd_chunked_matches_reference(S, chunk, init, group_elems,
                                       monkeypatch):
    """y and the final state, with and without a carried initial state;
    intra-chunk scores over several chunks at once and one at a time."""
    if group_elems is not None:
        monkeypatch.setattr(ssm, "SSD_GROUP_ELEMS", group_elems)
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(S=S, seed=S + chunk)
    init_state = s0 if init else None
    want_y, want_s = jax_ssm.ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk,
        init_state=None if init_state is None else jnp.asarray(init_state))
    got_y, got_s = ssm.ssd_chunked(
        *(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk,
        init_state=None if init_state is None
        else torch.from_numpy(init_state))
    assert got_y.dtype == torch.float32 and got_s.dtype == torch.float32
    _close(got_y, want_y)
    _close(got_s, want_s)


def test_ssd_chunked_masks_the_decay_above_the_diagonal():
    """Steep decays: exp(cum_i - cum_j) above the diagonal overflows to inf
    in the reference's order, and the port's output is finite and the
    reference's (the masked exponents never reach a product)."""
    x, dt, A, Bm, Cm, _ = _ssd_inputs(S=64, seed=9)
    dt = dt * 40.0                     # |dA| up to ~100 a step
    want_y, want_s = jax_ssm.ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), 32)
    got_y, got_s = ssm.ssd_chunked(
        *(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), 32)
    assert torch.isfinite(got_y).all() and torch.isfinite(got_s).all()
    cum = np.cumsum((dt * A)[:, :32], axis=1)
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(cum[:, :, None] - cum[:, None, :])).any()
    _close(got_y, want_y)
    _close(got_s, want_s)


@pytest.mark.parametrize("chunk", [1, 3, 8, 16, 32, 70])
def test_ssd_chunk_size_invariance(chunk):
    """The output does not depend on the chunking (the duality property):
    every chunk size gives the one-chunk (quadratic) output, and the same
    final state."""
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(S=70, seed=4)
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    one_y, one_s = ssm.ssd_chunked(*args, 70,
                                   init_state=torch.from_numpy(s0))
    y, s = ssm.ssd_chunked(*args, chunk, init_state=torch.from_numpy(s0))
    _close(y, one_y)
    _close(s, one_s)


def _jax_cfg(**kw):
    base = dict(name="t", arch_type="ssm", num_layers=1, d_model=32,
                num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=64,
                attn_kind="none", ssm_state=8, ssm_head_dim=8,
                ssm_expand=2, ssm_chunk=8)
    base.update(kw)
    return JaxModelConfig(**base)


def _cfgs(**kw):
    jcfg = _jax_cfg(**kw)
    fields = {k: getattr(jcfg, k) for k in jcfg.__dataclass_fields__}
    fields["dtype"] = torch.float32
    return jcfg, ModelConfig(**fields)


def _mixer(jcfg, cfg, seed):
    """The reference's mixer weights and the port's module holding them."""
    jp = jax_ssm.init_ssm_params(jcfg, jax.random.PRNGKey(seed))
    mod = ssm.SSM(cfg, device="cpu")
    mod.load_state_dict({k: torch.tensor(np.asarray(v))
                         for k, v in jp.items()}, strict=True)
    return jp, mod


def test_ssm_module_draws_the_reference_layout():
    """The port's own draw: every weight name, shape and dtype of the
    reference's, A_log / D / dt_bias in fp32 under a bf16 config, and
    softplus(dt_bias) within the mamba2 range [1e-3, 1e-1]."""
    jcfg, cfg = _cfgs()
    jp = jax_ssm.init_ssm_params(jcfg, jax.random.PRNGKey(0))
    mod = ssm.SSM(cfg, torch.Generator().manual_seed(0))
    got = dict(mod.named_parameters())
    assert set(got) == set(jp)
    for k, v in jp.items():
        assert tuple(got[k].shape) == v.shape, k
    dt = torch.nn.functional.softplus(mod.dt_bias)
    assert (dt >= 1e-3 * (1 - 1e-5)).all() and (dt <= 0.1 * (1 + 1e-5)).all()
    _close(mod.A_log, jp["A_log"])
    bf = ssm.SSM(cfg.with_overrides(dtype=torch.bfloat16),
                 torch.Generator().manual_seed(0))
    assert bf.w_x.dtype == torch.bfloat16 and bf.norm.dtype == torch.bfloat16
    for name in ("A_log", "D", "dt_bias"):
        assert getattr(bf, name).dtype == torch.float32, name


@pytest.mark.parametrize("with_prev", [False, True], ids=["zero", "prev"])
def test_causal_conv_matches_reference(with_prev):
    rng = np.random.default_rng(5)
    B, S, ch, W = 2, 11, 6, 4
    xc = rng.standard_normal((B, S, ch)).astype(np.float32)
    w = rng.standard_normal((W, ch)).astype(np.float32)
    b = rng.standard_normal(ch).astype(np.float32)
    prev = rng.standard_normal((B, W - 1, ch)).astype(np.float32) \
        if with_prev else None
    want, want_tail = jax_ssm._causal_conv(
        jnp.asarray(xc), jnp.asarray(w), jnp.asarray(b),
        None if prev is None else jnp.asarray(prev))
    got, tail = ssm._causal_conv(
        torch.from_numpy(xc), torch.from_numpy(w), torch.from_numpy(b),
        None if prev is None else torch.from_numpy(prev))
    _close(got, want)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(want_tail))
    # the tail is a tensor of its own, not a view of the padded input
    assert tail.untyped_storage().nbytes() == tail.numel() * 4


@pytest.mark.parametrize("S", [16, 21])
def test_ssm_forward_with_cache_matches_reference(S):
    """Output and the cache (conv tails, state) at a length that divides
    the chunk of 8 and one that does not."""
    jcfg, cfg = _cfgs()
    jp, mod = _mixer(jcfg, cfg, 1)
    x = (np.random.default_rng(S).standard_normal((2, S, cfg.d_model))
         * 0.3).astype(np.float32)
    want, wcache = jax_ssm.ssm_forward(jp, jcfg, jnp.asarray(x),
                                       return_cache=True)
    got, cache = ssm.ssm_forward(mod, cfg, torch.from_numpy(x),
                                 return_cache=True)
    _close(got, want)
    _close(ssm.ssm_forward(mod, cfg, torch.from_numpy(x)), want)
    for g, w in zip(cache, wcache):
        _close(g, w)
    assert cache.state.dtype == torch.float32


def test_ssm_decode_steps_match_reference_and_forward():
    """Token by token from an empty cache: each step's output equals the
    reference's ssm_decode and the port's own chunked forward, and the
    cache it updates in place carries the reference's state."""
    jcfg, cfg = _cfgs()
    jp, mod = _mixer(jcfg, cfg, 2)
    B, S = 2, 19
    x = (np.random.default_rng(7).standard_normal((B, S, cfg.d_model))
         * 0.3).astype(np.float32)
    full = ssm.ssm_forward(mod, cfg, torch.from_numpy(x))
    W, di, N = cfg.ssm_conv_width, cfg.d_inner, cfg.ssm_state
    shape = (B, cfg.ssm_heads, cfg.ssm_head_dim, N)
    jcache = jax_ssm.SSMCache(conv_x=jnp.zeros((B, W - 1, di)),
                              conv_bc=jnp.zeros((B, W - 1, 2 * N)),
                              state=jnp.zeros(shape))
    cache = ssm.SSMCache(conv_x=torch.zeros((B, W - 1, di)),
                         conv_bc=torch.zeros((B, W - 1, 2 * N)),
                         state=torch.zeros(shape))
    for t in range(S):
        want, jcache = jax_ssm.ssm_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                          jcache)
        got, out = ssm.ssm_decode(mod, cfg, torch.from_numpy(x[:, t:t + 1]),
                                  cache)
        assert out is cache or all(a is b for a, b in zip(out, cache))
        _close(got, want)
        _close(got, full[:, t:t + 1])
    for g, w in zip(cache, jcache):
        _close(g, w)


@pytest.mark.parametrize("S", [12, 16, 29])
def test_ssm_prefill_cache_continues_with_decode(S):
    """Prefill-then-decode: the cache of a forward over S tokens, one decode
    step, against the forward over S + 1 (the reference's own check, and
    the state-space duality across a chunk boundary)."""
    jcfg, cfg = _cfgs()
    jp, mod = _mixer(jcfg, cfg, 3)
    x = (np.random.default_rng(S + 1).standard_normal((1, S + 1, cfg.d_model))
         * 0.3).astype(np.float32)
    full = ssm.ssm_forward(mod, cfg, torch.from_numpy(x))
    _, cache = ssm.ssm_forward(mod, cfg, torch.from_numpy(x[:, :S]),
                               return_cache=True)
    out, _ = ssm.ssm_decode(mod, cfg, torch.from_numpy(x[:, S:]), cache)
    _close(out, full[:, S:])
    want = jax_ssm.ssm_forward(jp, jcfg, jnp.asarray(x))
    _close(out, np.asarray(want)[:, S:])


def test_ssm_forward_runs_in_float64_for_a_yardstick():
    """A float64 mixer (the yardstick the card's fp32 mixer is held to)
    computes in float64 throughout: its output, state and conv tails are
    float64 and within this file's tolerance of the fp32 mixer on the same
    weights; fp32 stays fp32."""
    jcfg, cfg = _cfgs()
    _, mod = _mixer(jcfg, cfg, 4)
    mod64 = ssm.SSM(cfg.with_overrides(dtype=torch.float64), device="cpu")
    mod64.load_state_dict(mod.state_dict())
    x = (np.random.default_rng(3).standard_normal((2, 21, cfg.d_model))
         * 0.3).astype(np.float32)
    y32, c32 = ssm.ssm_forward(mod, cfg, torch.from_numpy(x),
                               return_cache=True)
    y64, c64 = ssm.ssm_forward(mod64, cfg, torch.from_numpy(x).double(),
                               return_cache=True)
    assert y32.dtype == c32.state.dtype == torch.float32
    assert y64.dtype == torch.float64
    assert all(t.dtype == torch.float64 for t in c64)
    _close(y32, y64.numpy())
    _close(c32.state, c64.state.numpy())
