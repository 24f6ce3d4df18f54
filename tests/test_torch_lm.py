"""The port's LM serving path against the JAX reference, on the CPU.

The reduced qwen3-1.7b config (2 layers, d_model 256, 4 heads, head_dim
64, vocab 1024), and a grouped variant with 2 KV heads, with the
reference's `init_params` weights carried into the port by
`convert.lm_params_from_numpy`. On the CPU the port's prefill attention is
K4's plain version; the reference runs its jnp `blockwise_attention`.
Then every other architecture the port lists, reduced the same way
(`NEW_ARCHS`: dense GQA, MoE with a sliding window, MLA, MLA with MoE,
the Mamba2 SSM and the grouped hybrid with its weight-shared attention
block), end to end: logits and the MoE aux loss, the loss, the prefill's
caches and the engine's greedy tokens. The aux loss is held within 1e-6.

Tolerance: fp32 through two layers with other summation orders (XLA's
dots and blockwise online softmax against ATen's matmuls and a full
softmax): ~1e-6 relative per op, so logits, layer outputs and caches are
held to 1e-5 of their largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.models import attention as jax_attn
from repro.models import blocks as jax_blk
from repro.models import model as JM
from repro.serve import Engine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig

from repro_torch.configs import get_config, list_archs
from repro_torch.convert import (lm_params_from_numpy,
                                 lm_params_to_numpy)
from repro_torch.kernels.flash_attention import flash_attention as k4
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as attn
from repro_torch.models import blocks as blk
from repro_torch.models import common
from repro_torch.models import model as M
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(2)

RTOL = 1e-5
VARIANTS = {"mha": {}, "gqa": {"num_kv_heads": 2}}


def _close(got, want, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


def _configs(variant):
    return (jax_get_config("qwen3-1.7b").reduced().with_overrides(
                **VARIANTS[variant]),
            get_config("qwen3-1.7b").reduced().with_overrides(
                **VARIANTS[variant]))


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    """(jax cfg, jax params, port cfg, port model) on the same weights."""
    jcfg, cfg = _configs(request.param)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    return jcfg, jp, cfg, model


def _tokens(cfg, B=2, S=37, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _layer(jp, i):
    return jax.tree.map(lambda a: a[i], jp["blocks"])


def test_forward_logits_match(pair):
    jcfg, jp, cfg, model = pair
    toks = _tokens(cfg)
    want, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = M.forward(model, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 37, cfg.padded_vocab) and float(aux) == 0.0
    _close(got, want)
    _close(M.prefill(model, cfg, {"tokens": torch.from_numpy(toks)}),
           np.asarray(want)[:, -1:])


@pytest.mark.parametrize("cache_len", [None, 16])
def test_gqa_forward_and_block_forward_per_layer(pair, cache_len):
    jcfg, jp, cfg, model = pair
    B, S = 2, 29
    x = np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    for i in range(cfg.num_layers):
        lp = _layer(jp, i)
        want = jax_attn.gqa_forward(lp["attn"], jcfg, jx, jpos,
                                    cache_len=cache_len)
        got = attn.gqa_forward(model.blocks[i].attn, cfg, tx, tpos,
                               cache_len=cache_len)
        if cache_len is None:
            _close(got, want)
        else:
            _close(got[0], want[0])
            for g, w in zip(got[1], want[1]):
                _close(g, w)
        want = jax_blk.block_forward(lp, jcfg, jx, jpos, "dense",
                                     cache_len=cache_len)
        got = blk.block_forward(model.blocks[i], cfg, tx, tpos, "dense",
                                cache_len=cache_len)
        assert len(got) == len(want)
        _close(got[0], want[0])
        assert float(got[1]) == float(want[1]) == 0.0


@pytest.mark.parametrize("cache_len", [64, 16])
def test_gqa_prefill_cache_matches_reference_and_decodes(pair, cache_len):
    """gqa_prefill_cache: the reference's cache (full and rolling) within
    this file's tolerance; where the cache holds every token, a decode
    from it gives the forward's next position, as tests/test_attention.py
    holds the reference."""
    jcfg, jp, cfg, model = pair
    B, S = 2, 29
    x = np.random.default_rng(2).standard_normal(
        (B, S + 1, cfg.d_model)).astype(np.float32)
    pos = np.arange(S + 1, dtype=np.int32)
    lp = _layer(jp, 0)
    want = jax_attn.gqa_prefill_cache(lp["attn"], jcfg,
                                      jnp.asarray(x[:, :S]),
                                      jnp.asarray(pos[:S]), cache_len)
    p0 = model.blocks[0].attn
    got = attn.gqa_prefill_cache(p0, cfg, torch.from_numpy(x[:, :S]),
                                 torch.from_numpy(pos[:S]), cache_len)
    _close(got.k, want.k)
    _close(got.v, want.v)
    np.testing.assert_array_equal(got.slot_positions.numpy(),
                                  np.asarray(want.slot_positions))
    if cache_len > S:
        full = attn.gqa_forward(p0, cfg, torch.from_numpy(x),
                                torch.from_numpy(pos))
        out, _ = attn.gqa_decode(p0, cfg, torch.from_numpy(x[:, S:]), got, S)
        _close(out, full[:, S:].detach())


@pytest.mark.parametrize("cache_len", [64, 16])
def test_prefill_with_state_matches_reference(pair, cache_len):
    """Last-position logits and every layer's cache, full and rolling."""
    jcfg, jp, cfg, model = pair
    toks = _tokens(cfg)
    want_logits, want_state = JM.prefill_with_state(
        jp, jcfg, {"tokens": jnp.asarray(toks)}, cache_len)
    logits, state = M.prefill_with_state(
        model, cfg, {"tokens": torch.from_numpy(toks)}, cache_len)
    assert logits.shape == (2, 1, cfg.padded_vocab)
    _close(logits, want_logits)
    assert len(state["layers"]) == cfg.num_layers
    for i, cache in enumerate(state["layers"]):
        want = jax.tree.map(lambda a: np.asarray(a[i]), want_state["layers"])
        _close(cache.k, want.k)
        _close(cache.v, want.v)
        np.testing.assert_array_equal(cache.slot_positions.numpy(),
                                      want.slot_positions)


def test_decode_step_matches_reference_and_forward(pair):
    """Token-by-token decode from empty caches: each position's logits
    equal the reference's decode_step and the port's own forward (the
    serve path is numerically the train path, test_system.py)."""
    jcfg, jp, cfg, model = pair
    B, S = 2, 10
    toks = _tokens(cfg, B, S, seed=2)
    full, _ = M.forward(model, cfg, {"tokens": torch.from_numpy(toks)})
    jstate = JM.init_serve_state(jcfg, B, cache_len=S)
    state = M.init_serve_state(cfg, B, cache_len=S, device="cpu")
    for t in range(S):
        want, jstate = JM.decode_step(jp, jcfg, jnp.asarray(toks[:, t:t + 1]),
                                      jstate, jnp.asarray(t, jnp.int32))
        got, state = M.decode_step(model, cfg,
                                   torch.from_numpy(toks[:, t:t + 1]),
                                   state, t)
        _close(got, want)
        _close(got, full[:, t:t + 1])


def test_engine_greedy_tokens_equal_reference(pair):
    """Same greedy tokens; each step's top-1/top-2 logit margin exceeds the
    logit tolerance, so the equality is not a tie broken alike."""
    jcfg, jp, cfg, model = pair
    prompts = _tokens(cfg, 2, 12, seed=4)
    scfg = dict(max_new_tokens=8, cache_len=32)
    want = JaxEngine(jcfg, jp, JaxServeConfig(**scfg)).generate(prompts)
    got = Engine(cfg, model, ServeConfig(**scfg)).generate(prompts)
    assert got.shape == (2, 8) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # replay the decode and check the margins the equality rests on
    seq = np.concatenate([prompts, got[:, :-1]], axis=1)
    logits, _ = M.forward(model, cfg, {"tokens": torch.from_numpy(seq)})
    steps = logits[:, prompts.shape[1] - 1:, :cfg.vocab_size]
    top2 = torch.topk(steps, 2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    tol = RTOL * float(steps.abs().max())
    assert margin > 10 * tol, (margin, tol)
    np.testing.assert_array_equal(steps.argmax(-1).numpy(), got)


def test_engine_sampling_follows_the_generator():
    """Temperature sampling is deterministic for one generator seed and
    depends on it; near-zero temperature gives the greedy tokens."""
    _, cfg = _configs("mha")
    model = M.init_params(cfg, torch.Generator().manual_seed(3))
    prompts = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    greedy = Engine(cfg, model, ServeConfig(max_new_tokens=6, cache_len=32)
                    ).generate(prompts)
    cold = Engine(cfg, model, ServeConfig(max_new_tokens=6, cache_len=32,
                                          greedy=False, temperature=1e-4))
    np.testing.assert_array_equal(cold.generate(prompts), greedy)
    warm = Engine(cfg, model, ServeConfig(max_new_tokens=6, cache_len=32,
                                          greedy=False, temperature=5.0))

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    out = warm.generate(prompts, generator=gen(11))
    np.testing.assert_array_equal(out, warm.generate(prompts,
                                                     generator=gen(11)))
    assert (out != warm.generate(prompts, generator=gen(12))).any()
    np.testing.assert_array_equal(warm.generate(prompts),
                                  warm.generate(prompts, generator=gen(0)))
    assert (out < cfg.vocab_size).all()
    with pytest.raises(ValueError, match="temperature"):
        ServeConfig(greedy=False, temperature=0.0)


def test_launch_serve_runs_on_cpu(capsys):
    launch_serve.main(["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "5",
                       "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert out.startswith("arch=qwen3-1.7b batch=2 new=3 wall=")
    assert "generated ids:" in out


def test_registry_and_config_match_reference():
    assert list_archs() == ["qwen3-1.7b", *NEW_ARCHS, *MULTIMODAL_ARCHS]
    assert set(list_archs()) == set(jax_list_archs())
    for name in list_archs():
        cfg, jcfg = get_config(name), jax_get_config(name)
        for c, j in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
            mine = dataclasses.asdict(c)
            theirs = dataclasses.asdict(j)
            assert mine.pop("dtype") is torch.float32
            assert theirs.pop("dtype") == jnp.float32
            assert mine == theirs
    cfg = get_config("qwen3-1.7b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.padded_vocab) == (
        28, 2048, 16, 8, 128, 6144, 151936)
    with pytest.raises(KeyError, match="seamless-m4t-medium") as err:
        get_config("no-such-arch")
    assert "item 15d" not in str(err.value)
    assert all(a in str(err.value) for a in list_archs())
    for name in ("mamba2-2.7b", "zamba2-2.7b", *MULTIMODAL_ARCHS):
        assert get_config(name).source == jax_get_config(name).source


@pytest.mark.parametrize("arch", sorted(jax_list_archs()))
def test_model_config_properties_match_reference(arch):
    """ModelConfig carries every field, property and reduction of the
    reference, for every architecture the reference knows."""
    jcfg = jax_get_config(arch)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["dtype"] = torch.float32
    cfg = common.ModelConfig(**fields)
    for c, j in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced()),
                 (cfg.with_overrides(tp_head_pad=16),
                  jcfg.with_overrides(tp_head_pad=16))):
        for prop in ("resolved_head_dim", "padded_heads", "padded_vocab",
                     "d_inner", "ssm_heads", "is_moe", "is_encdec"):
            assert getattr(c, prop) == getattr(j, prop), prop
        mine, theirs = dataclasses.asdict(c), dataclasses.asdict(j)
        mine.pop("dtype"), theirs.pop("dtype")
        assert mine == theirs


def test_padded_heads_are_exact_no_ops():
    """tp_head_pad: the padded heads' wo rows are zero, in the port's own
    draw and in the reference's carried across, and the layer output
    equals the reference's."""
    jcfg, cfg = (c.with_overrides(num_kv_heads=2, tp_head_pad=3)
                 for c in _configs("mha"))
    assert cfg.padded_heads == 6 and cfg.num_heads == 4
    own = attn.init_gqa_params(cfg, torch.Generator().manual_seed(0))
    assert own.wq.shape == (cfg.d_model, 6, 64)
    assert (own.wo[4:] == 0).all() and (own.wo[:4] != 0).any()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(5))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    x = np.random.default_rng(2).standard_normal(
        (1, 9, cfg.d_model)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)
    want = jax_attn.gqa_forward(_layer(jp, 0)["attn"], jcfg, jnp.asarray(x),
                                jnp.asarray(pos))
    got = attn.gqa_forward(model.blocks[0].attn, cfg, torch.from_numpy(x),
                           torch.from_numpy(pos))
    _close(got, want)


@pytest.mark.parametrize("window", [0, 4])
def test_decode_attention_and_primitives_match_reference(window):
    rng = np.random.default_rng(6)
    B, C, H, KV, D = 2, 8, 4, 2, 16
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, C, KV, D)).astype(np.float32)
    vc = rng.standard_normal((B, C, KV, D)).astype(np.float32)
    slots = np.array([8, 9, 10, 3, 4, 5, 6, -1], np.int32)  # rolled, one empty
    want = jax_attn.decode_attention(*(jnp.asarray(a) for a in (q, kc, vc,
                                                                slots)),
                                     jnp.asarray(10, jnp.int32),
                                     window=window)
    got = attn.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc,
                                                                slots)),
                                10, window=window)
    _close(got, want)
    x = rng.standard_normal((2, 5, 3, D)).astype(np.float32)
    scale = rng.standard_normal(D).astype(np.float32)
    _close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           JM.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    pos = np.arange(3, 8, dtype=np.int32)
    cos, sin = common.rope_frequencies(D, 1e6, torch.from_numpy(pos))
    jcos, jsin = jax_attn.rope_frequencies(D, 1e6, jnp.asarray(pos))
    _close(cos, jcos)
    _close(sin, jsin)
    _close(common.apply_rope(torch.from_numpy(x), cos, sin),
           jax_attn.apply_rope(jnp.asarray(x), jcos, jsin))
    up = x[::-1].copy()
    _close(common.swiglu(torch.from_numpy(x), torch.from_numpy(up)),
           jax_blk.swiglu(jnp.asarray(x), jnp.asarray(up)))


def test_dense_init_draws_and_is_deterministic():
    a = common.dense_init(torch.Generator().manual_seed(0), (512, 256),
                          torch.float32)
    b = common.dense_init(torch.Generator().manual_seed(0), (512, 256),
                          torch.float32)
    assert torch.equal(a, b)
    assert abs(float(a.std()) * 512 ** 0.5 - 1.0) < 0.02
    c = common.dense_init(torch.Generator().manual_seed(0), (8, 4),
                          torch.bfloat16, fan_in=64)
    assert c.dtype == torch.bfloat16


def test_prefill_reaches_k4_once_per_layer_and_decode_never(pair, monkeypatch):
    """Every layer's prefill attention goes through gqa_flash (counted by
    wrapping it, since on the CPU the kernel's counter does not move);
    decode never does."""
    _, _, cfg, model = pair
    calls = []
    real = attn.gqa_flash

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(attn, "gqa_flash", counting)
    before = k4.LAUNCHES
    Engine(cfg, model, ServeConfig(max_new_tokens=4, cache_len=16)).generate(
        _tokens(cfg, 2, 9))
    assert len(calls) == cfg.num_layers
    assert calls[0] == (2, 9, cfg.num_heads, cfg.resolved_head_dim)
    assert k4.LAUNCHES == before


def test_what_the_port_does_not_run_raises():
    """MoE, MLA, SSM and hybrid models run (the NEW_ARCHS cases below), and
    so do enc-dec and the VLM prefix (tests/test_torch_multimodal.py has
    their parity; here their raise cases run); seq_parallel runs and
    gives the bits it gives off (its parity with the reference is in
    tests/test_torch_lm_sharding.py); attn_kind="none" outside an SSM
    model and a hybrid whose layers do not fill its groups are not
    models."""
    _, cfg = _configs("mha")
    encdec = M.LM(cfg.with_overrides(encoder_layers=2), device="cpu")
    assert len(encdec.encoder) == 2 and len(encdec.decoder) == cfg.num_layers
    hybrid = M.LM(cfg.with_overrides(arch_type="hybrid", shared_attn_every=2),
                  device="cpu")
    assert isinstance(hybrid.shared_attn, blk.DenseBlock)
    assert [len(g) for g in hybrid.blocks] == [2]
    with pytest.raises(ValueError, match="shared_attn_every"):
        M.LM(cfg.with_overrides(arch_type="hybrid", shared_attn_every=3),
             device="cpu")
    for arch_type in ("dense", "hybrid"):
        with pytest.raises(ValueError, match="outside an SSM model"):
            M.LM(cfg.with_overrides(arch_type=arch_type, attn_kind="none",
                                    shared_attn_every=2), device="cpu")
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    ecfg = cfg.with_overrides(encoder_layers=2)
    emodel = M.init_params(ecfg, torch.Generator().manual_seed(0))
    out = Engine(ecfg, emodel, ServeConfig(max_new_tokens=2, cache_len=8),
                 extra_batch={"encoder_embeds": torch.zeros(
                     (1, 5, cfg.d_model))}).generate([[1, 2, 3]])
    assert out.shape == (1, 2)
    logits, _ = M.forward(model, cfg.with_overrides(prefix_len=8),
                          {"tokens": torch.zeros((1, 4), dtype=torch.long),
                           "prefix_embeds": torch.zeros((1, 8, cfg.d_model))})
    assert logits.shape == (1, 4, cfg.padded_vocab)
    toks = {"tokens": torch.arange(4, dtype=torch.long)[None]}
    assert torch.equal(
        M.forward(model, cfg.with_overrides(seq_parallel=True), toks)[0],
        M.forward(model, cfg, toks)[0])
    ssm_cfg = get_config("mamba2-2.7b").reduced()
    ssm_block = blk.init_block_params(ssm_cfg, torch.Generator(), "ssm")
    assert isinstance(ssm_block, blk.SSMBlock)
    x = torch.randn((1, 4, ssm_cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    assert torch.equal(
        blk.block_forward(ssm_block, ssm_cfg.with_overrides(seq_parallel=True),
                          x, torch.arange(4), "ssm")[0],
        blk.block_forward(ssm_block, ssm_cfg, x, torch.arange(4), "ssm")[0])
    with pytest.raises(ValueError, match="unknown block kind"):
        blk.init_block_params(cfg, torch.Generator(), "cross")



# ---------------------------------------------------------------------------
# The other architectures: dense GQA, MoE (Mixtral's window), MLA, MLA + MoE,
# the Mamba2 SSM and the grouped hybrid (zamba2)
# ---------------------------------------------------------------------------

NEW_ARCHS = ["granite-3-8b", "llama3-405b", "mixtral-8x7b", "minicpm3-4b",
             "deepseek-v2-lite-16b", "mamba2-2.7b", "zamba2-2.7b"]
# 96-token prompts: past reduced Mixtral's window of 64, and 2 x 96 tokens
# divide into the reduced MoE groups of 64 (the reference asserts it); the
# SSM models take 3 x 32 + 5, past three of their reduced 32-token chunks
# and not a multiple of the chunk
PROMPT = 96
SSM_PROMPT = 3 * 32 + 5
NEW_TOKENS = 8


def _prompt(cfg):
    return SSM_PROMPT if M.layer_kind(cfg) == "ssm" else PROMPT


@pytest.fixture(scope="module", params=NEW_ARCHS)
def arch_pair(request):
    """(jax cfg, jax params, port cfg, port model) of a reduced arch on the
    same weights."""
    jcfg = jax_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(4))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    return jcfg, jp, cfg, model


def _cache_len(cfg):
    """A rolling cache of the window's length where the model has one (the
    decode then runs past it), else one that holds every token."""
    return cfg.sliding_window or _prompt(cfg) + NEW_TOKENS


def test_new_arch_builds_the_reference_tree(arch_pair):
    """The block kind and attention kind the config names (a hybrid's
    groups of SSM blocks and its one shared attention block), every weight
    carried by name, and the reference's tree back out."""
    jcfg, jp, cfg, model = arch_pair
    kind = M.layer_kind(cfg)
    hybrid = cfg.arch_type == "hybrid"
    first = model.blocks[0][0] if hybrid else model.blocks[0]
    assert isinstance(first, blk.BLOCKS[kind])
    if hybrid:
        every = cfg.shared_attn_every
        assert [len(g) for g in model.blocks] == [every] * (
            cfg.num_layers // every)
        attn_block = model.shared_attn
    else:
        assert len(model.blocks) == cfg.num_layers
        attn_block = None if kind == "ssm" else first
    assert hasattr(model, "shared_attn") == hybrid
    if attn_block is not None:
        assert isinstance(attn_block.attn, attn.MLAAttention
                          if cfg.attn_kind == "mla" else attn.GQAAttention)
    back = lm_params_to_numpy(model)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_new_arch_forward_and_loss_match_reference(arch_pair):
    jcfg, jp, cfg, model = arch_pair
    S = _prompt(cfg)
    toks = _tokens(cfg, 2, S, seed=5)
    want, want_aux = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = M.forward(model, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, S, cfg.padded_vocab)
    _close(got, want)
    assert abs(float(aux) - float(want_aux)) <= 1e-6, (float(aux),
                                                       float(want_aux))
    assert (float(aux) > 0) == cfg.is_moe
    labels = np.roll(toks, -1, axis=1)
    jloss, jparts = JM.loss_fn(jp, jcfg, {"tokens": jnp.asarray(toks),
                                          "labels": jnp.asarray(labels)})
    loss, parts = M.loss_fn(model, cfg, {"tokens": torch.from_numpy(toks),
                                         "labels": torch.from_numpy(labels)})
    _close(loss, jloss)
    _close(parts["nll"], jparts["nll"])
    assert abs(float(parts["aux"]) - float(jparts["aux"])) <= 1e-6


def _check_state(cfg, state, want_state):
    """Every cache of a serve state against the reference's stacked one:
    {"layers"} by layer, or a hybrid's {"ssm"} by (group, layer) and
    {"shared"} by application; KV and latent caches with their slots, SSM
    caches' conv tails and state."""
    want = jax.tree.map(np.asarray, want_state)
    if cfg.arch_type == "hybrid":
        every = cfg.shared_attn_every
        assert set(state) == {"ssm", "shared"}
        assert len(state["ssm"]) == cfg.num_layers
        assert len(state["shared"]) == cfg.num_layers // every
        pairs = [(c, jax.tree.map(lambda a: a[i // every, i % every],
                                  want["ssm"]))
                 for i, c in enumerate(state["ssm"])]
        pairs += [(c, jax.tree.map(lambda a: a[g], want["shared"]))
                  for g, c in enumerate(state["shared"])]
        # one KV cache per application: no two share storage
        ks = [c.k for c in state["shared"]]
        assert len({t.data_ptr() for t in ks}) == len(ks)
    else:
        assert set(state) == {"layers"}
        assert len(state["layers"]) == cfg.num_layers
        pairs = [(c, jax.tree.map(lambda a: a[i], want["layers"]))
                 for i, c in enumerate(state["layers"])]
    for cache, w in pairs:
        assert type(cache).__name__ == type(w).__name__
        assert cache._fields == w._fields
        for name, got_t, want_t in zip(cache._fields, cache, w):
            if name == "slot_positions":
                np.testing.assert_array_equal(got_t.numpy(), want_t)
            else:
                assert got_t.dtype == torch.float32, name
                _close(got_t, want_t)


def test_new_arch_prefill_with_state_matches_reference(arch_pair):
    """Last-position logits and every layer's cache (KV or latent, rolling
    for Mixtral's window; the SSM layers' conv tails and state; each of a
    hybrid's shared-block applications its own KV cache)."""
    jcfg, jp, cfg, model = arch_pair
    toks = _tokens(cfg, 2, _prompt(cfg), seed=6)
    C = _cache_len(cfg)
    want_logits, want_state = JM.prefill_with_state(
        jp, jcfg, {"tokens": jnp.asarray(toks)}, C)
    logits, state = M.prefill_with_state(
        model, cfg, {"tokens": torch.from_numpy(toks)}, C)
    _close(logits, want_logits)
    _check_state(cfg, state, want_state)


def test_new_arch_decode_step_matches_reference(arch_pair):
    """Decode steps from the prefill's state: each step's logits and the
    state after the last equal the reference's."""
    jcfg, jp, cfg, model = arch_pair
    S = _prompt(cfg)
    toks = _tokens(cfg, 2, S + 3, seed=8)
    C = _cache_len(cfg)
    _, jstate = JM.prefill_with_state(
        jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])}, C)
    _, state = M.prefill_with_state(
        model, cfg, {"tokens": torch.from_numpy(toks[:, :S])}, C)
    for t in range(S, S + 3):
        want, jstate = JM.decode_step(jp, jcfg, jnp.asarray(toks[:, t:t + 1]),
                                      jstate, jnp.asarray(t, jnp.int32))
        got, state = M.decode_step(model, cfg,
                                   torch.from_numpy(toks[:, t:t + 1]).long(),
                                   state, t)
        _close(got, want)
    _check_state(cfg, state, jstate)


def test_new_arch_engine_greedy_tokens_equal_reference(arch_pair):
    """Same greedy tokens from the arch's prompts (Mixtral: decoding past
    its window in a rolling cache of 64); each step's top-1/top-2 logit
    margin, replayed through the port's own prefill and decode, exceeds
    the logit tolerance, so the equality is not a tie broken alike."""
    jcfg, jp, cfg, model = arch_pair
    S = _prompt(cfg)
    prompts = _tokens(cfg, 2, S, seed=7)
    scfg = dict(max_new_tokens=NEW_TOKENS, cache_len=_cache_len(cfg))
    want = JaxEngine(jcfg, jp, JaxServeConfig(**scfg)).generate(prompts)
    got = Engine(cfg, model, ServeConfig(**scfg)).generate(prompts)
    assert got.shape == (2, NEW_TOKENS) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    logits, state = M.prefill_with_state(
        model, cfg, {"tokens": torch.from_numpy(prompts)}, scfg["cache_len"])
    steps = [logits]
    for i in range(NEW_TOKENS - 1):
        logits, state = M.decode_step(
            model, cfg, torch.from_numpy(got[:, i:i + 1]).long(), state,
            S + i)
        steps.append(logits)
    steps = torch.cat(steps, dim=1)[..., :cfg.vocab_size]
    np.testing.assert_array_equal(steps.argmax(-1).numpy(), got)
    top2 = torch.topk(steps, 2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    tol = RTOL * float(steps.abs().max())
    assert margin > 10 * tol, (margin, tol)


# the VLM backbone and the encoder-decoder (tests/test_torch_multimodal.py)
MULTIMODAL_ARCHS = ["internvl2-1b", "seamless-m4t-medium"]


@pytest.mark.parametrize("arch", NEW_ARCHS + MULTIMODAL_ARCHS)
def test_launch_serve_runs_each_arch_on_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "32",
                       "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert out.startswith(f"arch={arch} batch=2 new=3 wall=")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-2.7b",
                                  "minicpm3-4b", "zamba2-2.7b"])
def test_prefill_with_state_matches_decode_replay(arch):
    """tests/test_system.py's check of the reference, on the port: the one
    prefill pass that builds every cache agrees with replaying the prompt
    token by token through decode_step from empty caches, and the next
    decode step from either state gives the same logits (held here to the
    file's 1e-5 relative, not the reference test's 2e-3)."""
    cfg = get_config(arch).reduced()
    model = M.init_params(cfg, torch.Generator().manual_seed(9))
    B, S, C = 2, 9, 16
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=10)).long()
    logits_p, state_p = M.prefill_with_state(model, cfg, {"tokens": toks},
                                             cache_len=C)
    state_r = M.init_serve_state(cfg, B, cache_len=C, device="cpu")
    for t in range(S):
        logits_r, state_r = M.decode_step(model, cfg, toks[:, t:t + 1],
                                          state_r, t)
    _close(logits_r, logits_p)
    nxt = torch.argmax(logits_p[:, :, :cfg.vocab_size], -1)
    lp, _ = M.decode_step(model, cfg, nxt, state_p, S)
    lr, _ = M.decode_step(model, cfg, nxt, state_r, S)
    _close(lr, lp)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_models_reach_k4_once_per_attention_application(arch,
                                                            monkeypatch):
    """A hybrid's prefill goes through gqa_flash once per application of
    its shared block (counted by wrapping it, since on the CPU the kernel's
    counter does not move); the pure SSM model never does; decode never
    does."""
    jcfg = jax_get_config(arch).reduced().with_overrides(num_layers=4)
    cfg = get_config(arch).reduced().with_overrides(num_layers=4)
    model = M.init_params(cfg, torch.Generator().manual_seed(2))
    calls = []
    real = attn.gqa_flash

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(attn, "gqa_flash", counting)
    before = k4.LAUNCHES
    Engine(cfg, model, ServeConfig(max_new_tokens=4, cache_len=16)).generate(
        _tokens(cfg, 2, 9))
    applications = (cfg.num_layers // cfg.shared_attn_every
                    if cfg.arch_type == "hybrid" else 0)
    assert applications == (2 if arch == "zamba2-2.7b" else 0)
    assert len(calls) == applications
    assert all(c == (2, 9, cfg.num_heads, cfg.resolved_head_dim)
               for c in calls)
    assert k4.LAUNCHES == before
    # the reference's tree of the deeper hybrid: two groups, one shared block
    jp = JM.init_params(jcfg, jax.random.PRNGKey(6))
    deep = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                device="cpu")
    for a, b in zip(jax.tree.leaves(lm_params_to_numpy(deep)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_array_equal(a, b)
    toks = _tokens(cfg, 2, 37, seed=11)
    want, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, _ = M.forward(deep, cfg, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
