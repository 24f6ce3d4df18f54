"""The port's VLM prefix and enc-dec models against the JAX reference, on
the CPU.

The reduced internvl2-1b (2 layers, d_model 256, 4 query heads over 2 KV
heads of 64, an 8-row patch prefix) and the reduced seamless-m4t-medium
(2 encoder and 2 decoder layers, 4/4 heads of 64), on the reference's
`init_params` weights carried by `convert.lm_params_from_numpy`, with
prefix and encoder embeddings drawn by numpy from a seed. On the CPU the
port's attention is K4's plain version (no causal mask in the encoder
and the cross attention); the reference runs its jnp
`blockwise_attention`.

Tolerances, as in tests/test_torch_lm.py and tests/test_torch_train.py:
logits, layer outputs, caches and cross k/v within 1e-5 of their largest
magnitude; the loss within 1e-6 relative; every gradient leaf within
1e-5 of the leaf's largest magnitude (fp32 through two layers with other
summation orders, ~1e-6 relative per op); greedy tokens equal, with each
step's top-1/top-2 margin above the logit tolerance; training (both
families and the VLM at 14/2 heads): one AdamW step from the same
gradients within 1e-6 absolute, a 4-agent coke run's comms and
send_frac exact and its losses within 1e-3 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import tokens as jax_tokens
from repro.distributed import consensus as jax_cns
from repro.models import blocks as jax_blk
from repro.models import model as JM
from repro.optim import optimizers as jax_opt
from repro.serve import Engine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import engine as jax_engine
from repro.train import steps as jax_steps

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.distributed import consensus as cns
from repro_torch.kernels.flash_attention import flash_attention as k4
from repro_torch.models import attention as attn
from repro_torch.models import blocks as blk
from repro_torch.models import model as M
from repro_torch.optim import optimizers as opt
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve import engine as engine_mod
from repro_torch.train import steps

torch.set_num_threads(2)

RTOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
ADAMW_ATOL = 1e-6
RUN_RTOL = 1e-3
VLM, ENCDEC = "internvl2-1b", "seamless-m4t-medium"
S_ENC = 24          # encoder frames of the parity batches
NEW_TOKENS = 6


def _close(got, want, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=[VLM, ENCDEC])
def fam(request):
    """(jax cfg, jax params, port cfg, port model) of a reduced family on
    the same weights."""
    jcfg = jax_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(11))
    return jcfg, jp, cfg, lm_params_from_numpy(cfg, _np_tree(jp),
                                               device="cpu")


@pytest.fixture(scope="module")
def vlm():
    jcfg = jax_get_config(VLM).reduced()
    cfg = get_config(VLM).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(12))
    return jcfg, jp, cfg, lm_params_from_numpy(cfg, _np_tree(jp),
                                               device="cpu")


@pytest.fixture(scope="module")
def encdec():
    jcfg = jax_get_config(ENCDEC).reduced()
    cfg = get_config(ENCDEC).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(13))
    return jcfg, jp, cfg, lm_params_from_numpy(cfg, _np_tree(jp),
                                               device="cpu")


def _batch(cfg, B, S, seed, labels=False):
    """numpy {"tokens"[, "labels"]} and the family's stub embeddings:
    the VLM's prefix_len patch rows or S_ENC encoder frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks}
    if labels:
        batch["labels"] = np.roll(toks, -1, axis=1)
    if cfg.is_encdec:
        batch["encoder_embeds"] = rng.normal(
            size=(B, S_ENC, cfg.d_model)).astype(np.float32)
    else:
        batch["prefix_embeds"] = rng.normal(
            size=(B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _extra(batch):
    return {k: v for k, v in batch.items() if k.endswith("_embeds")}


# ---------------------------------------------------------------------------
# Both families
# ---------------------------------------------------------------------------

def test_builds_the_reference_tree_and_round_trips(fam):
    """The VLM is a decoder-only stack of dense blocks; the enc-dec model
    holds encoder (dense blocks), enc_norm and decoder (CrossBlocks), and
    no blocks, as the reference's tree. Every weight carried by name and
    the reference's tree back out, bitwise."""
    jcfg, jp, cfg, model = fam
    if cfg.is_encdec:
        assert not hasattr(model, "blocks")
        assert len(model.encoder) == cfg.encoder_layers == 2
        assert all(isinstance(b, blk.DenseBlock) for b in model.encoder)
        assert len(model.decoder) == cfg.num_layers
        assert all(isinstance(b, blk.CrossBlock) for b in model.decoder)
        for b in model.decoder:
            assert isinstance(b.self_attn, attn.GQAAttention)
            assert isinstance(b.cross_attn, attn.GQAAttention)
    else:
        assert not hasattr(model, "encoder")
        assert all(isinstance(b, blk.DenseBlock) for b in model.blocks)
        assert (cfg.num_heads, cfg.num_kv_heads, cfg.prefix_len) == (4, 2, 8)
    back = lm_params_to_numpy(model)
    want = _np_tree(jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    again = lm_params_from_numpy(cfg, back, device="cpu")
    for (n, p), (m, q) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        assert n == m
        assert torch.equal(p, q)


def test_forward_and_loss_match_reference(fam):
    """Logits aligned with the tokens (the VLM's prefix rows sliced off),
    the loss and its nll."""
    jcfg, jp, cfg, model = fam
    batch = _batch(cfg, 2, 21, seed=1, labels=True)
    want, want_aux = JM.forward(jp, jcfg, _jax(batch))
    got, aux = M.forward(model, cfg, _torch(batch))
    assert got.shape == (2, 21, cfg.padded_vocab)
    _close(got, want)
    assert float(aux) == float(want_aux) == 0.0
    _close(M.prefill(model, cfg, _torch(batch)), np.asarray(want)[:, -1:])
    jloss, jparts = JM.loss_fn(jp, jcfg, _jax(batch))
    loss, parts = M.loss_fn(model, cfg, _torch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["nll"]), float(jparts["nll"]),
                               rtol=LOSS_RTOL)


def test_every_gradient_matches_reference(fam):
    """jax.value_and_grad of the reference's loss_fn against the port's
    loss through `torch.func.functional_call` on the skeleton: the loss
    within 1e-6 relative, every gradient leaf (the prefix's path, the
    encoder, the cross attention) within 1e-5 of its largest magnitude."""
    jcfg, jp, cfg, model = fam
    batch = _batch(cfg, 2, 16, seed=2, labels=True)
    (jl, _), jg = jax.value_and_grad(JM.loss_fn, has_aux=True)(
        jp, jcfg, _jax(batch))
    loss, _, grads = steps._value_and_grad(M.skeleton(cfg), cfg,
                                           M.param_dict(model),
                                           _torch(batch))
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    flat_p = dict(jax.tree_util.tree_flatten_with_path(
        lm_params_to_numpy(grads))[0])
    flat_r = dict(jax.tree_util.tree_flatten_with_path(_np_tree(jg))[0])
    assert set(flat_p) == set(flat_r)
    for path, want in flat_r.items():
        np.testing.assert_allclose(
            flat_p[path], want, rtol=0,
            atol=GRAD_RTOL * max(float(np.abs(want).max()), 1e-30),
            err_msg=jax.tree_util.keystr(path))


def test_init_serve_state_matches_reference_shapes(fam):
    jcfg, _, cfg, _ = fam
    want = JM.init_serve_state(jcfg, 2, 16, enc_len=S_ENC)
    got = M.init_serve_state(cfg, 2, 16, enc_len=S_ENC, device="cpu")
    if cfg.is_encdec:
        assert set(got) == {"self", "cross_k", "cross_v"}
        for key in ("cross_k", "cross_v"):
            assert len(got[key]) == cfg.num_layers
            assert tuple(got[key][0].shape) == want[key].shape[1:]
        caches = got["self"]
        want_cache = want["self"]
    else:
        caches = got["layers"]
        want_cache = want["layers"]
    assert len(caches) == cfg.num_layers
    for name, t, w in zip(caches[0]._fields, caches[0], want_cache):
        assert tuple(t.shape) == w.shape[1:], name


# ---------------------------------------------------------------------------
# The VLM prefix
# ---------------------------------------------------------------------------

def test_vlm_offset_and_positions(vlm):
    """The prefix rows precede the tokens: the offset is P and positions
    run over P + S, as the reference's `_embed_inputs`; without
    prefix_embeds the model is a plain decoder."""
    jcfg, jp, cfg, model = vlm
    batch = _batch(cfg, 2, 7, seed=3)
    jx, jpos, joff = JM._embed_inputs(jp, jcfg, _jax(batch))
    x, pos, off = M._embed_inputs(model, cfg, _torch(batch))
    assert off == joff == cfg.prefix_len
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(pos.numpy(), np.arange(cfg.prefix_len + 7))
    _close(x, jx)
    np.testing.assert_array_equal(x[:, :off].numpy(), batch["prefix_embeds"])
    tokens = {"tokens": batch["tokens"]}
    _, _, off = M._embed_inputs(model, cfg, _torch(tokens))
    assert off == 0
    want, _ = JM.forward(jp, jcfg, _jax(tokens))
    _close(M.forward(model, cfg, _torch(tokens))[0], want)


def _check_kv_state(cfg, state, want_state, key="layers"):
    """Every layer's KV cache (k, v, slot positions) against the
    reference's stacked one."""
    want = _np_tree(want_state[key])
    assert len(state[key]) == cfg.num_layers
    for i, cache in enumerate(state[key]):
        assert type(cache).__name__ == "KVCache"
        for name, got_t, want_t in zip(cache._fields, cache, want):
            if name == "slot_positions":
                np.testing.assert_array_equal(got_t.numpy(), want_t[i])
            else:
                _close(got_t, want_t[i])


def test_vlm_prefill_with_state_matches_reference(vlm):
    """Last logits and every layer's cache, whose P + S rows hold the
    prefix's before the text's."""
    jcfg, jp, cfg, model = vlm
    S, C = 13, 32
    batch = _batch(cfg, 2, S, seed=4)
    want_logits, want_state = JM.prefill_with_state(jp, jcfg, _jax(batch), C)
    logits, state = M.prefill_with_state(model, cfg, _torch(batch), C)
    _close(logits, want_logits)
    _check_kv_state(cfg, state, want_state)
    filled = state["layers"][0].slot_positions
    np.testing.assert_array_equal(
        filled.numpy(), np.r_[np.arange(cfg.prefix_len + S),
                              -np.ones(C - cfg.prefix_len - S)])


@pytest.mark.parametrize("first", ["text", "engine"])
def test_vlm_decode_step_matches_reference(vlm, first):
    """Decode steps from the prefill's state, each step's logits and the
    state after the last: from position P + S (the text's next row), and
    from position S, where the engine decodes (`Engine._prefill_state`)."""
    jcfg, jp, cfg, model = vlm
    S, C = 5, 32
    batch = _batch(cfg, 2, S + 3, seed=5)
    head = dict(batch, tokens=batch["tokens"][:, :S])
    _, jstate = JM.prefill_with_state(jp, jcfg, _jax(head), C)
    _, state = M.prefill_with_state(model, cfg, _torch(head), C)
    start = S + cfg.prefix_len if first == "text" else S
    for i in range(3):
        tok = batch["tokens"][:, S + i:S + i + 1]
        want, jstate = JM.decode_step(jp, jcfg, jnp.asarray(tok), jstate,
                                      jnp.asarray(start + i, jnp.int32))
        got, state = M.decode_step(model, cfg, torch.from_numpy(tok).long(),
                                   state, start + i)
        _close(got, want)
    _check_kv_state(cfg, state, jstate)


def _margin_ok(steps_logits, vocab):
    steps_logits = steps_logits[..., :vocab]
    top2 = torch.topk(steps_logits, 2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    tol = RTOL * float(steps_logits.abs().max())
    assert margin > 10 * tol, (margin, tol)


@pytest.mark.parametrize("S", [5, 12], ids=["shorter", "longer"])
def test_vlm_engine_greedy_tokens_equal_reference(vlm, S):
    """Greedy tokens equal with prompts shorter (5) and longer (12) than
    the 8-row prefix. The engine keeps the reference's position
    bookkeeping: the first decode step runs at position S, the prompt's
    length, not P + S; it writes cache slot S and attends to the slots
    <= S (for S < P, prefix rows only). Pinned by replaying the port's
    prefill and decode steps at S + i, which give the engine's tokens,
    each step's top-1/top-2 margin above the logit tolerance."""
    jcfg, jp, cfg, model = vlm
    batch = _batch(cfg, 2, S, seed=6)
    prompts, extra = batch["tokens"], _extra(batch)
    scfg = dict(max_new_tokens=NEW_TOKENS, cache_len=32)
    want = JaxEngine(jcfg, jp, JaxServeConfig(**scfg),
                     extra_batch=_jax(extra)).generate(prompts)
    got = Engine(cfg, model, ServeConfig(**scfg),
                 extra_batch=extra).generate(prompts)
    assert got.shape == (2, NEW_TOKENS) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    logits, state = M.prefill_with_state(model, cfg, _torch(batch),
                                         scfg["cache_len"])
    seen = [logits]
    for i in range(NEW_TOKENS - 1):
        logits, state = M.decode_step(
            model, cfg, torch.from_numpy(got[:, i:i + 1]).long(), state,
            S + i)
        seen.append(logits)
    seen = torch.cat(seen, dim=1)
    np.testing.assert_array_equal(seen[..., :cfg.vocab_size].argmax(-1),
                                  got)
    _margin_ok(seen, cfg.vocab_size)
    # the first step at position S took slot S, which the prefill had
    # given to row S of the prefix (S < P) or of the text
    sp = state["layers"][0].slot_positions.numpy()
    assert sp[S] == S and (sp >= 0).sum() == cfg.prefix_len + S


# ---------------------------------------------------------------------------
# Enc-dec
# ---------------------------------------------------------------------------

def test_cross_block_matches_reference(encdec):
    """Decoder layer 0: cross_memory_kv, cross_attend (Sq = 9 decoder rows
    over Sk = 24 encoder rows, no mask), cross_block_forward, and
    cross_block_decode over the whole memory."""
    jcfg, jp, cfg, model = encdec
    rng = np.random.default_rng(7)
    memory = rng.normal(size=(2, S_ENC, cfg.d_model)).astype(np.float32)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["decoder"])
    lp = model.decoder[0]
    drawn = blk.init_cross_block_params(cfg, torch.Generator().manual_seed(0))
    assert isinstance(drawn, blk.CrossBlock)
    assert [n for n, _ in drawn.named_parameters()] == [
        n for n, _ in lp.named_parameters()]
    jmk, jmv = jax_blk.cross_memory_kv(jl["cross_attn"], jnp.asarray(memory))
    mk, mv = blk.cross_memory_kv(lp.cross_attn, torch.from_numpy(memory))
    _close(mk, jmk)
    _close(mv, jmv)
    pos = np.arange(9, dtype=np.int32)
    want = jax_blk.cross_attend(jl["cross_attn"], jcfg, jnp.asarray(x), jmk,
                                jmv, jnp.asarray(pos))
    _close(blk.cross_attend(lp.cross_attn, cfg, torch.from_numpy(x), mk, mv),
           want)
    want, _ = jax_blk.cross_block_forward(jl, jcfg, jnp.asarray(x),
                                          jnp.asarray(pos), jmk, jmv)
    got, aux = blk.cross_block_forward(lp, cfg, torch.from_numpy(x),
                                       torch.from_numpy(pos), mk, mv)
    _close(got, want)
    assert float(aux) == 0.0
    jcache = jax.tree.map(lambda a: a[0], JM.init_serve_state(
        jcfg, 2, 16, enc_len=S_ENC)["self"])
    cache = M.init_serve_state(cfg, 2, 16, enc_len=S_ENC,
                               device="cpu")["self"][0]
    for t in range(3):
        want, jcache = jax_blk.cross_block_decode(
            jl, jcfg, jnp.asarray(x[:, t:t + 1]), jcache,
            jnp.asarray(t, jnp.int32), jmk, jmv)
        got, cache = blk.cross_block_decode(
            lp, cfg, torch.from_numpy(x[:, t:t + 1]), cache, t, mk, mv)
        _close(got, want)
    _close(cache.k, jcache.k)
    np.testing.assert_array_equal(cache.slot_positions.numpy(),
                                  np.asarray(jcache.slot_positions))


def _states(jcfg, jp, cfg, model, enc, C):
    """The reference's and the port's serve states after
    `_fill_cross_memory` of the same encoder embeddings."""
    B, S_enc = enc.shape[:2]
    jstate = jax_engine._fill_cross_memory(
        jcfg, jp, JM.init_serve_state(jcfg, B, C, enc_len=S_enc),
        jnp.asarray(enc))
    state = engine_mod._fill_cross_memory(
        cfg, model, M.init_serve_state(cfg, B, C, enc_len=S_enc,
                                       device="cpu"), torch.from_numpy(enc))
    return jstate, state


def test_encdec_cross_memory_matches_reference(encdec):
    """`_fill_cross_memory`: the encoder (no causal mask), enc_norm, and
    each decoder layer's cross k and v."""
    jcfg, jp, cfg, model = encdec
    enc = _batch(cfg, 2, 1, seed=8)["encoder_embeds"]
    jstate, state = _states(jcfg, jp, cfg, model, enc, 16)
    for key in ("cross_k", "cross_v"):
        assert len(state[key]) == cfg.num_layers
        for i, t in enumerate(state[key]):
            assert t.shape == (2, S_ENC, cfg.num_kv_heads,
                               cfg.resolved_head_dim)
            _close(t, np.asarray(jstate[key])[i])
    memory, _ = M.encode(model, cfg, torch.from_numpy(enc))
    assert torch.equal(state["cross_k"][1], blk.cross_memory_kv(
        model.decoder[1].cross_attn, memory)[0])


def test_encdec_decode_step_matches_reference(encdec):
    """Decode from the filled cross memory, token by token from position
    0 (the engine's replay of the prompt, then new tokens): each step's
    logits and every layer's self cache after the last."""
    jcfg, jp, cfg, model = encdec
    batch = _batch(cfg, 2, 6, seed=9)
    jstate, state = _states(jcfg, jp, cfg, model, batch["encoder_embeds"],
                            16)
    for t in range(6):
        tok = batch["tokens"][:, t:t + 1]
        want, jstate = JM.decode_step(jp, jcfg, jnp.asarray(tok), jstate,
                                      jnp.asarray(t, jnp.int32))
        got, state = M.decode_step(model, cfg, torch.from_numpy(tok).long(),
                                   state, t)
        _close(got, want)
    _check_kv_state(cfg, state, jstate, key="self")
    with pytest.raises(ValueError, match="engine"):
        M.prefill_with_state(model, cfg, _torch(batch), 16)


@pytest.mark.parametrize("setting", ["test_system", "longer"])
def test_encdec_engine_greedy_tokens_equal_reference(encdec, setting):
    """Greedy tokens equal: tests/test_system.py::test_engine_encdec's
    setting (PRNGKey(4) weights, 8 frames from default_rng(0), prompts
    [[1, 2], [3, 4]], 4 new tokens, cache 16), and a 9-token prompt over
    24 frames; each step's margin, replayed, above the logit tolerance."""
    jcfg, jp, cfg, model = encdec
    if setting == "test_system":
        jp = JM.init_params(jcfg, jax.random.PRNGKey(4))
        model = lm_params_from_numpy(cfg, _np_tree(jp), device="cpu")
        enc = np.random.default_rng(0).normal(
            size=(2, 8, cfg.d_model)).astype(np.float32)
        prompts = np.array([[1, 2], [3, 4]], np.int32)
        scfg = dict(max_new_tokens=4, cache_len=16)
    else:
        batch = _batch(cfg, 2, 9, seed=10)
        enc, prompts = batch["encoder_embeds"], batch["tokens"]
        scfg = dict(max_new_tokens=NEW_TOKENS, cache_len=32)
    want = JaxEngine(jcfg, jp, JaxServeConfig(**scfg), extra_batch={
        "encoder_embeds": jnp.asarray(enc)}).generate(prompts)
    eng = Engine(cfg, model, ServeConfig(**scfg),
                 extra_batch={"encoder_embeds": enc})
    got = eng.generate(prompts)
    assert got.shape == want.shape and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    with torch.inference_mode():
        logits, state, pos = eng._prefill_state(
            torch.from_numpy(prompts).long())
        seen = [logits]
        for i in range(got.shape[1] - 1):
            logits, state = M.decode_step(
                model, cfg, torch.from_numpy(got[:, i:i + 1]).long(), state,
                pos + i)
            seen.append(logits)
    assert pos == prompts.shape[1]
    _margin_ok(torch.cat(seen, dim=1), cfg.vocab_size)


def test_encdec_reaches_k4_once_per_encoder_layer(encdec, monkeypatch):
    """Every attention over a whole sequence goes through gqa_flash
    (counted by wrapping it, since on the CPU the kernel's counter does
    not move): a forward runs it per encoder layer without the causal
    mask, per decoder layer causally, and per cross attention without the
    mask at Sq = S, Sk = S_enc; a generate only in the encoder (the
    prompt's replay and the decode run none)."""
    _, _, cfg, model = encdec
    calls = []
    real = attn.gqa_flash

    def counting(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attn, "gqa_flash", counting)
    before = k4.LAUNCHES
    batch = _batch(cfg, 2, 7, seed=11)
    M.forward(model, cfg, _torch(batch))
    L, E = cfg.num_layers, cfg.encoder_layers
    assert calls == ([(S_ENC, S_ENC, False)] * E
                     + [(7, 7, True), (7, S_ENC, False)] * L)
    calls.clear()
    Engine(cfg, model, ServeConfig(max_new_tokens=4, cache_len=16),
           extra_batch=_extra(batch)).generate(batch["tokens"])
    assert calls == [(S_ENC, S_ENC, False)] * E
    assert k4.LAUNCHES == before


# ---------------------------------------------------------------------------
# Training: one AdamW step, and a coke run at 4 agents
# ---------------------------------------------------------------------------

# the VLM also at 14 query heads over 2 KV heads, as the full model groups
# them (the attention's backward sums groups of 7)
TRAINED = {VLM: (VLM, {}), ENCDEC: (ENCDEC, {}),
           "internvl2-1b-14-2": (VLM, {"num_heads": 14, "num_kv_heads": 2})}


@pytest.fixture(scope="module", params=list(TRAINED))
def trained(request):
    """(jax cfg, jax params, port cfg, port model) of a reduced family on
    the same weights, the 14/2 VLM with its heads overridden in both."""
    arch, kw = TRAINED[request.param]
    jcfg = jax_get_config(arch).reduced().with_overrides(**kw)
    cfg = get_config(arch).reduced().with_overrides(**kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(14))
    return jcfg, jp, cfg, lm_params_from_numpy(cfg, _np_tree(jp),
                                               device="cpu")


def test_one_adamw_step_matches_reference(trained):
    """One AdamW step (the launcher's lr 3e-3, clip 1.0) from the
    reference's gradients of a batch with the stub embeddings, fed to
    both: params within 1e-6 absolute."""
    jcfg, jp, cfg, model = trained
    batch = _batch(cfg, 2, 16, seed=3, labels=True)
    _, jg = jax.value_and_grad(JM.loss_fn, has_aux=True)(jp, jcfg,
                                                         _jax(batch))
    kw = dict(kind="adamw", lr=3e-3, grad_clip=1.0)
    jcfg_o, tcfg_o = jax_opt.OptConfig(**kw), opt.OptConfig(**kw)
    ju, _ = jax_opt.opt_update(jcfg_o, jg, jax_opt.init_opt_state(jcfg_o, jp),
                               jp)
    jnew = jax_opt.apply_updates(jp, ju)
    params = M.param_dict(model)
    tgrads = M.param_dict(lm_params_from_numpy(cfg, _np_tree(jg),
                                               device="cpu"))
    tu, _ = opt.opt_update(tcfg_o, tgrads, opt.init_opt_state(tcfg_o, params),
                           params)
    flat_r = dict(jax.tree_util.tree_flatten_with_path(_np_tree(jnew))[0])
    flat_p = dict(jax.tree_util.tree_flatten_with_path(
        lm_params_to_numpy(opt.apply_updates(params, tu)))[0])
    assert set(flat_p) == set(flat_r)
    for path, want in flat_r.items():
        np.testing.assert_allclose(flat_p[path], want, rtol=0,
                                   atol=ADAMW_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_coke_run_matches_reference(trained):
    """The reference's and the port's coke train steps (4 agents on a
    ring, v=20, mu=0.5, AdamW lr 3e-3), 4 steps of B=8 from the same
    weights, token batches and stub embeddings (made once, split over the
    agents with the tokens): comms and send_frac exact every step, losses
    within 1e-3 relative."""
    jcfg, jp, cfg, model = trained
    agents, S = 4, 24
    kw = dict(vocab_size=cfg.vocab_size, seq_len=S, global_batch=8,
              structure=0.9)
    jstream = jax_tokens.TokenStream(jax_tokens.TokenStreamConfig(**kw))
    extra = _extra(_batch(cfg, 8, S, seed=4))
    ccfg_kw = dict(strategy="coke", rho=1e-3, censor_v=20.0, censor_mu=0.5)
    jccfg = jax_cns.ConsensusConfig(**dict(ccfg_kw, use_fused_kernel=False))
    jopt, topt = jax_opt.OptConfig(lr=3e-3), opt.OptConfig(lr=3e-3)
    _, jstep, _ = jax_steps.make_train_step(jcfg, jopt, jccfg,
                                            num_agents=agents)
    tinit, tstep, _ = steps.make_train_step(
        cfg, topt, cns.ConsensusConfig(**ccfg_kw), num_agents=agents)
    stacked = jax_cns.stack_params(jp, agents)
    js = {"params": stacked, "consensus": jax_cns.init_consensus_state(
        jccfg, jopt, stacked)}
    ts = tinit(M.param_dict(model))
    jstep = jax.jit(jstep)
    sends = []
    for i in range(4):
        toks, labels = jstream.batch(i)
        batch = {"tokens": toks, "labels": labels, **extra}
        js, jm = jstep(js, jax_steps.agent_batch(_jax(batch), agents))
        ts, tm = tstep(ts, steps.agent_batch(_torch(batch), agents))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=RUN_RTOL, err_msg=f"step {i}")
        for k in ("comms", "send_frac"):
            assert float(tm[k]) == float(jm[k]), (i, k)
        sends.append(float(tm["send_frac"]))
    assert min(sends) < 1.0 and max(sends) == 1.0
