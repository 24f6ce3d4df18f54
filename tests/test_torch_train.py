"""The port's deep-net training layer against the JAX reference, on the CPU.

The reduced qwen3-1.7b (2 layers, d_model 256, 4 heads of 64, vocab 1024)
and its grouped variant (2 KV heads), on the reference's `init_params`
weights carried by `convert.lm_params_from_numpy`: the token stream, the
loss and its gradients, the attention Function's backward, AdamW, the
allreduce and consensus train steps, `train.py` and its checkpoint. The
other served families, reduced (`FAMILIES`): the loss, its gradients and
one AdamW step. On the
CPU the attention is K4's plain version and its backward autograd through
it; the reference runs its jnp `blockwise_attention` under
`jax.value_and_grad`.

Tolerances, each stated beside its check:
- token batches bitwise (both are the same numpy code);
- the loss within 1e-6 relative, every gradient leaf within 1e-5 of the
  leaf's largest magnitude (fp32 through two layers, XLA's blockwise
  online softmax against a full softmax: ~1e-6 relative per op);
- one AdamW step from the same gradients within 1e-6 absolute;
- whole runs: comms and send_frac exact; losses within 1e-3 relative,
  but 3e-3 for tests/test_system.py's 20-step coke run, which parts from
  the reference's by up to 1.4e-3. The gradients agree to ~2.5e-7
  absolute, and AdamW's first step moves every element by
  lr * g / (|g| + eps): where |g| is no larger than that agreement the
  move is decided by roundoff, up to +-lr in one package and not the
  other. `test_coke_first_step_parts_only_where_adamw_divides_by_eps`
  checks that this is the whole of the first step's difference; the
  consensus rounds then carry it into the loss.
"""
import json
import subprocess
import sys
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore as jax_restore
from repro.configs import get_config as jax_get_config
from repro.data import tokens as jax_tokens
from repro.distributed import consensus as jax_cns
from repro.models import attention as jax_attn
from repro.models import model as JM
from repro.optim import optimizers as jax_opt
from repro.train import steps as jax_steps

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.data import tokens
from repro_torch.distributed import consensus as cns
from repro_torch.kernels.flash_attention import flash_attention as k4
from repro_torch.kernels.flash_attention import flash_attention_bwd as k7
from repro_torch.kernels.flash_attention.ops import gqa_flash
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)
from repro_torch.models import model as M
from repro_torch.optim import optimizers as opt
from repro_torch.train import steps

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
ADAMW_ATOL = 1e-6
RUN_RTOL = 1e-3
CONSENSUS_RUN_RTOL = 3e-3
VARIANTS = {"mha": {}, "gqa": {"num_kv_heads": 2}}


def _configs(variant="mha"):
    kw = VARIANTS[variant]
    return (jax_get_config("qwen3-1.7b").reduced().with_overrides(**kw),
            get_config("qwen3-1.7b").reduced().with_overrides(**kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    """(jax cfg, jax params, port cfg, port model) on the same weights."""
    jcfg, cfg = _configs(request.param)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, cfg, lm_params_from_numpy(cfg, _np_tree(jp),
                                               device="cpu")


def _stream(cfg, B=8, S=48):
    kw = dict(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
              structure=0.9)
    return (jax_tokens.TokenStream(jax_tokens.TokenStreamConfig(**kw)),
            tokens.TokenStream(tokens.TokenStreamConfig(**kw)))


def _batches(stream, i, agents=None):
    toks, labels = stream.batch(i)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    if agents:
        jb = jax_steps.agent_batch(jb, agents)
        tb = steps.agent_batch(tb, agents)
    return jb, tb


def _assert_tree_close(port_tree, ref_tree, rtol, what):
    """Every leaf of the port's tree (the reference's layout) within rtol
    of the reference leaf's largest magnitude."""
    flat_p = dict(jax.tree_util.tree_flatten_with_path(port_tree)[0])
    flat_r = dict(jax.tree_util.tree_flatten_with_path(ref_tree)[0])
    assert set(flat_p) == set(flat_r)
    for path, want in flat_r.items():
        want = np.asarray(want)
        got = np.asarray(flat_p[path])
        assert got.shape == want.shape, path
        np.testing.assert_allclose(
            got, want, rtol=0, atol=rtol * max(float(np.abs(want).max()),
                                               1e-30),
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


# ---------------------------------------------------------------------------
# the token stream, the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,structure", [(0, 0.8), (3, 0.9), (7, 0.0)])
def test_token_stream_batches_are_the_reference_bits(seed, structure):
    kw = dict(vocab_size=1000, seq_len=33, global_batch=6, seed=seed,
              structure=structure)
    ref = jax_tokens.TokenStream(jax_tokens.TokenStreamConfig(**kw))
    port = tokens.TokenStream(tokens.TokenStreamConfig(**kw))
    for step in (0, 1, 17):
        for a, b in zip(port.batch(step), ref.batch(step)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    (a, _), (b, _) = next(iter(port)), next(iter(ref))
    assert np.array_equal(a, b)


def test_regression_shards_match_the_reference():
    """regression_shards_to_device on the paper's synthetic shards with the
    reference's RFF draw carried across: labels bitwise, features within
    1e-5 (fp32 x @ omega and cos in other orders)."""
    from repro.core import rff as jax_rff
    from repro.data.synthetic import paper_synthetic as jax_synthetic
    from repro_torch.convert import rff_params_from_numpy
    from repro_torch.core import rff as port_rff
    ds = jax_synthetic(num_agents=3, samples_per_agent=20)
    jparams = jax_rff.draw_rff(jax.random.PRNGKey(1), ds.x.shape[-1], 64,
                               bandwidth=1.0)
    jf, jl = jax_tokens.regression_shards_to_device(ds, jparams,
                                                    jax_rff.featurize)
    tparams = rff_params_from_numpy(jparams.omega, jparams.bias,
                                    device="cpu")
    tf, tl = tokens.regression_shards_to_device(ds, tparams,
                                                port_rff.featurize,
                                                device="cpu")
    assert tf.shape == jf.shape and tl.device.type == "cpu"
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0,
                               atol=1e-5)


def test_loss_and_every_gradient_match_the_reference(pair):
    jcfg, jp, cfg, model = pair
    _, stream = _stream(cfg, B=2, S=40)
    toks, labels = stream.batch(3)
    (jl, jex), jg = jax.value_and_grad(JM.loss_fn, has_aux=True)(
        jp, jcfg, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    batch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    loss, extras, grads = steps._value_and_grad(M.skeleton(cfg), cfg,
                                                M.param_dict(model), batch)
    # loss: 1e-6 relative; the module path gives the same value
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(extras["nll"]), float(jex["nll"]),
                               rtol=LOSS_RTOL)
    assert float(extras["aux"]) == float(jex["aux"]) == 0.0
    assert float(M.loss_fn(model, cfg, batch)[0]) == float(loss)
    # every gradient leaf: 1e-5 of its largest magnitude
    _assert_tree_close(lm_params_to_numpy(grads), _np_tree(jg), GRAD_RTOL,
                       "grad")


# the served families beside qwen3, reduced: dense GQA, MoE with Mixtral's
# window, MLA, MLA with MoE, the SSM model and the grouped hybrid
FAMILIES = ["granite-3-8b", "mixtral-8x7b", "minicpm3-4b",
            "deepseek-v2-lite-16b", "mamba2-2.7b", "zamba2-2.7b"]


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """A reduced family on the reference's weights and the reference's
    loss and gradients at one batch of B=2, S=32 (B x S fills the reduced
    MoE's groups of 64 tokens, which the reference asserts): (jax params,
    port cfg, port model, batch, (loss, extras), jax gradients)."""
    jcfg = jax_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    _, stream = _stream(cfg, B=2, S=32)
    toks, labels = stream.batch(3)
    (jl, jex), jg = jax.value_and_grad(JM.loss_fn, has_aux=True)(
        jp, jcfg, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    batch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    return (jp, cfg, lm_params_from_numpy(cfg, _np_tree(jp), device="cpu"),
            batch, (jl, jex), jg)


def test_family_loss_and_every_gradient_match_the_reference(family):
    """The loss, its nll and the MoE aux (0 where the family has no MoE)
    within 1e-6 relative of jax.value_and_grad's, every gradient leaf
    within 1e-5 of its largest magnitude: autograd through the MoE's
    einsums, MLA's expansion for K4's plain version and the SSD scan's ATen
    ops."""
    _, cfg, model, batch, (jl, jex), jg = family
    loss, extras, grads = steps._value_and_grad(M.skeleton(cfg), cfg,
                                                M.param_dict(model), batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(extras["nll"]), float(jex["nll"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(extras["aux"]), float(jex["aux"]),
                               rtol=LOSS_RTOL)
    assert (float(jex["aux"]) != 0.0) == cfg.is_moe
    _assert_tree_close(lm_params_to_numpy(grads), _np_tree(jg), GRAD_RTOL,
                       "grad")


def test_family_one_adamw_step_matches_the_reference(family):
    """One AdamW step (the launcher's lr 3e-3, clip 1.0) from the
    reference's gradients, fed to both: params within 1e-6 absolute."""
    jp, cfg, model, _, _, jg = family
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


@pytest.mark.parametrize("shape", [(2, 37, 4, 4, 64, True, 0),
                                   (2, 40, 4, 2, 64, True, 0),
                                   (1, 50, 4, 2, 32, True, 16),
                                   (1, 24, 2, 1, 16, False, 0),
                                   # MLA's Dh != Dv (the reduced models'
                                   # 48 / 32), and with a window
                                   (2, 37, 4, 4, 48, True, 0, 32),
                                   (1, 50, 4, 2, 24, True, 16, 16),
                                   # the enc-dec cross attention: Sq != Sk
                                   # without the mask, both ways, off the
                                   # blocks of 16; the VLM's groups of 7
                                   (2, 20, 4, 4, 32, False, 0, 32, 45),
                                   (2, 45, 4, 4, 32, False, 0, 32, 20),
                                   (1, 40, 7, 1, 32, True, 0),
                                   (1, 23, 7, 1, 32, False, 0, 32, 50)],
                         ids=str)
def test_attention_backward_matches_jax_grad(shape):
    """The Function's CPU backward (autograd through the plain version) and
    K7's plain version against jax.grad of the reference's
    blockwise_attention (blocks of 16, so the online softmax runs): each
    gradient within 1e-5 of its largest magnitude. K4 and K7 stay idle on
    the CPU. (B, S, H, KV, Dh, causal, window[, Dv[, Sk]]); Dv defaults to
    Dh, the keys' length Sk to the queries' S."""
    B, S, H, KV, D, causal, window = shape[:7]
    Dv = shape[7] if len(shape) > 7 else D
    Sk = shape[8] if len(shape) > 8 else S
    rng = np.random.default_rng(4)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, S, H, D), (B, Sk, KV, D), (B, Sk, KV, Dv), (B, S, H, Dv)))
    q_pos = jnp.arange(S, dtype=jnp.int32)
    k_pos = jnp.arange(Sk, dtype=jnp.int32)

    def jf(q_, k_, v_):
        o = jax_attn.blockwise_attention(q_, k_, v_, q_pos, k_pos,
                                         causal=causal, window=window,
                                         block_q=16, block_k=16)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(jf, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                             for a in (q, k, v)))
    launches = (k4.LAUNCHES, k7.LAUNCHES)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = gqa_flash(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, torch.tensor(do))
    t = lambda a: torch.tensor(a).transpose(1, 2)
    plain = attention_bwd_ref(t(q), t(k), t(v), out.detach().transpose(1, 2),
                              t(do), causal=causal, window=window)
    for g, p, w in zip(got, plain, want):
        w = np.asarray(w)
        tol = GRAD_RTOL * float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)
        np.testing.assert_allclose(p.transpose(1, 2).numpy(), w, rtol=0,
                                   atol=tol)
    assert (k4.LAUNCHES, k7.LAUNCHES) == launches
    # the forward through the Function is the plain forward's bits
    assert torch.equal(out.detach(), attention_ref(
        t(q), t(k), t(v), causal=causal, window=window).transpose(1, 2))


def test_attention_backward_kernel_takes_cuda_tensors_only():
    """K7's wrapper launches or raises: CPU tensors raise ValueError (the
    CPU's backward is autograd through the Function), bf16 raises
    NotImplementedError first, and nothing launches."""
    q, k, v, o, do = (torch.randn(1, 8, 2, 16) for _ in range(5))
    lse = torch.zeros(1, 2, 8)
    before = k7.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        k7.gqa_flash_bwd(q, k, v, o, do, lse)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        k7.gqa_flash_bwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), o, do,
                         lse)
    assert k7.LAUNCHES == before


@pytest.mark.parametrize("clip,wd", [(0.0, 0.0), (1.0, 0.0), (0.0, 0.1),
                                     (1e-3, 0.01)])
def test_one_adamw_step_on_the_lm_matches_the_reference(pair, clip, wd):
    """One AdamW step on the LM's tree from the reference's gradients, fed
    to both: params within 1e-6 absolute; with a clip that binds."""
    jcfg, jp, cfg, model = pair
    _, stream = _stream(cfg, B=2, S=16)
    toks, labels = stream.batch(0)
    jg = jax.grad(lambda p: JM.loss_fn(p, jcfg, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})[0])(jp)
    kw = dict(kind="adamw", lr=3e-3, grad_clip=clip, weight_decay=wd)
    jcfg_o, tcfg_o = jax_opt.OptConfig(**kw), opt.OptConfig(**kw)
    ju, _ = jax_opt.opt_update(jcfg_o, jg, jax_opt.init_opt_state(jcfg_o, jp),
                               jp)
    jnew = jax_opt.apply_updates(jp, ju)
    params = M.param_dict(model)
    tgrads = M.param_dict(lm_params_from_numpy(cfg, _np_tree(jg),
                                               device="cpu"))
    tu, ts = opt.opt_update(tcfg_o, tgrads, opt.init_opt_state(tcfg_o, params),
                            params)
    tnew = opt.apply_updates(params, tu)
    assert int(ts["count"]) == 1
    flat_r = dict(jax.tree_util.tree_flatten_with_path(_np_tree(jnew))[0])
    flat_p = dict(jax.tree_util.tree_flatten_with_path(
        lm_params_to_numpy(tnew))[0])
    for path, want in flat_r.items():
        np.testing.assert_allclose(flat_p[path], want, rtol=0,
                                   atol=ADAMW_ATOL)


# ---------------------------------------------------------------------------
# the train steps against the reference's
# ---------------------------------------------------------------------------

def _run_both(jcfg, jp, cfg, model, *, ccfg_kw=None, agents=4, iters=5,
              opt_kw=None, microbatches=1, local_steps=1):
    """The reference's and the port's train steps side by side from the
    same weights and batches: [(port metrics, ref metrics)] per step."""
    opt_kw = opt_kw or dict(lr=3e-3)
    jccfg = tccfg = None
    if ccfg_kw is not None:
        # the reference's fused path is its Pallas kernel in interpret mode
        # on the CPU (minutes on the LM tree), equal to its unfused path to
        # roundoff (tests/test_consensus.py): the port's fused path, K3's
        # plain version here, is held to the reference's unfused one
        jccfg = jax_cns.ConsensusConfig(**dict(ccfg_kw,
                                               use_fused_kernel=False))
        tccfg = cns.ConsensusConfig(**ccfg_kw)
    jinit, jstep, jlocal = jax_steps.make_train_step(
        jcfg, jax_opt.OptConfig(**opt_kw), jccfg, num_agents=agents,
        microbatches=microbatches)
    tinit, tstep, tlocal = steps.make_train_step(
        cfg, opt.OptConfig(**opt_kw), tccfg, num_agents=agents,
        microbatches=microbatches)
    if jccfg is None:
        js = {"params": jp, "opt": jax_opt.init_opt_state(
            jax_opt.OptConfig(**opt_kw), jp), "step": jnp.zeros((), jnp.int32)}
    else:
        stacked = jax_cns.stack_params(jp, agents)
        js = {"params": stacked, "consensus": jax_cns.init_consensus_state(
            jccfg, jax_opt.OptConfig(**opt_kw), stacked)}
    ts = tinit(M.param_dict(model))
    jstep, jlocal = jax.jit(jstep), jlocal and jax.jit(jlocal)
    jstream, _ = _stream(cfg)
    out = []
    for i in range(iters):
        jb, tb = _batches(jstream, i, agents if jccfg is not None else None)
        local = (i + 1) % local_steps != 0
        js, jm = (jlocal if local else jstep)(js, jb)
        ts, tm = (tlocal if local else tstep)(ts, tb)
        out.append((tm, jm))
    return out, ts, js


def _check_run(rows, rtol=RUN_RTOL):
    for i, (tm, jm) in enumerate(rows):
        assert set(tm) == set(jm), i
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=rtol, err_msg=f"step {i}")
        for k in ("comms", "send_frac", "bits"):
            if k in jm:
                assert float(tm[k]) == float(jm[k]), (i, k)


def test_allreduce_run_of_test_system_matches_the_reference():
    """tests/test_system.py's allreduce run: 15 steps of AdamW at lr 3e-3
    from the reference's weights: losses within 1e-3 relative, and the
    loss falls as the reference's test asks."""
    jcfg, cfg = _configs()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_numpy(cfg, _np_tree(jp), device="cpu")
    rows, ts, _ = _run_both(jcfg, jp, cfg, model, iters=15)
    _check_run(rows)
    assert float(rows[-1][0]["loss"]) < 0.85 * float(rows[0][0]["loss"])
    assert ts["step"] == 15 and int(ts["opt"]["count"]) == 15


def test_coke_run_of_test_system_matches_the_reference():
    """tests/test_system.py's coke run: 4 agents on a ring, v=20, mu=0.5,
    20 steps: comms, send_frac and bits exact every step, losses within
    3e-3 relative, the early rounds censored and the later ones sent."""
    jcfg, cfg = _configs()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_numpy(cfg, _np_tree(jp), device="cpu")
    rows, ts, js = _run_both(jcfg, jp, cfg, model, iters=20, ccfg_kw=dict(
        strategy="coke", rho=1e-3, censor_v=20.0, censor_mu=0.5))
    _check_run(rows, CONSENSUS_RUN_RTOL)
    sends = [float(tm["send_frac"]) for tm, _ in rows]
    assert min(sends) < 1.0 and max(sends) == 1.0
    assert int(ts["consensus"]["comms"]) < 20 * 4
    np.testing.assert_allclose(float(rows[-1][0]["consensus_gap"]),
                               float(rows[-1][1]["consensus_gap"]),
                               rtol=CONSENSUS_RUN_RTOL)


def test_coke_first_step_parts_only_where_adamw_divides_by_eps():
    """Why the 20-step coke run is held at 3e-3: after the run's first step
    the port's parameters agree with the reference's within 1e-6 wherever
    the reference's gradient exceeds 1e-5 (1000 x AdamW's eps), and every
    element that parts by more than 1e-5 has |g| <= 1e-6, within a few
    times the packages' gradient agreement, where g / (|g| + eps) is
    decided by roundoff."""
    jcfg, cfg = _configs()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_numpy(cfg, _np_tree(jp), device="cpu")
    rows, ts, js = _run_both(jcfg, jp, cfg, model, iters=1, ccfg_kw=dict(
        strategy="coke", rho=1e-3, censor_v=20.0, censor_mu=0.5))
    _check_run(rows)
    flat = lambda tree: dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    got = flat(lm_params_to_numpy(ts["params"]))
    want = flat(_np_tree(js["params"]))
    # after one step AdamW's first moment is (1 - beta1) g
    m = flat(_np_tree(js["consensus"]["opt"]["m"]))
    beta1 = jax_opt.OptConfig().beta1
    for path, w in want.items():
        d = np.abs(got[path] - w)
        g = np.abs(m[path]) / (1.0 - beta1)
        where = jax.tree_util.keystr(path)
        assert np.all(d[g > 1e-5] <= ADAMW_ATOL), where
        assert np.all(g[d > 1e-5] <= 1e-6), where


@pytest.mark.parametrize("strategy,extra", [
    ("dkla", {}), ("cta", {}),
    ("coke_et", dict(local_steps=2, censor_v=20.0, censor_mu=0.5)),
    ("coke", dict(censor_v=20.0, censor_mu=0.5, use_fused_kernel=True))])
def test_consensus_strategies_match_the_reference(pair, strategy, extra):
    """dkla, cta, coke_et (a local step, then a consensus round) and coke
    through K3's plain version on the LM tree, 4 steps at 2 agents, with
    the launcher's AdamW (grad_clip 1.0): losses within 1e-3 relative,
    comms and send_frac exact."""
    jcfg, jp, cfg, model = pair
    kw = dict(strategy=strategy, rho=1e-3, **extra)
    rows, ts, js = _run_both(jcfg, jp, cfg, model, ccfg_kw=kw, agents=2,
                             iters=4, opt_kw=dict(lr=3e-3, grad_clip=1.0),
                             local_steps=extra.get("local_steps", 1))
    _check_run(rows)
    assert ts["consensus"]["step"] == int(js["consensus"]["step"]) == 4
    assert int(ts["consensus"]["comms"]) == int(js["consensus"]["comms"])


def test_microbatched_allreduce_matches_the_reference(pair):
    jcfg, jp, cfg, model = pair
    rows, _, _ = _run_both(jcfg, jp, cfg, model, iters=3, microbatches=2)
    _check_run(rows)
    for tm, jm in rows:
        np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]),
                                   rtol=RUN_RTOL)


def test_step_takes_ownership_of_the_state():
    """A step empties the dict it is given and returns the next state; the
    tensors it replaces are released by the time it returns (the
    parameters, the optimizer slots, the broadcast and the duals), so a
    step holds about one copy of the state. A local step carries the
    consensus state over as it is."""
    _, cfg = _configs()
    init_fn, step_fn, local_fn = steps.make_train_step(
        cfg, opt.OptConfig(lr=3e-3), cns.ConsensusConfig(strategy="coke_et",
                                                         local_steps=2),
        num_agents=2)
    state = init_fn(torch.Generator().manual_seed(0))
    _, stream = _stream(cfg, B=4, S=16)
    _, tb = _batches(stream, 0, agents=None)
    tb = steps.agent_batch(tb, 2)
    hat = state["consensus"]["theta_hat"]
    old = [weakref.ref(state["params"]["embed"]),
           weakref.ref(state["consensus"]["opt"]["m"]["embed"])]
    new, m = local_fn(state, tb)
    assert state == {} and set(m) == {"loss"}
    assert new["consensus"]["step"] == 1
    assert new["consensus"]["theta_hat"] is hat
    assert all(r() is None for r in old)
    del hat
    old = [weakref.ref(new["params"]["embed"]),
           weakref.ref(new["consensus"]["theta_hat"]["embed"]),
           weakref.ref(new["consensus"]["gamma"]["embed"]),
           weakref.ref(new["consensus"]["opt"]["v"]["embed"])]
    newer, m = step_fn(new, tb)
    assert new == {} and {"comms", "send_frac", "bits",
                          "consensus_gap"} <= set(m)
    assert all(r() is None for r in old)
    assert newer["consensus"]["step"] == 2


# ---------------------------------------------------------------------------
# local_update, the driver and its checkpoint
# ---------------------------------------------------------------------------

def test_local_update_touches_no_consensus_state():
    """tests/test_consensus.py's check, on the port: a local step moves the
    params and the optimizer, and leaves the broadcast, the duals, the
    cache and the comms as they were (the same tensors)."""
    rng = np.random.default_rng(0)
    A = torch.tensor(rng.normal(size=(8, 6, 4)).astype(np.float32))
    b = torch.tensor(rng.normal(size=(8, 6)).astype(np.float32))
    ccfg = cns.ConsensusConfig(strategy="coke_et", rho=0.05)
    ocfg = opt.OptConfig(kind="sgd", lr=0.1)
    params = {"x": torch.zeros(8, 4)}
    state = cns.init_consensus_state(ccfg, ocfg, params)
    r = torch.einsum("nij,nj->ni", A, params["x"]) - b
    grads = {"x": 2.0 * torch.einsum("nij,ni->nj", A, r) / 6}
    params2, state2 = cns.local_update(ocfg, params, grads, state)
    for k in ("theta_hat", "gamma", "nbr_left", "nbr_right", "comm"):
        assert state2[k] is state[k]
    assert int(state2["comms"]) == int(state["comms"]) == 0
    assert state2["step"] == state["step"] + 1
    assert not torch.allclose(params2["x"], params["x"])
    assert int(state2["opt"]["count"][0]) == 1


def test_train_driver_runs_on_the_cpu_and_checkpoints(tmp_path):
    """`python -m repro_torch.launch.train --reduced --device cpu --steps
    3` prints the reference's JSON keys per step; --ckpt writes the
    reference's tree layout, which repro.ckpt.restore reads back to the
    port's arrays bitwise."""
    ckpt = tmp_path / "run"
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-1.7b", "--reduced", "--device", "cpu", "--steps", "3",
         "--log-every", "1", "--strategy", "coke", "--agents", "2",
         "--batch", "4", "--seq", "16", "--ckpt", str(ckpt)],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    lines = [json.loads(x) for x in res.stdout.splitlines()
             if x.startswith("{")]
    assert [x["step"] for x in lines] == [0, 1, 2]
    assert list(lines[0]) == ["step", "bits", "comms", "consensus_gap",
                              "loss", "send_frac", "wall_s"]
    assert all(np.isfinite(x["loss"]) for x in lines)
    # the checkpoint: the reference's restore, at the reference's shapes
    jcfg, cfg = _configs()
    like = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct((2, *s.shape), s.dtype),
        jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0))))
    got, step = jax_restore(str(ckpt), like)
    assert step == 3
    leaves = jax.tree.leaves(got)
    assert [x.shape for x in leaves] == [x.shape for x in jax.tree.leaves(
        like)]
    assert all(np.all(np.isfinite(np.asarray(x))) for x in leaves)
    # the round trip: port arrays -> reference tree -> port arrays
    ref_tree = _np_tree(got)
    back = lm_params_from_numpy(cfg, jax.tree.map(lambda a: a[1], ref_tree),
                                device="cpu")
    again = lm_params_to_numpy(back)
    for x, y in zip(jax.tree.leaves(again),
                    jax.tree.leaves(jax.tree.map(lambda a: a[1], ref_tree))):
        assert np.array_equal(x, y)
