"""Residual blocks: the pre-norm attention block with a SwiGLU MLP (dense)
or a mixture of experts (MoE), over GQA or MLA attention; the pre-norm
Mamba2 block (SSM); the enc-dec decoder block with cross attention.

Port of `repro/models/blocks.py`. The reference builds stacks by a
vmapped init and runs them under `lax.scan`; the port keeps one module
per layer in an `nn.ModuleList` and loops (`models/model.py`).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ModelConfig, dense_init, frozen,
                                       init_device, rms_norm,
                                       shard_activations, swiglu)


def _check_kind(kind: str) -> None:
    if kind not in BLOCKS:
        raise ValueError(f"unknown block kind {kind!r}")


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU MLP weights: w_gate, w_up (d, f) and w_down (f, d)."""

    def __init__(self, cfg: ModelConfig,
                 generator: torch.Generator | None = None,
                 d_ff: int | None = None, *,
                 device: torch.device | str | None = None):
        super().__init__()
        dev = init_device(generator, device)
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.w_gate = frozen(dense_init(generator, (d, f), cfg.dtype,
                                        device=dev))
        self.w_up = frozen(dense_init(generator, (d, f), cfg.dtype,
                                      device=dev))
        self.w_down = frozen(dense_init(generator, (f, d), cfg.dtype,
                                        fan_in=f, device=dev))


def init_mlp_params(cfg: ModelConfig, generator: torch.Generator,
                    d_ff: int | None = None) -> MLP:
    return MLP(cfg, generator, d_ff)


def mlp_forward(params: MLP, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x @ params.w_gate, x @ params.w_up) @ params.w_down


# ---------------------------------------------------------------------------
# Attention dispatch (GQA vs MLA)
# ---------------------------------------------------------------------------

def init_attn_params(cfg: ModelConfig,
                     generator: torch.Generator | None = None, *,
                     device: torch.device | str | None = None):
    """The attention layer `cfg.attn_kind` names: MLAAttention or
    GQAAttention."""
    if cfg.attn_kind == "mla":
        return attn.MLAAttention(cfg, generator, device=device)
    if cfg.attn_kind != "gqa":
        raise ValueError(f"attn_kind={cfg.attn_kind!r} has no attention "
                         "layer")
    return attn.GQAAttention(cfg, generator, device=device)


def attn_forward(params, cfg: ModelConfig, x, positions, *, causal=True,
                 window=None, cache_len=None):
    fwd = attn.mla_forward if cfg.attn_kind == "mla" else attn.gqa_forward
    return fwd(params, cfg, x, positions, causal=causal, window=window,
               cache_len=cache_len)


def attn_decode(params, cfg: ModelConfig, x, cache, position):
    if cfg.attn_kind == "mla":
        return attn.mla_decode(params, cfg, x, cache, position)
    return attn.gqa_decode(params, cfg, x, cache, position)


def attn_empty_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                     device: torch.device | str):
    slots = torch.full((cache_len,), -1, dtype=torch.int32, device=device)
    if cfg.attn_kind == "mla":
        return attn.MLACache(
            ckv=torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                            dtype=dtype, device=device),
            krope=torch.zeros((batch, cache_len, cfg.qk_rope_dim),
                              dtype=dtype, device=device),
            slot_positions=slots)
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return attn.KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        slot_positions=slots)


# ---------------------------------------------------------------------------
# Decoder blocks
# ---------------------------------------------------------------------------

class DenseBlock(nn.Module):
    """Pre-norm residual block weights: ln1, attn (GQA or MLA), ln2, mlp."""

    def __init__(self, cfg: ModelConfig,
                 generator: torch.Generator | None = None, *,
                 device: torch.device | str | None = None):
        super().__init__()
        dev = init_device(generator, device)
        d = cfg.d_model
        self.ln1 = frozen(torch.ones((d,), dtype=cfg.dtype, device=dev))
        self.attn = init_attn_params(cfg, generator, device=dev)
        self.ln2 = frozen(torch.ones((d,), dtype=cfg.dtype, device=dev))
        self.mlp = MLP(cfg, generator, device=dev)


class MoEBlock(nn.Module):
    """Pre-norm residual block weights: ln1, attn (GQA or MLA), ln2, moe."""

    def __init__(self, cfg: ModelConfig,
                 generator: torch.Generator | None = None, *,
                 device: torch.device | str | None = None):
        super().__init__()
        dev = init_device(generator, device)
        d = cfg.d_model
        self.ln1 = frozen(torch.ones((d,), dtype=cfg.dtype, device=dev))
        self.attn = init_attn_params(cfg, generator, device=dev)
        self.ln2 = frozen(torch.ones((d,), dtype=cfg.dtype, device=dev))
        self.moe = moe_mod.MoE(cfg, generator, device=dev)


class SSMBlock(nn.Module):
    """Pre-norm residual block weights: ln1, ssm (the Mamba2 mixer)."""

    def __init__(self, cfg: ModelConfig,
                 generator: torch.Generator | None = None, *,
                 device: torch.device | str | None = None):
        super().__init__()
        dev = init_device(generator, device)
        self.ln1 = frozen(torch.ones((cfg.d_model,), dtype=cfg.dtype,
                                     device=dev))
        self.ssm = ssm_mod.SSM(cfg, generator, device=dev)


BLOCKS = {"dense": DenseBlock, "moe": MoEBlock, "ssm": SSMBlock}


def init_block_params(cfg: ModelConfig, generator: torch.Generator,
                      kind: str):
    """kind: dense | moe | ssm."""
    _check_kind(kind)
    return BLOCKS[kind](cfg, generator)


def _ffn(params, cfg: ModelConfig, h, kind: str):
    """The block's second half on the normed h: (y, aux)."""
    if kind == "moe":
        return moe_mod.moe_forward(params.moe, cfg, h)
    return mlp_forward(params.mlp, h), None


def block_forward(params, cfg: ModelConfig, x, positions, kind: str, *,
                  causal=True, window=None, cache_len=None):
    """Pre-norm residual block. Returns (x, aux_loss[, cache])."""
    _check_kind(kind)
    x = shard_activations(cfg, x)
    h = rms_norm(x, params.ln1, cfg.norm_eps)
    if kind == "ssm":
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cache_len is not None:
            y, cache = ssm_mod.ssm_forward(params.ssm, cfg, h,
                                           return_cache=True)
            return x + y, aux, cache
        return x + ssm_mod.ssm_forward(params.ssm, cfg, h), aux
    cache = None
    if cache_len is not None:
        y, cache = attn_forward(params.attn, cfg, h, positions,
                                causal=causal, window=window,
                                cache_len=cache_len)
    else:
        y = attn_forward(params.attn, cfg, h, positions, causal=causal,
                         window=window)
    x = shard_activations(cfg, x + y)
    h = rms_norm(x, params.ln2, cfg.norm_eps)
    y, aux = _ffn(params, cfg, h, kind)
    x = x + y
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cache_len is not None:
        return x, aux, cache
    return x, aux


def block_decode(params, cfg: ModelConfig, x, positions_unused, kind: str,
                 cache, position):
    """Single-token decode through one block. Returns (x, cache), the cache
    updated in place (`attention.gqa_decode`, `attention.mla_decode`,
    `ssm.ssm_decode`)."""
    _check_kind(kind)
    h = rms_norm(x, params.ln1, cfg.norm_eps)
    if kind == "ssm":
        y, new_cache = ssm_mod.ssm_decode(params.ssm, cfg, h, cache)
        return x + y, new_cache
    y, new_cache = attn_decode(params.attn, cfg, h, cache, position)
    x = x + y
    h = rms_norm(x, params.ln2, cfg.norm_eps)
    return x + _ffn(params, cfg, h, kind)[0], new_cache


def block_empty_cache(cfg: ModelConfig, kind: str, batch: int,
                      cache_len: int, dtype, device: torch.device | str):
    _check_kind(kind)
    if kind == "ssm":
        W = cfg.ssm_conv_width
        return ssm_mod.SSMCache(
            conv_x=torch.zeros((batch, W - 1, cfg.d_inner), dtype=dtype,
                               device=device),
            conv_bc=torch.zeros((batch, W - 1, 2 * cfg.ssm_state),
                                dtype=dtype, device=device),
            state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                               cfg.ssm_state), dtype=torch.float32,
                              device=device))
    return attn_empty_cache(cfg, batch, cache_len, dtype, device)


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec decoder blocks)
# ---------------------------------------------------------------------------

class CrossBlock(nn.Module):
    """Enc-dec decoder block weights, named as the reference's: ln1,
    self_attn (causal GQA over the decoder), ln_x, cross_attn (a GQA
    layer's weights: wq reads the decoder, wk and wv the encoder memory,
    with neither rope nor qk-norm), ln2, mlp."""

    def __init__(self, cfg: ModelConfig,
                 generator: torch.Generator | None = None, *,
                 device: torch.device | str | None = None):
        super().__init__()
        dev = init_device(generator, device)
        d = cfg.d_model
        self.ln1 = frozen(torch.ones((d,), dtype=cfg.dtype, device=dev))
        self.self_attn = attn.GQAAttention(cfg, generator, device=dev)
        self.ln_x = frozen(torch.ones((d,), dtype=cfg.dtype, device=dev))
        self.cross_attn = attn.GQAAttention(cfg, generator, device=dev)
        self.ln2 = frozen(torch.ones((d,), dtype=cfg.dtype, device=dev))
        self.mlp = MLP(cfg, generator, device=dev)


def init_cross_block_params(cfg: ModelConfig,
                            generator: torch.Generator) -> CrossBlock:
    return CrossBlock(cfg, generator)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bshe", x, w)."""
    B, S, d = x.shape
    return (x @ w.reshape(d, -1)).reshape(B, S, *w.shape[1:])


def cross_attend(params: attn.GQAAttention, cfg: ModelConfig, x, memory_k,
                 memory_v):
    """Queries from x (B, S, d) by wq alone, against the encoder memory's
    precomputed k/v (B, S_enc, KV, Dh): the flash kernel without a mask,
    Sq = S, Sk = S_enc (the reference's `positions_q` is not taken: an
    unmasked attention reads no position)."""
    q = _project(x, params.wq)
    out = attn.gqa_flash(q, memory_k, memory_v, causal=False, window=0)
    return attn._out_project(params, out)


def cross_memory_kv(params: attn.GQAAttention, memory: torch.Tensor):
    """Project the encoder output (B, S_enc, d) into the cross attention's
    k and v (B, S_enc, KV, Dh) once."""
    return _project(memory, params.wk), _project(memory, params.wv)


def cross_block_forward(params: CrossBlock, cfg: ModelConfig, x, positions,
                        memory_k, memory_v):
    """Decoder block over x (B, S, d): causal self attention, cross
    attention to the memory's k/v, the MLP. Returns (x, aux = 0)."""
    h = rms_norm(x, params.ln1, cfg.norm_eps)
    x = x + attn.gqa_forward(params.self_attn, cfg, h, positions,
                             causal=True, window=0)
    h = rms_norm(x, params.ln_x, cfg.norm_eps)
    x = x + cross_attend(params.cross_attn, cfg, h, memory_k, memory_v)
    h = rms_norm(x, params.ln2, cfg.norm_eps)
    return (x + mlp_forward(params.mlp, h),
            torch.zeros((), dtype=torch.float32, device=x.device))


def cross_block_decode(params: CrossBlock, cfg: ModelConfig, x, cache,
                       position, memory_k, memory_v):
    """Single-token decode through a decoder block: the self attention's
    cache updated in place (`attention.gqa_decode`), the cross attention
    over every row of the memory (`attention.decode_attention`, no
    kernel). Returns (x, cache)."""
    h = rms_norm(x, params.ln1, cfg.norm_eps)
    y, cache = attn.gqa_decode(params.self_attn, cfg, h, cache, position)
    x = x + y
    h = rms_norm(x, params.ln_x, cfg.norm_eps)
    q = _project(h, params.cross_attn.wq)
    S_enc = memory_k.shape[1]
    slots = torch.arange(S_enc, dtype=torch.int32, device=x.device)
    out = attn.decode_attention(q, memory_k, memory_v, slots, S_enc,
                                window=0)
    x = x + attn._out_project(params.cross_attn, out)
    h = rms_norm(x, params.ln2, cfg.norm_eps)
    return x + mlp_forward(params.mlp, h), cache
