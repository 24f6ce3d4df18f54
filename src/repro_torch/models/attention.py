"""Grouped-query attention (optional qk-norm and sliding window): the
training and prefill pass through the flash-attention kernels, and
single-token decode against a (rolling) KV cache.

Port of the GQA part of `repro/models/attention.py`. The reference's
prefill and training run `blockwise_attention`, a jnp mirror of its
Pallas flash kernel; the port runs the kernel itself
(`kernels/flash_attention`: K4 forward, K7 backward under autograd). MLA
raises NotImplementedError naming `common.LATER_ARCHS`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import gqa_flash
from repro_torch.models.common import (LATER_ARCHS, ModelConfig, apply_rope,
                                       dense_init, frozen, init_device,
                                       rms_norm, rope_frequencies)

NEG_INF = -1e30


def decode_attention(
    q: torch.Tensor,              # (B, 1, H, Dh)
    k_cache: torch.Tensor,        # (B, C, KV, Dh)
    v_cache: torch.Tensor,        # (B, C, KV, Dv)
    slot_positions: torch.Tensor,  # (C,) absolute position per slot, -1 empty
    position: int,                # current decode position
    window: int = 0,
) -> torch.Tensor:
    """One-token attention against a (possibly rolling) cache."""
    B, _, H, Dh = q.shape
    KV = k_cache.shape[2]
    rep = H // KV
    scale = 1.0 / (Dh ** 0.5)
    qg = q.reshape(B, KV, rep, Dh)
    s = torch.einsum("bgrd,bcgd->bgrc", qg.float(), k_cache.float()) * scale
    valid = (slot_positions >= 0) & (slot_positions <= position)
    if window:
        valid &= slot_positions > position - window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrc,bcgd->bgrd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, -1).to(q.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor               # (B, C, KV, Dh)
    v: torch.Tensor               # (B, C, KV, Dv)
    slot_positions: torch.Tensor  # (C,) int32, -1 = empty


class GQAAttention(nn.Module):
    """The weights of one GQA layer, named as the reference's param dict:
    wq (d, H, Dh), wk and wv (d, KV, Dh), wo (H, Dh, d), and with qk-norm
    q_norm and k_norm (Dh,). Drawn from `generator` on its device, or
    allocated and not drawn when generator is None (weights that are
    loaded next). Padded heads (tp_head_pad) get zero rows of wo."""

    def __init__(self, cfg: ModelConfig,
                 generator: torch.Generator | None = None, *,
                 device: torch.device | str | None = None):
        super().__init__()
        if cfg.attn_kind != "gqa":
            raise NotImplementedError(
                f"attn_kind={cfg.attn_kind!r} is not ported: "
                f"{LATER_ARCHS}")
        dev = init_device(generator, device)
        d, KV, Dh = cfg.d_model, cfg.num_kv_heads, cfg.resolved_head_dim
        H = cfg.padded_heads
        self.wq = frozen(dense_init(generator, (d, H, Dh), cfg.dtype,
                                    device=dev))
        self.wk = frozen(dense_init(generator, (d, KV, Dh), cfg.dtype,
                                    device=dev))
        self.wv = frozen(dense_init(generator, (d, KV, Dh), cfg.dtype,
                                    device=dev))
        wo = dense_init(generator, (H, Dh, d), cfg.dtype, fan_in=H * Dh,
                        device=dev)
        if generator is not None and H != cfg.num_heads:
            wo[cfg.num_heads:] = 0
        self.wo = frozen(wo)
        if cfg.qk_norm:
            self.q_norm = frozen(torch.ones((Dh,), dtype=cfg.dtype,
                                            device=dev))
            self.k_norm = frozen(torch.ones((Dh,), dtype=cfg.dtype,
                                            device=dev))


def init_gqa_params(cfg: ModelConfig,
                    generator: torch.Generator) -> GQAAttention:
    return GQAAttention(cfg, generator)


def _gqa_project_qkv(params: GQAAttention, cfg: ModelConfig, x, positions):
    B, S, d = x.shape
    q = (x @ params.wq.reshape(d, -1)).reshape(B, S, *params.wq.shape[1:])
    k = (x @ params.wk.reshape(d, -1)).reshape(B, S, *params.wk.shape[1:])
    v = (x @ params.wv.reshape(d, -1)).reshape(B, S, *params.wv.shape[1:])
    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm, cfg.norm_eps)
        k = rms_norm(k, params.k_norm, cfg.norm_eps)
    cos, sin = rope_frequencies(cfg.resolved_head_dim, cfg.rope_theta,
                                positions, q.dtype)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v


def _out_project(params: GQAAttention, out: torch.Tensor) -> torch.Tensor:
    """einsum("bshe,hed->bsd", out, wo)."""
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ params.wo.reshape(-1, params.wo.shape[-1])


def _build_kv_cache(k, v, positions, cache_len: int) -> KVCache:
    """Pack computed k/v into a (rolling) cache keeping the last
    `cache_len` tokens."""
    B, S = k.shape[:2]
    C = cache_len
    keep = min(S, C)
    kc = torch.zeros((B, C, *k.shape[2:]), dtype=k.dtype, device=k.device)
    vc = torch.zeros((B, C, *v.shape[2:]), dtype=v.dtype, device=v.device)
    pos_keep = positions[-keep:].long()
    slots = pos_keep % C
    kc[:, slots] = k[:, -keep:]
    vc[:, slots] = v[:, -keep:]
    sp = torch.full((C,), -1, dtype=torch.int32, device=k.device)
    sp[slots] = pos_keep.to(torch.int32)
    return KVCache(kc, vc, sp)


def gqa_forward(params: GQAAttention, cfg: ModelConfig, x, positions, *,
                causal: bool = True, window: int | None = None,
                cache_len: int | None = None):
    """Training / prefill attention. x: (B, S, d); positions: (S,), which
    rotate q and k. With cache_len, also returns the KV cache for decode.

    The attention itself is the flash kernel (`gqa_flash`, differentiable:
    its backward is K7), which masks by index: query i and key j stand at
    positions i and j. That is what the reference's `blockwise_attention`
    computes for the positions every caller passes, arange(S)."""
    w = cfg.sliding_window if window is None else window
    q, k, v = _gqa_project_qkv(params, cfg, x, positions)
    out = gqa_flash(q, k, v, causal=causal, window=w)
    y = _out_project(params, out)
    if cache_len is None:
        return y
    return y, _build_kv_cache(k, v, positions, cache_len)


def gqa_decode(params: GQAAttention, cfg: ModelConfig, x, cache: KVCache,
               position: int):
    """One-token decode. x: (B, 1, d). Returns (out (B, 1, d), cache).

    Unlike the reference, which returns a new cache, the port writes the
    new token's k, v and position into `cache` in place (one slot instead
    of a copy of the whole cache per token) and returns it."""
    positions = torch.full((1,), position, dtype=torch.int32,
                           device=x.device)
    q, k, v = _gqa_project_qkv(params, cfg, x, positions)
    slot = position % cache.k.shape[1]
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    cache.slot_positions[slot] = position
    out = decode_attention(q, cache.k, cache.v, cache.slot_positions,
                           position, window=cfg.sliding_window)
    return _out_project(params, out), cache
