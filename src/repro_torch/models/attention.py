"""Attention variants: GQA (optional qk-norm and sliding window) and MLA
(DeepSeek-V2-style multi-head latent attention). The training and prefill
pass runs through the flash-attention kernels; single-token decode runs
against a (rolling) cache, with the *absorbed* MLA decode that scores
directly in the compressed latent space.

Port of `repro/models/attention.py`. The reference's prefill and training
run `blockwise_attention`, a jnp mirror of its Pallas flash kernel; the
port runs the kernel itself (`kernels/flash_attention`: K4 forward, K7
backward under autograd), for MLA on the latents expanded to full heads
(Dh = qk_nope_dim + qk_rope_dim, Dv = v_head_dim).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import gqa_flash
from repro_torch.models.common import (ModelConfig, apply_rope, dense_init,
                                       frozen, init_device, rms_norm,
                                       rope_frequencies)

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


def _out_project(params, out: torch.Tensor) -> torch.Tensor:
    """einsum("bshe,hed->bsd", out, wo), wo the layer's (H, Dv, d)."""
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ params.wo.reshape(-1, params.wo.shape[-1])


def _build_kv_cache(k, v, positions, cache_len: int) -> KVCache:
    """Pack computed k/v into a (rolling) cache keeping the last
    `cache_len` tokens."""
    return KVCache(*_rolling_cache((k, v), positions, cache_len))


def _rolling_cache(tensors, positions, cache_len: int):
    """Each (B, S, ...) tensor packed into a (B, C, ...) cache that keeps
    the last C = cache_len tokens, token at position p in slot p % C, and
    the slots' positions (C,) int32, -1 where empty."""
    S = tensors[0].shape[1]
    C = cache_len
    keep = min(S, C)
    pos_keep = positions[-keep:].long()
    slots = pos_keep % C
    out = []
    for t in tensors:
        c = torch.zeros((t.shape[0], C, *t.shape[2:]), dtype=t.dtype,
                        device=t.device)
        c[:, slots] = t[:, -keep:]
        out.append(c)
    sp = torch.full((C,), -1, dtype=torch.int32, device=positions.device)
    sp[slots] = pos_keep.to(torch.int32)
    return (*out, sp)


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


def gqa_prefill_cache(params: GQAAttention, cfg: ModelConfig, x, positions,
                      cache_len: int) -> KVCache:
    """The decode cache after a prefill pass over x (B, S, d), without the
    attention itself: the last `cache_len` tokens' k and v (rolling for a
    sliding window)."""
    _, k, v = _gqa_project_qkv(params, cfg, x, positions)
    return _build_kv_cache(k, v, positions, cache_len)


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


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention
# ---------------------------------------------------------------------------

class MLACache(NamedTuple):
    ckv: torch.Tensor             # (B, C, r) compressed latents
    krope: torch.Tensor           # (B, C, Dr) shared rotary key
    slot_positions: torch.Tensor  # (C,) int32, -1 = empty


class MLAAttention(nn.Module):
    """The weights of one MLA layer, named as the reference's param dict:
    wkv_a (d, r + dr), kv_norm (r,), wkv_b (r, H, dn + dv), wo (H, dv, d);
    and wq (d, H, dn + dr), or with q-LoRA wq_a (d, qr), q_norm_a (qr,) and
    wq_b (qr, H, dn + dr). Drawn from `generator` on its device, or
    allocated and not drawn when generator is None (weights that are
    loaded next). Padded heads (tp_head_pad) get zero rows of wo."""

    def __init__(self, cfg: ModelConfig,
                 generator: torch.Generator | None = None, *,
                 device: torch.device | str | None = None):
        super().__init__()
        dev = init_device(generator, device)
        d, H = cfg.d_model, cfg.padded_heads
        r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                         cfg.v_head_dim)

        def draw(shape, fan_in=None):
            return dense_init(generator, shape, cfg.dtype, fan_in,
                              device=dev)

        def ones(n):
            return frozen(torch.ones((n,), dtype=cfg.dtype, device=dev))

        if cfg.q_lora_rank:
            qr = cfg.q_lora_rank
            self.wq_a = frozen(draw((d, qr)))
            self.q_norm_a = ones(qr)
            self.wq_b = frozen(draw((qr, H, dn + dr), fan_in=qr))
        else:
            self.wq = frozen(draw((d, H, dn + dr)))
        self.wkv_a = frozen(draw((d, r + dr)))
        self.kv_norm = ones(r)
        self.wkv_b = frozen(draw((r, H, dn + dv), fan_in=r))
        wo = draw((H, dv, d), fan_in=H * dv)
        if generator is not None and H != cfg.num_heads:
            wo[cfg.num_heads:] = 0
        self.wo = frozen(wo)


def init_mla_params(cfg: ModelConfig,
                    generator: torch.Generator) -> MLAAttention:
    return MLAAttention(cfg, generator)


def _mla_q(params: MLAAttention, cfg: ModelConfig, x, positions):
    """(q_nope (B, S, H, dn), q_rope (B, S, H, dr) rotated)."""
    B, S, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        qa = rms_norm(x @ params.wq_a, params.q_norm_a, cfg.norm_eps)
        w = params.wq_b
    else:
        qa, w = x, params.wq
    q = (qa @ w.reshape(w.shape[0], -1)).reshape(B, S, *w.shape[1:])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    cos, sin = rope_frequencies(dr, cfg.rope_theta, positions, q.dtype)
    return q_nope, apply_rope(q_rope, cos, sin)


def _mla_latents(params: MLAAttention, cfg: ModelConfig, x, positions):
    """(ckv (B, S, r) normed, krope (B, S, dr) rotated)."""
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    kv = x @ params.wkv_a
    ckv = rms_norm(kv[..., :r], params.kv_norm, cfg.norm_eps)
    krope = kv[..., r:][:, :, None, :]  # single shared rope "head"
    cos, sin = rope_frequencies(dr, cfg.rope_theta, positions, x.dtype)
    return ckv, apply_rope(krope, cos, sin)[:, :, 0]


def mla_forward(params: MLAAttention, cfg: ModelConfig, x, positions, *,
                causal: bool = True, window: int | None = None,
                cache_len: int | None = None):
    """Training / prefill: expand the latents to full k and v and run the
    flash kernel (`gqa_flash`) with KV = H heads, Dh = dn + dr and
    Dv = dv, scale 1/sqrt(dn + dr) as in the reference. v is a view of
    the expansion (the last dim contiguous, as the kernel reads it). With
    cache_len, also returns the latent cache for decode."""
    w = cfg.sliding_window if window is None else window
    (q, k, v), (ckv, krope) = _mla_expand(params, cfg, x, positions)
    out = gqa_flash(q, k, v, causal=causal, window=w)
    y = _out_project(params, out)
    if cache_len is None:
        return y
    return y, _build_mla_cache(ckv, krope, positions, cache_len)


def _mla_expand(params: MLAAttention, cfg: ModelConfig, x, positions):
    """((q, k, v), (ckv, krope)): the prefill's attention operands, q and k
    (B, S, H, dn + dr) and v (B, S, H, dv) a view of the latents' expansion,
    and the latents themselves."""
    dn = cfg.qk_nope_dim
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    ckv, krope = _mla_latents(params, cfg, x, positions)
    B, S = x.shape[:2]
    wkv_b = params.wkv_b
    kv = (ckv @ wkv_b.reshape(wkv_b.shape[0], -1)).reshape(
        B, S, *wkv_b.shape[1:])
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k_rope = krope[:, :, None, :].expand(B, S, kv.shape[2], krope.shape[-1])
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope], -1)
    return (q, k, v), (ckv, krope)


def _build_mla_cache(ckv, krope, positions, cache_len: int) -> MLACache:
    return MLACache(*_rolling_cache((ckv, krope), positions, cache_len))


def mla_prefill_cache(params: MLAAttention, cfg: ModelConfig, x, positions,
                      cache_len: int) -> MLACache:
    """The latent cache after a prefill pass over x (B, S, d), without the
    attention itself (rolling for a sliding window)."""
    ckv, krope = _mla_latents(params, cfg, x, positions)
    return _build_mla_cache(ckv, krope, positions, cache_len)


def mla_decode(params: MLAAttention, cfg: ModelConfig, x, cache: MLACache,
               position: int):
    """Absorbed decode: scores in the r-dim latent space — the cache stays
    (B, C, r + Dr) instead of (B, C, H, Dh) (MLA's memory advantage).
    x: (B, 1, d). Returns (out (B, 1, d), cache), the new token's latents
    and position written into `cache` in place, as `gqa_decode` does."""
    dn = cfg.qk_nope_dim
    positions = torch.full((1,), position, dtype=torch.int32,
                           device=x.device)
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    ckv, krope = _mla_latents(params, cfg, x, positions)
    slot = position % cache.ckv.shape[1]
    cache.ckv[:, slot] = ckv[:, 0]
    cache.krope[:, slot] = krope[:, 0]
    cache.slot_positions[slot] = position
    cc, kc, sp = cache

    wk = params.wkv_b[..., :dn]     # (r, H, dn)
    wv = params.wkv_b[..., dn:]     # (r, H, dv)
    # absorb W_k into q: q_lat (B, 1, H, r)
    q_lat = torch.einsum("bshe,rhe->bshr", q_nope, wk)
    s = (torch.einsum("bshr,bcr->bshc", q_lat.float(), cc.float())
         + torch.einsum("bshe,bce->bshc", q_rope.float(), kc.float()))
    s = s * (1.0 / (dn + cfg.qk_rope_dim) ** 0.5)
    valid = (sp >= 0) & (sp <= position)
    if cfg.sliding_window:
        valid &= sp > position - cfg.sliding_window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bshc,bcr->bshr", p.to(cc.dtype), cc)  # latent ctx
    out_h = torch.einsum("bshr,rhe->bshe", ctx, wv)          # (B, 1, H, dv)
    return _out_project(params, out_h), cache
