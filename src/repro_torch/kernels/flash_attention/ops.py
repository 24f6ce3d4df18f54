"""Public entry: the GQA-layout flash attention, the prefill attention of the
model's layers.

Takes (B, S, H, Dh) activations-layout q and (B, S, KV, *) k/v, the
model's own layout. On the card the kernel reads them there through their
strides, and query head h reads KV head h // (H // KV): no transpose and no
repeat of K and V (the reference repeats them H/KV times).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ref import attention_ref


def gqa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, block_q: int = 128,
              block_k: int = 128) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v: (B, Sk, KV, *) -> (B, Sq, H, Dv).
    `block_q` and `block_k` are accepted and checked, as in
    `flash_attention`, and size nothing."""
    fa.check_operands(q, k, v, heads_dim=2, causal=causal, window=window,
                      block_q=block_q, block_k=block_k)
    if q.device.type == "cpu":
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window)
        return out.transpose(1, 2).contiguous()
    return fa.launch(q, k, v, heads_dim=2, causal=causal, window=window)
