"""Public entry: the GQA-layout flash attention, the attention of the
model's layers, differentiable.

Takes (B, S, H, Dh) activations-layout q and (B, S, KV, *) k/v, the
model's own layout. On the card the kernels read them there through their
strides, and query head h reads KV head h // (H // KV): no transpose and no
repeat of K and V (the reference repeats them H/KV times).

Where autograd needs gradients of q, k or v, the call goes through
`FlashAttention`, a `torch.autograd.Function`: on the card its forward is
K4 writing each row's log-sum-exp and its backward is K7
(`flash_attention_bwd`); on the CPU its forward is the plain version and
its backward is autograd through the plain version. Without gradients
(serving, `torch.inference_mode`) K4 launches as it always did, writing no
log-sum-exp.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
from repro_torch.kernels.flash_attention.ref import attention_ref


def _plain(q, k, v, causal, window):
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2).contiguous()


class FlashAttention(torch.autograd.Function):
    """(q, k, v, causal, window) -> (out, lse) in the GQA layout; lse is
    K4's fp32 (B, H, Sq) log-sum-exp on the card (an empty tensor on the
    CPU) and carries no gradient."""

    @staticmethod
    def forward(q, k, v, causal, window):
        if q.device.type == "cpu":
            return _plain(q, k, v, causal, window), q.new_empty(0)
        B, Sq, H = q.shape[:3]
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        out = fa.launch(q, k, v, heads_dim=2, causal=causal, window=window,
                        lse=lse)
        return out, lse

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                o = _plain(*leaves, ctx.causal, ctx.window)
                grads = torch.autograd.grad(o, leaves, dout)
            return (*grads, None, None)
        dq, dk, dv = fab.gqa_flash_bwd(q, k, v, out, dout, lse,
                                       causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def gqa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, block_q: int = 128,
              block_k: int = 128) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v: (B, Sk, KV, *) -> (B, Sq, H, Dv).
    `block_q` and `block_k` are accepted and checked, as in
    `flash_attention`, and size nothing. Differentiable (`FlashAttention`);
    on the card the backward takes fp32 at the head-dim widths K7 is built
    for (`flash_attention_bwd.check_operands`) and raises
    NotImplementedError, before the forward launches, on the rest."""
    fa.check_operands(q, k, v, heads_dim=2, causal=causal, window=window,
                      block_q=block_q, block_k=block_k)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.device.type == "cuda":
            fab.check_operands(q, k, v)
        return FlashAttention.apply(q, k, v, causal, window)[0]
    if q.device.type == "cpu":
        return _plain(q, k, v, causal, window)
    return fa.launch(q, k, v, heads_dim=2, causal=causal, window=window)
