"""Wrapper of the CUDA kernel `csrc/flash_attention_bwd.cu` (K7): dQ, dK and
dV of the flash attention, from K4's per-row log-sum-exp.

No Pallas kernel corresponds: the reference differentiates its jnp
`blockwise_attention` inside XLA. `gqa_flash_bwd` takes CUDA tensors only
and launches the kernel (one call: the delta pass, the dK/dV pass and the
dQ pass, in that order on PyTorch's current stream) or raises. On the CPU
the attention's backward is autograd through the plain forward
(`ops.FlashAttention`); `ref.attention_bwd_ref` is the kernel's plain
version, for the tests. `LAUNCHES` counts calls that launched it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.flash_attention import MAX_HEAD_DIM

#: calls that launched the kernel (reset it to 0 to count a run)
LAUNCHES = 0
#: where the kernel's missing instances are planned
LATER = ("ROADMAP.md Queue 2, K7's open work (bf16 operands and Dh != Dv "
         "in the attention backward)")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "flash_attention_bwd": (_I, [_P] * 10 + [ctypes.POINTER(ctypes.c_int64)]
                            + [_I] * 8 + [_F, _P]),
}


def check_operands(q, k, v) -> None:
    """Raise NotImplementedError for what the kernel has no instance of:
    bf16 operands and Dh != Dv (q, k, v in the layout (B, S, heads, D))."""
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise NotImplementedError(
            f"the attention backward takes fp32 operands, not "
            f"{q.dtype}: {LATER}")
    if q.shape[3] != v.shape[3] or k.shape[3] != v.shape[3]:
        raise NotImplementedError(
            f"the attention backward takes Dh == Dv; got Dh={q.shape[3]}, "
            f"Dv={v.shape[3]}: {LATER}")
    if not 1 <= q.shape[3] <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must lie in [1, {MAX_HEAD_DIM}]; got "
                         f"{q.shape[3]}")


def _last_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(3) == 1 or t.shape[3] == 1 else t.contiguous()


def gqa_flash_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                  window: int = 0):
    """CUDA tensors q, o, do: (B, Sq, H, D); k, v: (B, Sk, KV, D); lse:
    fp32 (B, H, Sq), K4's log-sum-exp -> (dq, dk, dv) in the layouts of q,
    k and v, fp32, Dh = Dv."""
    global LAUNCHES
    check_operands(q, k, v)
    if any(t.device.type != "cuda" for t in (q, k, v, o, do, lse)):
        raise ValueError("the attention backward kernel takes CUDA tensors; "
                         "on the CPU, differentiate `ops.gqa_flash`")
    if do.dtype != torch.float32 or o.dtype != torch.float32:
        raise NotImplementedError(f"the attention backward takes fp32 "
                                  f"gradients: {LATER}")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 {(B, H, Sq)}; got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the kernel's grid (65535)")
    q, k, v, o, do = (_last_contiguous(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty(t.shape, dtype=torch.float32, device=t.device)
                  for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = []
    for t in (q, k, v, o, do, dq, dk, dv):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    lib = build.load("flash_attention_bwd", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), (ctypes.c_int64 * 24)(*strides),
        B, H, KV, Sq, Sk, D, int(causal), window, 1.0 / (D ** 0.5), stream)
    build.check(lib, code, "flash_attention_bwd")
    LAUNCHES += 1
    return dq, dk, dv
