"""Wrapper of the CUDA kernel `csrc/flash_attention.cu`: the flash-attention
forward with causal and sliding-window masks and grouped-query heads.

Port of `repro/kernels/flash_attention/flash_attention.py::flash_attention`.
On CPU tensors it runs the plain version (`ref.attention_ref`); on CUDA
tensors it launches the kernel once, on PyTorch's current stream, or
raises. `LAUNCHES` counts kernel launches, of this entry point and of
`ops.gqa_flash`, which launches the same kernel on the model's layout.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

#: kernel launches made by `flash_attention` and `gqa_flash` (reset it to 0
#: to count a run)
LAUNCHES = 0
#: largest head dim (Dh and Dv) the kernel takes
MAX_HEAD_DIM = 256

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "flash_attention_fwd": (_I, [_P, _P, _P, _P, ctypes.POINTER(
        ctypes.c_int64)] + [_I] * 9 + [_F, _I, _P]),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_operands(q, k, v, *, heads_dim: int, causal, window: int,
                   block_q: int = 128, block_k: int = 128) -> None:
    """Raise TypeError or ValueError on what the kernel does not take.
    `heads_dim` is the axis of the heads: 1 for (B, H, S, D), 2 for
    (B, S, H, D)."""
    seq_dim = 3 - heads_dim
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.ndim != 4:
            raise ValueError(f"{name} must be a 4-d tensor")
        if t.dtype not in _DTYPES:
            raise TypeError(f"flash attention takes float32 or bfloat16; "
                            f"{name} is {t.dtype}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k and v must share a dtype; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"q, k and v lie on several devices: {devices}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, not "
                         f"{q.device}")
    B, H, Dh = q.shape[0], q.shape[heads_dim], q.shape[3]
    KV, Sk = k.shape[heads_dim], k.shape[seq_dim]
    if (k.shape[0], v.shape[0]) != (B, B) or v.shape[heads_dim] != KV \
            or v.shape[seq_dim] != Sk or k.shape[3] != Dh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not split into groups of "
                         f"{KV} KV heads")
    Dv = v.shape[3]
    if not (1 <= Dh <= MAX_HEAD_DIM and 1 <= Dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims must lie in [1, {MAX_HEAD_DIM}]; got "
                         f"Dh={Dh}, Dv={Dv}")
    if not isinstance(causal, bool):
        raise TypeError(f"causal must be a bool, not {type(causal).__name__}")
    for name, val, least in (("window", window, 0), ("block_q", block_q, 1),
                             ("block_k", block_k, 1)):
        if isinstance(val, bool) or not isinstance(val, int) or val < least:
            raise ValueError(f"{name} must be an int >= {least}; got {val!r}")


def launch(q, k, v, *, heads_dim: int, causal: bool,
           window: int) -> torch.Tensor:
    """One kernel launch on CUDA tensors of either layout, already checked
    by `check_operands`. Returns the output in q's layout and dtype."""
    global LAUNCHES
    seq_dim = 3 - heads_dim
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 and t.shape[3] != 1:
            raise ValueError(f"the CUDA kernel needs {name}'s last dim "
                             "contiguous")
    B, Sq, H, Dh = (q.shape[0], q.shape[seq_dim], q.shape[heads_dim],
                    q.shape[3])
    KV, Sk, Dv = k.shape[heads_dim], k.shape[seq_dim], v.shape[3]
    if B * H > 65535 or max(Sq, Sk) >= 2**31:
        raise ValueError(f"B * H = {B * H} (at most 65535) or a sequence "
                         f"length ({Sq}, {Sk}) exceeds the kernel's grid")
    shape = list(q.shape)
    shape[3] = Dv
    out = torch.empty(shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(seq_dim), t.stride(heads_dim)]
    lib = build.load("flash_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        (ctypes.c_int64 * 12)(*strides), B, H, KV, Sq, Sk, Dh, Dv,
        int(causal), window, 1.0 / (Dh ** 0.5), _DTYPES[q.dtype], stream)
    build.check(lib, code, "flash_attention_fwd")
    LAUNCHES += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q: (B, H, Sq, Dh); k/v: (B, KV, Sk, Dh|Dv) with KV dividing H (the
    reference takes KV = H, pre-broadcast) -> (B, H, Sq, Dv) in q's dtype.

    fp32 or bf16 with fp32 softmax and accumulation (fp32 products as
    3xTF32 on the card, bf16 products with P rounded to bf16); Dh, Dv <=
    256. `block_q` and `block_k` are accepted for the reference's signature
    and checked, but do not size the kernel's tiles: those are the
    kernel's own (64 x 32 in fp32, 128 x 64 in bf16 up to Dv = 128)."""
    check_operands(q, k, v, heads_dim=1, causal=causal, window=window,
                   block_q=block_q, block_k=block_k)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    return launch(q, k, v, heads_dim=1, causal=causal, window=window)
