"""Wrapper of the CUDA kernel `csrc/flash_attention_bwd.cu` (K7): dQ, dK and
dV of the flash attention, from K4's per-row log-sum-exp.

No Pallas kernel corresponds: the reference differentiates its jnp
`blockwise_attention` inside XLA. `gqa_flash_bwd` takes CUDA tensors only
and launches the kernel (one call: the delta pass, the dK/dV pass and the
dQ pass, in that order on PyTorch's current stream) or raises. On the CPU
the attention's backward is autograd through the plain forward
(`ops.FlashAttention`); `ref.attention_bwd_ref` is the kernel's plain
version, for the tests. `LAUNCHES` counts calls that launched it.

The launch plan (`attention_bwd_plan`) is a pure function of the shapes and
of the card's SM count and shared memory per block, so the CPU tests can
check it; on the card the occupancy API confirms that a block of each pass
fits.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.flash_attention import MAX_HEAD_DIM

#: calls that launched the kernel (reset it to 0 to count a run)
LAUNCHES = 0
#: where the kernel's missing instances are planned
LATER = ("ROADMAP.md Queue 2, K7's open work (bf16 operands and Dh != Dv "
         "in the attention backward)")

#: the kernel's instances, by head-dim width, in the plan's order of
#: preference (largest block first); both passes take the same ones:
#: (rw, cw, ns) = rw x cw warps, each owning 16 stationary rows and 8 ns
#: streamed rows of a step
INSTANCES = {64: ((4, 2, 4), (2, 4, 1), (1, 4, 1)),
             128: ((4, 2, 4), (2, 4, 1), (1, 4, 1)),
             256: ((2, 4, 1), (1, 4, 1))}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "flash_attention_bwd": (_I, [_P] * 10 + [ctypes.POINTER(ctypes.c_int64)]
                            + [_I] * 8 + [_F] + [_I] * 6 + [_P]),
    "flash_attention_bwd_limits": (_I, [_I] * 5 + [ctypes.POINTER(_I)]),
}


def head_dim_width(D: int) -> int:
    """The instance width a head dim D runs at: 64, 128 or 256."""
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must lie in [1, {MAX_HEAD_DIM}]; got {D}")
    return 64 if D <= 64 else 128 if D <= 128 else 256


@dataclass(frozen=True)
class PassPlan:
    """One pass's launch: rw x cw warps per block, each owning 16
    stationary rows (keys in the dK/dV pass, queries in the dQ pass) and
    8 ns rows of each streamed step; `smem` bytes of dynamic shared memory;
    `grid` (stationary tiles, batch x heads, column blocks)."""
    rw: int
    cw: int
    ns: int
    smem: int
    grid: tuple[int, int, int]

    @property
    def instance(self) -> tuple[int, int, int]:
        return (self.rw, self.cw, self.ns)

    @property
    def rows(self) -> int:
        """Stationary rows per block."""
        return 16 * self.rw

    @property
    def step_rows(self) -> int:
        """Streamed rows per step."""
        return 8 * self.ns * self.cw

    @property
    def warps(self) -> int:
        return self.rw * self.cw

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


@dataclass(frozen=True)
class AttentionBwdPlan:
    """K7's plan: the head-dim width of the instance, the accumulator
    columns of a block (the grid's third axis splits the width into
    width / columns blocks), and the dK/dV and dQ passes."""
    width: int
    columns: int
    kv: PassPlan
    q: PassPlan

    def args(self) -> tuple[int, ...]:
        """The C entry's plan arguments."""
        return self.kv.instance + self.q.instance


def pass_smem_bytes(width: int, rw: int, cw: int, ns: int, kvp: bool) -> int:
    """Dynamic shared memory of one block (csrc Geo::SMEM): the
    stationary rows of two operands, a ring of two tiles of each of the two
    streamed operands, L and delta."""
    st, br, bc = width + 4, 16 * rw, 8 * ns * cw
    return 4 * (2 * br * st + 4 * bc * st + (4 * bc if kvp else 2 * br))


def attention_bwd_plan(B: int, H: int, KV: int, Sq: int, Sk: int, D: int, *,
                       sm_count: int, smem_per_block: int) -> AttentionBwdPlan:
    """K7's launch plan for q (B, Sq, H, D), k and v (B, Sk, KV, D) on a
    card with `sm_count` SMs and `smem_per_block` bytes of shared memory a
    block may opt into. Each pass takes the first instance of
    INSTANCES whose shared memory fits and whose grid covers the SMs
    (blocks >= sm_count), else the fitting one with the most blocks: large
    stationary tiles where the sequence is long (fewer re-reads of the
    streamed tiles), 16- or 32-row tiles where it is short."""
    if min(B, H, KV, Sq, sm_count) < 1 or Sk < 0 or H % KV:
        raise ValueError(f"attention_bwd_plan: bad shape B={B} H={H} KV={KV}"
                         f" Sq={Sq} Sk={Sk} or sms={sm_count}")
    width = head_dim_width(D)

    def choose(rows: int, heads: int, kvp: bool) -> PassPlan:
        fits = [pp for pp in (pass_plan(width, inst, kvp, rows, B * heads)
                              for inst in INSTANCES[width])
                if pp.smem <= smem_per_block]
        if not fits:
            raise ValueError(
                f"attention backward: no instance at D={D} fits in "
                f"{smem_per_block} bytes of shared memory per block")
        return next((f for f in fits if f.blocks >= sm_count), fits[-1])

    return AttentionBwdPlan(width, min(width, 128), choose(Sk, KV, True),
                            choose(Sq, H, False))


def pass_plan(width: int, instance: tuple[int, int, int], kvp: bool,
              rows: int, bh: int) -> PassPlan:
    """The launch of one pass at `instance` (rw, cw, ns) over `rows`
    stationary rows and `bh` = batch x heads."""
    rw, cw, ns = instance
    return PassPlan(rw, cw, ns, pass_smem_bytes(width, rw, cw, ns, kvp),
                    (-(-rows // (16 * rw)), bh, width // min(width, 128)))


def _lib():
    return build.load("flash_attention_bwd", _SIGNATURES)


def pass_limits(D: int, kvp: bool, rw: int, cw: int, ns: int
                ) -> tuple[int, int, int, int]:
    """(SMs, shared memory a block may opt into, the instance's shared
    memory, its blocks per SM by the occupancy API) on the current card;
    rw = 0 asks for the card's figures alone (the last two 0)."""
    lib = _lib()
    out = (ctypes.c_int * 4)()
    build.check(lib, lib.flash_attention_bwd_limits(D, int(kvp), rw, cw, ns,
                                                    out),
                "flash_attention_bwd_limits")
    return tuple(out)


@functools.lru_cache(maxsize=64)
def _device_plan(B: int, H: int, KV: int, Sq: int, Sk: int, D: int,
                 device_index: int) -> AttentionBwdPlan:
    with torch.cuda.device(device_index):
        sms, optin, _, _ = pass_limits(D, True, 0, 0, 0)
        plan = attention_bwd_plan(B, H, KV, Sq, Sk, D, sm_count=sms,
                                  smem_per_block=optin)
        for kvp, pp in ((True, plan.kv), (False, plan.q)):
            _, _, smem, blocks = pass_limits(D, kvp, *pp.instance)
            if smem != pp.smem or blocks < 1:
                raise RuntimeError(
                    f"attention backward: the {'dK/dV' if kvp else 'dQ'} "
                    f"pass of {pp} does not fit an SM ({smem} bytes, "
                    f"{blocks} blocks per SM)")
    return plan


def device_plan(q: torch.Tensor, k: torch.Tensor) -> AttentionBwdPlan:
    """The plan a CUDA call on q (B, Sq, H, D), k (B, Sk, KV, D) launches
    with, sized from the card that holds them."""
    B, Sq, H, D = q.shape
    dev = q.device
    return _device_plan(B, H, k.shape[2], Sq, k.shape[1], D,
                        dev.index if dev.index is not None
                        else torch.cuda.current_device())


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
                  window: int = 0, plan: AttentionBwdPlan | None = None):
    """CUDA tensors q, o, do: (B, Sq, H, D); k, v: (B, Sk, KV, D); lse:
    fp32 (B, H, Sq), K4's log-sum-exp -> (dq, dk, dv) in the layouts of q,
    k and v, fp32, Dh = Dv. `plan` defaults to `device_plan(q, k)`."""
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
    if plan is None:
        plan = device_plan(q, k)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = []
    for t in (q, k, v, o, do, dq, dk, dv):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), (ctypes.c_int64 * 24)(*strides),
        B, H, KV, Sq, Sk, D, int(causal), window, 1.0 / (D ** 0.5),
        *plan.args(), stream)
    build.check(lib, code, "flash_attention_bwd")
    LAUNCHES += 1
    return dq, dk, dv
