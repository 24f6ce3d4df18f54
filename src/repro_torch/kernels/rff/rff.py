"""Wrapper of the CUDA kernel `csrc/rff.cu`: phi = sqrt(2/L) cos(X Omega + b).

Port of `repro/kernels/rff/rff.py::rff_pallas`. On CPU tensors it runs the
plain version (`ref.rff_ref`); on CUDA tensors it makes one launch, on
PyTorch's current stream, or raises. `LAUNCHES` counts kernel launches.

The card kernel runs persistent blocks over (column strip, row tile) work
items. `rff_plan` cuts the output and sizes the launch from the device's SM
count and shared memory; `rff_work_items` lists each block's items; both are
pure functions the CPU tests walk. Where L % 4 == 0 and the output is
16-byte aligned, the tiles leave through TMA bulk stores; otherwise a second
instance writes with masked 4-byte stores (`rff_staging` says which).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rff.ref import rff_ref

#: kernel launches made by `rff_cos_bias` (reset it to 0 to count a run)
LAUNCHES = 0

#: shared-memory bytes a strip's omega and bias slices may take
OMEGA_BUDGET_BYTES = 96 * 1024
#: bytes of one output tile, where the strip leaves room (at L = 4096: 4 rows)
TILE_TARGET_BYTES = 64 * 1024
#: output tiles in shared memory in the bulk instance (csrc BUFFERS)
BUFFERS = 2

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PI = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "rff_limits": (_I, [_I, _I, _I, _PI]),
    "rff_cos_mismatches": (_I, [_P, _P]),
    "rff_cos_bias": (_I, [_P, _P, _P, _P, _I, _I, _I, _F] + [_I] * 5 + [_P]),
}


@dataclasses.dataclass(frozen=True)
class RffPlan:
    """How the card kernel cuts an (M, L) output and launches.

    Strip s holds columns s*strip .. min((s+1)*strip, L) - 1, row tile t
    rows t*rows .. min((t+1)*rows, M) - 1. Work item i is (strip i //
    tiles, tile i % tiles); block g walks items g*items//blocks ..
    (g+1)*items//blocks - 1."""

    instance: str       # "bulk" (TMA bulk stores) or "4-byte"
    M: int
    d: int
    L: int
    strip: int          # columns per strip, a multiple of 4
    rows: int           # rows per tile, a multiple of 4
    buffers: int        # output tiles in shared memory (0: 4-byte stores)
    smem_bytes: int     # dynamic shared memory per block
    blocks: int         # persistent blocks launched

    @property
    def strips(self) -> int:
        return -(-self.L // self.strip)

    @property
    def tiles(self) -> int:
        return -(-self.M // self.rows)

    @property
    def items(self) -> int:
        return self.strips * self.tiles


def rff_smem_bytes(d: int, strip: int, rows: int, buffers: int) -> int:
    """Dynamic shared memory of one block: output tiles, the omega and bias
    slices, and two x tiles (csrc smem_bytes)."""
    return 4 * (buffers * rows * strip + (d + 1) * strip + 2 * d * rows)


def rff_plan(M: int, d: int, L: int, *, bulk: bool, sm_count: int,
             smem_per_block: int) -> RffPlan:
    """The launch plan for x (M, d) @ omega (d, L) on a card with
    `sm_count` SMs and `smem_per_block` bytes of shared memory a block may
    opt into: one persistent block per SM (a block's 512 threads take most
    of an SM's registers), at most one per item.

    The strip is the widest multiple of 4 columns, at most L rounded up to
    4, whose omega and bias slices fit OMEGA_BUDGET_BYTES. The row tile is
    the largest multiple of 4 rows whose output tiles (BUFFERS of them in
    the bulk instance) and x tiles fit the rest, at most one
    TILE_TARGET_BYTES tile and M rounded up to 4 (at least 4 rows)."""
    if min(M, L, sm_count) < 1 or d < 0:
        raise ValueError(f"rff_plan needs positive sizes, got M={M} d={d} "
                         f"L={L} sms={sm_count}")
    if bulk and L % 4:
        raise ValueError(f"the bulk instance needs L % 4 == 0, got L={L}")
    up4 = lambda n: -(-n // 4) * 4
    strip = max(0, min(up4(L), OMEGA_BUDGET_BYTES // (4 * (d + 1)) // 4 * 4))
    buffers = BUFFERS if bulk else 0
    free = smem_per_block - 4 * (d + 1) * strip
    per_row = 4 * (buffers * strip + 2 * d)
    rows = 0 if strip < 4 else min(
        free // per_row if per_row else up4(M),
        max(4, TILE_TARGET_BYTES // (4 * strip)), up4(M)) // 4 * 4
    if rows < 4:
        raise ValueError(
            f"rff_cos_bias: d={d} is too large for the card kernel: a "
            "4-column strip of omega and a 4-row tile must fit in one "
            f"block's {smem_per_block} bytes of shared memory")
    strips, tiles = -(-L // strip), -(-M // rows)
    return RffPlan("bulk" if bulk else "4-byte", M, d, L, strip, rows,
                   buffers, rff_smem_bytes(d, strip, rows, buffers),
                   min(strips * tiles, sm_count))


def rff_work_items(plan: RffPlan) -> list[list[tuple[int, int]]]:
    """Each block's (strip, row tile) items, in the order it walks them."""
    n, g = plan.items, plan.blocks
    return [[divmod(i, plan.tiles) for i in range(b * n // g,
                                                  (b + 1) * n // g)]
            for b in range(g)]


def rff_staging(L: int, out: torch.Tensor) -> str:
    """Which instance a CUDA call writing `out` (M, L) takes: "bulk" (TMA
    bulk stores of whole row segments, which must be 16-byte multiples at
    16-byte-aligned addresses) or "4-byte" (masked 4-byte stores, for
    L % 4 != 0 or an unaligned output)."""
    return "bulk" if L % 4 == 0 and out.data_ptr() % 16 == 0 else "4-byte"


def _lib():
    return build.load("rff", _SIGNATURES)


def _limits(bulk: bool, d: int, smem: int) -> tuple[int, int, int]:
    lib = _lib()
    out = (ctypes.c_int * 3)()
    build.check(lib, lib.rff_limits(int(bulk), d, smem, out), "rff_limits")
    return tuple(out)


@functools.lru_cache(maxsize=64)
def _device_plan(M: int, d: int, L: int, bulk: bool,
                 device_index: int) -> RffPlan:
    """The plan on this device, from its SMs and its shared memory; the
    occupancy API confirms that one block of the plan fits on an SM."""
    with torch.cuda.device(device_index):
        sms, optin, _ = _limits(bulk, d, 0)
        plan = rff_plan(M, d, L, bulk=bulk, sm_count=sms,
                        smem_per_block=optin)
        if _limits(bulk, d, plan.smem_bytes)[2] < 1:
            raise RuntimeError(f"rff_cos_bias: no block of {plan.smem_bytes}"
                               " bytes of shared memory fits on an SM")
    return plan


def rff_device_plan(M: int, d: int, L: int, out: torch.Tensor) -> RffPlan:
    """The plan a CUDA call writing `out` launches with."""
    dev = out.device
    return _device_plan(M, d, L, rff_staging(L, out) == "bulk",
                        dev.index if dev.index is not None
                        else torch.cuda.current_device())


def rff_cos_mismatches(device: torch.device | int | None = None
                       ) -> tuple[int, int | None]:
    """The card kernel's cosine (cosf's fast path written out, and cosf
    itself from |a| >= 105615) against cosf, on every one of the 2^32 fp32
    bit patterns: (how many give other bits, the smallest such pattern or
    None). Runs on the card only."""
    lib = _lib()
    count, first = ctypes.c_ulonglong(0), ctypes.c_uint(0)
    with torch.cuda.device(device):
        build.check(lib, lib.rff_cos_mismatches(ctypes.byref(count),
                                                ctypes.byref(first)),
                    "rff_cos_mismatches")
    return count.value, (None if count.value == 0 else first.value)


def _check_operands(x, omega, bias) -> None:
    if x.ndim != 2 or omega.ndim != 2 or bias.ndim != 1:
        raise ValueError(
            f"rff_cos_bias takes x (T, d), omega (d, L), bias (L,); got "
            f"{tuple(x.shape)}, {tuple(omega.shape)}, {tuple(bias.shape)}")
    if x.shape[1] != omega.shape[0] or bias.shape[0] != omega.shape[1]:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, omega "
            f"{tuple(omega.shape)}, bias {tuple(bias.shape)}")
    devices = {t.device for t in (x, omega, bias)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {devices}")
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"rff_cos_bias runs on cpu or cuda, not {dev}")


def rff_cos_bias(x: torch.Tensor, omega: torch.Tensor,
                 bias: torch.Tensor, *,
                 num_features: int | None = None) -> torch.Tensor:
    """x (T, d), omega (d, L), bias (L,) -> (T, L) fp32 features, scaled
    by sqrt(2 / num_features): a feature block of a map num_features wide
    (the map's own width L when None) gives the bits of those columns of
    the whole map."""
    global LAUNCHES
    _check_operands(x, omega, bias)
    if x.device.type == "cpu":
        return rff_ref(x, omega, bias, num_features)
    for name, t in (("x", x), ("omega", omega), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes fp32; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes contiguous tensors; "
                             f"{name} is not")
    T, d = x.shape
    L = omega.shape[1]
    width = L if num_features is None else num_features
    out = torch.empty((T, L), device=x.device, dtype=torch.float32)
    if T == 0 or L == 0:
        return out
    plan = rff_device_plan(T, d, L, out)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.rff_cos_bias(x.data_ptr(), omega.data_ptr(), bias.data_ptr(),
                            out.data_ptr(), T, d, L, math.sqrt(2.0 / width),
                            int(plan.instance == "bulk"), plan.strip,
                            plan.rows, plan.blocks, plan.smem_bytes, stream)
    build.check(lib, code, "rff_cos_bias")
    LAUNCHES += 1
    return out
