"""Wrapper of the CUDA kernel `csrc/gather_rowdot.cu` (K6): the gathered
row-dot out[i] = phi[i] . stack[slots[i]].

No Pallas counterpart: the reference gathers and row-dots inside XLA
(`serve/kernel_server.py:164-169`). The same contract holds on every
device: phi (B, D) and stack (M, D) contiguous fp32 on one device, slots a
host array of B int32 row indices, each in [0, M), checked here before any
upload. On CPU tensors it runs the plain version (`ref.py`); on CUDA
tensors it uploads the slots and makes one launch, on PyTorch's current
stream, or raises. `LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.rowdot.ref import gather_rowdot_ref

#: kernel launches made by `gather_rowdot` (reset it to 0 to count a run)
LAUNCHES = 0

#: threads per block (csrc THREADS): one warp per row
THREADS = 256
ROWS_PER_BLOCK = THREADS // 32

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "gather_rowdot": (_I, [_P, _P, _P, _L, _L, _I, _P, _P]),
}


def _lib():
    return build.load("gather_rowdot", _SIGNATURES)


def _host_slots(slots) -> np.ndarray:
    """The slots as a 1-D host int32 array: a numpy array or a CPU tensor
    of integers. A CUDA tensor raises: its range could not be checked
    without waiting for the card."""
    if isinstance(slots, torch.Tensor):
        if slots.device.type != "cpu":
            raise ValueError(
                "slots are host int32 (numpy or a CPU tensor): the wrapper "
                f"checks their range before the upload; got a tensor on "
                f"{slots.device}")
        slots = slots.numpy()
    slots = np.asarray(slots)
    if slots.ndim != 1 or not np.issubdtype(slots.dtype, np.integer):
        raise ValueError(f"slots must be a 1-D integer array, got "
                         f"{slots.shape} {slots.dtype}")
    if (slots.dtype != np.int32 or not slots.flags.c_contiguous
            or not slots.flags.writeable):
        slots = np.array(slots, dtype=np.int32, order="C")
    return slots


def _check_operands(phi, stack, slots: np.ndarray) -> None:
    if phi.ndim != 2 or stack.ndim != 2:
        raise ValueError(f"gather_rowdot takes phi (B, D) and stack (M, D); "
                         f"got {tuple(phi.shape)} and {tuple(stack.shape)}")
    if phi.shape[1] != stack.shape[1] or slots.shape[0] != phi.shape[0]:
        raise ValueError(
            f"shape mismatch: phi {tuple(phi.shape)}, stack "
            f"{tuple(stack.shape)}, slots {slots.shape}")
    if phi.device != stack.device:
        raise ValueError(f"phi lies on {phi.device}, the stack on "
                         f"{stack.device}")
    if phi.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_rowdot runs on cpu or cuda, not "
                         f"{phi.device}")
    for name, t in (("phi", phi), ("stack", stack)):
        if t.dtype != torch.float32:
            raise TypeError(f"gather_rowdot takes fp32; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"gather_rowdot takes contiguous tensors; "
                             f"{name} is not")
    if slots.size and (int(slots.min()) < 0
                       or int(slots.max()) >= stack.shape[0]):
        raise IndexError(
            f"slots must lie in [0, {stack.shape[0]}); got "
            f"[{int(slots.min())}, {int(slots.max())}]")


def staging(phi: torch.Tensor, stack: torch.Tensor) -> str:
    """Which instance a CUDA call takes: "16-byte" (float4 loads: D % 4 ==
    0 and both bases 16-byte aligned) or "4-byte". Both walk the same
    order, so where both apply they give the same bits."""
    return ("16-byte" if phi.shape[1] % 4 == 0 and phi.data_ptr() % 16 == 0
            and stack.data_ptr() % 16 == 0 else "4-byte")


def launch(phi: torch.Tensor, stack: torch.Tensor, slots: torch.Tensor,
           out: torch.Tensor) -> None:
    """The launch alone, on operands already checked: slots a device int32
    tensor. `gather_rowdot` checks, uploads and calls this."""
    global LAUNCHES
    lib = _lib()
    stream = torch.cuda.current_stream(phi.device).cuda_stream
    code = lib.gather_rowdot(phi.data_ptr(), stack.data_ptr(),
                             slots.data_ptr(), phi.shape[0], phi.shape[1],
                             int(staging(phi, stack) == "16-byte"),
                             out.data_ptr(), stream)
    build.check(lib, code, "gather_rowdot")
    LAUNCHES += 1


def gather_rowdot(phi: torch.Tensor, stack: torch.Tensor,
                  slots) -> torch.Tensor:
    """phi (B, D), stack (M, D), host int32 slots (B,) -> (B,) fp32, out[i]
    = phi[i] . stack[slots[i]]."""
    slots = _host_slots(slots)
    _check_operands(phi, stack, slots)
    if phi.device.type == "cpu":
        return gather_rowdot_ref(phi, stack, torch.from_numpy(slots))
    out = torch.empty((phi.shape[0],), device=phi.device,
                      dtype=torch.float32)
    if phi.shape[0] == 0:
        return out
    # pageable memory is staged at once: no wait for the card
    d_slots = torch.from_numpy(slots).to(phi.device, non_blocking=True)
    launch(phi, stack, d_slots, out)
    return out
