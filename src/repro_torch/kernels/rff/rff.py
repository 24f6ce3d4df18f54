"""Wrapper of the CUDA kernel `csrc/rff.cu`: phi = sqrt(2/L) cos(X Omega + b).

Port of `repro/kernels/rff/rff.py::rff_pallas`. On CPU tensors it runs the
plain version (`ref.rff_ref`); on CUDA tensors it launches the kernel, on
PyTorch's current stream, or raises. `LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rff.ref import rff_ref

#: kernel launches made by `rff_cos_bias` (reset it to 0 to count a run)
LAUNCHES = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "rff_cos_bias": (_I, [_P, _P, _P, _P, _I, _I, _I, _F, _P]),
}


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
                 bias: torch.Tensor) -> torch.Tensor:
    """x (T, d), omega (d, L), bias (L,) -> (T, L) fp32 features."""
    global LAUNCHES
    _check_operands(x, omega, bias)
    if x.device.type == "cpu":
        return rff_ref(x, omega, bias)
    for name, t in (("x", x), ("omega", omega), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes fp32; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes contiguous tensors; "
                             f"{name} is not")
    T, d = x.shape
    L = omega.shape[1]
    out = torch.empty((T, L), device=x.device, dtype=torch.float32)
    if T == 0 or L == 0:
        return out
    lib = build.load("rff", _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.rff_cos_bias(x.data_ptr(), omega.data_ptr(), bias.data_ptr(),
                            out.data_ptr(), T, d, L,
                            math.sqrt(2.0 / L), stream)
    build.check(lib, code, "rff_cos_bias")
    LAUNCHES += 1
    return out
