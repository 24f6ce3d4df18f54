"""Wrappers of the CUDA kernels `csrc/coke_megastep.cu` (K2) and
`csrc/coke_fused_update.cu` (K3).

`coke_megastep` ports `repro/kernels/coke_update/coke_update.py::
coke_megastep`: one gradient-primal COKE/DKLA ADMM iteration for all
agents. On CPU tensors it runs the plain version (`ref.coke_megastep_ref`);
on CUDA tensors it makes two launches on PyTorch's current stream (the
partial T-sums, then the consensus combine), or raises. Either way theta'
is written in place onto `theta`, as the reference donates its output onto
theta. `LAUNCHES` counts its kernel launches: two per call on the card.

`coke_fused_update` ports `coke_update.py::coke_fused_update`: the
augmented gradient and the per-agent censor norm of the ring runtime's
gradient primal. On CPU tensors it runs `ref.coke_update_ref`; on CUDA
tensors it makes one launch, or raises. `FUSED_UPDATE_LAUNCHES` counts its
launches, apart from K2's.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: kernel launches made by `coke_megastep` (reset it to 0 to count a run)
LAUNCHES = 0
#: launches per `coke_megastep` call on the card
LAUNCHES_PER_CALL = 2
#: kernel launches made by `coke_fused_update`: one per call on the card
FUSED_UPDATE_LAUNCHES = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PI = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "coke_megastep_plan": (_I, [_I, _I, _I, _PI, _PI, _PI]),
    "coke_megastep_partial": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _P]),
    "coke_megastep_finish": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _PI, _I,
                                  _F, _F, _F, _F, _F, _F, _P]),
}
_MAX_OFFSETS = 8
_FUSED_UPDATE_SIGNATURES = {
    "coke_fused_update_tiles": (_I, [_I]),
    "coke_fused_update": (_I, [_P] * 8 + [_I, _I, _I, _F, _F, _F, _P]),
}


def megastep_scalars(*, rho: float, lam: float, lr: float, n_agents: int,
                     n_samples: int, n_offsets: int) -> dict[str, float]:
    """Python-float constants shared by the kernel and its plain version."""
    deg = 2.0 * n_offsets
    return {
        "rho": float(rho),
        "deg": deg,
        "lam2": 2.0 * float(lam) / float(n_agents),
        "rho2deg": 2.0 * float(rho) * deg,
        "lr": float(lr),
        "inv_t2": 2.0 / float(n_samples),
    }


def _lib():
    return build.load("coke_megastep", _SIGNATURES)


@functools.lru_cache(maxsize=32)
def _plan(n: int, t: int, d: int, device_index: int) -> tuple[int, int, int]:
    """(bt, rows_per_chunk, nchunk) for this shape on this device."""
    lib = _lib()
    bt, rows, nchunk = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        code = lib.coke_megastep_plan(n, t, d, ctypes.byref(bt),
                                      ctypes.byref(rows),
                                      ctypes.byref(nchunk))
    build.check(lib, code, f"coke_megastep_plan(N={n}, T={t}, D={d})")
    return bt.value, rows.value, nchunk.value


def _check_operands(theta, theta_hat, gamma, phi, y, offsets) -> None:
    if phi.ndim != 3:
        raise ValueError(f"phi must be (N, T, D), got {tuple(phi.shape)}")
    N, T, D = phi.shape
    for name, t in (("theta", theta), ("theta_hat", theta_hat),
                    ("gamma", gamma)):
        if tuple(t.shape) != (N, D):
            raise ValueError(f"{name} must be ({N}, {D}), got "
                             f"{tuple(t.shape)}")
    if tuple(y.shape) != (N, T):
        raise ValueError(f"y must be ({N}, {T}), got {tuple(y.shape)}")
    if T < 1:
        raise ValueError("coke_megastep needs at least one sample per agent")
    if not offsets or any(not 0 < o < N for o in offsets):
        raise ValueError(f"ring offsets {offsets} must lie in (0, {N})")
    devices = {t.device for t in (theta, theta_hat, gamma, phi, y)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {devices}")
    dev = phi.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"coke_megastep runs on cpu or cuda, not {dev}")


def coke_megastep(theta, theta_hat, gamma, phi, y, *, rho: float,
                  lam: float, lr: float, offsets: tuple[int, ...] = (1,)):
    """One fused COKE/DKLA gradient-primal iteration for all agents.

    theta/theta_hat/gamma (N, D); phi (N, T, D); y (N, T); `offsets` the
    ring offsets (neighbours at +-o for each o). Per agent i, with
    deg = 2 len(offsets):

        g      = (2/T) phi^T (phi theta - y)
        g_aug  = g + (2 lam / N) theta + 2 rho deg theta + gamma
                 - rho (deg theta_hat + sum_o theta_hat[i+-o])
        theta' = theta - lr * g_aug

    Writes theta' in place onto `theta` and returns (theta, xi_sq (N,))
    with xi_sq = ||theta' - theta_hat||^2.
    """
    global LAUNCHES
    offsets = tuple(int(o) for o in offsets)
    _check_operands(theta, theta_hat, gamma, phi, y, offsets)
    if phi.device.type == "cpu":
        from repro_torch.kernels.coke_update.ref import coke_megastep_ref

        new, xi_sq = coke_megastep_ref(theta, theta_hat, gamma, phi, y,
                                       rho=rho, lam=lam, lr=lr,
                                       offsets=offsets)
        theta.copy_(new)
        return theta, xi_sq
    for name, t in (("theta", theta), ("theta_hat", theta_hat),
                    ("gamma", gamma), ("phi", phi), ("y", y)):
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes fp32; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes contiguous tensors; "
                             f"{name} is not")
    if len(offsets) > _MAX_OFFSETS:
        raise ValueError(f"the CUDA kernel takes at most {_MAX_OFFSETS} "
                         f"ring offsets, got {len(offsets)}")
    N, T, D = phi.shape
    dev = phi.device
    bt, rows, nchunk = _plan(N, T, D, dev.index if dev.index is not None
                             else torch.cuda.current_device())
    sc = megastep_scalars(rho=rho, lam=lam, lr=lr, n_agents=N, n_samples=T,
                          n_offsets=len(offsets))
    partial = torch.empty((N, nchunk, D), device=dev, dtype=torch.float32)
    xi_sq = torch.empty((N,), device=dev, dtype=torch.float32)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream

    code = lib.coke_megastep_partial(theta.data_ptr(), phi.data_ptr(),
                                     y.data_ptr(), partial.data_ptr(),
                                     N, T, D, bt, rows, nchunk, stream)
    build.check(lib, code, "coke_megastep_partial")
    LAUNCHES += 1

    offs = (ctypes.c_int * len(offsets))(*offsets)
    code = lib.coke_megastep_finish(
        theta.data_ptr(), theta_hat.data_ptr(), gamma.data_ptr(),
        partial.data_ptr(), xi_sq.data_ptr(), N, D, nchunk, offs,
        len(offsets), sc["rho"], sc["deg"], sc["lam2"], sc["rho2deg"],
        sc["lr"], sc["inv_t2"], stream)
    build.check(lib, code, "coke_megastep_finish")
    LAUNCHES += 1
    return theta, xi_sq


def _check_update_operands(ops: dict[str, torch.Tensor]) -> None:
    shapes = {tuple(t.shape) for t in ops.values()}
    if len(shapes) != 1 or len(next(iter(shapes))) != 2:
        raise ValueError("coke_fused_update takes six (N, D) operands; got "
                         + ", ".join(f"{k} {tuple(t.shape)}"
                                     for k, t in ops.items()))
    devices = {t.device for t in ops.values()}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {devices}")
    dev = next(iter(devices))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"coke_fused_update runs on cpu or cuda, not {dev}")


def coke_fused_update(theta, theta_hat, gamma, grad, left, right, *,
                      rho: float, deg: float = 2.0):
    """All operands (N, D). Returns (g_aug (N, D) fp32, xi_sq (N,) fp32):

        g_aug = g + 2 rho deg theta + gamma - rho (deg theta_hat + left + right)
        xi_sq = ||theta_hat - theta||^2 per agent

    xi_sq is the *squared* censor norm; `ops.coke_update_pytree` takes the
    sqrt. The CUDA kernel takes fp32 operands; the plain version casts."""
    global FUSED_UPDATE_LAUNCHES
    ops = {"theta": theta, "theta_hat": theta_hat, "gamma": gamma,
           "grad": grad, "left": left, "right": right}
    _check_update_operands(ops)
    if theta.device.type == "cpu":
        from repro_torch.kernels.coke_update.ref import coke_update_ref

        return coke_update_ref(theta, theta_hat, gamma, grad, left, right,
                               rho=rho, deg=deg)
    for name, t in ops.items():
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes fp32; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes contiguous tensors; "
                             f"{name} is not")
    N, D = theta.shape
    dev = theta.device
    g_aug = torch.empty((N, D), device=dev, dtype=torch.float32)
    if N == 0 or D == 0:
        return g_aug, torch.zeros((N,), device=dev, dtype=torch.float32)
    lib = build.load("coke_fused_update", _FUSED_UPDATE_SIGNATURES)
    partial = torch.empty((N, lib.coke_fused_update_tiles(D)), device=dev,
                          dtype=torch.float32)
    ptrs = [t.data_ptr() for t in (*ops.values(), g_aug)]
    vec = int(D % 4 == 0 and all(p % 16 == 0 for p in ptrs))
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.coke_fused_update(*ptrs, partial.data_ptr(), N, D, vec,
                                 float(rho), float(deg),
                                 2.0 * float(rho) * float(deg), stream)
    build.check(lib, code, "coke_fused_update")
    FUSED_UPDATE_LAUNCHES += 1
    return g_aug, torch.sum(partial, dim=1)
