"""Wrapper of the CUDA kernel `csrc/threefry.cu`: jax.random's threefry2x32
`random_bits` / `uniform` in one launch.

No Pallas counterpart: the reference draws inside XLA. On CPU tensors it
runs the plain version (`ref.py`); on the card it makes one launch, on
PyTorch's current stream, or raises. `LAUNCHES` counts kernel launches.

A single key is a host pair of words below 2^32, passed to the kernel as
two arguments (nothing is uploaded); G keys are a (G, 2) int64 tensor on
the card, giving (G, *shape), lane g bitwise the single draw under key g.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.threefry.ref import random_bits_ref, uniform_ref

#: kernel launches made by `threefry_draw` (reset it to 0 to count a run)
LAUNCHES = 0

#: threads per block (csrc THREADS) and the most blocks per key's row
THREADS = 256
MAX_BLOCKS = 1024

_P, _I, _U, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, \
    ctypes.c_int64
_SIGNATURES = {
    "threefry_launch": (_I, [_U, _U, _P, _L, _I, _I, _I, _P, _P]),
}


def _lib():
    return build.load("threefry", _SIGNATURES)


def launch_blocks(n: int) -> int:
    """Blocks per key's row for n words: one thread per word, at most
    MAX_BLOCKS blocks (a grid-stride loop takes the rest)."""
    return max(1, min(MAX_BLOCKS, -(-n // THREADS)))


def _device(key, device) -> torch.device:
    dev = torch.device(device)
    if isinstance(key, torch.Tensor):
        if key.ndim != 2 or key.shape[1] != 2 or key.dtype != torch.int64:
            raise ValueError("lane keys are a (G, 2) int64 tensor, got "
                             f"{tuple(key.shape)} {key.dtype}")
        if key.device.type != dev.type:
            raise ValueError(f"the keys lie on {key.device}, the draw is "
                             f"asked for on {dev}")
        dev = key.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the threefry draw runs on cpu or cuda, not {dev}")
    return dev


def threefry_draw(key, shape, device, *, uniform: bool) -> torch.Tensor:
    """jax.random.uniform (uniform=True, float32) or jax.random.bits
    (int64 words in [0, 2^32)) of `shape` under `key`: a host pair, or a
    (G, 2) int64 tensor of G keys (then (G, *shape))."""
    global LAUNCHES
    shape = tuple(int(s) for s in shape)
    dev = _device(key, device)
    if dev.type == "cpu":
        return (uniform_ref if uniform else random_bits_ref)(key, shape, dev)
    lanes = key.shape[0] if isinstance(key, torch.Tensor) else None
    out = torch.empty(((lanes,) if lanes is not None else ()) + shape,
                      dtype=torch.float32 if uniform else torch.int64,
                      device=dev)
    n = math.prod(shape)
    if out.numel() == 0:
        return out
    if lanes is None:
        k0, k1 = (int(w) for w in key)
        if not (0 <= k0 <= 0xFFFFFFFF and 0 <= k1 <= 0xFFFFFFFF):
            raise OverflowError(f"key words {key} are not uint32")
        keys_ptr = None
    else:
        if lanes > 65535:
            raise ValueError(f"{lanes} keys: the kernel takes at most 65535")
        key = key.contiguous()
        k0 = k1 = 0
        keys_ptr = key.data_ptr()
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.threefry_launch(k0, k1, keys_ptr, n, lanes or 1, int(uniform),
                               launch_blocks(n), out.data_ptr(), stream)
    build.check(lib, code, "threefry_launch")
    LAUNCHES += 1
    return out
