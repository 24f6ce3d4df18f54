"""Plain PyTorch version of the threefry draw: jax.random's threefry2x32
(20 rounds, partitionable form) in int64 tensor ops.

The threefry words are carried in int64 tensors and masked to 32 bits after
every addition (PyTorch cannot add uint32 tensors): a rotation of a value
below 2^32 by r <= 31 fits in int64. The same hash runs over Python ints
(`core.prng.fold_in`), numpy arrays (`fold_in_lanes`) and tensors. A draw
is ~173 elementwise launches on the card; `threefry.py` is one.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds (jax's `_threefry2x32_lowering`) over
    counters (x0, x1). The key words and the counters are Python ints, or
    int64 tensors / numpy arrays holding values below 2^32, broadcast
    against each other. Returns the two output words, broadcast."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ((ks[(i + 2) % 3] + i + 1) & MASK32)) & MASK32
    return x0, x1


def random_bits_ref(key, shape: tuple[int, ...],
                    device: torch.device) -> torch.Tensor:
    """Element i of the flattened shape hashes the counter pair (i >> 32,
    i & 0xFFFFFFFF); the word is the XOR of the two outputs, as int64
    values in [0, 2^32). key is a host pair, or a (G, 2) int64 tensor:
    then (G, *shape), lane g the draw under key g."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    if isinstance(key, torch.Tensor):
        hi, lo = threefry2x32((key[:, 0:1], key[:, 1:2]), idx >> 32,
                              idx & MASK32)
        return (hi ^ lo).reshape((key.shape[0],) + shape)
    hi, lo = threefry2x32(key, idx >> 32, idx & MASK32)
    return (hi ^ lo).reshape(shape)


def uniform_ref(key, shape: tuple[int, ...],
                device: torch.device) -> torch.Tensor:
    """float32 on [0, 1): each word's top 23 bits as the mantissa of a
    float in [1, 2), minus 1, clamped at 0."""
    bits = (random_bits_ref(key, shape, device) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats, 0.0)
