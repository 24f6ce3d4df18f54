"""Counter-based random numbers bit-compatible with `jax.random`'s default
threefry2x32 generator (`jax_threefry_partitionable=True`).

    key = fold_in(PRNGKey(0), 3)               # (2467461003, 3840466878)
    u = uniform(key, (4,), device="cuda")      # jax.random.uniform's bits

A key is a pair of Python ints below 2^32, as the reference's uint32[2] key
data. `PRNGKey` and `fold_in` run on the host: the port's loops carry the
round counter k as a host int, so deriving a round's key reads nothing from
the device. Only `random_bits` / `uniform` touch the device: on the card
they are one launch of the threefry kernel (K5, `kernels/threefry`), on
the CPU its plain version, the same hash in int64 tensor ops
(`kernels/threefry/ref.py`). Both give the same bits; nothing is read back.

A batch of G keys (what the reference draws under `vmap`, one key per
sweep lane) is a (G, 2) int64 tensor on the device: `random_bits` and
`uniform` then return (G, *shape), lane g bitwise the single draw under
key g, in one launch. `fold_in_lanes` derives such keys on the host with
numpy, many rounds and lanes at once.

`split` and `normal` are not here: no path of the port draws them (the RFF
draw uses a torch.Generator by design).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.threefry import ops as _k5
from repro_torch.kernels.threefry.ref import MASK32, threefry2x32

Key = tuple[int, int]


def PRNGKey(seed: int) -> Key:
    """jax.random.PRNGKey(seed) with jax's default 32-bit integers: the
    seed's low 32 bits (two's complement for a negative seed) under a zero
    high word."""
    return 0, int(seed) & MASK32


def fold_in(key: Key, data: int) -> Key:
    """jax.random.fold_in(key, data) for a 32-bit data word: the hash of
    the counter pair (0, data) under `key`."""
    data = int(data)
    if not 0 <= data <= MASK32:
        raise OverflowError(f"fold_in data {data} is not a uint32")
    return threefry2x32(key, 0, data)


def fold_in_lanes(keys: np.ndarray, data) -> np.ndarray:
    """fold_in over arrays on the host: keys (..., 2) int64 words, data an
    int or an int array broadcast against keys[..., 0]. Equal, element for
    element, to `fold_in` of each key and datum; returns (..., 2) int64."""
    data = np.asarray(data, dtype=np.int64)
    if np.any((data < 0) | (data > MASK32)):
        raise OverflowError(f"fold_in data {data} is not a uint32")
    keys = np.asarray(keys, dtype=np.int64)
    hi, lo = threefry2x32((keys[..., 0], keys[..., 1]), 0, data)
    return np.stack(np.broadcast_arrays(hi, lo), axis=-1)


def random_bits(key, shape, device: torch.device | str = "cpu"
                ) -> torch.Tensor:
    """jax.random.bits(key, shape) for 32-bit words, partitionable form:
    element i of the flattened shape hashes the counter pair (i >> 32,
    i & 0xFFFFFFFF); the word is the XOR of the two outputs. Returned as
    int64 values in [0, 2^32).

    key is a host pair, or a (G, 2) int64 tensor of G keys: the result is
    then (G, *shape), one draw per key."""
    return _k5.random_bits(key, shape, device)


def uniform(key, shape, device: torch.device | str = "cpu"
            ) -> torch.Tensor:
    """jax.random.uniform(key, shape) in float32 on [0, 1): the top 23 bits
    of each word as the mantissa of a float in [1, 2), minus 1. With a
    (G, 2) tensor of keys, (G, *shape): lane g is the draw under key g."""
    return _k5.uniform(key, shape, device)
