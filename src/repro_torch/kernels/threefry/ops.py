"""Public entry points of the threefry draw (K5), as `core.prng` calls
them."""
from __future__ import annotations

import torch

from repro_torch.kernels.threefry.threefry import threefry_draw


def random_bits(key, shape, device: torch.device | str = "cpu"
                ) -> torch.Tensor:
    """jax.random.bits(key, shape) as int64 words in [0, 2^32)."""
    return threefry_draw(key, shape, device, uniform=False)


def uniform(key, shape, device: torch.device | str = "cpu"
            ) -> torch.Tensor:
    """jax.random.uniform(key, shape) in float32 on [0, 1)."""
    return threefry_draw(key, shape, device, uniform=True)
