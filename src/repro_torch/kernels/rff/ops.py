"""Public entry point of the fused RFF featurizer."""
from __future__ import annotations

import torch

from repro_torch.core.rff import RFFParams
from repro_torch.kernels.rff.rff import rff_cos_bias


def featurize_fused(params: RFFParams, x: torch.Tensor) -> torch.Tensor:
    """Drop-in for `core.rff.featurize` (cos_bias mapping), batched over
    leading dims."""
    if params.mapping != "cos_bias":
        raise ValueError("the fused featurizer implements the 'cos_bias' "
                         f"mapping, not {params.mapping!r}")
    flat = x.reshape(-1, x.shape[-1]).contiguous()
    out = rff_cos_bias(flat, params.omega, params.bias)
    return out.reshape(*x.shape[:-1], out.shape[-1])
