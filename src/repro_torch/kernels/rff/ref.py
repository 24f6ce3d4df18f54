"""Plain PyTorch version of the fused RFF featurizer."""
import math

import torch


def rff_ref(x: torch.Tensor, omega: torch.Tensor, bias: torch.Tensor,
            num_features: int | None = None) -> torch.Tensor:
    """scale * cos(x @ omega + bias) with scale = sqrt(2/L); (T, d) -> (T, L).
    L is `num_features` when omega is one feature block of a wider map,
    else omega's width."""
    L = omega.shape[1] if num_features is None else num_features
    scale = math.sqrt(2.0 / L)
    return scale * torch.cos(x @ omega + bias)
