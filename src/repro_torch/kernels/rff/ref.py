"""Plain PyTorch version of the fused RFF featurizer."""
import math

import torch


def rff_ref(x: torch.Tensor, omega: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """scale * cos(x @ omega + bias) with scale = sqrt(2/L); (T, d) -> (T, L)."""
    scale = math.sqrt(2.0 / omega.shape[1])
    return scale * torch.cos(x @ omega + bias)
