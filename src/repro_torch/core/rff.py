"""Random Fourier feature (RFF) mapping — the enabling transform of the paper.

Both real-valued maps of Rahimi & Recht (2008): Eq. (12) (cos/sin pairs,
output dim 2L) and Eq. (13) (sqrt(2) cos(w'x + b), output dim L), plus the
Gaussian-kernel spectral draw with a common seed across agents.

`draw_rff` draws from a `torch.Generator`: the port's draw at a seed does
NOT equal the reference's `jax.random` draw at the same seed. A model is
carried between the two packages by its arrays (`repro_torch.convert`, or a
saved artifact), never by re-drawing.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class RFFParams:
    """Frozen random-feature parameters shared by every agent.

    omega : (d, L) spectral samples from p_kappa(omega).
    bias  : (L,) uniform [0, 2pi) phases (only used by the 'cos_bias' map).
    mapping : which real-valued mapping to apply.
    """

    omega: torch.Tensor
    bias: torch.Tensor
    mapping: str = "cos_bias"

    @property
    def num_features(self) -> int:
        L = self.omega.shape[1]
        return 2 * L if self.mapping == "cos_sin" else L

    @property
    def input_dim(self) -> int:
        return self.omega.shape[0]

    def to(self, device) -> "RFFParams":
        return dataclasses.replace(self, omega=self.omega.to(device),
                                   bias=self.bias.to(device))


def draw_rff(generator: torch.Generator, input_dim: int, num_features: int,
             bandwidth: float = 1.0, mapping: str = "cos_bias",
             device: torch.device | str = "cpu",
             dtype: torch.dtype = torch.float32) -> RFFParams:
    """Draw L iid spectral samples for a Gaussian kernel of the given
    bandwidth: N(0, sigma^-2 I) by Bochner's theorem (Eq. 10).

    The draw runs on the generator's device and is then moved to `device`,
    so a CPU generator gives the same parameters whatever the target."""
    L = num_features // 2 if mapping == "cos_sin" else num_features
    gdev = generator.device
    omega = torch.randn((input_dim, L), generator=generator, dtype=dtype,
                        device=gdev) / bandwidth
    bias = torch.rand((L,), generator=generator, dtype=dtype,
                      device=gdev) * (2.0 * math.pi)
    return RFFParams(omega=omega.to(device), bias=bias.to(device),
                     mapping=mapping)


def featurize(params: RFFParams, x: torch.Tensor) -> torch.Tensor:
    """phi_L(x): map raw inputs (..., d) to RF-space features (..., D).

    D = L for 'cos_bias' (Eq. 13), D = 2L for 'cos_sin' (Eq. 12); both are
    scaled so that E[phi(x)'phi(x')] = kappa(x, x')."""
    proj = torch.matmul(x, params.omega)   # (..., L)
    L = params.omega.shape[1]
    if params.mapping == "cos_sin":
        feats = torch.cat([torch.cos(proj), torch.sin(proj)], dim=-1)
        return feats * math.sqrt(1.0 / L)
    feats = math.sqrt(2.0) * torch.cos(proj + params.bias)
    return feats * math.sqrt(1.0 / L)


def approx_kernel(params: RFFParams, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """kappa_hat_L(x, y) = phi_L(x)' phi_L(y), Eq. (11)."""
    return featurize(params, x) @ featurize(params, y).T


def exact_gaussian_kernel(x: torch.Tensor, y: torch.Tensor,
                          bandwidth: float) -> torch.Tensor:
    """The exact Gaussian Gram matrix: the oracle the RFF approximation is
    held to."""
    sq = (torch.sum(x * x, -1)[:, None] - 2.0 * x @ y.T
          + torch.sum(y * y, -1)[None, :])
    return torch.exp(-sq / (2.0 * bandwidth**2))


def featurize_jit(params: RFFParams, x: torch.Tensor) -> torch.Tensor:
    """The reference's name for its compiled featurize, the data
    pipeline's entry point: here `featurize` itself (the port runs it
    eagerly; K1 is `kernels.rff`)."""
    return featurize(params, x)
