"""Dataset generators (numpy), copied from the JAX package so the arrays
are exactly equal to the reference's.

`paper_synthetic` reproduces Section 5.1 exactly: N agents, each with
T_i ~ U(4000, 6000) pairs from  y = sum_m b_m kappa(c_m, x) + e,
b_m ~ U[0,1], c_m ~ N(0, I_5), x ~ N(0, I_5), e ~ N(0, 0.1),
Gaussian kernel with bandwidth sigma = 5.

`uci_standin` generates stand-ins for the UCI regression datasets used in
Section 5.2. The real files are not shipped with the repo; the generators
match the published sample counts and input dimensions and produce a smooth
nonlinear regression surface, which preserves the experimental *protocol*
(normalization to [0,1], 70/30 split, per-agent sharding) even though
absolute MSE numbers are not comparable to the paper's tables.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Dataset:
    """Per-agent sharded regression dataset (equal shards for batching)."""

    x: np.ndarray  # (N, T_i, d) in [0, 1]
    y: np.ndarray  # (N, T_i)
    x_test: np.ndarray  # (N, S_i, d)
    y_test: np.ndarray  # (N, S_i)
    name: str

    @property
    def num_agents(self) -> int:
        return self.x.shape[0]

    @property
    def input_dim(self) -> int:
        return self.x.shape[-1]


def _normalize01(x: np.ndarray) -> np.ndarray:
    lo, hi = x.min(axis=(0, 1), keepdims=True), x.max(axis=(0, 1), keepdims=True)
    return (x - lo) / np.maximum(hi - lo, 1e-9)


def _split(x, y, train_frac=0.7):
    Ti = x.shape[1]
    cut = int(Ti * train_frac)
    return x[:, :cut], y[:, :cut], x[:, cut:], y[:, cut:]


def paper_synthetic(
    num_agents: int = 20,
    samples_per_agent: int = 500,
    input_dim: int = 5,
    num_components: int = 50,
    bandwidth: float = 5.0,
    noise_std: float = np.sqrt(0.1),
    seed: int = 0,
    name: str = "synthetic",
) -> Dataset:
    """The paper's synthetic model (Sec 5.1), equal shards for batching.

    (The paper draws T_i in (4000, 6000); we default to a smaller equal shard
    for test speed — Assumption 3 only requires same order of magnitude.)
    """
    rng = np.random.default_rng(seed)
    b = rng.uniform(0.0, 1.0, num_components)
    c = rng.normal(size=(num_components, input_dim))
    x = rng.normal(size=(num_agents, samples_per_agent, input_dim))

    # y = sum_m b_m exp(-||c_m - x||^2 / (2 sigma^2)) + e
    sq = ((x[:, :, None, :] - c[None, None, :, :]) ** 2).sum(-1)
    y = (np.exp(-sq / (2.0 * bandwidth**2)) @ b
         + rng.normal(scale=noise_std, size=(num_agents, samples_per_agent)))

    x = _normalize01(x)
    # Sec. 5: "entries of data samples are normalized to lie in [0,1]" —
    # label scale determines how censor thresholds bite, so this matters.
    y = (y - y.min()) / max(y.max() - y.min(), 1e-9)
    xtr, ytr, xte, yte = _split(x, y)
    return Dataset(xtr.astype(np.float32), ytr.astype(np.float32),
                   xte.astype(np.float32), yte.astype(np.float32), name)


#: stream generator kinds the reference implements (what `FitConfig.stream`
#: validates against; streaming itself is not ported yet)
STREAM_KINDS = ("stationary", "drift", "shift")


# Published (samples, input_dim) of the Section-5.2 UCI datasets.
UCI_SPECS = {
    "toms_hardware": (11000, 96),
    "twitter": (13800, 77),
    "twitter_large": (98704, 77),
    "energy": (19735, 28),
    "air_quality": (9358, 13),
}


def uci_standin(
    name: str,
    num_agents: int = 10,
    seed: int = 1,
    subsample: int | None = 4000,
) -> Dataset:
    """Offline stand-in with the published dims of the named UCI dataset."""
    total, dim = UCI_SPECS[name]
    if subsample is not None:
        total = min(total, subsample)
    per_agent = total // num_agents
    # zlib.crc32, not hash(): str hashing is salted per process, which made
    # every stand-in dataset (and all UCI benchmark numbers) differ run-to-run
    import zlib
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 2**16)

    # Smooth nonlinear surface: random low-rank features + sinusoidal response.
    proj = rng.normal(size=(dim, 8)) / np.sqrt(dim)
    w = rng.normal(size=8)
    x = rng.uniform(size=(num_agents, per_agent, dim))
    z = np.tanh(x @ proj)
    y = np.sin(z @ w) + 0.1 * (z**2 @ np.abs(w)) \
        + rng.normal(scale=0.05, size=(num_agents, per_agent))

    x = _normalize01(x)
    y = (y - y.min()) / max(y.max() - y.min(), 1e-9)
    xtr, ytr, xte, yte = _split(x, y)
    return Dataset(xtr.astype(np.float32), ytr.astype(np.float32),
                   xte.astype(np.float32), yte.astype(np.float32), name)
