"""Dataset generators (numpy), copied from the JAX package so the arrays
are exactly equal to the reference's.

`paper_synthetic` reproduces Section 5.1 exactly: N agents, each with
T_i ~ U(4000, 6000) pairs from  y = sum_m b_m kappa(c_m, x) + e,
b_m ~ U[0,1], c_m ~ N(0, I_5), x ~ N(0, I_5), e ~ N(0, 0.1),
Gaussian kernel with bandwidth sigma = 5.

`heterogeneous` splits the synthetic mixture into K latent tasks (the
clustered non-IID workload of personalization), and `stream_synthetic`
extends the synthetic model to per-agent minibatch streams (the
online-learning workload), as the reference's do.

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


# ---------------------------------------------------------------------------
# Clustered non-IID: K latent tasks, per-agent mixtures (personalization)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeterogeneousDataset(Dataset):
    """A clustered non-IID `Dataset`: agent n's labels come from latent
    task cluster[n] (plus a small cross-task mixture), so full consensus
    averages models that were never meant to agree. The ground-truth
    cluster assignment ships with the data — it is the reference the
    graph-recovery metric scores learned adjacencies against."""

    cluster: np.ndarray = None   # (N,) int — agent n's latent task
    num_tasks: int = 0


def heterogeneous(
    num_agents: int = 20,
    num_tasks: int = 3,
    samples_per_agent: int = 500,
    input_dim: int = 5,
    num_components: int = 50,
    bandwidth: float = 5.0,
    noise_std: float = np.sqrt(0.1),
    mix: float = 0.1,
    seed: int = 0,
    name: str = "heterogeneous",
) -> HeterogeneousDataset:
    """The paper's synthetic mixture split into K latent tasks.

    All tasks share the component centers c_m (same input geometry), but
    each task t draws its own mixture weights b_t — K distinct target
    functions over a common feature space. Agent n is assigned to task
    cluster[n] = n % K (balanced round-robin) and labels with the softened
    weights  w_n = (1 - mix) b_{cluster[n]} + (mix / K) sum_t b_t : with
    mix > 0 tasks overlap slightly (collaboration helps), with mix = 0
    they are fully disjoint. Inputs stay iid across agents — the
    heterogeneity is in the target function, which is exactly what theta
    affinities can detect. Normalization/split follow paper_synthetic.
    """
    if not 1 <= num_tasks <= num_agents:
        raise ValueError(
            f"need 1 <= num_tasks <= num_agents, got K={num_tasks} over "
            f"N={num_agents} agents")
    rng = np.random.default_rng(seed)
    b = rng.uniform(0.0, 1.0, (num_tasks, num_components))   # per-task
    c = rng.normal(size=(num_components, input_dim))          # shared
    x = rng.normal(size=(num_agents, samples_per_agent, input_dim))

    cluster = np.arange(num_agents) % num_tasks
    onehot = np.eye(num_tasks)[cluster]                       # (N, K)
    alpha = (1.0 - mix) * onehot + mix / num_tasks            # (N, K)
    w = alpha @ b                                             # (N, M)

    sq = ((x[:, :, None, :] - c[None, None, :, :]) ** 2).sum(-1)
    kappa = np.exp(-sq / (2.0 * bandwidth**2))                # (N, T, M)
    y = (np.einsum("ntm,nm->nt", kappa, w)
         + rng.normal(scale=noise_std, size=(num_agents, samples_per_agent)))

    x = _normalize01(x)
    y = (y - y.min()) / max(y.max() - y.min(), 1e-9)
    xtr, ytr, xte, yte = _split(x, y)
    return HeterogeneousDataset(
        xtr.astype(np.float32), ytr.astype(np.float32),
        xte.astype(np.float32), yte.astype(np.float32), name,
        cluster=cluster.astype(np.int32), num_tasks=num_tasks)


#: stream generator kinds `stream_synthetic` implements (and
#: `FitConfig.stream` validates against)
STREAM_KINDS = ("stationary", "drift", "shift")


@dataclasses.dataclass(frozen=True)
class StreamDataset:
    """Per-agent minibatch stream: round k hands agent n the fresh
    minibatch (x[k, n], y[k, n]); the arrival order is materialized up
    front and sliced per round."""

    x: np.ndarray  # (R, N, b, d) in [0, 1]
    y: np.ndarray  # (R, N, b)
    kind: str
    name: str = "stream"

    @property
    def num_rounds(self) -> int:
        return self.x.shape[0]

    @property
    def num_agents(self) -> int:
        return self.x.shape[1]

    @property
    def batch(self) -> int:
        return self.x.shape[2]

    @property
    def input_dim(self) -> int:
        return self.x.shape[-1]


def stream_synthetic(
    kind: str = "stationary",
    num_rounds: int = 200,
    num_agents: int = 6,
    batch: int = 16,
    input_dim: int = 5,
    num_components: int = 50,
    bandwidth: float = 5.0,
    noise_std: float = np.sqrt(0.1),
    drift: float = 1.0,
    shift: float = 2.0,
    seed: int = 0,
) -> StreamDataset:
    """The paper's synthetic model extended to a stream.

    kind — "stationary": the Section-5.1 mixture, fresh draws per round;
           "drift" (concept drift): the mixture *weights* interpolate
           b(k) = (1-t_k) b0 + t_k b1 between two independent draws
           (t_k = drift * k/(R-1), clipped to [0, 1]) — the target
           function itself moves while the inputs stay iid;
           "shift" (covariate shift): the input mean slides
           m_k = shift * t_k * u along a fixed random direction u while
           the target function stays fixed — the regressor sees a moving
           slice of an unchanged surface.
    """
    if kind not in STREAM_KINDS:
        raise ValueError(
            f"unknown stream kind {kind!r}; choose from {STREAM_KINDS}")
    rng = np.random.default_rng(seed)
    b0 = rng.uniform(0.0, 1.0, num_components)
    b1 = rng.uniform(0.0, 1.0, num_components)
    c = rng.normal(size=(num_components, input_dim))
    u = rng.normal(size=input_dim)
    u /= np.linalg.norm(u)

    t = (np.arange(num_rounds) / max(num_rounds - 1, 1)).astype(np.float64)
    x = rng.normal(size=(num_rounds, num_agents, batch, input_dim))
    if kind == "shift":
        x = x + (shift * t)[:, None, None, None] * u
    if kind == "drift":
        w = np.clip(drift * t, 0.0, 1.0)
        b_k = (1.0 - w)[:, None] * b0 + w[:, None] * b1   # (R, M)
    else:
        b_k = np.broadcast_to(b0, (num_rounds, num_components))

    # y[k] = sum_m b_m(k) exp(-||c_m - x||^2 / (2 sigma^2)) + e, one round
    # at a time — the (N, b, M, d) intermediate stays round-sized.
    y = np.empty((num_rounds, num_agents, batch))
    for k in range(num_rounds):
        sq = ((x[k][:, :, None, :] - c[None, None, :, :]) ** 2).sum(-1)
        y[k] = np.exp(-sq / (2.0 * bandwidth**2)) @ b_k[k]
    y += rng.normal(scale=noise_std, size=y.shape)

    # global normalization (matching paper_synthetic's protocol): inputs to
    # [0, 1] per coordinate, labels to [0, 1] — so censor thresholds bite
    # the same way they do on the batch problem
    lo = x.min(axis=(0, 1, 2), keepdims=True)
    hi = x.max(axis=(0, 1, 2), keepdims=True)
    x = (x - lo) / np.maximum(hi - lo, 1e-9)
    y = (y - y.min()) / max(y.max() - y.min(), 1e-9)
    return StreamDataset(x.astype(np.float32), y.astype(np.float32),
                         kind=kind, name=f"stream-{kind}")


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
