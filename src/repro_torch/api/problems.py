"""Problem construction: FitConfig/KRRConfig -> the RF-space Problem, and
the streaming problem `fit_stream` runs.

Draw the dataset shards (numpy, equal to the reference's), the consensus
graph, the common-seed random features (a `torch.Generator` seeded with
`krr.seed`; not the reference's draw) and featurize with the plain
`core.rff.featurize`, as the reference does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.config import FitConfig
from repro_torch.configs.coke_krr import KRRConfig
from repro_torch.core import graph as graph_mod
from repro_torch.core import rff
from repro_torch.core.admm import Problem, make_problem
from repro_torch.data.synthetic import (StreamDataset, heterogeneous,
                                        paper_synthetic, stream_synthetic,
                                        uci_standin)
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BuiltProblem:
    problem: Problem
    graph: graph_mod.Graph
    rff_params: rff.RFFParams
    feats_test: torch.Tensor
    labels_test: torch.Tensor
    # raw held-out inputs (N, S, d) / (N, S): what `KernelModel.evaluate`
    # consumes — the model owns featurization at inference time
    x_test: torch.Tensor | None = None
    y_test: torch.Tensor | None = None
    # ground-truth latent task of each agent (N,), only for the clustered
    # non-IID dataset: what personalize.graph_recovery scores against
    clusters: np.ndarray | None = None


@dataclasses.dataclass(frozen=True)
class StreamProblem:
    """The decentralized online learning problem: round k feeds agent n
    the fresh, already-featurized minibatch (feats[k, n], labels[k, n])."""

    feats: torch.Tensor      # (R, N, b, D) RF-mapped minibatch streams
    labels: torch.Tensor     # (R, N, b)
    adjacency: torch.Tensor  # (N, N)
    lam: float               # global ridge lambda (split lam/N per agent)
    rho: float               # ADMM penalty / step size

    @property
    def num_rounds(self) -> int:
        return self.feats.shape[0]

    @property
    def num_agents(self) -> int:
        return self.feats.shape[1]

    @property
    def batch(self) -> int:
        return self.feats.shape[2]

    @property
    def feature_dim(self) -> int:
        return self.feats.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.feats.device

    def round_batch(self, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(feats, labels) of round k (a host int; wraps modulo R): views,
        no copy."""
        r = k % self.num_rounds
        return self.feats[r], self.labels[r]

    def to(self, device) -> "StreamProblem":
        return dataclasses.replace(
            self, feats=self.feats.to(device),
            labels=self.labels.to(device),
            adjacency=self.adjacency.to(device))


@dataclasses.dataclass(frozen=True)
class BuiltStream:
    stream: StreamProblem
    graph: graph_mod.Graph
    rff_params: rff.RFFParams
    dataset: StreamDataset


def _on(a, device) -> torch.Tensor:
    """A tensor or an array-like, as a tensor on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


def stream_from_arrays(rff_params: rff.RFFParams, x, y,
                       graph_or_adjacency, *, lam: float,
                       rho: float) -> StreamProblem:
    """Featurize a raw (R, N, b, d) / (R, N, b) stream with an existing RFF
    map, on the map's device — how `KernelModel.partial_fit` turns fresh
    raw traffic into the StreamProblem its thetas were trained against."""
    dev = rff_params.omega.device
    x, y = _on(x, dev), _on(y, dev)
    if x.ndim != 4 or y.ndim != 3 or tuple(x.shape[:3]) != tuple(y.shape):
        raise ValueError(
            "a raw stream is x (R, N, b, d) with labels y (R, N, b); got "
            f"x {tuple(x.shape)} / y {tuple(y.shape)}")
    adj = (graph_or_adjacency.adjacency
           if isinstance(graph_or_adjacency, graph_mod.Graph)
           else graph_or_adjacency)
    feats = rff.featurize(rff_params, x)
    return StreamProblem(feats=feats, labels=y,
                         adjacency=_on(adj, dev).to(feats.dtype),
                         lam=lam, rho=rho)


def build_stream(config: FitConfig, num_rounds: int | None = None, *,
                 device: torch.device | str | None = None) -> BuiltStream:
    """Construct the streaming problem a config describes, on `device`
    (None = "cuda"): the per-agent minibatch stream (`config.stream`
    kind, `config.online_batch` sized, one round per fit iteration unless
    `num_rounds` overrides), the consensus graph, and the common-seed RFF
    featurization (the port's draw)."""
    dev = resolve_device(device)
    cfg = config.krr
    R = config.resolved_iters if num_rounds is None else num_rounds
    if R < 1:
        raise ValueError(f"a stream needs >= 1 round, got {R}")
    ds = stream_synthetic(kind=config.stream, num_rounds=R,
                          num_agents=cfg.num_agents,
                          batch=config.online_batch,
                          bandwidth=cfg.bandwidth, seed=cfg.seed)
    g = build_graph(config, cfg.num_agents, seed=cfg.seed)
    p = rff.draw_rff(torch.Generator().manual_seed(cfg.seed), ds.input_dim,
                     cfg.num_features, cfg.bandwidth, mapping=cfg.mapping,
                     device=dev)
    stream = stream_from_arrays(p, ds.x, ds.y, g, lam=cfg.lam, rho=cfg.rho)
    return BuiltStream(stream=stream, graph=g, rff_params=p, dataset=ds)


def build_graph(config: FitConfig, num_agents: int,
                seed: int) -> graph_mod.Graph:
    if config.graph == "erdos_renyi":
        return graph_mod.erdos_renyi(num_agents, config.krr.graph_p,
                                     seed=seed)
    if config.graph == "ring":
        return graph_mod.ring(num_agents)
    if config.graph == "circulant":
        return graph_mod.circulant(num_agents, config.graph_offsets)
    if config.graph == "full":
        return graph_mod.fully_connected(num_agents)
    raise ValueError(f"unknown graph family {config.graph!r}")


def build_problem(config: FitConfig | KRRConfig,
                  samples_override: int | None = None, *,
                  device: torch.device | str | None = None) -> BuiltProblem:
    """Construct the decentralized learning problem a config describes,
    with every tensor on `device` (None = "cuda")."""
    dev = resolve_device(device)
    if isinstance(config, KRRConfig):
        config = FitConfig(krr=config)
    cfg = config.krr
    n = samples_override or cfg.samples_per_agent
    if cfg.dataset == "synthetic":
        ds = paper_synthetic(num_agents=cfg.num_agents, samples_per_agent=n,
                             seed=cfg.seed)
        g = build_graph(config, cfg.num_agents, seed=cfg.seed)
    elif cfg.dataset == "heterogeneous":
        ds = heterogeneous(num_agents=cfg.num_agents, samples_per_agent=n,
                           num_tasks=cfg.num_tasks, seed=cfg.seed)
        g = build_graph(config, cfg.num_agents, seed=cfg.seed)
    else:
        ds = uci_standin(cfg.dataset, num_agents=cfg.num_agents,
                         subsample=n * cfg.num_agents)
        g = build_graph(config, cfg.num_agents, seed=cfg.seed + 1)
    gen = torch.Generator().manual_seed(cfg.seed)
    p = rff.draw_rff(gen, ds.input_dim, cfg.num_features, cfg.bandwidth,
                     mapping=cfg.mapping, device=dev)
    feats = rff.featurize(p, torch.as_tensor(ds.x, device=dev))
    labels = torch.as_tensor(ds.y, device=dev)
    prob = make_problem(feats, labels, g, lam=cfg.lam, rho=cfg.rho)
    x_test = torch.as_tensor(ds.x_test, device=dev)
    y_test = torch.as_tensor(ds.y_test, device=dev)
    return BuiltProblem(
        problem=prob, graph=g, rff_params=p,
        feats_test=rff.featurize(p, x_test),
        labels_test=y_test, x_test=x_test, y_test=y_test,
        clusters=getattr(ds, "cluster", None))
