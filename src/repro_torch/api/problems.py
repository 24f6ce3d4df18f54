"""Problem construction: FitConfig/KRRConfig -> the RF-space Problem.

Draw the dataset shards (numpy, equal to the reference's), the consensus
graph, the common-seed random features (a `torch.Generator` seeded with
`krr.seed`; not the reference's draw) and featurize with the plain
`core.rff.featurize`, as the reference does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.api.config import FitConfig
from repro_torch.configs.coke_krr import KRRConfig
from repro_torch.core import graph as graph_mod
from repro_torch.core import rff
from repro_torch.core.admm import Problem, make_problem
from repro_torch.data.synthetic import paper_synthetic, uci_standin
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
        raise NotImplementedError(
            "the heterogeneous dataset is not ported yet: ROADMAP.md Queue 1 "
            "item 11 (personalization)")
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
        labels_test=y_test, x_test=x_test, y_test=y_test)
