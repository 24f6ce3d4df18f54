"""CTA, the diffusion-based combine-then-adapt baseline (Section 5), in the
simulator form: every agent (a) combines its neighbours' parameters with
doubly-stochastic Metropolis weights, then (b) takes a gradient step on
its local RF-space cost (15). It transmits every iteration, N per step.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import torch

from repro_torch.core import losses as losses_mod
from repro_torch.core.admm import Problem
from repro_torch.core.graph import Graph


class CTAState(NamedTuple):
    theta: torch.Tensor   # (N, D)
    step: int             # iterations done (host int)
    comms: torch.Tensor   # () int32 cumulative transmissions


class CTAResult(NamedTuple):
    state: CTAState
    train_mse: torch.Tensor   # (K,)
    comms: torch.Tensor       # (K,)


def init_state(problem: Problem) -> CTAState:
    N, D = problem.num_agents, problem.feature_dim
    dev = problem.device
    return CTAState(torch.zeros((N, D), dtype=problem.feats.dtype,
                                device=dev), 0,
                    torch.zeros((), dtype=torch.int32, device=dev))


def cta_step(problem: Problem, mixing: torch.Tensor, lr: float,
             state: CTAState) -> CTAState:
    """mixing: (N, N) Metropolis weights (`core.graph.metropolis_weights`).
    The local gradients come from autograd of the agent sum of the local
    risks, each of which depends on its own row only (`losses.risk_grad`,
    which also takes feature-sharded operands)."""
    N = problem.num_agents
    combined = mixing @ state.theta
    g = losses_mod.risk_grad(combined, problem.feats, problem.labels,
                             problem.lam / N, problem.loss)
    return CTAState(combined - lr * g, state.step + 1, state.comms + N)


def run(problem: Problem, graph: Graph, lr: float,
        num_iters: int) -> CTAResult:
    """Deprecated entry point: use `api.fit(FitConfig(algorithm='cta'))`,
    which this runs on `graph`'s Metropolis weights. Warns with the
    reference's text."""
    warnings.warn(
        "repro.core.cta.run is deprecated; use repro.api.fit("
        "FitConfig(algorithm='cta', ...))",
        DeprecationWarning, stacklevel=2)
    from repro_torch.api import FitConfig, fit  # import cycle

    adjacency = torch.as_tensor(graph.adjacency, dtype=problem.feats.dtype,
                                device=problem.device)
    res = fit(FitConfig(algorithm="cta", cta_lr=lr, num_iters=num_iters),
              problem=dataclasses.replace(problem, adjacency=adjacency),
              device=problem.device)
    return CTAResult(res.state, res.history["train_mse"],
                     res.history["comms"])
