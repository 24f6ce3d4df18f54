"""Public entry: the tree-level fused COKE update.

Flattens agent-stacked parameter trees to (N, D), runs `coke_fused_update`
(K3) and unflattens g_aug: the fused core of
`repro_torch.distributed.consensus.consensus_update`. The kernel returns
xi_sq, the *squared* censor norm; this wrapper returns xi_norm =
sqrt(xi_sq), the quantity the censor policy compares against h(k).
"""
from __future__ import annotations

import torch

from repro_torch.core.comm import flatten_agents, unflatten_agents
from repro_torch.kernels.coke_update.coke_update import coke_fused_update


def coke_update_pytree(params, theta_hat, gamma, grads, left, right, *,
                       rho: float, deg: float = 2.0):
    """Agent-stacked trees -> (g_aug tree fp32, xi_norm (N,))."""
    th, leaves = flatten_agents(params)
    hat, _ = flatten_agents(theta_hat)
    gm, _ = flatten_agents(gamma)
    g, _ = flatten_agents(grads)
    lf, _ = flatten_agents(left)
    rt, _ = flatten_agents(right)
    gaug, xisq = coke_fused_update(th, hat, gm, g, lf, rt, rho=rho, deg=deg)
    return unflatten_agents(gaug, leaves, params), torch.sqrt(xisq)
