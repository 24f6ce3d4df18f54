"""Public entry: the tree-level fused COKE update.

Flattens agent-stacked parameter trees to (N, D), runs `coke_fused_update`
(K3) and unflattens g_aug: the fused core of
`repro_torch.distributed.consensus.consensus_update`. The kernel returns
xi_sq, the *squared* censor norm; this wrapper returns xi_norm =
sqrt(xi_sq), the quantity the censor policy compares against h(k). On
a mesh the trees' leaves are feature-sharded blocks and K3 runs once per
block (`coke_update_blocks`), xi_sq the psum of the blocks' partials.
"""
from __future__ import annotations

import torch

from repro_torch.core.comm import flatten_agents, unflatten_agents
from repro_torch.distributed import sharding
from repro_torch.kernels.coke_update.coke_update import coke_fused_update


def coke_update_pytree(params, theta_hat, gamma, grads, left, right, *,
                       rho: float, deg: float = 2.0, norm: bool = True):
    """Agent-stacked trees -> (g_aug tree fp32, xi_norm (N,)). With
    norm=False xi_norm is None and nothing is computed from the kernel's
    xi_sq: the fused fallback of `consensus_update` censors on the new
    iterate, whose norm xi_sq (of the old one) is not."""
    th, leaves = flatten_agents(params)
    hat, _ = flatten_agents(theta_hat)
    gm, _ = flatten_agents(gamma)
    g, _ = flatten_agents(grads)
    lf, _ = flatten_agents(left)
    rt, _ = flatten_agents(right)
    out = coke_update_blocks(th, hat, gm, g, lf, rt, rho=rho, deg=deg,
                             xi_sq=norm)
    gaug, xisq = out if norm else (out, None)
    return (unflatten_agents(gaug, leaves, params),
            torch.sqrt(xisq) if norm else None)


def coke_update_blocks(theta, theta_hat, gamma, grad, left, right, *,
                       rho: float, deg: float = 2.0, xi_sq: bool = True):
    """K3 once per block of a feature-sharded carry (every block a
    contiguous (N/b, D/s) tensor of each operand; plain (N, D) operands
    are one block) -> (g_aug in the carry's layout, xi^2 (N,)), xi^2 the
    psum of the blocks' partials in ascending model-block order
    (`distributed.sharding.psum_model`). With xi_sq=False only g_aug: the
    blocks' partials are left unsummed."""
    ops = (theta, theta_hat, gamma, grad, left, right)
    spec = sharding.spec_of(theta, 0, 1)
    if not xi_sq:
        return sharding.blockwise(
            lambda *blocks: coke_fused_update(*blocks, rho=rho,
                                              deg=deg)[0], *ops, out=spec)
    return sharding.blockwise(
        lambda *blocks: coke_fused_update(*blocks, rho=rho, deg=deg),
        *ops, out=(spec, sharding.P(spec[0])), partial=(False, True))
