"""Optimizers as pure transforms over dicts of tensors: SGD (+momentum) and
AdamW, with global-norm clipping. The deep-net training loop (`train/`)
runs AdamW; the consensus (ADMM) strategies use either as their inexact
inner solver, one step per iteration."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"          # adamw | sgd
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.0        # sgd only
    grad_clip: float = 0.0       # 0 = off (global-norm clip)


def _check_kind(cfg: OptConfig) -> None:
    if cfg.kind not in ("adamw", "sgd"):
        raise ValueError(f"unknown optimizer kind {cfg.kind!r}")


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def init_opt_state(cfg: OptConfig, params) -> dict:
    """The optimizer slot for `params`; pass a stacked tree and
    `num_agents` rows of slots come out of `torch.func.vmap`."""
    _check_kind(cfg)
    count = torch.zeros((), dtype=torch.int32,
                        device=tree_leaves(params)[0].device)
    if cfg.kind == "adamw":
        return {"m": _zeros_f32(params), "v": _zeros_f32(params),
                "count": count}
    if cfg.momentum:
        return {"m": _zeros_f32(params), "count": count}
    return {"count": count}


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def opt_update(cfg: OptConfig, grads, state, params):
    """-> (updates to ADD to params, new_state). The clipped gradient is
    formed inside each leaf's expressions, as g * scale (the reference's
    product), so no clipped copy of the whole tree is held."""
    _check_kind(cfg)
    if cfg.grad_clip:
        gn = _global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
        clip = lambda g: g * scale
    else:
        clip = lambda g: g
    count = state["count"] + 1

    if cfg.kind == "adamw":
        b1, b2 = cfg.beta1, cfg.beta2
        m = tree_map(lambda m_, g: b1 * m_
                     + (1 - b1) * clip(g).to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_
                     + (1 - b2) * torch.square(clip(g).to(torch.float32)),
                     state["v"], grads)
        # the bias corrections in fp32, as the reference's beta ** count
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=c.device), c)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=c.device), c)
        updates = tree_map(
            lambda m_, v_, p: (-cfg.lr * ((m_ / bc1)
                               / (torch.sqrt(v_ / bc2) + cfg.eps)
                               + cfg.weight_decay
                               * p.to(torch.float32))).to(p.dtype),
            m, v, params)
        return updates, {"m": m, "v": v, "count": count}

    if cfg.momentum:
        m = tree_map(lambda m_, g: cfg.momentum * m_
                     + clip(g).to(torch.float32), state["m"], grads)
        updates = tree_map(lambda m_, p: (-cfg.lr * m_).to(p.dtype),
                           m, params)
        return updates, {"m": m, "count": count}
    updates = tree_map(lambda g, p: (-cfg.lr * clip(g)).to(p.dtype), grads,
                       params)
    return updates, {"count": count}


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
