"""Optimizers as pure transforms over dicts of tensors: SGD (+momentum,
+global-norm clipping). The consensus (ADMM) strategies use it as their
inexact inner solver, one step per iteration. AdamW belongs to the
deep-net training layer and is not ported yet."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tree import tree_leaves, tree_map

_ADAMW_LATER = ("optimizer kind 'adamw' is not ported to repro_torch yet: "
                "ROADMAP.md Queue 1 item 15 (the deep-net layer)")


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "sgd"            # sgd; adamw raises (not ported yet)
    lr: float = 1e-3
    momentum: float = 0.0
    grad_clip: float = 0.0       # 0 = off (global-norm clip)


def _check_kind(cfg: OptConfig) -> None:
    if cfg.kind == "adamw":
        raise NotImplementedError(_ADAMW_LATER)
    if cfg.kind != "sgd":
        raise ValueError(f"unknown optimizer kind {cfg.kind!r}")


def init_opt_state(cfg: OptConfig, params) -> dict:
    """The optimizer slot for `params`; pass a stacked tree and
    `num_agents` rows of slots come out of `torch.func.vmap`."""
    _check_kind(cfg)
    count = torch.zeros((), dtype=torch.int32,
                        device=tree_leaves(params)[0].device)
    if cfg.momentum:
        return {"m": tree_map(lambda p: torch.zeros(p.shape,
                                                    dtype=torch.float32,
                                                    device=p.device),
                              params),
                "count": count}
    return {"count": count}


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def opt_update(cfg: OptConfig, grads, state, params):
    """-> (updates to ADD to params, new_state)."""
    _check_kind(cfg)
    if cfg.grad_clip:
        gn = _global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale, grads)
    count = state["count"] + 1
    if cfg.momentum:
        m = tree_map(lambda m_, g: cfg.momentum * m_ + g.to(torch.float32),
                     state["m"], grads)
        updates = tree_map(lambda m_, p: (-cfg.lr * m_).to(p.dtype),
                           m, params)
        return updates, {"m": m, "count": count}
    updates = tree_map(lambda g, p: (-cfg.lr * g).to(p.dtype), grads, params)
    return updates, {"count": count}


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
