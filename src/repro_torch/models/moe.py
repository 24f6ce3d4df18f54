"""Mixture-of-Experts layer: grouped GShard-style top-k dispatch.

Port of `repro/models/moe.py`. Tokens are split into groups of
`moe_group_size`; within a group, top-k routing builds a one-hot dispatch
tensor (S_g, E, C) with capacity C = ceil(k * S_g / E * capacity_factor)
rounded up to a multiple of 4, and the experts run as the reference's
einsums over it: dispatch, three expert matmuls batched over E, combine.
No kernel of the port's own: the reference's MoE is plain einsums outside
any Pallas kernel, and the port's are ATen's.

Routing is exact integer arithmetic, as the reference's: the top k of the
router's softmax, the lower expert index first on ties (as
`jax.lax.top_k`, by a stable descending sort: `torch.topk` does not
promise it), then each slot's position in its expert by a cumulative sum
over the group, earlier slots first (GShard slot priority); a token-slot
whose position reaches C is dropped.

Supports shared (always-on) experts (DeepSeek-V2) alongside routed ones,
and returns the switch-transformer load-balance auxiliary loss.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (ModelConfig, dense_init, frozen,
                                       init_device, swiglu)


class MoE(nn.Module):
    """The weights of one MoE layer, named as the reference's param dict:
    router (d, E), always fp32; w_gate and w_up (E, d, f), w_down (E, f, d);
    with shared experts shared_gate, shared_up (d, fs) and shared_down
    (fs, d), fs = f * num_shared_experts. Drawn from `generator` on its
    device, or allocated and not drawn when generator is None (weights that
    are loaded next)."""

    def __init__(self, cfg: ModelConfig,
                 generator: torch.Generator | None = None, *,
                 device: torch.device | str | None = None):
        super().__init__()
        dev = init_device(generator, device)
        d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts

        def draw(shape, dtype, fan_in=None):
            return frozen(dense_init(generator, shape, dtype, fan_in,
                                     device=dev))

        self.router = draw((d, E), torch.float32)
        self.w_gate = draw((E, d, f), cfg.dtype, fan_in=d)
        self.w_up = draw((E, d, f), cfg.dtype, fan_in=d)
        self.w_down = draw((E, f, d), cfg.dtype, fan_in=f)
        if cfg.num_shared_experts:
            fs = f * cfg.num_shared_experts
            self.shared_gate = draw((d, fs), cfg.dtype)
            self.shared_up = draw((d, fs), cfg.dtype)
            self.shared_down = draw((fs, d), cfg.dtype, fan_in=fs)


def init_moe_params(cfg: ModelConfig, generator: torch.Generator) -> MoE:
    return MoE(cfg, generator)


def _capacity(cfg: ModelConfig, group: int) -> int:
    c = int(cfg.top_k * group / cfg.num_experts * cfg.moe_capacity_factor)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, the lower
    index first among equal values (as `jax.lax.top_k`)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Routing(NamedTuple):
    probs: torch.Tensor        # (G, Sg, E) fp32 router softmax
    gate_vals: torch.Tensor    # (G, Sg, k) fp32, normalized over the k
    expert_idx: torch.Tensor   # (G, Sg, k) int64, slot 0 the top expert
    position: torch.Tensor     # (G, Sg, k) int64 place in the expert's queue
    keep: torch.Tensor         # (G, Sg, k) bool, position < capacity


def route(router: torch.Tensor, cfg: ModelConfig, xg: torch.Tensor,
          capacity: int) -> Routing:
    """Top-k routing of the grouped tokens xg (G, Sg, d) with GShard slot
    priority: slot s of token t sits in its expert's queue behind every
    earlier slot of the group and every earlier token's slot s."""
    E, k = cfg.num_experts, cfg.top_k
    probs = torch.softmax(xg.float() @ router, dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)
    pos_base = torch.zeros((xg.shape[0], 1, E), dtype=torch.int64,
                           device=xg.device)
    position = []
    for slot in range(k):
        oh = F.one_hot(expert_idx[:, :, slot], E)              # (G, Sg, E)
        pos = torch.cumsum(oh, dim=1) - oh + pos_base
        position.append(torch.sum(pos * oh, dim=-1))
        pos_base = pos_base + torch.sum(oh, dim=1, keepdim=True)
    position = torch.stack(position, dim=-1)
    return Routing(probs, gate_vals, expert_idx, position,
                   position < capacity)


def dispatch_combine(r: Routing, num_experts: int, capacity: int,
                     dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's one-hot dispatch (G, Sg, E, C) in `dtype` and its
    fp32 combine weights: 1 (the gate) at (token, expert, position) of each
    kept slot, 0 elsewhere. A token's k experts differ, so no two of its
    slots share a place and each place takes at most one value."""
    G, Sg, _ = r.expert_idx.shape
    place = r.expert_idx * capacity + r.position.clamp(max=capacity - 1)
    keep = r.keep.float()
    dispatch = torch.zeros((G, Sg, num_experts * capacity), dtype=dtype,
                           device=place.device)
    combine = torch.zeros((G, Sg, num_experts * capacity),
                          dtype=torch.float32, device=place.device)
    dispatch.scatter_(2, place, keep.to(dtype))
    combine.scatter_(2, place, keep * r.gate_vals)
    shape = (G, Sg, num_experts, capacity)
    return dispatch.reshape(shape), combine.reshape(shape)


def _shared(params: MoE, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x @ params.shared_gate,
                  x @ params.shared_up) @ params.shared_down


def moe_forward(params: MoE, cfg: ModelConfig, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss)."""
    B, S, d = x.shape
    E = cfg.num_experts
    T = B * S
    Sg = min(cfg.moe_group_size, T)
    if T % Sg:
        raise ValueError(f"tokens {T} not divisible by group {Sg}")
    G = T // Sg
    C = _capacity(cfg, Sg)

    xg = x.reshape(G, Sg, d)
    r = route(params.router, cfg, xg, C)
    dispatch, combine = dispatch_combine(r, E, C, x.dtype)

    expert_in = torch.einsum("gsec,gsd->gecd", dispatch, xg)    # (G,E,C,d)
    h = swiglu(torch.einsum("gecd,edf->gecf", expert_in, params.w_gate),
               torch.einsum("gecd,edf->gecf", expert_in, params.w_up))
    expert_out = torch.einsum("gecf,efd->gecd", h, params.w_down)
    y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), expert_out)

    # --- load-balance aux loss (switch-style) ------------------------------
    frac_tokens = torch.mean(F.one_hot(r.expert_idx[..., 0], E).float(),
                             dim=(0, 1))                        # top-1 share
    mean_probs = torch.mean(r.probs, dim=(0, 1))
    aux = E * torch.sum(frac_tokens * mean_probs)

    if cfg.num_shared_experts:
        y = y + _shared(params, xg)
    return y.reshape(B, S, d), aux


def moe_forward_dense_ref(params: MoE, cfg: ModelConfig, x: torch.Tensor
                          ) -> torch.Tensor:
    """Oracle: compute every expert densely, combine by normalized top-k
    gates with *no capacity drops* — `moe_forward` matches it when
    capacity is ample."""
    E, k = cfg.num_experts, cfg.top_k
    probs = torch.softmax(x.float() @ params.router, dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)
    gates = torch.zeros_like(probs)
    for slot in range(k):
        gates = gates + F.one_hot(expert_idx[..., slot], E) * \
            gate_vals[..., slot, None]

    h = swiglu(torch.einsum("bsd,edf->bsef", x, params.w_gate),
               torch.einsum("bsd,edf->bsef", x, params.w_up))
    per_expert = torch.einsum("bsef,efd->bsed", h, params.w_down)
    y = torch.einsum("bse,bsed->bsd", gates.to(x.dtype), per_expert)
    if cfg.num_shared_experts:
        y = y + _shared(params, x)
    return y
