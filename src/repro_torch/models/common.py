"""Shared model components: the unified ModelConfig, norms, RoPE, init.

Port of `repro/models/common.py`. One config dataclass covers every
architecture of the reference, field for field, and the port runs each:
the decoder-only models with GQA or MLA attention and dense or MoE layers
(qwen3-1.7b, granite-3-8b, llama3-405b, mixtral-8x7b, minicpm3-4b,
deepseek-v2-lite-16b), the SSM model (mamba2-2.7b), the grouped hybrid
(zamba2-2.7b), the VLM backbone with its patch prefix (internvl2-1b) and
the encoder-decoder (seamless-m4t-medium).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str            # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // num_heads

    # --- attention variant -------------------------------------------------
    attn_kind: str = "gqa"    # gqa | mla | none (pure SSM)
    qk_norm: bool = False     # qwen3
    sliding_window: int = 0   # 0 = full attention; >0 = SWA window (mixtral)

    # --- MLA (deepseek-v2 / minicpm3) --------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0      # 0 = direct q projection
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_group_size: int = 512        # GShard grouped-dispatch group length
    moe_capacity_factor: float = 1.25

    # --- SSM (mamba2 SSD) ----------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # --- hybrid (zamba2: shared attention block every k layers) --------------
    shared_attn_every: int = 0

    # --- enc-dec (seamless-m4t) ----------------------------------------------
    encoder_layers: int = 0

    # --- multimodal stubs ---------------------------------------------------
    prefix_len: int = 0        # vlm: number of (precomputed) patch embeddings

    # --- distribution hints -------------------------------------------------
    seq_parallel: bool = False        # shard the residual stream's seq dim
    act_batch_axes: tuple = ("data",)  # mesh axes carrying the batch dim
    act_model_axis: str = "model"
    # pad Q heads to a multiple of this so they shard over the model axis.
    # Padded heads' wo rows are zero-initialized -> outputs are EXACT.
    tp_head_pad: int = 0

    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.float32
    vocab_pad_multiple: int = 128
    attn_block_q: int = 1024   # the reference's blockwise-attention tiles;
    attn_block_k: int = 1024   # the port's kernel sizes its own
    remat: bool = True
    source: str = ""           # paper / model-card citation

    # ---------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_heads(self) -> int:
        """Physical Q-head count (>= num_heads; multiple of tp_head_pad).
        For GQA, kept a multiple of num_kv_heads so grouping stays exact."""
        if not self.tp_head_pad:
            return self.num_heads
        m = self.tp_head_pad
        h = ((self.num_heads + m - 1) // m) * m
        if self.attn_kind == "gqa" and self.num_kv_heads:
            while h % self.num_kv_heads:
                h += m
        return h

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """The smoke-test variant: <=2 layers, d_model<=512, <=4 experts —
        same family, CPU-runnable."""
        heads = min(self.num_heads, 4) or 4
        kv = min(self.num_kv_heads, heads) if self.num_kv_heads else heads
        d_model = min(self.d_model, 256)
        kw = dict(
            num_layers=2,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=max(1, kv if heads % max(kv, 1) == 0 else heads),
            head_dim=64,
            d_ff=min(self.d_ff, 512) or 0,
            vocab_size=min(self.vocab_size, 1024),
            moe_group_size=64,
            attn_block_q=64,
            attn_block_k=64,
            dtype=torch.float32,
        )
        if self.is_moe:
            kw.update(num_experts=4, top_k=min(self.top_k, 2),
                      num_shared_experts=min(self.num_shared_experts, 1))
        if self.kv_lora_rank:
            kw.update(kv_lora_rank=64, q_lora_rank=0, qk_nope_dim=32,
                      qk_rope_dim=16, v_head_dim=32)
        if self.ssm_state:
            kw.update(ssm_state=min(self.ssm_state, 32), ssm_head_dim=32,
                      ssm_chunk=32)
        if self.shared_attn_every:
            kw.update(shared_attn_every=2)
        if self.encoder_layers:
            kw.update(encoder_layers=2)
        if self.prefix_len:
            kw.update(prefix_len=8)
        if self.sliding_window:
            kw.update(sliding_window=64)
        return self.with_overrides(**kw)


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def at_least_fp32(t: torch.Tensor) -> torch.Tensor:
    """t in fp32, or in its own dtype where that is wider (float64, which
    a float64 yardstick of an fp32 computation runs in)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def shard_activations(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The reference's sequence-parallel constraint on the residual
    stream: under `cfg.seq_parallel` it asks XLA to lay (B, S, d)
    activations out with S over the model axis and B over
    `cfg.act_batch_axes` (`distributed.sharding.activation_spec`). A
    layout constraint moves no value, and the port runs a model on one
    device, where that layout cuts nothing: x is returned as it is, with
    seq_parallel or without it."""
    return x


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = at_least_fp32(x)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, positions: torch.Tensor,
                     dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the given absolute positions: (..., head_dim/2)."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2 cos).

    x: (..., S, H, D); cos/sin: (S, D/2) broadcast over batch and heads.
    """
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def swiglu(x_gate: torch.Tensor, x_up: torch.Tensor) -> torch.Tensor:
    return F.silu(x_gate) * x_up


# ---------------------------------------------------------------------------
# Parameter initialization helpers
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator | None, shape: tuple[int, ...],
               dtype, fan_in: int | None = None, *,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """N(0, 1/fan) draws (fan = shape[0] unless given) from `generator`,
    made in fp32 on `device` and cast to `dtype`. With generator=None the
    tensor is allocated and not drawn (weights that are loaded next)."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device=device)
    fan = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan, 1))
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return w.mul_(std).to(dtype)


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter of the model, kept out of autograd: serving runs the
    module as it is, and training differentiates a dict of tensors put in
    the parameters' places (`models.model.loss_fn`)."""
    return nn.Parameter(t, requires_grad=False)


def init_device(generator: torch.Generator | None,
                device: torch.device | str | None) -> torch.device:
    """Where a module's weights live: the generator's device when weights
    are drawn, else `device` (None means "cuda"; "meta" gives a module of
    shapes only, whose weights are always passed in)."""
    if generator is not None:
        return generator.device
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)
