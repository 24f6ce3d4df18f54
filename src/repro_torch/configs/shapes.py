"""The four input shapes and per-(arch, shape) input specs.

Port of `repro/configs/shapes.py`. `input_specs(cfg, shape)` returns
(resolved_cfg, step_kind, specs):
  * resolved_cfg — the config actually run (long_500k enables a
    sliding-window variant for full-attention archs),
  * step_kind — "train" | "prefill" | "decode",
  * specs — a dict of stand-ins: tensors on the `meta` device, which carry
    a shape and a dtype and allocate nothing (the reference's
    `jax.ShapeDtypeStruct`s).

Shape semantics:
  train_4k     seq_len=4096    global_batch=256   train_step
  prefill_32k  seq_len=32768   global_batch=32    serve prefill
  decode_32k   seq_len=32768   global_batch=128   ONE token, cache=seq_len
  long_500k    seq_len=524288  global_batch=1     ONE token, sub-quadratic only

Modality splits:
  vlm   — prefix_len patch embeddings + (seq - prefix) text tokens,
  audio — encoder frames = seq/2, decoder tokens = seq/2 (train/prefill);
          decode uses a 4096-frame cached encoder memory.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import model as model_lib
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

LONG_WINDOW = 4096  # sliding window enabled for full-attention archs @500k
AUDIO_DECODE_ENC_LEN = 4096


def long_context_mode(cfg: ModelConfig) -> str:
    """How this arch runs long_500k: native | window-variant | skip."""
    if cfg.arch_type in ("ssm", "hybrid"):
        return "native"          # O(1)/windowed state
    if cfg.is_encdec:
        return "skip"
    if cfg.sliding_window:
        return "native"          # mixtral
    return "window-variant"      # dense/MLA/VLM: SWA override, window 4096


def resolve(cfg: ModelConfig, shape_name: str) -> ModelConfig | None:
    """Config actually used for this shape (None = skipped pair)."""
    if shape_name != "long_500k":
        return cfg
    mode = long_context_mode(cfg)
    if mode == "skip":
        return None
    if mode == "window-variant":
        return cfg.with_overrides(sliding_window=LONG_WINDOW)
    return cfg


def _sds(shape, dtype) -> torch.Tensor:
    """A stand-in of `shape` and `dtype`: a meta tensor, no storage."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_specs(cfg: ModelConfig, B: int, S: int, with_labels: bool):
    """Token/embedding inputs for a full-sequence pass."""
    specs: dict = {}
    if cfg.is_encdec:
        S_enc = S // 2
        S_dec = S - S_enc
        specs["encoder_embeds"] = _sds((B, S_enc, cfg.d_model), cfg.dtype)
        specs["tokens"] = _sds((B, S_dec), torch.int32)
        if with_labels:
            specs["labels"] = _sds((B, S_dec), torch.int32)
        return specs
    if cfg.prefix_len:
        P = cfg.prefix_len
        specs["prefix_embeds"] = _sds((B, P, cfg.d_model), cfg.dtype)
        specs["tokens"] = _sds((B, S - P), torch.int32)
        if with_labels:
            specs["labels"] = _sds((B, S - P), torch.int32)
        return specs
    specs["tokens"] = _sds((B, S), torch.int32)
    if with_labels:
        specs["labels"] = _sds((B, S), torch.int32)
    return specs


def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def decode_state_specs(cfg: ModelConfig, B: int, seq_len: int):
    """The serve state of `init_serve_state` on the meta device: every
    cache a stand-in, nothing allocated (decode_32k's 128 x 32768 caches
    included)."""
    C = cache_len_for(cfg, seq_len)
    enc_len = AUDIO_DECODE_ENC_LEN if cfg.is_encdec else 0
    return model_lib.init_serve_state(cfg, B, C, enc_len=enc_len,
                                      device="meta")


def input_specs(cfg: ModelConfig, shape_name: str):
    """-> (resolved_cfg, step_kind, specs dict) or (None, None, None) if
    the pair is skipped."""
    shape = SHAPES[shape_name]
    rcfg = resolve(cfg, shape_name)
    if rcfg is None:
        return None, None, None
    B, S = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        return rcfg, "train", _token_specs(rcfg, B, S, with_labels=True)
    if shape.kind == "prefill":
        return rcfg, "prefill", _token_specs(rcfg, B, S, with_labels=False)

    specs = {
        "token": _sds((B, 1), torch.int32),
        "position": _sds((), torch.int32),
        "state": decode_state_specs(rcfg, B, S),
    }
    return rcfg, "decode", specs
