"""Roofline terms and model-flop counts.

Port of `repro/launch/analysis.py`, with the H100's figures in place of
the reference's TPU constants. Three terms per step, per device, in
seconds:

  compute    = flops_per_device / PEAK_FLOPS[dtype]
  memory     = bytes_per_device / HBM_BW
  collective = collective_bytes_per_device / NVLINK_BW

`collective_bytes` parses a compiled program's HLO text, the reference's
parser unchanged: the port compiles no HLO, so it reads text that XLA
wrote (the reference's dry run, or the snippets of its tests).
`count_params`, `active_params` and `model_flops` count over the port's
parameter dicts ({name: tensor}, `models.model.param_dict` or the meta
tensors of `models.model.param_shapes`); `efficiency` is the
reference's.

Hardware figures, NVIDIA H100 SXM5 80GB (the card `chip_smoke.py` runs
on), dense peaks from NVIDIA's H100 Tensor Core GPU data sheet, the same
that `chip_smoke.py`'s bounds use:
  fp32 on the CUDA cores  67 TFLOP/s
  TF32 on the tensor cores  494.7 TFLOP/s
  bf16 / fp16 on the tensor cores  989 TFLOP/s
  HBM3  3.35 TB/s
  NVLink 4  18 links x 25 GB/s each way = 450 GB/s each way (900 GB/s
            both ways, the data sheet's figure). A device's collectives
            run over all its links at once (NCCL rings and trees), so the
            term divides by the sum; the reference divides by one ICI link.
"""
from __future__ import annotations

import math
import re

import torch

# dense peaks by the dtype of the operands (NVIDIA H100 SXM5 data sheet)
PEAK_FLOPS = {
    torch.float32: 67e12,        # CUDA cores
    "tf32": 494.7e12,            # tensor cores, fp32 operands as TF32
    torch.bfloat16: 989e12,      # tensor cores
    torch.float16: 989e12,       # tensor cores
}
HBM_BW = 3.35e12                 # bytes/s, HBM3 (data sheet)
NVLINK_LINKS = 18                # NVLink 4 links per H100 SXM5
NVLINK_LINK_BW = 25e9            # bytes/s per link, each way
NVLINK_BW = NVLINK_LINKS * NVLINK_LINK_BW   # bytes/s, each way

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1,
    "f8e5m2": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# `bf16[2,128,1024]{2,1,0}` (layout suffix optional); scalars: `f32[]`
_SHAPE_RE = re.compile(r"\b([a-z]\d*[a-z]*\d*)\[([\d,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def collective_bytes(hlo_text: str) -> dict[str, int]:
    """Per-collective-kind operand bytes (per-device program)."""
    out = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        stripped = line.strip()
        m = re.search(r"=\s*(?:\([^)]*\)|\S+)\s+([a-z\-]+)", stripped)
        if not m:
            continue
        op = m.group(1)
        kind = next((k for k in _COLLECTIVES if op == k or
                     op.startswith(k + "-start")), None)
        if kind is None:
            continue
        # operand shapes: everything inside the top-level call parens
        paren = stripped.find("(", m.end())
        if paren < 0:
            continue
        args = stripped[paren:]
        # stop at metadata to avoid counting shapes in attributes
        for stop in ("replica_groups", "source_target_pairs", "metadata",
                     "channel_id", "dimensions"):
            idx = args.find(stop)
            if idx > 0:
                args = args[:idx]
                break
        for dt, dims in _SHAPE_RE.findall(args):
            out[kind] += _shape_bytes(dt, dims)
    return out


def roofline(cost: dict, coll_bytes: dict[str, int],
             dtype=torch.bfloat16) -> dict:
    """The three terms of a step whose operations run at `dtype`'s peak
    (`PEAK_FLOPS`; the reference's one bf16 peak is the default)."""
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    cbytes = float(sum(coll_bytes.values()))
    compute_t = flops / PEAK_FLOPS[dtype]
    memory_t = bytes_accessed / HBM_BW
    coll_t = cbytes / NVLINK_BW
    terms = {"compute": compute_t, "memory": memory_t,
             "collective": coll_t}
    dominant = max(terms, key=terms.get)
    return {
        "flops_per_device": flops,
        "bytes_per_device": bytes_accessed,
        "collective_bytes_per_device": cbytes,
        "collective_breakdown": coll_bytes,
        "compute_s": compute_t,
        "memory_s": memory_t,
        "collective_s": coll_t,
        "dominant": dominant,
        "step_s_lower_bound": max(terms.values()),
    }


def count_params(shapes: dict) -> int:
    """Elements over a {name: tensor} dict (meta tensors count alike)."""
    return sum(math.prod(t.shape) for t in shapes.values())


def active_params(cfg, shapes: dict) -> int:
    """Active (per-token) params: MoE counts top_k + shared experts only.
    The port keeps each layer's leaves apart (blocks.3.moe.w_gate), so an
    expert leaf is (E, ...) where the reference's stack is (L, E, ...):
    the test is the same on the trailing dims."""
    total = 0
    for name, leaf in shapes.items():
        keys = name.split(".")
        n = math.prod(leaf.shape)
        if cfg.is_moe and any(k in ("w_gate", "w_up", "w_down")
                              for k in keys) and leaf.ndim >= 3 \
                and leaf.shape[-3] == cfg.num_experts:
            n = n * cfg.top_k // cfg.num_experts
        total += n
    return total


def model_flops(cfg, kind: str, global_batch: int, seq_len: int,
                n_active: int) -> float:
    """6*N*D (train) or 2*N*D (forward-only), D = tokens per step.

    Enc-dec: a token traverses only its branch (~half the params), so the
    effective N*D halves (enc tokens never see the decoder and vice versa).
    """
    branch = 0.5 if getattr(cfg, "encoder_layers", 0) else 1.0
    if kind == "train":
        return 6.0 * n_active * branch * global_batch * seq_len
    if kind == "prefill":
        return 2.0 * n_active * branch * global_batch * seq_len
    return 2.0 * n_active * branch * global_batch  # decode: one new token


def efficiency(cost_flops_per_device: float, num_devices: int,
               mflops: float) -> float:
    """MODEL_FLOPS / counted FLOPS (global) — >1 impossible; <<1 = waste
    (recompute, the attention's quadratic term, dispatch overhead)."""
    hlo_global = cost_flops_per_device * num_devices
    return mflops / hlo_global if hlo_global else 0.0
