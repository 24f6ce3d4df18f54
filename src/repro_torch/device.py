"""Device resolution for the port's entry points.

`fit`, `build_problem` and `KernelModel.load` take `device=None`, which
means "cuda": the port runs on the card. When no card is present they
raise, unless the caller asks for the CPU explicitly with device="cpu"
(the plain PyTorch versions then run). Nothing falls back quietly.
"""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    return dev
