"""Architecture registry: `--arch <id>` resolution."""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

_ARCH_MODULES = {
    "qwen3-1.7b": "repro_torch.configs.qwen3_1p7b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2p7b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
}


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


def get_krr_config(setup: str = "synthetic"):
    """One of the paper's kernel-ridge setups (`configs.coke_krr`)."""
    from repro_torch.configs.coke_krr import PAPER_SETUPS
    return PAPER_SETUPS[setup]
