"""Architecture registry: `--arch <id>` resolution.

Lists only the architectures the port runs. The reference's other ids
raise KeyError naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import LATER_ARCHS, ModelConfig

_ARCH_MODULES = {
    "qwen3-1.7b": "repro_torch.configs.qwen3_1p7b",
}


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"arch {name!r} is not in the port, which runs "
                       f"{list_archs()}; the reference's other "
                       f"architectures come with {LATER_ARCHS}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


def get_krr_config(setup: str = "synthetic"):
    """One of the paper's kernel-ridge setups (`configs.coke_krr`)."""
    from repro_torch.configs.coke_krr import PAPER_SETUPS
    return PAPER_SETUPS[setup]
