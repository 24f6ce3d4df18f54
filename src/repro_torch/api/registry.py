"""Solver registry — where an algorithm plugs into `repro_torch.api`.

The port registers the two ADMM solvers, `dkla` (Algorithm 1) and `coke`
(Algorithm 2). The reference's other solvers raise NotImplementedError
naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class Solver(Protocol):
    """What a registered algorithm gives the fused backend: its registry
    name, its consensus strategy and its view of the comm policy."""

    name: str
    consensus_strategy: str

    def _policy(self, ctx): ...


_REGISTRY: dict[str, Solver] = {}

#: reference solvers not ported yet -> the ROADMAP.md item that ports them
_LATER = {
    "cta": "ROADMAP.md Queue 1 item 3 (simulator backend and its solvers)",
    "ridge_oracle": "ROADMAP.md Queue 1 item 3 (simulator backend and its "
                    "solvers)",
    "online_dkla": "ROADMAP.md Queue 1 item 9 (streaming)",
    "online_coke": "ROADMAP.md Queue 1 item 9 (streaming)",
    "qc_odkla": "ROADMAP.md Queue 1 item 9 (streaming)",
}


def register_solver(name: str):
    """Class decorator: instantiate the class and file it under `name`."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls()
        return cls

    return deco


def _ensure_builtin_solvers() -> None:
    from repro_torch.api import solvers  # noqa: F401  (registers on import)


def get_solver(name: str) -> Solver:
    _ensure_builtin_solvers()
    if name in _LATER:
        raise NotImplementedError(
            f"solver {name!r} is not ported yet: {_LATER[name]}")
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown solver {name!r}; registered solvers: "
            f"{', '.join(sorted(_REGISTRY))}") from None


def list_solvers() -> list[str]:
    _ensure_builtin_solvers()
    return sorted(_REGISTRY)
