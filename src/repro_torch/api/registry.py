"""Solver registry — where an algorithm plugs into `repro_torch.api`.

The port registers the two ADMM solvers, `dkla` (Algorithm 1) and `coke`
(Algorithm 2), and the `cta` diffusion baseline. The reference's other
solvers raise NotImplementedError naming the ROADMAP.md item that ports
them.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class Solver(Protocol):
    """What a registered algorithm gives `fit` and the backends: its
    registry name, the backends it runs on, its consensus strategy,
    whether it threads a comm policy and has a (21a) primal subproblem,
    and (when comm-aware) its view of the policy."""

    name: str
    backends: tuple[str, ...]
    consensus_strategy: str
    comm_aware: bool
    primal_aware: bool

    def _policy(self, ctx): ...


_REGISTRY: dict[str, Solver] = {}

#: reference solvers not ported yet -> the ROADMAP.md item that ports them
_LATER = {
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
