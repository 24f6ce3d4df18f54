"""Solver registry — where an algorithm plugs into `repro_torch.api`.

The port registers the reference's solvers: the two ADMM solvers, `dkla`
(Algorithm 1) and `coke` (Algorithm 2), the `cta` diffusion baseline, the
streaming family (`online_dkla`, `online_coke`, `qc_odkla`) and the
centralized `ridge_oracle`.
"""
from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import torch


@runtime_checkable
class Solver(Protocol):
    """The contract every registered algorithm implements.

    `prepare_host` and `prepare_traced` run once per fit (host-side
    precomputation such as the Metropolis weights; device-side such as
    the per-agent Cholesky factors); `step` and `metrics` run once per
    iteration on the simulator backend. The spmd and fused backends read
    `consensus_strategy` (and `_policy` for comm-aware solvers). A solver
    without a (21a) primal subproblem sets `primal_aware = False`."""

    #: registry key, filled in by @register_solver
    name: str
    #: subset of {"simulator", "spmd", "fused"} this solver can run on
    backends: tuple[str, ...]
    #: distributed.consensus strategy for the spmd / fused backends, or
    #: None when only the simulator applies
    consensus_strategy: str | None
    #: whether the solver threads a core.comm policy through its broadcast
    comm_aware: bool
    # capability flags the admission table reads (api/capabilities.py),
    # absent = False: topology_aware, primal_aware, gossip_aware,
    # personalization_aware, streaming (+ stream_backends)

    def prepare_host(self, problem: Any, ctx: Any) -> Any: ...

    def prepare_traced(self, problem: Any, ctx: Any, host_aux: Any) -> Any: ...

    def init_state(self, problem: Any, ctx: Any) -> Any: ...

    def step(self, problem: Any, ctx: Any, aux: Any, state: Any) -> Any: ...

    def metrics(self, problem: Any, ctx: Any, aux: Any,
                state: Any) -> dict[str, torch.Tensor]: ...

    def theta_of(self, state: Any) -> torch.Tensor: ...


_REGISTRY: dict[str, Solver] = {}


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
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown solver {name!r}; registered solvers: "
            f"{', '.join(sorted(_REGISTRY))}") from None


def list_solvers() -> list[str]:
    _ensure_builtin_solvers()
    return sorted(_REGISTRY)
