"""Solver registry — where an algorithm plugs into `repro_torch.api`.

The port registers the two ADMM solvers, `dkla` (Algorithm 1) and `coke`
(Algorithm 2), the `cta` diffusion baseline and the centralized
`ridge_oracle`. The reference's streaming solvers are not ported yet:
`get_solver` raises NotImplementedError naming the ROADMAP.md item, and
`solver_spec` gives their capability flags, so that the capability table
rejects a combination the reference rejects with the reference's
ValueError before it says "not ported".
"""
from __future__ import annotations

import dataclasses
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

#: reference solvers not ported yet -> the ROADMAP.md item that ports them
_LATER = {
    "online_dkla": "ROADMAP.md Queue 1 item 9 (streaming)",
    "online_coke": "ROADMAP.md Queue 1 item 9 (streaming)",
    "qc_odkla": "ROADMAP.md Queue 1 item 9 (streaming)",
}


@dataclasses.dataclass(frozen=True)
class _StreamingSpec:
    """The reference's capability flags of a streaming solver, which the
    port does not run yet: the admission table reads them."""

    name: str
    backends: tuple = ("simulator",)
    stream_backends: tuple = ("simulator", "spmd")
    streaming: bool = True
    consensus_strategy: None = None
    comm_aware: bool = True
    topology_aware: bool = False
    gossip_aware: bool = True
    personalization_aware: bool = True


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


def solver_spec(name: str):
    """The registered solver, or the capability flags of a reference
    solver not ported yet (for the admission table); KeyError otherwise."""
    if name in _LATER:
        return _StreamingSpec(name)
    return get_solver(name)


def all_solver_names() -> list[str]:
    """Every solver name of the reference's registry the port knows:
    the ported ones and those not ported yet."""
    return sorted(set(list_solvers()) | set(_LATER))
