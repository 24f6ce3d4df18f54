"""`FitConfig` / `FitResult` — the run description and the run record.

`FitConfig` has the reference's fields and defaults, so a config reads the
same in both packages; `fit` raises NotImplementedError, naming the
ROADMAP.md item, for any part of it this port does not run yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.coke_krr import KRRConfig
from repro_torch.core import comm as comm_mod
from repro_torch.core.admm import PRIMAL_MODES
from repro_torch.data.synthetic import STREAM_KINDS

BACKENDS = ("simulator", "spmd", "fused")
EXEC_MODES = ("sync", "gossip")


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Everything `fit()` needs to run one algorithm on one problem."""

    algorithm: str = "coke"          # registry key: see list_solvers()
    krr: KRRConfig = KRRConfig()     # dataset / RF / lam / rho / graph_p spec
    backend: str = "simulator"       # simulator | spmd | fused

    # communication policy: a core.comm Chain / stage / CensorSchedule.
    # None = the legacy censor knobs below, i.e. Chain([Censor(v, mu)]).
    comm: object | None = None
    censor_v: float | None = None
    censor_mu: float | None = None

    # execution semantics: "sync" | "gossip"
    exec: str = "sync"
    participation: float = 1.0
    gossip_size: int | None = None
    churn: object | None = None
    topology: object | None = None
    personalization: object | None = None

    num_iters: int | None = None     # None = krr.num_iters

    # primal update: "auto" | "cholesky" | "cg" | "gradient"
    primal: str = "auto"
    inner_steps: int = 50
    inner_lr: float = 0.1            # gradient primal stepsize
    cg_tol: float = 1e-8
    cg_maxiter: int = 64

    cta_lr: float = 0.9
    online_lr: float = 0.3
    online_batch: int = 16
    stream: str = "stationary"
    qc_eta: float | None = None

    # graph family ("erdos_renyi" uses krr.graph_p; the fused backend
    # requires the circulant family)
    graph: str = "erdos_renyi"       # erdos_renyi | ring | circulant | full
    graph_offsets: tuple[int, ...] = (1,)

    # fit-loop plumbing
    chunk_size: int | None = None    # iterations between host callbacks
    record_oracle_distance: bool = False

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; choose from {BACKENDS}")
        if self.primal not in PRIMAL_MODES:
            raise ValueError(
                f"unknown primal mode {self.primal!r}; choose from "
                f"{PRIMAL_MODES}")
        if self.chunk_size is not None and self.chunk_size < 1:
            raise ValueError(
                f"chunk_size must be >= 1 or None, got {self.chunk_size}")
        if self.stream not in STREAM_KINDS:
            raise ValueError(
                f"unknown stream kind {self.stream!r}; choose from "
                f"{STREAM_KINDS}")
        if self.qc_eta is not None and self.qc_eta <= 0:
            raise ValueError(
                f"qc_eta must be positive (or None to reuse online_lr), "
                f"got {self.qc_eta}")
        if self.exec not in EXEC_MODES:
            raise ValueError(
                f"unknown exec mode {self.exec!r}; choose from {EXEC_MODES}")
        if self.comm is not None:
            if self.censor_v is not None or self.censor_mu is not None:
                raise ValueError("give either comm= or the legacy "
                                 "censor_v/censor_mu knobs, not both")
            comm_mod.as_chain(self.comm)  # fail fast on non-policies

    @property
    def resolved_comm(self) -> comm_mod.Chain:
        """The communication policy as a Chain: `comm` when set, else the
        (censor_v, censor_mu) knobs, defaulting to the KRRConfig."""
        if self.comm is not None:
            return comm_mod.as_chain(self.comm)
        v, mu = self.resolved_censor
        return comm_mod.Chain((comm_mod.Censor(v, mu),))

    @property
    def resolved_censor(self) -> tuple[float, float]:
        """(v, mu) of the policy's first Censor stage ((0, 0) when the
        policy does not censor)."""
        if self.comm is not None:
            for s in comm_mod.as_chain(self.comm).stages:
                if isinstance(s, comm_mod.Censor):
                    return float(s.v), float(s.mu)
            return 0.0, 0.0
        v = self.krr.censor_v if self.censor_v is None else self.censor_v
        mu = self.krr.censor_mu if self.censor_mu is None else self.censor_mu
        return float(v), float(mu)

    @property
    def resolved_iters(self) -> int:
        return self.krr.num_iters if self.num_iters is None else self.num_iters

    def replace(self, **kw) -> "FitConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class SolveContext:
    """The solver-facing slice of a FitConfig that this port's path reads."""

    comm: comm_mod.Chain
    inner_lr: float = 0.1
    cta_lr: float = 0.9

    @classmethod
    def from_config(cls, config: FitConfig) -> "SolveContext":
        return cls(comm=config.resolved_comm, inner_lr=config.inner_lr,
                   cta_lr=config.cta_lr)


@dataclasses.dataclass(frozen=True)
class FitResult:
    """What `fit()` returns: the final carry plus per-iteration metric
    histories, each a (num_iters,) tensor on the fit's device."""

    config: FitConfig
    state: Any
    history: dict[str, torch.Tensor]
    theta: torch.Tensor              # (N, D) final per-agent parameters
    # the RFF map the thetas were trained against; set when fit() built
    # the problem itself (pass it to to_model() otherwise)
    rff_params: Any = None

    @property
    def train_mse(self) -> torch.Tensor:
        return self.history["train_mse"]

    @property
    def comms(self) -> torch.Tensor:
        return self.history["comms"]

    @property
    def bits(self) -> torch.Tensor:
        return self.history["bits"]

    @property
    def consensus_gap(self) -> torch.Tensor:
        return self.history["consensus_gap"]

    def _model_meta(self) -> dict:
        krr = self.config.krr
        v, mu = self.config.resolved_censor
        return {
            "algorithm": self.config.algorithm,
            "backend": self.config.backend,
            "exec": self.config.exec,
            "num_iters": self.config.resolved_iters,
            "censor_v": v, "censor_mu": mu,
            "comm": self.config.resolved_comm.describe(),
            "dataset": krr.dataset, "num_agents": krr.num_agents,
            "num_features": krr.num_features, "lam": krr.lam,
            "rho": krr.rho, "seed": krr.seed, "graph": self.config.graph,
            "graph_offsets": list(self.config.graph_offsets),
            "graph_p": krr.graph_p,
        }

    def to_model(self, rff_params=None, *, include_per_agent: bool = True):
        """Package the fitted thetas with their RFF map into a deployable
        `KernelModel`. `rff_params` is required when fit() was handed a
        pre-built problem."""
        from repro_torch.api.model import KernelModel  # local: import cycle

        params = self.rff_params if rff_params is None else rff_params
        if params is None:
            raise ValueError(
                "this FitResult has no RFF parameters (fit() was given a "
                "pre-built problem); pass them explicitly: "
                "result.to_model(built.rff_params)")
        krr = self.config.krr
        return KernelModel(
            rff_params=params,
            theta=torch.mean(self.theta, dim=0),
            thetas=self.theta if include_per_agent else None,
            bandwidth=krr.bandwidth, kernel="gaussian",
            meta=self._model_meta())
