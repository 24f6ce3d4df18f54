"""`FitConfig` / `FitResult` — the run description and the run record.

`FitConfig` has the reference's fields and defaults, so a config reads the
same in both packages. Its construction runs the capability table's
solver-free rules (`api/capabilities.check_config`), as the reference's
does; `fit` runs the rest, and raises NotImplementedError, naming the
ROADMAP.md item, for any part of a config this port does not run yet.
A personalized fit's `FitResult` deploys as one `KernelModel` per agent
(`to_models`, `publish_models`); `to_model` refuses it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.api.capabilities import check_config
from repro_torch.configs.coke_krr import KRRConfig
from repro_torch.core import comm as comm_mod
from repro_torch.core.admm import PRIMAL_MODES
from repro_torch.core.gossip import EXEC_MODES, ChurnSchedule, GossipPlan
from repro_torch.core.graph import TopologySchedule
from repro_torch.core.personalize import Personalization
from repro_torch.data.synthetic import STREAM_KINDS

BACKENDS = ("simulator", "spmd", "fused")


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

    # execution semantics: "sync" | "gossip" (per iteration a
    # Bernoulli(participation) or fixed-size (gossip_size) sample of agents
    # steps and broadcasts; churn: a core.gossip.ChurnSchedule of straggler
    # slowdowns and join/leave events)
    exec: str = "sync"
    participation: float = 1.0
    gossip_size: int | None = None
    churn: ChurnSchedule | None = None
    topology: TopologySchedule | None = None
    # learned collaboration graph: a core.personalize.Personalization
    personalization: Personalization | None = None

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
        if self.exec == "gossip":
            if not 0.0 < self.participation <= 1.0:
                raise ValueError(
                    f"participation must be in (0, 1], got "
                    f"{self.participation}")
            if self.gossip_size is not None and self.gossip_size < 1:
                raise ValueError(
                    f"gossip_size must be >= 1 or None, got "
                    f"{self.gossip_size}")
            if self.churn is not None and not isinstance(self.churn,
                                                         ChurnSchedule):
                raise ValueError(
                    "churn must be a repro_torch.core.gossip.ChurnSchedule, "
                    f"got {type(self.churn).__name__}")
        if self.personalization is not None and not isinstance(
                self.personalization, Personalization):
            raise ValueError(
                "personalization must be a repro_torch.core.personalize."
                "Personalization, got "
                f"{type(self.personalization).__name__}")
        # the cross-axis admission: one declarative table, shared with the
        # drivers' solver-scoped checks and the README matrix
        check_config(self)
        if self.comm is not None:
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
    """The solver-facing slice of a FitConfig that this port's path reads;
    `gossip` is the run's `core.gossip.GossipPlan` under exec="gossip".
    `pz_warmup` marks the warmup phase of a personalized fit
    (`api.fit.phase_plan`): that phase runs the static-graph program
    itself, so its iterations are bitwise a run without personalization."""

    comm: comm_mod.Chain
    primal: str = "auto"
    inner_steps: int = 50
    inner_lr: float = 0.1
    cg_tol: float = 1e-8
    cg_maxiter: int = 64
    cta_lr: float = 0.9
    online_lr: float = 0.3
    online_batch: int = 16
    qc_eta: float | None = None
    topology: TopologySchedule | None = None
    gossip: GossipPlan | None = None    # set exactly under exec="gossip"
    personalization: Personalization | None = None
    pz_warmup: bool = False

    @classmethod
    def from_config(cls, config: FitConfig, num_agents: int | None = None,
                    device: torch.device | str = "cpu") -> "SolveContext":
        """The context of `config`; under exec="gossip" its participation
        and churn plan is made for `num_agents` agents on `device`."""
        gossip = None
        if config.exec == "gossip":
            if num_agents is None:
                raise ValueError(
                    "exec='gossip' needs the agent count to compile its "
                    "participation/churn plan; pass num_agents")
            sched = config.churn if config.churn is not None \
                else ChurnSchedule()
            gossip = sched.plan(num_agents,
                                participation=config.participation,
                                size=config.gossip_size, device=device)
        return cls(comm=config.resolved_comm, primal=config.primal,
                   inner_steps=config.inner_steps, inner_lr=config.inner_lr,
                   cg_tol=config.cg_tol, cg_maxiter=config.cg_maxiter,
                   cta_lr=config.cta_lr, online_lr=config.online_lr,
                   online_batch=config.online_batch, qc_eta=config.qc_eta,
                   topology=config.topology, gossip=gossip,
                   personalization=config.personalization)


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

    @property
    def learned_adjacency(self) -> torch.Tensor | None:
        """The final learned collaboration graph of a personalized fit
        ((N, N) weighted, symmetric, zero diagonal); None when the run was
        not personalized."""
        if self.config.personalization is None:
            return None
        A = getattr(self.state, "adjacency", None)   # simulator states
        if A is not None:
            return A
        if isinstance(self.state, tuple):   # spmd: (params, cstate) carry
            return self.state[1]["adjacency"]
        return None

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

    def _resolved_rff(self, rff_params):
        params = self.rff_params if rff_params is None else rff_params
        if params is None:
            raise ValueError(
                "this FitResult has no RFF parameters (fit() was given a "
                "pre-built problem); pass them explicitly: "
                "result.to_model(built.rff_params)")
        return params

    def to_model(self, rff_params=None, *, include_per_agent: bool = True):
        """Package the fitted thetas with their RFF map into a deployable
        `KernelModel`. `rff_params` is required when fit() was handed a
        pre-built problem. A personalized fit raises: use `to_models`."""
        from repro_torch.api.model import KernelModel  # local: import cycle

        if self.config.personalization is not None:
            raise ValueError(
                "this fit was personalized: its per-agent thetas were "
                "never meant to agree, and consensus-averaging them "
                "destroys the per-cluster models — use to_models() (one "
                "KernelModel per agent) or index result.theta yourself")
        params = self._resolved_rff(rff_params)
        krr = self.config.krr
        return KernelModel(
            rff_params=params,
            theta=torch.mean(self.theta, dim=0),
            thetas=self.theta if include_per_agent else None,
            bandwidth=krr.bandwidth, kernel="gaussian",
            meta=self._model_meta())

    def to_models(self, rff_params=None) -> list:
        """One deployable `KernelModel` per agent, the personalized serving
        path (on a consensus fit the N models are near-identical). Model i
        predicts with theta_i alone; its meta records the agent index and
        the personalization knobs. Each model's `predict` / `evaluate` with
        backend="fused" featurizes through K1."""
        from repro_torch.api.model import KernelModel  # local: import cycle

        params = self._resolved_rff(rff_params)
        krr = self.config.krr
        meta = self._model_meta()
        pz = self.config.personalization
        if pz is not None:
            meta["personalization"] = {
                "k": pz.k, "every": pz.every, "warmup": pz.warmup,
                "affinity": pz.affinity, "scale": float(pz.scale)}
        return [KernelModel(rff_params=params, theta=self.theta[i],
                            thetas=None, bandwidth=krr.bandwidth,
                            kernel="gaussian", meta={**meta, "agent": i})
                for i in range(self.theta.shape[0])]

    def publish_models(self, registry, *, prefix: str = "agent",
                       rff_params=None) -> list[tuple[str, int]]:
        """Publish every per-agent model into a model registry (any object
        with `publish(model_id, model) -> version`) as `{prefix}-{i:03d}`;
        returns [(model_id, version), ...]."""
        out = []
        for i, model in enumerate(self.to_models(rff_params)):
            model_id = f"{prefix}-{i:03d}"
            out.append((model_id, registry.publish(model_id, model)))
        return out
