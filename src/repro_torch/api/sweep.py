"""`sweep` — a grid of communication policies fitted as one lane-batched
simulator loop, with per-cell models (the reference's `api/sweep.py`).

The paper's tuning protocol is a grid search over h(k) = v mu^k; QC-ODKLA
adds a quantization axis. The reference `vmap`s its compiled fit over the
stacked policies. The port's fit loop is eager and host-bound, so running
the G cells in turn would cost G times the host time: it runs them as one
batch on a leading lane axis instead. Every state tensor is (G, N, D), the
policies are one `core.comm.LaneChain`, and an iteration of the grid takes
about as many launches as an iteration of one fit. The problem's Cholesky
factors are made once and shared by every lane.

    sw = sweep(FitConfig(algorithm="coke", num_iters=500), grid)
    mses = sw.evaluate(x_test, y_test)["test_mse"]        # (G,)
    idx, model = sw.select(x_test, y_test)                # operating point

Grid cells may be (v, mu) pairs, (v, mu, bits) triples, or `core.comm`
policies (Chain / stage / stage sequence) of one shared structure. A
personalized sweep replays fit()'s phased program on the lanes: the
warmup phase is the static sweep itself; at the boundary every lane's
carry gets the starting graph, and from then on each lane learns its own
(G, N, N) graph from its own thetas. The policy-unaware solvers (cta, ridge_oracle) ignore the cells: they run once
and every lane holds that run, as every lane of the reference's vmap
computes the same thing.
"""
from __future__ import annotations

import dataclasses
from numbers import Number
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from repro_torch.api.capabilities import check_sweep
from repro_torch.api.config import FitConfig, FitResult
from repro_torch.api.fit import (_phased_runner, _simulator_runner,
                                 _solve_context, phase_plan)
from repro_torch.api.model import KernelModel
from repro_torch.api.problems import build_problem
from repro_torch.api.registry import get_solver
from repro_torch.core import comm as comm_mod
from repro_torch.core.admm import Problem
from repro_torch.device import resolve_device


def _cell_to_policy(cell) -> comm_mod.Chain:
    """One grid cell -> a Chain. (v, mu) pairs and (v, mu, bits) triples
    are shorthand for Censor / Censor+Quantize chains."""
    if isinstance(cell, (comm_mod.Chain, *comm_mod.STAGE_TYPES)):
        return comm_mod.as_chain(cell)
    if isinstance(cell, (tuple, list)):
        cell = tuple(cell)
        if cell and all(isinstance(x, Number) for x in cell):
            if len(cell) == 2:
                v, mu = cell
                return comm_mod.Chain((comm_mod.Censor(float(v),
                                                       float(mu)),))
            if len(cell) == 3:
                v, mu, bits = cell
                return comm_mod.Chain((comm_mod.Censor(float(v), float(mu)),
                                       comm_mod.Quantize(float(bits))))
            raise ValueError(
                f"numeric grid cells must be (v, mu) or (v, mu, bits), "
                f"got {cell!r}")
        return comm_mod.as_chain(cell)  # a sequence of stages
    try:
        return comm_mod.as_chain(cell)  # CensorSchedule, None, ...
    except TypeError:
        raise ValueError(
            f"not a sweepable policy cell: {cell!r}") from None


def _grid_from_configs(configs: Sequence[FitConfig]):
    base = configs[0]
    for c in configs[1:]:
        if c.replace(censor_v=base.censor_v, censor_mu=base.censor_mu,
                     comm=base.comm) != base:
            raise ValueError(
                "sweep over a config list requires the configs to differ "
                "only in their communication policy (censor_v/censor_mu/"
                f"comm); differing cell: {c}")
    return base, [c.resolved_comm for c in configs]


def _lanes(x: torch.Tensor, g: int) -> torch.Tensor:
    return x.unsqueeze(0).expand(g, *x.shape)


def sweep(configs_or_base: FitConfig | Sequence[FitConfig],
          grid: Iterable | None = None, *, problem: Problem | None = None,
          device: torch.device | str | None = None) -> "SweepResult":
    """Fit one problem under a grid of communication policies in one
    lane-batched simulator loop.

    configs_or_base — a base `FitConfig` (policies come from `grid`), or a
                      sequence of FitConfigs that differ only in their
                      communication policy.
    grid            — iterable of cells: (v, mu) pairs, (v, mu, bits)
                      triples, or `core.comm` policies with one shared
                      structure; required with a base config.
    problem         — an existing `core.admm.Problem` (moved to `device`);
                      None builds one from the base config (and the
                      per-cell models inherit its RFF map).
    device          — None = "cuda" (raises when no card is present).

    The capability table admits the base config first, before the grid is
    read and before the device is resolved: a config the reference's table
    rejects raises its ValueError on any machine.
    """
    if isinstance(configs_or_base, FitConfig):
        base = configs_or_base
        check_sweep(base, get_solver(base.algorithm))
        if grid is None:
            raise ValueError("sweep(base_config) requires a policy grid")
        cells = [_cell_to_policy(c) for c in grid]
    else:
        if grid is not None:
            raise ValueError("pass either a config list or a base config "
                             "with a grid, not both")
        base, cells = _grid_from_configs(list(configs_or_base))
        check_sweep(base, get_solver(base.algorithm))
    if not cells:
        raise ValueError("empty policy grid")
    solver = get_solver(base.algorithm)
    stacked = comm_mod.stack_policies(cells)

    dev = resolve_device(device)
    rff_params = None
    if problem is None:
        built = build_problem(base, device=dev)
        problem, rff_params = built.problem, built.rff_params
    elif problem.device != dev:
        problem = problem.to(dev)
    G = len(cells)
    # under exec="gossip" each lane draws its own participation: the draw
    # folds the lane's chain key, which folds every numeric policy
    # parameter of its cell
    ctx = _solve_context(base, problem.device, problem.feats.dtype,
                         problem.num_agents)
    if solver.comm_aware:   # the policy lanes as one batch
        ctx = dataclasses.replace(ctx, comm=stacked)

    carry0, chunk_fn, theta_fn = _phased_runner(
        lambda c: _simulator_runner(solver, problem, c, None),
        phase_plan(ctx, base.resolved_iters, problem.adjacency))
    state, hist = chunk_fn(carry0, base.resolved_iters)
    theta = theta_fn(state)
    if solver.comm_aware:   # (iters, G, ...) -> (G, iters, ...)
        history = {k: v.transpose(0, 1).contiguous()
                   for k, v in hist.items()}
    else:                   # one run, held by every lane
        history = {k: _lanes(v, G) for k, v in hist.items()}
        theta = _lanes(theta, G)
    censors = torch.tensor(
        [FitConfig(krr=base.krr, comm=c).resolved_censor for c in cells],
        dtype=torch.float32, device=problem.device)
    return SweepResult(config=base, censors=censors, thetas=theta,
                       history=history, rff_params=rff_params,
                       policies=tuple(cells))


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """G policy cells fitted on one problem, ready to compare."""

    config: FitConfig
    censors: torch.Tensor               # (G, 2): [v, mu] per cell
    thetas: torch.Tensor                # (G, N, D) final per-agent params
    history: dict[str, torch.Tensor]    # each (G, num_iters)
    rff_params: Any = None
    policies: tuple = ()                # (G,) core.comm.Chain per cell

    def __len__(self) -> int:
        return self.thetas.shape[0]

    def cell_config(self, i: int) -> FitConfig:
        if self.policies:
            return self.config.replace(comm=self.policies[i],
                                       censor_v=None, censor_mu=None)
        v, mu = (float(x) for x in self.censors[i])
        return self.config.replace(censor_v=v, censor_mu=mu)

    def model(self, i: int, rff_params=None, *,
              include_per_agent: bool = True) -> KernelModel:
        """Export cell i as a deployable `KernelModel`."""
        params = self.rff_params if rff_params is None else rff_params
        res = FitResult(config=self.cell_config(i), state=None,
                        history={k: v[i] for k, v in self.history.items()},
                        theta=self.thetas[i], rff_params=params)
        return res.to_model(include_per_agent=include_per_agent)

    def models(self, rff_params=None, *,
               include_per_agent: bool = True) -> list[KernelModel]:
        """Export every cell as a deployable `KernelModel`."""
        return [self.model(i, rff_params,
                           include_per_agent=include_per_agent)
                for i in range(len(self))]

    def evaluate(self, x, y, *, backend: str = "ref",
                 rff_params=None) -> dict[str, torch.Tensor]:
        """Per-cell held-out metrics: test_mse (G,), final train_mse (G,),
        final cumulative comms (G,) and bits (G,).

        The test set is featurized once (one K1 launch with
        backend="fused") and scored against the stacked (G, N, D) thetas:
        every cell shares the problem's RFF map. With per-agent x (N, S, d)
        agent n scores its shard with theta_{g,n}; with flat x (S, d) every
        cell scores with its consensus average."""
        probe = self.model(0, rff_params)    # carries the shared RFF map
        x = probe._as_input(x)
        y = probe._as_input(y)
        phi = probe.featurize(x, backend)
        if x.ndim == 3:
            preds = torch.einsum("nsd,gnd->gns", phi, self.thetas)
        else:
            theta_bar = torch.mean(self.thetas, dim=1)        # (G, D)
            preds = torch.einsum("sd,gd->gs", phi, theta_bar)
        mses = torch.mean((y[None] - preds) ** 2,
                          dim=tuple(range(1, preds.ndim)))
        out = {"test_mse": mses,
               "train_mse": self.history["train_mse"][:, -1],
               "comms": self.history["comms"][:, -1]}
        if "bits" in self.history:
            out["bits"] = self.history["bits"][:, -1]
        return out

    def select(self, x, y, *, max_mse_gap: float = 0.01,
               rff_params=None) -> tuple[int, KernelModel]:
        """The paper's operating-point rule, extended to the bits axis:
        among cells whose test MSE is within `max_mse_gap` (relative) of
        the best cell, pick the one that paid the fewest cumulative bits;
        ties break on fewest transmissions, then on the lowest cell index.
        Histories without a `bits` trajectory rank on (comms, index)
        alone, never on transmission counts taken for bits."""
        ev = self.evaluate(x, y, rff_params=rff_params)
        mses = ev["test_mse"].cpu()
        comms = ev["comms"].cpu()
        bits = ev.get("bits")
        best = float(torch.min(mses))
        cutoff = best * (1.0 + max_mse_gap) + 1e-12
        if bits is None:   # no bit accounting: fewest transmissions wins
            candidates = [(float(comms[i]), i)
                          for i in range(len(self))
                          if float(mses[i]) <= cutoff]
        else:
            bits = bits.cpu()
            candidates = [(float(bits[i]), float(comms[i]), i)
                          for i in range(len(self))
                          if float(mses[i]) <= cutoff]
        if not candidates:
            raise ValueError(
                "no sweep cell qualifies for selection — every test MSE is "
                f"non-finite or above the cutoff ({cutoff!r}); the fits "
                "likely diverged (check rho / learning rates): "
                f"test_mse={np.asarray(mses)!r}")
        idx = min(candidates)[-1]
        return idx, self.model(idx, rff_params)
