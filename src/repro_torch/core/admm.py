"""DKLA (Algorithm 1) and COKE (Algorithm 2) in the RF space: the problem,
and the simulator form of one iteration (the reference's `core/admm.py`).

The simulator keeps all N agents in one process on a leading batch axis and
exchanges through the adjacency (`A @ x`). The primal update (21a) has
three forms:
  cholesky — the exact solve of the quadratic loss's normal equations

      [ (2/T_i) Phi_i' Phi_i + (2 lam/N + 2 rho |N_i|) I ] theta
            = (2/T_i) Phi_i' y_i - gamma_i + rho (|N_i| theta_hat_i
                                                 + sum_n theta_hat_n)

             through per-agent Cholesky factors made once per fit;
  cg       — the same system matrix-free: Jacobi-preconditioned conjugate
             gradients whose operator is Phi_i' (Phi_i v), warm-started
             from the previous iterate, step for step the reference's
             `jax.scipy.sparse.linalg.cg` under `vmap`;
  gradient — `inner_steps` gradient steps on the augmented objective (any
             loss).
The ring runtimes (`distributed/consensus.py`) run the one-step gradient
primal, or `_primal_cg` through their `primal_solve` hook; the fused
megakernel path runs the gradient primal inside `coke_megastep` (K2).

Every form also runs a sweep's G policy lanes at once: theta, theta_hat
and gamma (G, N, D) against one problem. The lanes share the problem's
Cholesky factors (no per-lane copy: the triangular solves take the G lanes
as G right-hand sides) and its Phi (the CG and gradient products take the
lanes as G columns).

On a mesh (`fit(mesh=)`) Phi, theta, theta_hat and gamma are feature-
sharded `distributed.sharding.Blocked` tensors: CG's Phi v is the psum of
Phi_s v_s over the feature blocks and Phi' r stays block-local, its inner
products are psums; the gradient primal's Phi theta is a psum and its
gradient block-local; the Cholesky primal gathers each agent block's
feature blocks for its (D, D) factor and the triangular solves, then cuts
the solution back into blocks.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import torch

from repro_torch.core import comm as comm_mod
from repro_torch.core import losses as losses_mod
from repro_torch.core import step as step_mod
from repro_torch.core.censor import CensorSchedule
from repro_torch.core.graph import Graph
from repro_torch.distributed import sharding

#: primal modes FitConfig accepts (as in the reference)
PRIMAL_MODES = ("auto", "cholesky", "cg", "gradient")
#: feature count above which primal="auto" picks CG over Cholesky
CG_CROSSOVER_DIM = 2048


def resolve_primal(primal: str, feature_dim: int, loss: str) -> str:
    """Resolve a FitConfig primal mode to the concrete update that runs.

    auto     -> "cholesky" up to CG_CROSSOVER_DIM features, "cg" above;
                general losses have no normal equations and fall back to
                "gradient".
    cholesky / cg -> forced; both solve (21a) and require the quadratic
                loss (ValueError otherwise).
    gradient -> the inexact gradient primal (any loss).
    """
    if primal not in PRIMAL_MODES:
        raise ValueError(
            f"unknown primal mode {primal!r}; choose from {PRIMAL_MODES}")
    if loss != "quadratic":
        if primal in ("cholesky", "cg"):
            raise ValueError(
                f"primal={primal!r} solves the quadratic-loss (21a) normal "
                f"equations; loss={loss!r} has none — use primal='gradient'")
        return "gradient"
    if primal == "auto":
        return "cg" if feature_dim > CG_CROSSOVER_DIM else "cholesky"
    return primal


@dataclasses.dataclass(frozen=True)
class Problem:
    """feats (N, T_i, D) RF-mapped local data (equal shards), labels
    (N, T_i), adjacency (N, N), the global ridge lambda (split lam/N per
    agent), the ADMM penalty rho and the loss name."""

    feats: torch.Tensor
    labels: torch.Tensor
    adjacency: torch.Tensor
    lam: float
    rho: float
    loss: str = "quadratic"

    @property
    def num_agents(self) -> int:
        return self.feats.shape[0]

    @property
    def feature_dim(self) -> int:
        return self.feats.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.feats.device

    @property
    def degrees(self) -> torch.Tensor:
        """Row sums of the adjacency: (N,), or (G, N) over a sweep's
        per-lane learned graphs (G, N, N)."""
        return torch.sum(self.adjacency, dim=-1)

    def to(self, device) -> "Problem":
        return dataclasses.replace(
            self, feats=self.feats.to(device),
            labels=self.labels.to(device),
            adjacency=self.adjacency.to(device))


def make_problem(feats: torch.Tensor, labels: torch.Tensor, graph: Graph,
                 lam: float, rho: float, loss: str = "quadratic") -> Problem:
    return Problem(
        feats=feats, labels=labels,
        adjacency=torch.as_tensor(graph.adjacency, dtype=feats.dtype,
                                  device=feats.device),
        lam=lam, rho=rho, loss=loss)


class COKEState(NamedTuple):
    """Per-agent state, batched over the leading N axis (behind a lane axis
    G in a sweep). `step` is a host int (the censor threshold h(k) is
    formed on the host); `comms` stays on the device."""

    theta: torch.Tensor       # (N, D) local primal variables theta_i^k
    theta_hat: torch.Tensor   # (N, D) latest broadcast primal variables
    gamma: torch.Tensor       # (N, D) local dual variables
    step: int                 # iteration counter k
    comms: torch.Tensor       # () int32 cumulative transmissions
    comm: comm_mod.CommState | None = None


def init_state(problem: Problem, policy=None) -> COKEState:
    """theta^0 = theta_hat^0 = gamma^0 = 0 (Algorithms 1/2); `policy`'s
    persistent state (per-agent bits) rides in the state. A
    `core.comm.LaneChain` of G lanes gives (G, N, D) iterates and (G,)
    comms."""
    N, D = problem.num_agents, problem.feature_dim
    dev, dtype = problem.device, problem.feats.dtype
    chain = comm_mod.as_chain(policy)
    lanes = ((chain.num_lanes,) if isinstance(chain, comm_mod.LaneChain)
             else ())

    def z():
        return torch.zeros(lanes + (N, D), dtype=dtype, device=dev)

    return COKEState(z(), z(), z(), 0,
                     torch.zeros(lanes, dtype=torch.int32, device=dev),
                     chain.init_state(N, dev))


# --------------------------------------------------------------------------
# Primal update
# --------------------------------------------------------------------------

class PrimalTerms(NamedTuple):
    """The iteration-invariant parts of the (21a) system, per agent: the
    right-hand side's (2/T_i) Phi_i' y_i, and for CG the data part of the
    Jacobi diagonal, (2/T_i) sum_t Phi_i[t]^2. The reference recomputes
    both in every iteration; they are the same values at every one."""

    phity: torch.Tensor            # (N, D)
    phisq: torch.Tensor | None     # (N, D), or None where no CG runs


def primal_terms(problem: Problem, jacobi: bool = True) -> PrimalTerms:
    """One read of Phi for phity, one more for the Jacobi diagonal, one
    agent at a time: no (N, T, D) temporary. Each is rounded as the
    reference forms it: ((2/T_i) Phi_i') y_i, the scale on Phi before the
    product (scaling after moves the Cholesky trajectories by ~1e-5), and
    (2/T_i) sum_t Phi_i[t]^2, the scale after the sum. On a mesh both are
    block-local (each feature block of each agent block)."""
    phi = problem.feats
    s = 2.0 / phi.shape[1]

    def phity_of(p, labels):
        return torch.stack([(s * a.T) @ y for a, y in zip(p, labels)])

    def phisq_of(p):
        return torch.stack([torch.sum(torch.square(a), dim=0) for a in p])

    out = sharding.spec_of(phi, 0, 2)
    phity = sharding.blockwise(phity_of, phi, problem.labels, out=out)
    phisq = s * sharding.blockwise(phisq_of, phi, out=out) if jacobi \
        else None
    return PrimalTerms(phity, phisq)


def _diag_reg(problem: Problem, deg: torch.Tensor) -> torch.Tensor:
    """(N, 1): 2 lam/N + 2 rho d_i, the (21a) system's diagonal shift
    ((G, N, 1) over per-lane degrees (G, N))."""
    return (2.0 * problem.lam / problem.num_agents
            + 2.0 * problem.rho * deg)[..., None]


def _rhs(problem: Problem, phity, gamma, theta_ref, nbr_sum, deg):
    return phity - gamma + problem.rho * (deg[..., None] * theta_ref
                                          + nbr_sum)


def _as_columns(x: torch.Tensor) -> torch.Tensor:
    """(G, N, D) lanes -> (N, D, G): the lanes as columns of per-agent
    batched products."""
    return x.permute(1, 2, 0)


def _from_columns(x: torch.Tensor) -> torch.Tensor:
    """(N, D, G) -> (G, N, D)."""
    return x.permute(2, 0, 1)


def _ridge_factors(problem: Problem, deg=None) -> torch.Tensor:
    """(N, D, D) lower Cholesky factors of the (18a) normal matrices
    (2/T_i) Phi_i' Phi_i + (2 lam/N + 2 rho d_i) I, batched over agents.
    The Gram stays fp32 (no TF32); `torch.linalg.cholesky` checks its
    result, which syncs the host once. On a mesh the factor needs whole
    feature rows: each agent block gathers its feature blocks (an
    all-gather of Phi over "model", D/s -> D columns per agent) and holds
    its agents' (D, D) factors, cut over the batch axes only."""
    N, Ti, D = problem.feats.shape
    if deg is None:
        deg = problem.degrees
    s = 2.0 / Ti

    def factors(feats, d):
        # ((2/T_i) Phi_i') Phi_i, scaled before the product as the
        # reference rounds it, one agent at a time
        gram = torch.stack([(s * p.T) @ p for p in feats])
        gram.diagonal(dim1=1, dim2=2).add_(_diag_reg(problem, d))
        return torch.linalg.cholesky(gram)

    feats = sharding.all_gather(problem.feats, "model")
    return sharding.blockwise(factors, feats, sharding.rows_like(deg, feats),
                              out=sharding.spec_of(feats, 0, None, None))


def _primal_closed_form(problem: Problem, chol, gamma, theta_ref, nbr_sum,
                        deg=None, terms: PrimalTerms | None = None):
    """Solve (21a) exactly per agent with the prefactored system: two
    batched triangular solves. theta_ref / nbr_sum are (theta_hat_i,
    sum_n theta_hat_n)."""
    if deg is None:
        deg = problem.degrees
    if terms is None:
        terms = primal_terms(problem, jacobi=False)
    rhs = _rhs(problem, terms.phity, gamma, theta_ref, nbr_sum, deg)
    if rhs.ndim == 3:   # G lanes: G right-hand sides of the one factor
        z = torch.linalg.solve_triangular(chol, _as_columns(rhs),
                                          upper=False)
        return _from_columns(torch.linalg.solve_triangular(chol.mT, z,
                                                           upper=True))

    def solve(c, r):
        z = torch.linalg.solve_triangular(c, r[..., None], upper=False)
        return torch.linalg.solve_triangular(c.mT, z, upper=True)[..., 0]
    # on a mesh: whole feature rows per agent block around the solves,
    # then the solution cut back into the iterates' feature blocks
    whole = sharding.all_gather(rhs, "model")
    x = sharding.blockwise(solve, chol, whole,
                           out=sharding.spec_of(whole, 0, 1))
    return sharding.recut(x, rhs)


def _rowdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _primal_cg(problem: Problem, gamma, theta_ref, nbr_sum, deg=None,
               theta0=None, tol: float = 1e-8, maxiter: int = 64,
               terms: PrimalTerms | None = None):
    """Solve (21a) per agent matrix-free: Jacobi-preconditioned CG on

        [ (2/T_i) Phi_i' Phi_i + (2 lam/N + 2 rho d_i) I ] theta = rhs_i

    whose operator is two batched products, Phi_i' (Phi_i v); no (D, D)
    array is built. Lanes (G, N, D) ride as the products' G columns. Step for step `jax.scipy.sparse.linalg.cg` under
    `vmap`: the stop rs > max(tol^2 |b|^2, 0) with rs = |r|^2, the
    preconditioner v / jacobi, the warm start theta0, and gamma = <r, z>,
    alpha = gamma / <p, Ap>, beta = gamma' / gamma in that order. Under
    vmap the while loop runs until every agent has stopped and a stopped
    agent keeps its values; here that is a fixed loop of `maxiter` steps
    with a per-agent active mask applied by `torch.where` (a stopped
    agent's alpha may be 0/0, which a select drops and a product would
    not). Nothing is read back to the host."""
    N, Ti, D = problem.feats.shape
    phi = problem.feats
    if deg is None:
        deg = problem.degrees
    if theta0 is None:
        theta0 = torch.zeros((N, D), dtype=phi.dtype, device=phi.device)
    if terms is None or terms.phisq is None:
        terms = primal_terms(problem, jacobi=True)
    diag_reg = _diag_reg(problem, deg)
    b = _rhs(problem, terms.phity, gamma, theta_ref, nbr_sum, deg)
    jacobi = terms.phisq + diag_reg
    s = 2.0 / Ti

    def matvec(v):
        if v.ndim == 3:
            phi_t = phi.transpose(1, 2)
            return s * _from_columns(torch.bmm(
                phi_t, torch.bmm(phi, _as_columns(v)))) + diag_reg * v
        # on a mesh Phi_i v is the psum of the feature blocks' partials
        # and Phi_i' u block-local
        u = torch.einsum("ntd,nd->nt", phi, v)
        return s * torch.einsum("ntd,nt->nd", phi, u) + diag_reg * v

    atol2 = (tol * tol) * _rowdot(b, b)
    x = theta0
    r = b - matvec(x)
    z = r / jacobi
    p = z
    gam = _rowdot(r, z)
    for _ in range(maxiter):
        active = _rowdot(r, r) > atol2
        ap = matvec(p)
        alpha = gam / _rowdot(p, ap)
        x_new = x + alpha[..., None] * p
        r_new = r - alpha[..., None] * ap
        z_new = r_new / jacobi
        gam_new = _rowdot(r_new, z_new)
        beta = gam_new / gam
        p_new = z_new + beta[..., None] * p
        keep = active[..., None]
        x = torch.where(keep, x_new, x)
        r = torch.where(keep, r_new, r)
        p = torch.where(keep, p_new, p)
        gam = torch.where(active, gam_new, gam)
    return x


def _primal_gradient(problem: Problem, inner_steps: int, inner_lr: float,
                     theta0, gamma, theta_ref, nbr_sum, deg=None):
    """Inexact (21a) for any convex loss: `inner_steps` gradient steps on
    the augmented local objective

        R_i(theta) + rho d_i |theta|^2 + <theta, gamma_i - rho (d_i
                                          theta_ref_i + nbr_sum_i)>,

    each gradient by autograd of the agent sum (agent i's term depends on
    its own row only)."""
    N = problem.num_agents
    if deg is None:
        deg = problem.degrees
    lin = gamma - problem.rho * (deg[..., None] * theta_ref + nbr_sum)
    rho_d = (problem.rho * deg)[..., None]
    lam = problem.lam / N
    theta = theta0
    for _ in range(inner_steps):
        # the terms in the order autograd of the summed objective adds
        # them, so the bits are its bits
        reg, prox = lam * theta, rho_d * theta
        grad = ((((lin + prox) + prox) + reg) + reg) + losses_mod.data_grad(
            theta, problem.feats, problem.labels, problem.loss)
        theta = theta - inner_lr * grad
    return theta


def _primal_stage(problem: Problem, primal: str, *, chol=None,
                  terms: PrimalTerms | None = None, inner_steps: int = 50,
                  inner_lr: float = 0.1, cg_tol: float = 1e-8,
                  cg_maxiter: int = 64, legacy_auto: bool = False):
    """The (21a) primal update as a `core.step` stage. With
    `legacy_auto=True` the dispatch keeps `coke_step`'s contract (the
    closed form whenever a factor is in hand and the loss is quadratic);
    otherwise the mode is explicit ("cg" / "cholesky" / gradient). A view
    that carries its own factors (a topology schedule) overrides `chol`."""
    def stage(k, g, theta0, theta_hat0, gamma0, nbr_hat):
        c = chol if g.chol is None else g.chol
        if primal == "cg":
            if problem.loss != "quadratic":
                raise ValueError(
                    "primal='cg' solves the quadratic-loss normal "
                    f"equations; loss={problem.loss!r} needs "
                    "primal='gradient'")
            theta = _primal_cg(problem, gamma0, theta_hat0, nbr_hat, g.deg,
                               theta0=theta0, tol=cg_tol,
                               maxiter=cg_maxiter, terms=terms)
        elif ((problem.loss == "quadratic" and c is not None)
              if legacy_auto else primal == "cholesky"):
            if c is None:
                raise ValueError("primal='cholesky' needs the factor stack")
            theta = _primal_closed_form(problem, c, gamma0, theta_hat0,
                                        nbr_hat, g.deg, terms=terms)
        else:
            theta = _primal_gradient(problem, inner_steps, inner_lr,
                                     theta0, gamma0, theta_hat0, nbr_hat,
                                     g.deg)
        return theta, {}
    return stage


# --------------------------------------------------------------------------
# One COKE / DKLA iteration
# --------------------------------------------------------------------------

def coke_step(problem: Problem, policy, state: COKEState,
              chol: torch.Tensor | None = None, inner_steps: int = 50,
              inner_lr: float = 0.1, topology=None, primal: str = "auto",
              cg_tol: float = 1e-8, cg_maxiter: int = 64,
              terms: PrimalTerms | None = None) -> COKEState:
    """One iteration of Algorithm 2 for every agent.

    policy   — a `core.comm` policy; an empty chain (or v == 0) is DKLA.
    topology — a `core.graph.TopologySchedule`: iteration k runs on
    `topology.at(k)`. With the closed-form primal pass the (M, N, D, D)
    per-graph factor stack as `chol`; the step picks the active graph's.
    primal   — "auto": the closed form when `chol` is given and the loss is
    quadratic, else the gradient primal; "cg": the matrix-free solve.
    terms    — `primal_terms(problem)`, hoisted by the caller; None forms
    them in this call, as the reference does in every iteration."""
    if topology is None:
        view = step_mod.dense_view(problem.adjacency, deg=problem.degrees)

        def exchange(s, k):
            return view
    else:
        def exchange(s, k):
            c = chol
            if c is not None and c.ndim == 4:
                c = c[topology.index(k)]
            return step_mod.dense_view(topology.at(k), chol=c)

    program = step_mod.StepProgram(
        chain=comm_mod.as_chain(policy), rho=problem.rho,
        exchange=exchange,
        primal=_primal_stage(problem, primal, chol=chol, terms=terms,
                             inner_steps=inner_steps, inner_lr=inner_lr,
                             cg_tol=cg_tol, cg_maxiter=cg_maxiter,
                             legacy_auto=True))
    new_state, _ = step_mod.run_step(program, state)
    return new_state


# --------------------------------------------------------------------------
# The legacy driver (deprecated)
# --------------------------------------------------------------------------

class RunResult(NamedTuple):
    state: COKEState
    train_mse: torch.Tensor      # (K,) global training MSE per iteration
    comms: torch.Tensor          # (K,) cumulative transmissions
    consensus_gap: torch.Tensor  # (K,) max_i ||theta_i - mean(theta)||


def run(problem: Problem, schedule, num_iters: int, inner_steps: int = 50,
        inner_lr: float = 0.1) -> RunResult:
    """Deprecated entry point: use `api.fit(FitConfig(...))`, which this
    runs. COKE (DKLA when schedule.v == 0) on the simulator with the
    legacy primal: the closed form on the quadratic loss, else the
    gradient steps. Warns with the reference's text."""
    warnings.warn(
        "repro.core.admm.run is deprecated; use repro.api.fit("
        "FitConfig(algorithm='coke'|'dkla', ...))",
        DeprecationWarning, stacklevel=2)
    from repro_torch.api import FitConfig, fit  # import cycle

    res = fit(FitConfig(algorithm="coke", comm=schedule,
                        num_iters=num_iters, inner_steps=inner_steps,
                        inner_lr=inner_lr,
                        primal="cholesky" if problem.loss == "quadratic"
                        else "gradient"),
              problem=problem, device=problem.device)
    h = res.history
    return RunResult(res.state, h["train_mse"], h["comms"],
                     h["consensus_gap"])


def dkla_schedule() -> CensorSchedule:
    """The h == 0 schedule under which COKE is DKLA."""
    return CensorSchedule(v=0.0, mu=0.5)
