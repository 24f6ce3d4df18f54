"""Personalization: learned collaboration graphs and per-agent models, as
in the reference's `core/personalize.py`.

Full consensus on a chosen topology is wrong when agents hold
heterogeneous (non-IID) data. Following Dada (Zantedeschi et al., AISTATS
2020), a personalized fit alternates the DKLA/COKE/online ADMM steps with
a graph update: affinities between the agents' (N, D) thetas are cut to a
mutual top-k collaboration graph whose weights scale the consensus
penalty. Agents with similar models pull on each other; agents of
different clusters decouple and keep distinct models.

The learned adjacency goes into the same update equations every backend
runs (deg_i = sum_j w_ij, nbr_sum = A @ theta_hat, the dual gamma +=
rho (deg theta_hat - A theta_hat)), so no new update rule exists.

Affinities are computed in row blocks of B = min(128, N) rows: no (N, N)
score tensor is made, only the (N, k) top-k result, which is scattered
into the dense adjacency the steps consume. Top-k takes the k best scores
of a row by a stable descending sort, which breaks ties by the lower
index, as `jax.lax.top_k` does (`torch.topk` does not promise it). The
tie rule decides the graph when thetas are equal, as they are at
iteration 1 of a run with warmup=0.

Refresh cadence: iteration k (1-based) relearns the graph iff k > warmup
and (k - warmup - 1) % every == 0. The port's iteration index is a host
int, so a refresh is a host `if`: nothing is read back from the device.

Every function has an (N, D) -> (N, N) form and, for a sweep's lanes, a
(G, N, D) -> (G, N, N) form with one graph per lane, broadcast over the
leading axis.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import comm as comm_mod
from repro_torch.core import step as step_mod
from repro_torch.core.admm import COKEState, PrimalTerms, Problem, \
    _primal_stage
from repro_torch.core.gossip import GossipPlan
from repro_torch.core.online import OnlineState
from repro_torch.distributed.sharding import P, Blocked, all_gather, blockwise

AFFINITY_KINDS = ("rbf", "cosine")

#: guard for zero distances and zero norms in the affinity kernels
_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class Personalization:
    """The `FitConfig.personalization` axis: how and when the
    collaboration graph is learned from the agent-stacked thetas.

    k        — neighbours kept per agent (mutual top-k; learned row
               degrees are <= k).
    every    — graph-refresh period in iterations.
    warmup   — iterations on the configured static graph before the first
               refresh (the thetas start equal; let them separate first).
    affinity — "rbf": w_ij = exp(-||t_i - t_j||^2 / s_ij), ranked by
               distance; "cosine": cosine similarity clipped to [0, 1].
    scale    — rbf length scale. 0.0 = local auto-scaling (Zelnik-Manor &
               Perona): s_ij = sigma_i sigma_j, sigma_i the distance to
               agent i's k-th neighbour. scale > 0 fixes s_ij = 2 scale^2.
    """

    k: int = 3
    every: int = 10
    warmup: int = 10
    affinity: str = "rbf"
    scale: float = 0.0

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"personalization needs k >= 1, got {self.k}")
        if self.every < 1:
            raise ValueError(
                f"graph-refresh period must be >= 1, got {self.every}")
        if self.warmup < 0:
            raise ValueError(f"warmup must be >= 0, got {self.warmup}")
        if self.affinity not in AFFINITY_KINDS:
            raise ValueError(
                f"unknown affinity {self.affinity!r}; choose from "
                f"{AFFINITY_KINDS}")
        if isinstance(self.scale, (int, float)) and self.scale < 0:
            raise ValueError(
                f"scale must be >= 0 (0 = local auto-scaling), got "
                f"{self.scale}")


class PersonalizedState(NamedTuple):
    """The ADMM state plus the current learned adjacency: what the live
    phase of a personalized fit carries."""

    inner: COKEState
    adjacency: torch.Tensor   # (N, N) (or (G, N, N)) weighted, symmetric


# ---------------------------------------------------------------------------
# Learning the graph
# ---------------------------------------------------------------------------

def topk_neighbors(thetas: torch.Tensor, k: int, affinity: str = "rbf",
                   scale: float = 0.0, block: int = 128
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each agent's k most affine peers from the (N, D) theta stack (or a
    sweep's (G, N, D) lanes, one ranking per lane).

    Returns (idx, w): (..., N, k) int64 neighbour indices (self excluded,
    best first; ties to the lower index) and (..., N, k) float32 weights
    in [0, 1]. The scores are made one (B, N) tile at a time, B = min(block,
    N); the last block is padded with clamped rows and trimmed, as in the
    reference, so every tile's product has one shape. fp32 throughout (the
    card's products without TF32, PyTorch's default).

    On a mesh (a blocked (N, D) stack) the rows are gathered over the
    batch axes; |t_i|^2 and each tile of dots are per-feature-block
    partials summed by psum_model in ascending block order. The scores,
    the sort, the top-k and the weights are plain tensors."""
    N = thetas.shape[-2]
    if not 1 <= k <= N - 1:
        raise ValueError(
            f"top-k needs 1 <= k <= N-1 (k={k}, N={N} agents)")
    dev = thetas.device
    t = all_gather(thetas.to(torch.float32), "batch")
    blocked = isinstance(t, Blocked)
    sq = torch.sum(t * t, dim=-1)                     # (..., N)
    norms = torch.sqrt(sq) if affinity == "cosine" else None
    B = min(block, N)
    num_blocks = -(-N // B)
    all_rows = torch.clamp_max(torch.arange(num_blocks * B, device=dev),
                               N - 1)
    col = torch.arange(N, device=dev)
    t_cols = None if blocked else t.transpose(-1, -2)   # (..., D, N)
    idx_parts, val_parts = [], []
    for i0 in range(0, num_blocks * B, B):
        rows = all_rows[i0:i0 + B]
        if blocked:
            dots = blockwise(
                lambda tb: torch.index_select(tb, 0, rows) @ tb.T, t,
                out=P(None, None), partial=True)
        else:
            dots = torch.index_select(t, -2, rows) @ t_cols   # (..., B, N)
        sq_rows = torch.index_select(sq, -1, rows)
        if affinity == "rbf":
            d2 = torch.clamp_min(
                sq_rows[..., :, None] + sq[..., None, :] - 2.0 * dots, 0.0)
            score, val = -d2, d2
        else:
            denom = torch.clamp_min(
                torch.index_select(norms, -1, rows)[..., :, None]
                * norms[..., None, :], _EPS)
            cos = torch.clamp(dots / denom, 0.0, 1.0)
            score, val = cos, cos
        score = score.masked_fill(rows[:, None] == col[None, :], -torch.inf)
        order = torch.sort(score, dim=-1, descending=True, stable=True)[1]
        top = order[..., :k]
        idx_parts.append(top)
        val_parts.append(torch.gather(val, -1, top))
    idx = torch.cat(idx_parts, dim=-2)[..., :N, :]
    val = torch.cat(val_parts, dim=-2)[..., :N, :]

    if affinity == "cosine":
        return idx, val
    # rbf: the ascending-d2 top-k as weights. Local auto-scaling
    # (scale == 0): sigma_i^2 = d2 to the k-th neighbour, w_ij =
    # exp(-d2_ij / (sigma_i sigma_j)); a fixed scale: exp(-d2 / (2 s^2)),
    # with 2 s^2 rounded in float32 as the reference forms it
    if scale > 0:
        s = np.float32(scale)
        denom2 = max(np.float32(2.0) * s * s, np.float32(_EPS))
        return idx, torch.exp(step_mod.true_div(-val, float(denom2)))
    sig2 = val[..., -1]                               # (..., N)
    sig2_nb = torch.gather(sig2, -1, idx.flatten(-2)).view(idx.shape)
    local = torch.clamp_min(torch.sqrt(sig2[..., :, None] * sig2_nb), _EPS)
    return idx, torch.exp(-val / local)


def learned_adjacency(pz: Personalization,
                      thetas: torch.Tensor) -> torch.Tensor:
    """The mutual top-k collaboration graph as a dense weighted (N, N)
    adjacency (or (G, N, N) over lanes): symmetric, zero diagonal, row
    degrees <= pz.k. Edge (i, j) survives only when i and j both rank each
    other top-k, with weight (w_ij + w_ji) / 2."""
    idx, w = topk_neighbors(thetas, pz.k, pz.affinity, pz.scale)
    N = thetas.shape[-2]
    directed = torch.zeros(thetas.shape[:-1] + (N,), dtype=torch.float32,
                           device=thetas.device).scatter_(-1, idx, w)
    both = directed.transpose(-1, -2)
    mutual = (directed > 0) & (both > 0)
    return torch.where(mutual, 0.5 * (directed + both), 0.0)


def should_update(pz: Personalization, k: int) -> bool:
    """Does iteration k (1-based, a host int) refresh the graph?"""
    return k > pz.warmup and (k - pz.warmup - 1) % pz.every == 0


def maybe_update(pz: Personalization, thetas: torch.Tensor, k: int,
                 adjacency: torch.Tensor) -> torch.Tensor:
    """The per-iteration graph step: relearn the adjacency from the current
    thetas on refresh iterations, carry it unchanged otherwise."""
    if should_update(pz, k):
        return learned_adjacency(pz, thetas).to(adjacency.dtype)
    return adjacency


def graph_recovery(adjacency: torch.Tensor, clusters) -> torch.Tensor:
    """Fraction of the learned edge mass that is intra-cluster, in [0, 1]
    (1.0: every learned edge joins agents of the same task), against the
    ground-truth task labels `clusters` (N,). A 0-d tensor (G over
    lanes)."""
    c = torch.as_tensor(np.asarray(clusters), device=adjacency.device)
    same = c[:, None] == c[None, :]
    total = torch.sum(adjacency, dim=(-2, -1))
    intra = torch.sum(torch.where(same, adjacency, 0.0), dim=(-2, -1))
    return torch.where(total > 0, intra / torch.clamp_min(total, _EPS),
                       0.0)


# ---------------------------------------------------------------------------
# Personalized gossip steps on the dense learned graph
#
# The static gossip path reads the topology through a NeighborTable made
# once on the host, which cannot follow a graph relearned during the run.
# These steps keep core.gossip's update structure (participation mask,
# silent sleepers, delayed duals) with `A @ x` neighbour sums, so
# participation 1.0 is bitwise the synchronous personalized step.
# ---------------------------------------------------------------------------

def gossip_coke_step_dense(
    problem: Problem,
    policy,
    pz: Personalization,
    state: PersonalizedState,
    plan: GossipPlan,
    inner_steps: int = 50,
    inner_lr: float = 0.1,
    primal: str = "cg",
    cg_tol: float = 1e-8,
    cg_maxiter: int = 64,
    terms: PrimalTerms | None = None,
) -> PersonalizedState:
    """One asynchronous personalized ADMM iteration: refresh the learned
    graph if due, then the sampled participants run the (21a) primal, the
    policy-governed broadcast and the delayed (21b) dual on it. `terms`:
    the hoisted `admm.primal_terms(problem)`, or None to form them here."""
    s = state.inner
    A = maybe_update(pz, s.theta, s.step + 1, state.adjacency)
    view = step_mod.dense_view(A)
    program = step_mod.StepProgram(
        chain=comm_mod.as_chain(policy), rho=problem.rho,
        exchange=lambda st, k: view,
        primal=_primal_stage(problem, primal, terms=terms,
                             inner_steps=inner_steps, inner_lr=inner_lr,
                             cg_tol=cg_tol, cg_maxiter=cg_maxiter),
        comm_decide=step_mod.sampled_stage(plan))
    inner, _ = step_mod.run_step(program, s)
    return PersonalizedState(inner, A)


def gossip_stream_step_dense(
    state: OnlineState,
    feats: torch.Tensor,
    labels: torch.Tensor,
    adjacency: torch.Tensor,
    schedule,
    plan: GossipPlan,
    *,
    lam: float,
    rho: float,
    lr: float,
    eta: float | None = None,
) -> tuple[OnlineState, torch.Tensor]:
    """The asynchronous streaming round on a (learned) dense graph:
    `core.gossip.gossip_stream_step` with `A @ x` in place of the table's
    gathers. The caller owns the graph refresh (the adjacency rides in the
    solver's fit state, not in the OnlineState)."""
    view = step_mod.dense_view(adjacency)
    program = step_mod.StepProgram(
        chain=comm_mod.as_chain(schedule), rho=rho,
        exchange=lambda st, k: view,
        primal=step_mod.stream_primal(feats, labels, lam=lam, rho=rho,
                                      lr=lr, eta=eta),
        comm_decide=step_mod.sampled_stage(plan))
    new_state, extras = step_mod.run_step(program, state)
    return new_state, extras["inst_mse"]
