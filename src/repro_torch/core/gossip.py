"""Asynchronous gossip execution, `FitConfig(exec="gossip")`, as in the
reference's `core/gossip.py`.

Per iteration only a sampled subset of agents wakes up, runs its primal
step and broadcasts; everyone else holds state and neighbours read stale
values:
  * participation sampling: a Bernoulli(rate) or fixed-size subset, drawn
    from the `CommState` chain key folded with the iteration and a stage
    tag (`core.step.participation_mask`), so the simulator and spmd draw
    the same masks, and every sweep lane draws its own;
  * stale neighbours: a sleeper neither transmits nor pays bits; its last
    broadcast (`theta_hat`) keeps serving its neighbours;
  * delayed-but-correct duals: a sleeper's dual is frozen and integrates
    the drift it slept through at its next wake;
  * churn: a `ChurnSchedule` scripts straggler slowdowns and agent
    join/leave events at given iterations. A leaver drops out of every
    neighbour sum and degree; a (re)joiner restarts from zero.

Scaling contract: the simulator gossip step reads the graph only through a
`NeighborTable`, a padded (N, K) gather form, so no (N, N) tensor is made
or read; N in the thousands fits. Degeneracy contract: at participation
1.0 with no churn and no stragglers, the gossip step is bitwise the
synchronous one on a ring (a two-term gather-sum equals the dense `A @ x`
row exactly).

Host and device: a plan's event iterations stay on the host, so the event
index of iteration k is found without reading the device; the alive rows,
the slowdowns and the rate live on the device. A sweep's lanes draw from
their (G, 2) keys, folded on the host for `LANE_BLOCK` rounds at a time
and uploaded without a wait.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import comm as comm_mod
from repro_torch.core import prng
from repro_torch.core import step as step_mod
from repro_torch.core.admm import COKEState, PrimalTerms, Problem, \
    _primal_stage
from repro_torch.core.online import OnlineState
from repro_torch.core.step import (PARTICIPATION_TAG,  # noqa: F401
                                   _mask_rows, participation_mask)
from repro_torch.core.tree import tree_map
from repro_torch.distributed.sharding import Blocked, fold_add, neighbor_sum

EXEC_MODES = ("sync", "gossip")


# ---------------------------------------------------------------------------
# NeighborTable: the sparse neighbour view (no dense (N, N) on the hot path)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class NeighborTable:
    """Padded neighbour-index form of an undirected graph: row i lists
    agent i's neighbours in ascending index order, padded to the largest
    degree. Every neighbour reduction is a gather and a weighted sum over
    K, O(N K D), never an (N, N) product. On deg-2 rows the two-term sum
    is bitwise the dense `A @ x` row."""

    idx: torch.Tensor     # (N, K) int64 neighbour indices (0-padded)
    nmask: torch.Tensor   # (N, K) float32: 1.0 real neighbour, 0.0 padding

    @property
    def num_agents(self) -> int:
        return self.idx.shape[0]

    @property
    def max_degree(self) -> int:
        return self.idx.shape[1]

    @classmethod
    def from_adjacency(cls, adjacency, device: torch.device | str = "cpu"
                       ) -> "NeighborTable":
        """Build on the host from a dense (N, N) adjacency (numpy or a
        tensor); the dense form never reaches the step."""
        if isinstance(adjacency, torch.Tensor):
            adjacency = adjacency.detach().cpu().numpy()
        A = np.asarray(adjacency)
        if A.ndim != 2 or A.shape[0] != A.shape[1]:
            raise ValueError(f"adjacency must be square, got {A.shape}")
        N = A.shape[0]
        rows = [np.nonzero(A[i])[0] for i in range(N)]
        K = max((len(r) for r in rows), default=0) or 1
        idx = np.zeros((N, K), np.int64)
        msk = np.zeros((N, K), np.float32)
        for i, r in enumerate(rows):
            idx[i, : len(r)] = r
            msk[i, : len(r)] = 1.0
        return cls(idx=torch.from_numpy(idx).to(device),
                   nmask=torch.from_numpy(msk).to(device))

    def _weights(self, alive: torch.Tensor | None) -> torch.Tensor:
        if alive is None:
            return self.nmask
        return self.nmask * alive[self.idx].to(self.nmask.dtype)

    def degrees(self, alive: torch.Tensor | None = None) -> torch.Tensor:
        """(N,) live degrees: dead neighbours (churn) drop out."""
        return torch.sum(self._weights(alive), dim=1)

    def gather_sum(self, x: torch.Tensor, weights: torch.Tensor
                   ) -> torch.Tensor:
        """sum_k weights[i, k] x[idx[i, k]] for x (N,), (N, D) or a sweep's
        (G, N, D) (agent axis second to last), summed over k = 0, 1, ... in
        turn (`sharding.fold_add`). On a mesh (x blocked, its agent dim
        cut over the batch axes) the layout's `neighbor_sum`, bitwise this
        plain sum."""
        if isinstance(x, Blocked):
            return neighbor_sum(x, self.idx, weights)
        if x.ndim == 1:
            return fold_add(weights * x[self.idx], 1)
        g = x[..., self.idx, :]                      # (..., N, K, D)
        return fold_add(weights[..., None] * g, -2)

    def nbr_sum(self, x: torch.Tensor,
                alive: torch.Tensor | None = None) -> torch.Tensor:
        """sum_{n in N(i)} x_n over live neighbours: the gossip spelling of
        `adjacency @ x`."""
        return self.gather_sum(x, self._weights(alive))


# ---------------------------------------------------------------------------
# ChurnSchedule (host description) -> GossipPlan (the run's device data)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChurnSchedule:
    """Scenario knobs for population dynamics, scripted per iteration.

    leave / join   — ((iteration, agent), ...) events, 1-based iterations;
                     effective AT the named iteration. An agent may leave
                     and later rejoin (it restarts from zero state).
    slowdown       — ((agent, factor), ...) straggler factors >= 1: agent
                     i's participation probability is rate / factor (a
                     2x-slow straggler joins half as often).
    start_absent   — agents dead at iteration 1 (they join later).
    """

    leave: tuple = ()
    join: tuple = ()
    slowdown: tuple = ()
    start_absent: tuple = ()

    @property
    def has_events(self) -> bool:
        return bool(self.leave or self.join or self.start_absent)

    def plan(self, num_agents: int, participation: float = 1.0,
             size: int | None = None,
             device: torch.device | str = "cpu") -> "GossipPlan":
        """Compile the schedule into the plan the gossip step consumes: an
        event-indexed alive stack plus the straggler vector. The reference's
        validation messages, word for word."""
        def _check_agent(a):
            a = int(a)
            if not 0 <= a < num_agents:
                raise ValueError(
                    f"churn names agent {a} but the problem has "
                    f"{num_agents} agents")
            return a

        if size is not None and not 1 <= size <= num_agents:
            raise ValueError(
                f"gossip_size={size} out of range for {num_agents} agents")

        events: list[tuple[int, int, bool]] = []
        for it, a in self.leave:
            if int(it) < 1:
                raise ValueError(f"churn iterations are 1-based, got {it}")
            events.append((int(it), _check_agent(a), False))
        for it, a in self.join:
            if int(it) < 1:
                raise ValueError(f"churn iterations are 1-based, got {it}")
            events.append((int(it), _check_agent(a), True))
        seen = set()
        for it, a, _ in events:
            if (it, a) in seen:
                raise ValueError(
                    f"conflicting churn events for agent {a} at "
                    f"iteration {it}")
            seen.add((it, a))

        alive = np.ones((num_agents,), bool)
        for a in self.start_absent:
            alive[_check_agent(a)] = False

        event_iters, stack = [], [alive.copy()]
        for it in sorted({e[0] for e in events}):
            for eit, a, up in events:
                if eit == it:
                    alive[a] = up
            event_iters.append(it)
            stack.append(alive.copy())

        slow = None
        if self.slowdown:
            slow = np.ones((num_agents,), np.float32)
            for a, f in self.slowdown:
                if float(f) < 1.0:
                    raise ValueError(
                        f"straggler factors are >= 1 (a slowdown), got {f}")
                slow[_check_agent(a)] = float(f)

        rate = float(np.float32(participation))
        alive_stack, joined = None, ()
        if self.has_events:
            stack = np.stack(stack)
            # the rows that (re)join at each event: the reference's
            # alive_at(k) & ~alive_at(k - 1), None where nobody joins
            joined = tuple(torch.from_numpy(j).to(device) if j.any()
                           else None for j in stack[1:] & ~stack[:-1])
            alive_stack = torch.from_numpy(stack).to(device)
        return GossipPlan(
            participation=torch.tensor(rate, dtype=torch.float32,
                                       device=device),
            rate=rate, size=size,
            slowdown=None if slow is None else torch.from_numpy(slow).to(
                device),
            event_iters=np.asarray(event_iters, np.int64),
            alive_stack=alive_stack, joined_stack=joined)


@dataclasses.dataclass(frozen=True, eq=False)
class GossipPlan:
    """The execution plan of one gossip run. `participation` is the rate as
    a 0-d float32 tensor on the run's device (`rate` the host float),
    `slowdown` the (N,) straggler factors there, `alive_stack` the (E + 1,
    N) bool liveness after each of the E events (None without churn);
    `event_iters` the (E,) sorted 1-based event iterations, on the host."""

    participation: torch.Tensor
    rate: float
    size: int | None = None
    slowdown: torch.Tensor | None = None
    event_iters: np.ndarray | None = None
    alive_stack: torch.Tensor | None = None
    joined_stack: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "_memo", {})

    @property
    def has_churn(self) -> bool:
        return self.alive_stack is not None

    def event_index(self, k: int) -> int | None:
        """The row of `alive_stack` in effect during iteration k (the number
        of events at or before k), found on the host; None without churn."""
        if self.alive_stack is None:
            return None
        return int(np.searchsorted(self.event_iters, k, side="right"))

    def alive_at(self, k: int) -> torch.Tensor | None:
        """(N,) liveness during iteration k; None without churn."""
        i = self.event_index(k)
        return None if i is None else self.alive_stack[i]

    def joined_at(self, k: int) -> torch.Tensor | None:
        """(N,) the rows that (re)join at iteration k, or None where none
        does (the reference's all-false mask there changes no row)."""
        if not self.joined_stack:
            return None
        i = self.event_index(k)
        if i == 0 or int(self.event_iters[i - 1]) != k:
            return None
        return self.joined_stack[i - 1]

    def table_weights(self, table: NeighborTable, event: int | None):
        """(degrees, weights) of `table` under the alive row of event index
        `event` (None: everyone lives), made once per index and kept."""
        memo = self._memo.setdefault(("weights", id(table)), (table, {}))[1]
        if event not in memo:
            alive = None if event is None else self.alive_stack[event]
            w = table._weights(alive)
            memo[event] = (torch.sum(w, dim=1), w)
        return memo[event]

    def lane_keys(self, keys: np.ndarray, k: int, device) -> torch.Tensor:
        """(G, 2) int64 device keys of round k's participation draw under a
        sweep's (G, 2) lane chain keys: each lane's `participation_key`,
        folded on the host LANE_BLOCK rounds at a time and uploaded without
        a wait."""
        block = (k - 1) // comm_mod.LANE_BLOCK
        memo_key = (str(device), keys.tobytes())
        have = self._memo.get(memo_key)
        if have is None or have[0] != block:
            ks = np.arange(block * comm_mod.LANE_BLOCK + 1,
                           (block + 1) * comm_mod.LANE_BLOCK + 1)
            r = prng.fold_in_lanes(np.asarray(keys)[None], ks[:, None])
            r = prng.fold_in_lanes(r, PARTICIPATION_TAG)
            r = prng.fold_in_lanes(
                r, int(np.float32(self.rate).view(np.uint32)))
            have = (block, comm_mod._upload(np.ascontiguousarray(r), device))
            self._memo[memo_key] = have
        return have[1][(k - 1) % comm_mod.LANE_BLOCK]


# ---------------------------------------------------------------------------
# One gossip iteration: the ADMM family (DKLA / COKE)
# ---------------------------------------------------------------------------

def gossip_coke_step(problem: Problem, policy, state: COKEState,
                     table: NeighborTable, plan: GossipPlan,
                     chol: torch.Tensor | None = None, inner_steps: int = 50,
                     inner_lr: float = 0.1, primal: str = "cg",
                     cg_tol: float = 1e-8, cg_maxiter: int = 64,
                     terms: PrimalTerms | None = None) -> COKEState:
    """One asynchronous iteration of Algorithm 1/2: the sampled
    participants run the (21a) primal, the policy-governed broadcast and
    the delayed (21b) dual; everyone else holds state and pays zero bits.
    Reads the graph only through `table`: `problem.adjacency` is never
    consumed, so the step touches no (N, N) tensor."""
    program = step_mod.StepProgram(
        chain=comm_mod.as_chain(policy), rho=problem.rho,
        exchange=lambda s, k: step_mod.table_view(table, plan, k),
        primal=_primal_stage(problem, primal, chol=chol, terms=terms,
                             inner_steps=inner_steps, inner_lr=inner_lr,
                             cg_tol=cg_tol, cg_maxiter=cg_maxiter),
        comm_decide=step_mod.sampled_stage(plan))
    new_state, _ = step_mod.run_step(program, state)
    return new_state


# ---------------------------------------------------------------------------
# One gossip round: the streaming family (online DKLA/COKE, QC-ODKLA)
# ---------------------------------------------------------------------------

def gossip_stream_step(state: OnlineState, feats: torch.Tensor,
                       labels: torch.Tensor, table: NeighborTable, schedule,
                       plan: GossipPlan, *, lam: float, rho: float,
                       lr: float, eta: float | None = None
                       ) -> tuple[OnlineState, torch.Tensor]:
    """The asynchronous `core.online.stream_step`: the round's sampled
    participants take the streaming step on their fresh minibatch and
    gossip; sleepers hold. Returns (state, the pre-update instantaneous
    MSE over every agent's minibatch: the stream flows whether or not an
    agent woke up to learn from it)."""
    program = step_mod.StepProgram(
        chain=comm_mod.as_chain(schedule), rho=rho,
        exchange=lambda s, k: step_mod.table_view(table, plan, k),
        primal=step_mod.stream_primal(feats, labels, lam=lam, rho=rho,
                                      lr=lr, eta=eta),
        comm_decide=step_mod.sampled_stage(plan))
    new_state, extras = step_mod.run_step(program, state)
    return new_state, extras["inst_mse"]


# ---------------------------------------------------------------------------
# Growing and shrinking agent-stacked state
# ---------------------------------------------------------------------------

def _stacked(x, n: int) -> bool:
    return isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == n


def grow_agents(tree, old_n: int, new_n: int):
    """Pad every agent-stacked leaf (leading axis == old_n) of a tree with
    zero rows up to new_n agents; other leaves pass through. Existing rows
    are untouched bit for bit; new rows start cold, as a joiner does."""
    if new_n < old_n:
        raise ValueError(f"grow_agents: {new_n} < current {old_n} "
                         "(use take_agents to shrink)")

    def pad(x):
        if _stacked(x, old_n):
            z = torch.zeros((new_n - old_n, *x.shape[1:]), dtype=x.dtype,
                            device=x.device)
            return torch.cat([x, z], dim=0)
        return x

    return tree_map(pad, tree)


def take_agents(tree, old_n: int, index):
    """Select (shrink or reorder) the agent rows of every agent-stacked
    leaf (leading axis == old_n); other leaves pass through. Surviving rows
    are bitwise the old ones."""
    def take(x):
        if _stacked(x, old_n):
            idx = torch.as_tensor(index, dtype=torch.int64, device=x.device)
            return torch.index_select(x, 0, idx)
        return x

    return tree_map(take, tree)
