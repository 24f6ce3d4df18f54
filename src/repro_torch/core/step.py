"""The step-composition layer: one per-iteration skeleton for the ADMM
family, as in the reference's `core/step.py`.

Every iteration runs the same named stages: `exchange` (the graph view),
`primal` (the (21a) update), the comm chain's broadcast decision, the
(21b) dual ascent against the fresh broadcasts, and the transmission
count. A backend substitutes stages; `run_step` owns the order.

Only synchronous execution is ported: the reference's `comm_decide`
stage (gossip participation) arrives with ROADMAP.md Queue 1 item 10.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class GraphView:
    """What one iteration sees of the consensus graph: (N,) degrees and a
    neighbour-sum operator x (N, ...) -> sum_n w x_n."""

    deg: torch.Tensor
    nbr_sum: Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StepProgram:
    """One per-iteration program: the comm chain, the dual stepsize and the
    substitutable stages. `exchange(state, k)` gives the GraphView;
    `primal(k, g, theta0, theta_hat0, gamma0, nbr_hat)` returns (theta_new,
    extras). `primal_owns_exchange=True` declares that the primal stage
    reads its neighbours' theta_hat itself (the fused megakernel does), so
    `run_step` skips the pre-primal neighbour sum and passes nbr_hat=None."""

    chain: Any
    rho: float
    exchange: Callable[[Any, int], GraphView]
    primal: Callable
    primal_owns_exchange: bool = False


def run_step(program: StepProgram, state):
    """Execute one iteration of `program` on a (theta, theta_hat, gamma,
    step, comms, comm) carry; returns (new_state, extras)."""
    chain = program.chain
    k = state.step + 1
    comm_state = chain.ensure_state(state.comm, state.theta.shape[0],
                                    state.theta.device)
    g = program.exchange(state, k)

    theta0, theta_hat0, gamma0 = state.theta, state.theta_hat, state.gamma
    nbr_hat = (None if program.primal_owns_exchange
               else g.nbr_sum(theta_hat0))
    theta, extras = program.primal(k, g, theta0, theta_hat0, gamma0, nbr_hat)

    theta_hat, send, comm_state = chain.apply(theta, theta_hat0, k,
                                              comm_state)

    # dual (21b): gamma_i += rho * sum_n (theta_hat_i - theta_hat_n)
    nbr_new = g.nbr_sum(theta_hat)
    gamma = gamma0 + program.rho * (g.deg[:, None] * theta_hat - nbr_new)

    new_state = type(state)(
        theta=theta, theta_hat=theta_hat, gamma=gamma, step=k,
        comms=state.comms + torch.sum(send, dtype=torch.int32),
        comm=comm_state)
    return new_state, extras
