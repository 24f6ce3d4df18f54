"""The step-composition layer: one per-iteration skeleton for the ADMM
family, as in the reference's `core/step.py`.

Every iteration runs the same named stages: `exchange` (the graph view),
`primal` (the (21a) update), the comm chain's broadcast decision, the
(21b) dual ascent against the fresh broadcasts, and the transmission
count. A backend substitutes stages; `run_step` owns the order.

Only synchronous execution is ported: the reference's `comm_decide`
stage (gossip participation) arrives with ROADMAP.md Queue 1 item 10.
The simulator's exchange is `dense_view` (`A @ x` over the adjacency);
the fused megakernel path builds its own ring view.

A sweep runs G policy cells as one program on a leading lane axis: theta,
theta_hat and gamma are (G, N, D), `comms` is (G,), and the chain is a
`core.comm.LaneChain`. The stages broadcast over the lane axis (`A @ x`
over (G, N, D), degrees as (N, 1)); where the reference `vmap`s a whole
fit, the port batches one step.

`stream_primal` is the streaming family's featurize + primal stage
(online-DKLA / online-COKE, and QC-ODKLA's linearized-ADMM form).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class GraphView:
    """What one iteration sees of the consensus graph: (N,) degrees, a
    neighbour-sum operator x (N, ...) -> sum_n w x_n, and, under a topology
    schedule, the Cholesky factors of the graph in effect."""

    deg: torch.Tensor
    nbr_sum: Callable[[torch.Tensor], torch.Tensor]
    chol: torch.Tensor | None = None


def dense_view(adjacency: torch.Tensor, deg: torch.Tensor | None = None,
               chol: torch.Tensor | None = None) -> GraphView:
    """A dense (possibly Erdos-Renyi) graph: `A @ x` neighbour sums, as the
    simulator exchanges."""
    d = torch.sum(adjacency, dim=1) if deg is None else deg
    return GraphView(deg=d, nbr_sum=lambda x: adjacency @ x, chol=chol)


def true_div(x: torch.Tensor, value: float) -> torch.Tensor:
    """x / value as one float32 division, on the card too: CUDA divides a
    tensor by a host scalar through its reciprocal (a second rounding), the
    reference divides; a 0-d device tensor keeps the division."""
    return x / torch.full((), value, dtype=x.dtype, device=x.device)


def stream_primal(feats: torch.Tensor, labels: torch.Tensor, *, lam: float,
                  rho: float, lr: float, eta: float | None) -> Callable:
    """The streaming featurize + primal stage shared by online-DKLA/COKE
    (eta=None: one gradient step of size lr on the streaming augmented
    Lagrangian) and QC-ODKLA (eta=float: the linearized-ADMM closed form,
    a gradient step of size 1/(eta + 2 rho deg_i), written in the same
    subtractive form so that the two modes share every other float op).
    feats (N, b, D), labels (N, b): the round's fresh minibatch. Emits the
    pre-update instantaneous MSE, the online protocol's regret sample."""
    def stage(k, g: GraphView, theta0, theta_hat0, gamma0, nbr_hat):
        N = feats.shape[0]
        deg = g.deg
        preds = torch.einsum("nbd,nd->nb", feats, theta0)
        inst_mse = torch.mean((labels - preds) ** 2)
        resid = preds - labels
        g_data = true_div(2.0 * torch.einsum("nb,nbd->nd", resid, feats),
                          feats.shape[1])
        grad = (g_data + (2.0 * lam / N) * theta0
                + 2.0 * rho * deg[:, None] * theta0
                + gamma0
                - rho * (deg[:, None] * theta_hat0 + nbr_hat))
        if eta is None:
            theta_new = theta0 - lr * grad
        else:
            theta_new = theta0 - grad / (eta + 2.0 * rho * deg[:, None])
        return theta_new, {"inst_mse": inst_mse}
    return stage


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
    comm_state = chain.ensure_state(state.comm, state.theta.shape[-2],
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
    gamma = gamma0 + program.rho * (g.deg[..., None] * theta_hat - nbr_new)

    new_state = type(state)(
        theta=theta, theta_hat=theta_hat, gamma=gamma, step=k,
        comms=state.comms + torch.sum(send, dim=-1, dtype=torch.int32),
        comm=comm_state)
    return new_state, extras
