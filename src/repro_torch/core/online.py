"""Online (streaming) COKE, the paper's future-work direction, as in the
reference's `core/online.py`.

Each round every agent receives a fresh minibatch from its local stream,
takes one step on the streaming augmented Lagrangian (`core.step.
stream_primal`: a gradient step, or QC-ODKLA's linearized-ADMM closed
form), censors / quantizes / drops its broadcast through the comm chain,
and exchanges theta_hat with its neighbours. With v = 0 it is online
DKLA. The regret sample is the instantaneous MSE on the incoming
minibatch, before the update.

The round counter `step` is a host int, as in the batch simulator: a
round's threshold and draw keys are formed without reading the device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import comm as comm_mod
from repro_torch.core import step as step_mod


class OnlineState(NamedTuple):
    theta: torch.Tensor       # (N, D)
    theta_hat: torch.Tensor   # (N, D)
    gamma: torch.Tensor       # (N, D)
    step: int                 # rounds done (host int)
    comms: torch.Tensor       # () int32 cumulative transmissions
    comm: comm_mod.CommState | None = None


def init_state(num_agents: int, feature_dim: int,
               dtype=torch.float32, policy=None,
               device: torch.device | str = "cpu") -> OnlineState:
    def z():
        return torch.zeros((num_agents, feature_dim), dtype=dtype,
                           device=device)

    return OnlineState(z(), z(), z(), 0,
                       torch.zeros((), dtype=torch.int32, device=device),
                       comm_mod.as_chain(policy).init_state(num_agents,
                                                            device))


def stream_step(state: OnlineState, feats: torch.Tensor,
                labels: torch.Tensor, adjacency: torch.Tensor, schedule, *,
                lam: float, rho: float, lr: float, eta: float | None = None
                ) -> tuple[OnlineState, torch.Tensor]:
    """One streaming round, shared by the online family. feats (N, b, D)
    and labels (N, b) are the round's minibatch; `schedule` any
    `core.comm` policy. Returns (new state, pre-update instantaneous
    MSE). eta=None takes one gradient step of size lr; eta=float the
    QC-ODKLA linearized-ADMM step of size 1/(eta + 2 rho deg_i), in the
    same subtractive form (with eta=None and step lr the two modes agree
    bit for bit)."""
    program = step_mod.StepProgram(
        chain=comm_mod.as_chain(schedule), rho=rho,
        exchange=lambda s, k: step_mod.dense_view(adjacency),
        primal=step_mod.stream_primal(feats, labels, lam=lam, rho=rho,
                                      lr=lr, eta=eta))
    new_state, extras = step_mod.run_step(program, state)
    return new_state, extras["inst_mse"]


def online_coke_step(state: OnlineState, feats: torch.Tensor,
                     labels: torch.Tensor, adjacency: torch.Tensor,
                     schedule, *, lam: float, rho: float,
                     lr: float) -> tuple[OnlineState, torch.Tensor]:
    """`stream_step` with the gradient primal."""
    return stream_step(state, feats, labels, adjacency, schedule,
                       lam=lam, rho=rho, lr=lr, eta=None)


def run_stream(state: OnlineState, adjacency: torch.Tensor, schedule, *,
               lam: float, rho: float, lr: float, num_rounds: int,
               batch_fn: Callable[[int], tuple[torch.Tensor, torch.Tensor]]):
    """`num_rounds` rounds of streaming COKE; batch_fn(k) -> (feats,
    labels) for the host round index k. Returns (state, instantaneous MSE
    (num_rounds,), cumulative comms (num_rounds,)) as device tensors."""
    # align the carried policy state with the schedule's chain first, so a
    # state made without a policy still runs
    state = state._replace(comm=comm_mod.as_chain(schedule).ensure_state(
        state.comm, state.theta.shape[0], state.theta.device))
    mses, comms = [], []
    for k in range(num_rounds):
        feats, labels = batch_fn(k)
        state, mse = online_coke_step(state, feats, labels, adjacency,
                                      schedule, lam=lam, rho=rho, lr=lr)
        mses.append(mse)
        comms.append(state.comms)
    if not num_rounds:
        empty = torch.empty((0,), device=state.theta.device)
        return state, empty, empty.to(torch.int32)
    return state, torch.stack(mses), torch.stack(comms)
