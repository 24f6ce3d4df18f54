"""Train-step factories.

Port of `repro/train/steps.py`. `make_train_step(cfg, opt_cfg, ccfg)`
returns (init_fn, step_fn, local_step_fn):

  * allreduce: the mean loss over the global batch, one gradient (with
    gradient accumulation over `microbatches`), AdamW or SGD;
  * dkla / coke / coke_et / cta: the paper's decentralized strategies. The
    batch carries a leading agent axis, each agent takes the gradient of
    its own loss, and `distributed.consensus` couples the agents over the
    ring; coke_et's local rounds are `local_step_fn`.

The parameters are a dict of tensors by the model's parameter names
(`models.model.param_dict`), agent-stacked (N, ...) for the consensus
strategies, and the loss runs them through a shapes-only skeleton of the
model (`models.model.loss_fn`). The reference vmaps
`jax.value_and_grad(loss_fn)` over the agents; the port loops over them
with `torch.autograd.grad`, because `torch.func.vmap` cannot see into the
attention kernels' launches: a step runs the forward and backward
attention kernels (K4, K7) N times per layer.

`init_fn(source)` starts the state from a `torch.Generator` (weights drawn
on its device) or from given weights (a dict of tensors by parameter
name, `models.model.param_dict`). `step_fn(state, batch)` and
`local_step_fn` take ownership of `state`, as a jitted step with donated
arguments does: the dict passed in is emptied and its tensors are
released as the step replaces them, so a step holds about one copy of
the state. Use the returned state.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import consensus as cns
from repro_torch.models import model as model_lib
from repro_torch.models.common import ModelConfig
from repro_torch.optim.optimizers import (OptConfig, apply_updates,
                                          init_opt_state, opt_update)


def _initial_params(cfg: ModelConfig, source) -> dict[str, torch.Tensor]:
    if isinstance(source, torch.Generator):
        return model_lib.param_dict(model_lib.init_params(cfg, source))
    return dict(source)


def _value_and_grad(model, cfg: ModelConfig, params: dict, batch: dict):
    """(loss, extras, grads) of `loss_fn` at `params`, detached."""
    leaves = {n: t.detach().requires_grad_() for n, t in params.items()}
    loss, extras = model_lib.loss_fn(leaves, cfg, batch, model=model)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (loss.detach(), {k: v.detach() for k, v in extras.items()},
            dict(zip(leaves, grads)))


def make_allreduce_step(cfg: ModelConfig, opt_cfg: OptConfig,
                        microbatches: int = 1):
    model = model_lib.skeleton(cfg)

    def init_fn(source):
        params = _initial_params(cfg, source)
        return {"params": params, "opt": init_opt_state(opt_cfg, params),
                "step": 0}

    def _grads(params, batch):
        if microbatches == 1:
            return _value_and_grad(model, cfg, params, batch)
        # gradient accumulation: one microbatch's activations at a time
        def split(x):
            return x.reshape(microbatches, x.shape[0] // microbatches,
                             *x.shape[1:])
        mbatch = {k: split(v) for k, v in batch.items()}
        dev = next(iter(params.values())).device
        zero = lambda: torch.zeros((), dtype=torch.float32, device=dev)
        g_acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                 for n, p in params.items()}
        loss_sum, aux_sum = zero(), zero()
        for i in range(microbatches):
            loss, extras, g = _value_and_grad(
                model, cfg, params, {k: v[i] for k, v in mbatch.items()})
            g_acc = {n: a + g[n].to(a.dtype) for n, a in g_acc.items()}
            del g
            loss_sum = loss_sum + loss
            aux_sum = aux_sum + extras["aux"]
        scale = 1.0 / microbatches
        grads = {n: g * scale for n, g in g_acc.items()}
        return loss_sum * scale, {"nll": loss_sum * scale,
                                  "aux": aux_sum * scale}, grads

    def step_fn(state, batch):
        params = state.pop("params")
        loss, extras, grads = _grads(params, batch)
        updates, opt = opt_update(opt_cfg, grads, state.pop("opt"), params)
        del grads
        params = apply_updates(params, updates)
        del updates
        metrics = {"loss": loss, **extras}
        return ({"params": params, "opt": opt,
                 "step": state.pop("step") + 1}, metrics)

    return init_fn, step_fn


def make_consensus_step(cfg: ModelConfig, opt_cfg: OptConfig,
                        ccfg: cns.ConsensusConfig, num_agents: int,
                        comm=None):
    """Batch layout: every leaf gains a leading agent axis (N, ...).

    comm — optional core.comm policy chain governing the broadcast
    (censor / quantize / drop); None = ccfg's legacy censor knobs."""
    model = model_lib.skeleton(cfg)

    def init_fn(source):
        stacked = cns.stack_params(_initial_params(cfg, source), num_agents)
        return {"params": stacked,
                "consensus": cns.init_consensus_state(ccfg, opt_cfg,
                                                      stacked, comm=comm)}

    def _local_grads(params_stacked, batch_stacked):
        """Each agent's gradient of its own loss, in turn, into one
        agent-stacked tree; the mean loss over the agents."""
        grads = {n: torch.empty(p.shape, dtype=p.dtype, device=p.device)
                 for n, p in params_stacked.items()}
        losses = []
        for i in range(num_agents):
            loss, _, g = _value_and_grad(
                model, cfg, {n: p[i] for n, p in params_stacked.items()},
                {k: v[i] for k, v in batch_stacked.items()})
            for n, gi in g.items():
                grads[n][i].copy_(gi)
            del g
            losses.append(loss)
        return torch.mean(torch.stack(losses)), grads

    def step_fn(state, batch):
        loss, grads = _local_grads(state["params"], batch)
        # hand params and grads over: consensus_update drops each tree
        # after its last use
        owned = [state.pop("params"), grads]
        del grads
        params, cstate, metrics = cns.consensus_update(
            ccfg, opt_cfg, owned.pop(0), owned.pop(0),
            state.pop("consensus"), comm=comm)
        metrics = {"loss": loss, "comms": cstate["comms"], **metrics}
        if ccfg.track_gap:  # a reduction over the whole stacked tree
            metrics["consensus_gap"] = cns.consensus_gap(params)
        return {"params": params, "consensus": cstate}, metrics

    def local_step_fn(state, batch):
        """coke_et's censored round: no exchange over the agent axis."""
        loss, grads = _local_grads(state["params"], batch)
        owned = [state.pop("params"), grads]
        del grads
        params, cstate = cns.local_update(opt_cfg, owned.pop(0),
                                          owned.pop(0),
                                          state.pop("consensus"))
        return {"params": params, "consensus": cstate}, {"loss": loss}

    return init_fn, step_fn, local_step_fn


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    ccfg: cns.ConsensusConfig | None = None,
                    num_agents: int = 1, microbatches: int = 1,
                    comm=None):
    if ccfg is None or ccfg.strategy == "allreduce":
        init_fn, step_fn = make_allreduce_step(cfg, opt_cfg, microbatches)
        return init_fn, step_fn, None
    return make_consensus_step(cfg, opt_cfg, ccfg, num_agents, comm=comm)


def agent_batch(batch: dict, num_agents: int) -> dict:
    """Reshape a global batch (B, ...) into (N, B/N, ...) agent shards."""
    def r(x):
        return x.reshape(num_agents, x.shape[0] // num_agents, *x.shape[1:])
    return {k: r(v) for k, v in batch.items()}
