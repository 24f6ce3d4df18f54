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

On a mesh (`mesh=`, `launch.mesh.make_host_mesh(data, 1, group=)`: the
reference's data-parallel layout, one COKE agent per batch block of the
mesh, `launch/dryrun.py::_agent_stack_specs`), the steps run SPMD over
the mesh's ranks, every rank with the same arguments:

  * consensus strategies, data = N: the agent stack is cut over the batch
    axis (`sharding.agent_stack_spec`). `init_fn` draws the weights once
    and stacks only the rank's own agents (`sharding.from_rows`); each
    step takes the gradients of the rank's own agents, in agent order,
    from their rows of the (N, B/N, ...) batch, and `consensus_update`
    exchanges the rows over the ranks (`sharding.gather_ranks`). K4 and
    K7 run N/W times per layer on each of the W ranks. The step's loss is
    the N agents' losses gathered in agent order, then the one-process
    mean; comms, send_frac, bits and consensus_gap are the layer's
    ascending-order reductions, the same on every rank.
  * allreduce, data = W: each rank takes its 1/W of the global batch;
    the gradients are gathered and folded in rank order as `microbatches
    = W` folds its microbatches (0 + g_0 + g_1 + ..., then x 1/W), so a
    step is bitwise the one-process step with microbatches=W. Every rank
    keeps the whole parameters and AdamW slots.

A mesh whose "model" extent is > 1 (an agent's layers cut over "model")
and fsdp raise NotImplementedError (ROADMAP.md Queue 1 item 14f), as does
a consensus mesh whose batch extent is not the agent count.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import consensus as cns
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import num_agents as batch_extent
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


LATER = "ROADMAP.md Queue 1 item 14f"


def _check_mesh(mesh, fsdp: bool) -> None:
    if fsdp:
        raise NotImplementedError(
            "fsdp (the weights cut over the batch axes) in the trainer is "
            f"{LATER}")
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            f"a train step on a mesh whose 'model' extent is "
            f"{mesh.shape['model']}: an agent's layers cut over 'model' "
            f"(tensor parallelism) is {LATER}")


def _fold_ranks(rows: torch.Tensor, mesh, scale: float) -> torch.Tensor:
    """This rank's rows of per-batch-block values (one row per batch
    block it holds) gathered in block order over the mesh, then summed
    as gradient accumulation sums its microbatches: 0 + row_0 + row_1 +
    ..., then x scale."""
    whole = sharding.unshard(sharding.from_rows(
        rows, mesh, batch_extent(mesh)))
    acc = torch.zeros(whole.shape[1:], dtype=torch.float32,
                      device=whole.device)
    for r in range(whole.shape[0]):
        acc = acc + whole[r].to(acc.dtype)
    return acc * scale


def make_allreduce_step(cfg: ModelConfig, opt_cfg: OptConfig,
                        microbatches: int = 1, mesh=None,
                        fsdp: bool = False):
    _check_mesh(mesh, fsdp)
    if mesh is not None and microbatches != 1:
        raise ValueError("on a mesh each batch block is one microbatch: "
                         f"microbatches={microbatches} has no meaning there")
    model = model_lib.skeleton(cfg)

    def init_fn(source):
        params = _initial_params(cfg, source)
        return {"params": params, "opt": init_opt_state(opt_cfg, params),
                "step": 0}

    def _ranked_grads(params, batch):
        """Each batch block this rank holds, its gradient; folded over
        the blocks of every rank in block order."""
        W = batch_extent(mesh)
        b0, nb = mesh.local_range("batch")
        parts = {k: v.reshape(W, v.shape[0] // W, *v.shape[1:])
                 for k, v in batch.items()}
        vals, grads = [], []
        for b in range(b0, b0 + nb):
            loss, extras, g = _value_and_grad(
                model, cfg, params, {k: v[b] for k, v in parts.items()})
            vals.append(torch.stack([loss, extras["aux"]]))
            grads.append(g)
        scale = 1.0 / W
        total = _fold_ranks(torch.stack(vals), mesh, scale)
        out = {}
        for n in params:
            rows = [g.pop(n) for g in grads]
            out[n] = _fold_ranks(rows[0][None] if nb == 1
                                 else torch.stack(rows), mesh, scale)
            del rows
        return total[0], {"nll": total[0], "aux": total[1]}, out

    def _grads(params, batch):
        if mesh is not None:
            return _ranked_grads(params, batch)
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
                        comm=None, mesh=None, fsdp: bool = False):
    """Batch layout: every leaf gains a leading agent axis (N, ...).

    comm — optional core.comm policy chain governing the broadcast
    (censor / quantize / drop); None = ccfg's legacy censor knobs.
    mesh — a (data=N, model=1) mesh: the agents on their own ranks (the
    module docstring)."""
    _check_mesh(mesh, fsdp)
    if mesh is not None and batch_extent(mesh) != num_agents:
        raise NotImplementedError(
            f"{num_agents} agents on a mesh of batch extent "
            f"{batch_extent(mesh)}: the trainer puts one agent "
            f"on each batch block (data = N); other cuts are {LATER}")
    model = model_lib.skeleton(cfg)
    own = range(num_agents) if mesh is None else sharding.agent_range(
        mesh, num_agents)

    def init_fn(source):
        params = _initial_params(cfg, source)
        if mesh is None:
            stacked = cns.stack_params(params, num_agents)
        else:
            # all agents start equal: this rank's rows only
            stacked = {n: sharding.from_rows(
                p[None].expand(len(own), *p.shape).contiguous(), mesh,
                num_agents) for n, p in params.items()}
        del params
        return {"params": stacked,
                "consensus": cns.init_consensus_state(ccfg, opt_cfg,
                                                      stacked, comm=comm)}

    def _local_grads(params_stacked, batch_stacked):
        """Each agent's gradient of its own loss, in turn (on a mesh the
        rank's own agents, in agent order), into one agent-stacked tree;
        the mean loss over the agents."""
        grads = {n: torch.empty(p.shape, dtype=p.dtype, device=p.device)
                 if mesh is None else torch.empty_like(p)
                 for n, p in params_stacked.items()}
        row = sharding.agent_row
        losses = []
        for i in own:
            loss, _, g = _value_and_grad(
                model, cfg, {n: row(p, i) for n, p in params_stacked.items()},
                {k: row(v, i) for k, v in batch_stacked.items()})
            for n, gi in g.items():
                row(grads[n], i).copy_(gi)
            del g
            losses.append(loss)
        losses = torch.stack(losses)
        if mesh is not None:    # the N losses, gathered in agent order
            losses = sharding.unshard(sharding.from_rows(losses, mesh,
                                                         num_agents))
        return torch.mean(losses), grads

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
        """coke_et's censored round: no exchange over the agent axis (on a
        mesh only the N losses are gathered, for the metric)."""
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
                    comm=None, mesh=None, fsdp: bool = False):
    """mesh — None (one process holds every agent), or a (data, 1) mesh:
    data = N for the consensus strategies, W for allreduce (the module
    docstring). fsdp raises NotImplementedError (item 14f)."""
    if ccfg is None or ccfg.strategy == "allreduce":
        init_fn, step_fn = make_allreduce_step(cfg, opt_cfg, microbatches,
                                               mesh=mesh, fsdp=fsdp)
        return init_fn, step_fn, None
    return make_consensus_step(cfg, opt_cfg, ccfg, num_agents, comm=comm,
                               mesh=mesh, fsdp=fsdp)


def agent_batch(batch: dict, num_agents: int) -> dict:
    """Reshape a global batch (B, ...) into (N, B/N, ...) agent shards."""
    def r(x):
        return x.reshape(num_agents, x.shape[0] // num_agents, *x.shape[1:])
    return {k: r(v) for k, v in batch.items()}
