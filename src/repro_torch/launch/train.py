"""Training driver: allreduce DP and every consensus strategy on the LM.

Port of `repro/launch/train.py`, with its arguments and defaults (AdamW,
grad_clip 1.0), plus --device (the card unless --device cpu):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --reduced --strategy coke --agents 4 --steps 50 [--device cpu]

Weights are drawn from a seeded torch.Generator on the device (the
reference draws from jax's PRNG: the runs start from other weights); the
token batches are the reference's. Prints the reference's JSON line per
logged step; --ckpt writes the final parameters in the reference's tree
layout (`convert.lm_params_to_numpy`), which `repro.ckpt.restore` reads.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.ckpt.checkpoint import save
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_to_numpy
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.consensus import ConsensusConfig
from repro_torch.optim.optimizers import OptConfig
from repro_torch.train.steps import agent_batch, make_train_step


def flat_checkpoint(tree: dict, prefix: str = "") -> dict:
    """The reference's checkpoint keys: a nested dict's paths joined by
    '/', as `repro.ckpt.save` writes them."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_checkpoint(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced family variant (CPU-runnable)")
    ap.add_argument("--strategy", default="allreduce",
                    choices=["allreduce", "dkla", "coke", "coke_et", "cta"])
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--rho", type=float, default=1e-3)
    ap.add_argument("--censor-v", type=float, default=1.0)
    ap.add_argument("--censor-mu", type=float, default=0.99)
    ap.add_argument("--local-steps", type=int, default=1,
                    help="coke_et: local steps per consensus round")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    opt_cfg = OptConfig(kind="adamw", lr=args.lr, grad_clip=1.0)
    ccfg = None
    if args.strategy != "allreduce":
        ccfg = ConsensusConfig(strategy=args.strategy, rho=args.rho,
                               censor_v=args.censor_v,
                               censor_mu=args.censor_mu,
                               local_steps=args.local_steps)
    init_fn, step_fn, local_fn = make_train_step(
        cfg, opt_cfg, ccfg, num_agents=args.agents)
    state = init_fn(torch.Generator(device=dev).manual_seed(0))

    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch))

    t0 = time.time()
    for i in range(args.steps):
        toks, labels = stream.batch(i)
        batch = {"tokens": torch.as_tensor(toks, device=dev),
                 "labels": torch.as_tensor(labels, device=dev)}
        if ccfg is not None:
            batch = agent_batch(batch, args.agents)
            if (args.strategy == "coke_et"
                    and (i + 1) % max(args.local_steps, 1) != 0):
                state, metrics = local_fn(state, batch)
            else:
                state, metrics = step_fn(state, batch)
        else:
            state, metrics = step_fn(state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            m = {k: float(metrics[k]) for k in sorted(metrics)
                 if torch.as_tensor(metrics[k]).ndim == 0}
            print(json.dumps({"step": i, **m,
                              "wall_s": round(time.time() - t0, 1)}),
                  flush=True)

    if args.ckpt:
        params = lm_params_to_numpy(state["params"])
        save(args.ckpt, flat_checkpoint(params), step=args.steps)
        print(f"saved checkpoint to {args.ckpt}.npz")


if __name__ == "__main__":
    main()
