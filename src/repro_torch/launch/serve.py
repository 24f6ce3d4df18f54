"""Serving driver: batched greedy generation with the KV caches.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      [--reduced] [--device cpu] --batch 4 --prompt-len 8 --new-tokens 16

Weights are drawn from a seeded torch.Generator on the device (the card
unless --device cpu), so nothing is downloaded; an enc-dec model gets the
reference driver's 16 frames of encoder embeddings. Prints the reference
driver's line.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve import Engine, ServeConfig


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))

    extra = {}
    if cfg.is_encdec:
        extra["encoder_embeds"] = np.random.default_rng(0).normal(
            size=(args.batch, 16, cfg.d_model)).astype(np.float32)
    eng = Engine(cfg, params,
                 ServeConfig(max_new_tokens=args.new_tokens,
                             cache_len=args.cache_len), extra_batch=extra)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.time()
    out = eng.generate(prompts)
    dt = time.time() - t0
    print(f"arch={cfg.name} batch={args.batch} new={args.new_tokens} "
          f"wall={dt:.2f}s tok/s={args.batch * args.new_tokens / dt:.1f}")
    print("generated ids:\n", out)


if __name__ == "__main__":
    main()
