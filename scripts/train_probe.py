#!/usr/bin/env python3
"""Where a reduced model's training on the card parts from the CPU's.

    python3 scripts/train_probe.py

For the reduced qwen3-1.7b (2 KV heads), mamba2-2.7b, zamba2-2.7b and
zamba2-2.7b at head_dim 80, from the same weights and batches as
`chip_smoke.py` phase 20(d) and (f) (TokenStream seq 48, batch 8,
structure 0.9):
  1. one gradient on the card against the CPU's: the worst leaf's
     max|diff| over its max|g|, with the attention through K4 and K7 and
     with it through the plain version on the card (autograd through
     `ops._plain`, swapped in here only);
  2. 20 coke steps at 4 agents (v=20, mu=0.5, AdamW lr 3e-3) on the card
     against the CPU, both ways: each step's loss difference relative to
     the CPU's, and whether comms and send_frac are equal.
The swap isolates what K4 and K7 add to the parting from what the GEMMs'
order adds. Exits 2 without a card.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

MODELS = (("qwen3-1.7b", {"num_kv_heads": 2}), ("mamba2-2.7b", {}),
          ("zamba2-2.7b", {}), ("zamba2-2.7b", {"head_dim": 80}))
STEPS = 20


def main() -> int:
    if not torch.cuda.is_available():
        print("train_probe: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.distributed.consensus import ConsensusConfig
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train import steps as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)

    def plain_gqa(q, k, v, *, causal=True, window=0, block_q=128,
                  block_k=128):
        return ops._plain(q, k, v, causal, window)

    def attention(plain):
        A.gqa_flash = plain_gqa if plain else ops.gqa_flash

    for arch, over in MODELS:
        cfg = get_config(arch).reduced().with_overrides(**over)
        tag = f"{arch}{' ' + str(over) if over else ''}"
        weights = M.param_dict(M.init_params(
            cfg, torch.Generator().manual_seed(0)))
        stream = TokenStream(TokenStreamConfig(
            vocab_size=cfg.vocab_size, seq_len=48, global_batch=8,
            structure=0.9))

        def batch(i, where, agents=None):
            toks, labels = stream.batch(i)
            b = {"tokens": torch.as_tensor(toks, device=where),
                 "labels": torch.as_tensor(labels, device=where)}
            return S.agent_batch(b, agents) if agents else b

        grads = {}
        for where, plain in (("cpu", False), (dev, False), (dev, True)):
            attention(plain)
            params = {k: x.to(where) for k, x in weights.items()}
            _, _, g = S._value_and_grad(M.skeleton(cfg), cfg, params,
                                        batch(0, where))
            grads[(str(where), plain)] = {k: x.cpu() for k, x in g.items()}
        attention(False)
        want = grads[("cpu", False)]
        for key in ((str(dev), False), (str(dev), True)):
            worst = max(((float((grads[key][k] - w).abs().max())
                          / max(float(w.abs().max()), 1e-30)), k)
                        for k, w in want.items())
            print(f"[{card}] {tag}: one gradient, card "
                  f"{'plain attention' if key[1] else 'K4 and K7'} against "
                  f"the CPU: worst leaf {worst[1]} {worst[0]:.3e} of its "
                  "max", flush=True)
        ccfg = ConsensusConfig(strategy="coke", rho=1e-3, censor_v=20.0,
                               censor_mu=0.5)
        runs = {}
        for where, plain in (("cpu", False), (dev, False), (dev, True)):
            attention(plain)
            init_fn, step_fn, _ = S.make_train_step(
                cfg, OptConfig(lr=3e-3), ccfg, num_agents=4)
            state = init_fn({k: x.to(where) for k, x in weights.items()})
            rows = []
            for i in range(STEPS):
                state, m = step_fn(state, batch(i, where, 4))
                rows.append((float(m["loss"]), int(m["comms"]),
                             float(m["send_frac"])))
            runs[(str(where), plain)] = rows
        attention(False)
        cpu = runs[("cpu", False)]
        for key in ((str(dev), False), (str(dev), True)):
            got = runs[key]
            rel = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, cpu)]
            same = [a[1:] for a in got] == [b[1:] for b in cpu]
            print(f"[{card}] {tag}: {STEPS} coke steps, card "
                  f"{'plain attention' if key[1] else 'K4 and K7'} against "
                  f"the CPU: comms and send_frac equal {same}; loss "
                  f"difference per step "
                  f"{', '.join(f'{x:.1e}' for x in rel)}; max "
                  f"{max(rel):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
