#!/usr/bin/env python3
"""Trace a prefill of S + 1 tokens against a prefill of S tokens and one
decode step, layer by layer at full width on a CUDA card, for each LM
family of `chip_smoke.LM_FAMILY` (its depth cuts; S + 1 the prompt and one
token, or `HOLD_TOKENS`). This is why `chip_smoke.py` phase 22(c) holds the
decode step layer by layer, not through the whole stack: end to end the
two part by more than chip_smoke.LM_RTOL.

For each layer it prints the last token's hidden state in the prefill of
S + 1 against:
  decode     the prefill of S, then one decode step (the hold itself);
  plain      the same prefill of S + 1 with K4 replaced by its plain
             version (`ops._plain`, a full fp32 softmax on the card);
  batch      the same prefill of S + 1 with the batch doubled (the same
             arithmetic in other GEMM shapes: fp32's own noise floor);
each as max|diff| / max|hidden|, and for a MoE layer whether the last
token's top-k experts agree between the prefill and the decode step, with
the gap between its k-th and (k+1)-th router probability. Then the same
three for the last position's logits, against chip_smoke.LM_RTOL.

    python3 scripts/lm_hold_probe.py [arch ...]

Exits 2 without a card. Prints the card's name and power limit first.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# the MoE models' S + 1 at batch 1, in one group of all the tokens with
# capacity C = group, so that no token is dropped (the decode step's group
# of one drops none, and a drop in the longer prefill would part the two
# by design); Mixtral's exceeds its window of 4096
HOLD_TOKENS = {"deepseek-v2-lite-16b": 512, "mixtral-8x7b": 4224}


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_hold_probe: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as blk
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import rms_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    want = set(sys.argv[1:])

    routed = []
    real_route = moe_mod.route

    def recording_route(*a, **kw):
        r = real_route(*a, **kw)
        routed.append(r)
        return r

    moe_mod.route = recording_route
    kernel_flash = A.gqa_flash

    def plain_flash(q, k, v, *, causal=True, window=0):
        return ops._plain(q, k, v, causal, window)

    for arch, layers, B, S, cache in cs.LM_FAMILY:
        if want and arch not in want:
            continue
        cfg = get_config(arch)
        if layers is not None:
            cfg = cfg.with_overrides(num_layers=layers)
        hold = HOLD_TOKENS.get(arch)
        hcfg, hb, S1, hcache = cfg, B, S + 1, cache
        if hold:
            hb, S1, hcache = 1, hold, min(cache, hold)
            hcfg = cfg.with_overrides(
                moe_group_size=hold,
                moe_capacity_factor=cfg.num_experts / cfg.top_k)
        kind = M.layer_kind(cfg)
        torch.cuda.empty_cache()
        lm = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        tokens = torch.as_tensor(np.random.default_rng(22).integers(
            0, cfg.vocab_size, (hb, S1)), device=dev)
        print(f"{arch}: {cfg.num_layers} layers, hold {hb} x {S1} tokens "
              f"against {S1 - 1} and one decode step, cache {hcache}, "
              f"{kind} layers, {cfg.attn_kind}, window {cfg.sliding_window}"
              f"{', C = group' if hold else ''}", flush=True)
        full_pos = torch.arange(S1, dtype=torch.int32, device=dev)
        with torch.inference_mode():
            emb = torch.nn.functional.embedding(tokens, lm.embed)
            xf, xp, xd = emb, emb[:, :-1], emb[:, -1:]
            xq = emb
            xb = torch.cat([emb, emb])
            for i, lp in enumerate(lm.blocks):
                routed.clear()
                xf, _ = blk.block_forward(lp, hcfg, xf, full_pos, kind)
                rf = routed[-1] if routed else None
                xp, _, c = blk.block_forward(lp, hcfg, xp, full_pos[:-1],
                                             kind, cache_len=hcache)
                routed.clear()
                xd, c = blk.block_decode(lp, hcfg, xd, None, kind, c, S1 - 1)
                rd = routed[-1] if routed else None
                A.gqa_flash = plain_flash
                try:
                    xq, _ = blk.block_forward(lp, hcfg, xq, full_pos, kind)
                finally:
                    A.gqa_flash = kernel_flash
                xb, _ = blk.block_forward(lp, hcfg, xb, full_pos, kind)
                last = xf[:, -1]
                scale = float(last.abs().max())
                e = [float((last - other).abs().max()) / scale
                     for other in (xd[:, 0], xq[:, -1], xb[:hb, -1])]
                line = (f"  layer {i:2d}: |x| {scale:9.4f}  decode "
                        f"{e[0]:.3e}  plain {e[1]:.3e}  batch {e[2]:.3e}")
                if rf is not None:
                    ef = rf.expert_idx[-1, -1].sort().values
                    ed = rd.expert_idx[0, 0].sort().values
                    top = rf.probs[-1, -1].sort(descending=True).values
                    gap = float(top[cfg.top_k - 1] - top[cfg.top_k])
                    line += (f"  experts equal {bool(torch.equal(ef, ed))}"
                             f" (margin {gap:.3e})")
                print(line, flush=True)
                del c
            logits = []
            for x in (xf[:, -1:], xd, xq[:, -1:], xb[:hb, -1:]):
                logits.append(rms_norm(x, lm.final_norm, cfg.norm_eps)
                              @ lm.lm_head)
            scale = float(logits[0].abs().max())
            e = [float((logits[0] - other).abs().max()) / scale
                 for other in logits[1:]]
            print(f"  logits: max {scale:.4f}; decode {e[0]:.3e}  plain "
                  f"{e[1]:.3e}  batch {e[2]:.3e} (LM_RTOL {cs.LM_RTOL:g})",
                  flush=True)
        del lm, xf, xp, xd, xq, xb, emb, logits
    return 0


if __name__ == "__main__":
    sys.exit(main())
