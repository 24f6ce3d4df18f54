#!/usr/bin/env python3
"""Where a reduced model's training on the card parts from the CPU's.

    python3 scripts/train_probe.py [--fused] [--arch ARCH] [--seeds N]
        [--k7-source NAME=SOURCE.cu ...]
    python3 scripts/train_probe.py --hold ARCH [--plant-fault]

For the reduced qwen3-1.7b (phase 20(d)'s configuration, 4 KV heads, and
with 2 KV heads), mamba2-2.7b, zamba2-2.7b and zamba2-2.7b at head_dim 80,
from the same weights and batches as `chip_smoke.py` phase 20(d) and (f)
(TokenStream seq 48, batch 8, structure 0.9):
  1. one gradient on the card against the CPU's: the worst leaf's
     max|diff| over its max|g|, with the attention through K4 and K7 and
     with it through the plain version on the card (autograd through
     `ops._plain`, swapped in here only);
  2. 20 coke steps at 4 agents (v=20, mu=0.5, AdamW lr 3e-3) on the card
     against the CPU, both ways: each step's loss difference relative to
     the CPU's, and whether comms and send_frac are equal.
The swap isolates what K4 and K7 add to the parting from what the GEMMs'
order adds. --fused runs the coke steps through K3 (phase 20(d)'s second
run); --arch keeps the model of that tag (`qwen3-1.7b` is 20(d)'s own);
--seeds runs weights and stream seeds 0 .. N - 1 (20(d) runs seed 0); each
--k7-source (a K7 source with the kernel's C entry points, built beside
it) adds card runs through that K7.
3. with --fused or --k7-source, also each step from the CPU's state: the
   card's loss for that step against the CPU's (phase 20(f)'s hold).

--hold ARCH: phase 25(b)'s hold (`chip_smoke.card_cpu_hold`, coke at 4
agents, B=8 at S=96, TRAIN_MOE_MLA_STEPS steps) of the reduced ARCH, read
at TRAIN_MOE_MLA_RTOL; with --plant-fault, also with dK of KV head 0 zeroed
after every K7 launch, a fault the hold must catch.
Exits 2 without a card.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

MODELS = (("qwen3-1.7b", {}), ("qwen3-1.7b", {"num_kv_heads": 2}),
          ("mamba2-2.7b", {}), ("zamba2-2.7b", {}),
          ("zamba2-2.7b", {"head_dim": 80}))
STEPS = 20


def hold(dev, card, arch, plant):
    """Phase 25(b)'s coke hold of the reduced `arch`, sound and, with
    `plant`, with K7's dK of KV head 0 zeroed."""
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.distributed.consensus import ConsensusConfig
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.models import model as M

    cfg = get_config(arch).reduced()
    weights = M.param_dict(M.init_params(cfg,
                                         torch.Generator().manual_seed(0)))
    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=chip_smoke.TRAIN_MOE_MLA_SEQ,
        global_batch=8, structure=0.9))
    ccfg = ConsensusConfig(strategy="coke", rho=1e-3, censor_v=20.0,
                           censor_mu=0.5)
    sound = fab.gqa_flash_bwd

    def faulty(*args, **kwargs):
        dq, dk, dv = sound(*args, **kwargs)
        dk[:, :, 0] = 0.0
        return dq, dk, dv

    for way in ("sound", "planted fault") if plant else ("sound",):
        fab.gqa_flash_bwd = faulty if way != "sound" else sound
        try:
            h = chip_smoke.card_cpu_hold(dev, cfg, weights, stream, ccfg, 4,
                                         chip_smoke.TRAIN_MOE_MLA_STEPS)
        finally:
            fab.gqa_flash_bwd = sound
        for tol in (chip_smoke.TRAIN_MOE_MLA_RTOL,
                    chip_smoke.TRAIN_SMALL_RTOL):
            text, ok = chip_smoke.hold_line(h, True, tol=tol)
            print(f"[{card}] reduced {arch}, coke, 4 agents, K7 {way}: "
                  f"{text}; holds: {ok}", flush=True)


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--arch")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--k7-source", action="append", default=[],
                    metavar="NAME=SOURCE.cu")
    ap.add_argument("--hold", metavar="ARCH")
    ap.add_argument("--plant-fault", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_probe: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.distributed.consensus import ConsensusConfig
    from repro_torch.kernels import build
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
    sys.path.insert(0, str(ROOT / "scripts"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from k4_accuracy import compile_sources
    build.build(("flash_attention", "flash_attention_bwd"))
    if args.hold:
        hold(dev, card, args.hold, args.plant_fault)
        return 0
    k7_libs = {"K4 and K7": build.load("flash_attention_bwd", {})}
    k7_libs.update((f"K4 and K7 {n}", lib) for n, lib in compile_sources(
        args.k7_source, "flash_attention_bwd").items())

    def plain_gqa(q, k, v, *, causal=True, window=0, block_q=128,
                  block_k=128):
        return ops._plain(q, k, v, causal, window)

    def attention(plain):
        A.gqa_flash = plain_gqa if plain else ops.gqa_flash

    for (arch, over), seed in ((m, s) for m in MODELS
                               for s in range(args.seeds)):
        tag = f"{arch}{' ' + str(over) if over else ''}"
        if args.arch and tag != args.arch:
            continue
        cfg = get_config(arch).reduced().with_overrides(**over)
        tag += f" seed {seed}"
        weights = M.param_dict(M.init_params(
            cfg, torch.Generator().manual_seed(seed)))
        stream = TokenStream(TokenStreamConfig(
            vocab_size=cfg.vocab_size, seq_len=48, global_batch=8,
            seed=seed, structure=0.9))

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
                               censor_mu=0.5, use_fused_kernel=args.fused)
        runs, fns, cpu_states = {}, {}, []
        ways = [("cpu", "cpu")] + [(dev, name) for name in k7_libs] + [
            (dev, "plain attention")]
        for where, way in ways:
            attention(way == "plain attention")
            if way in k7_libs:
                build._LIBS["flash_attention_bwd"] = k7_libs[way]
            init_fn, fns[way], _ = S.make_train_step(
                cfg, OptConfig(lr=3e-3), ccfg, num_agents=4)
            state = init_fn({k: x.to(where) for k, x in weights.items()})
            rows = []
            for i in range(STEPS):
                if way == "cpu":
                    cpu_states.append(chip_smoke.state_on(state, "cpu"))
                state, m = fns[way](state, batch(i, where, 4))
                rows.append((float(m["loss"]), int(m["comms"]),
                             float(m["send_frac"])))
            runs[way] = rows
        attention(False)
        build._LIBS["flash_attention_bwd"] = k7_libs["K4 and K7"]
        cpu = runs["cpu"]
        for _, way in ways[1:]:
            got = runs[way]
            rel = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, cpu)]
            same = [a[1:] for a in got] == [b[1:] for b in cpu]
            print(f"[{card}] {tag}: {STEPS} coke steps"
                  f"{' with K3' if args.fused else ''}, card {way} against "
                  f"the CPU: comms and send_frac equal {same}; loss "
                  f"difference per step "
                  f"{', '.join(f'{x:.1e}' for x in rel)}; max "
                  f"{max(rel):.3e}", flush=True)
        if not (args.fused or args.k7_source):
            continue
        for way, lib in k7_libs.items():
            build._LIBS["flash_attention_bwd"] = lib
            rel = []
            for i in range(STEPS):
                m = fns[way](chip_smoke.state_on(cpu_states[i], dev),
                             batch(i, dev, 4))[1]
                rel.append(abs(float(m["loss"]) - cpu[i][0]) / abs(cpu[i][0]))
            print(f"[{card}] {tag}: each step from the CPU's state, card "
                  f"{way}: that step's loss against the CPU's, max "
                  f"{max(rel):.3e}", flush=True)
        build._LIBS["flash_attention_bwd"] = k7_libs["K4 and K7"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
