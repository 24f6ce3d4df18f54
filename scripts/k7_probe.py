#!/usr/bin/env python3
"""Build K7 (`csrc/flash_attention_bwd.cu`) on a CUDA card, print its ptxas
report per instance and its tensor-core instructions, hold every instance
against the plain backward (`ref.attention_bwd_ref`) at the card tests'
shapes, and time each instance at the training shape (B=8, S=64, 16/8
heads of 128) and the prefill shape (2 x 4096) beside the backward of
F.scaled_dot_product_attention, in one call.

    python3 scripts/k7_probe.py [--quick]

`--quick` checks the plan's instances only and times nothing. Times are
cold-L2 device times (`chip_smoke.flushed_ms`), printed with the card's
name and power limit. Exits 2 without a card, 1 if an instance disagrees
with the plain version beyond chip_smoke.K7_RTOL.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# (B, H, KV, Sq, Sk, D, causal, window): tests/test_torch_cuda.py's
# ATTN_BWD_SHAPES
SHAPES = [(8, 16, 8, 64, 64, 128, True, 0),
          (2, 16, 8, 1000, 1000, 128, True, 256),
          (3, 4, 2, 77, 77, 64, True, 0),
          (8, 4, 2, 64, 64, 64, True, 0),
          (1, 2, 2, 90, 40, 64, True, 16),
          (2, 2, 1, 100, 100, 40, True, 0),
          (1, 2, 2, 130, 130, 256, True, 0),
          (2, 4, 4, 70, 50, 128, False, 0),
          (1, 8, 1, 200, 200, 128, True, 64),
          (2, 4, 2, 33, 33, 20, True, 0),
          (2, 4, 2, 17, 17, 1, True, 0),
          (1, 4, 2, 17, 17, 128, True, 0),
          (1, 4, 2, 33, 33, 64, False, 0),
          (2, 16, 8, 4096, 4096, 128, True, 0)]
TIMED = {"training": (8, 16, 8, 64, 128), "prefill": (2, 16, 8, 4096, 128)}


def main() -> int:
    if not torch.cuda.is_available():
        print("k7_probe: no CUDA card", file=sys.stderr)
        return 2
    quick = "--quick" in sys.argv[1:]
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.kernels.flash_attention import flash_attention_bwd as k7
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    report = build.build(("flash_attention", "flash_attention_bwd"))
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for fn, props in chip_smoke.ptxas_report(
            report["flash_attention_bwd"]["log"]).items():
        print(f"ptxas {fn}: {props}")
    print("HMMA:", chip_smoke.hmma_count(
        build.library_path("flash_attention_bwd")), flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(28)
    t = lambda x: x.transpose(1, 2)
    bad = 0

    def operands(B, H, KV, Sq, Sk, D, causal, window):
        q = torch.randn((B, Sq, H, D), generator=gen, device=dev)
        k = torch.randn((B, Sk, KV, D), generator=gen, device=dev)
        v = torch.randn((B, Sk, KV, D), generator=gen, device=dev)
        do = torch.randn((B, Sq, H, D), generator=gen, device=dev)
        lse = torch.empty((B, H, Sq), device=dev)
        out = k4.launch(q, k, v, heads_dim=2, causal=causal, window=window,
                        lse=lse)
        return q, k, v, do, out, lse

    def plans(q, k, every):
        """The device's plan, then (with `every`) each built instance of
        each pass beside the plan's instance of the other."""
        base = k7.device_plan(q, k)
        yield "plan", base
        if not every:
            return
        B, H, Sq, KV, Sk = q.shape[0], q.shape[2], q.shape[1], k.shape[2], \
            k.shape[1]
        for kvp in (True, False):
            mine = base.kv if kvp else base.q
            for inst in k7.INSTANCES[base.width]:
                if inst == mine.instance:
                    continue
                pp = k7.pass_plan(base.width, inst, kvp, Sk if kvp else Sq,
                                  B * (KV if kvp else H))
                yield (f"{'kv' if kvp else 'q'}={inst}",
                       k7.AttentionBwdPlan(base.width, base.columns,
                                           pp if kvp else base.kv,
                                           base.q if kvp else pp))

    for shape in SHAPES:
        B, H, KV, Sq, Sk, D, causal, window = shape
        q, k, v, do, out, lse = operands(*shape)
        want = attention_bwd_ref(t(q), t(k), t(v), t(out), t(do),
                                 causal=causal, window=window)
        for tag, plan in plans(q, k, not quick):
            got = k7.gqa_flash_bwd(q, k, v, out, do, lse, causal=causal,
                                   window=window, plan=plan)
            again = k7.gqa_flash_bwd(q, k, v, out, do, lse, causal=causal,
                                     window=window, plan=plan)
            torch.cuda.synchronize()
            rel = [float((g - t(w)).abs().max()) / max(float(w.abs().max()),
                                                       1e-30)
                   for g, w in zip(got, want)]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok = max(rel) <= chip_smoke.K7_RTOL and same
            bad += not ok
            print(f"{shape} {tag} {plan.args()}: relative errors dq "
                  f"{rel[0]:.3e} dk {rel[1]:.3e} dv {rel[2]:.3e}; rerun "
                  f"bitwise {same}{'' if ok else '  <-- FAIL'}", flush=True)
    if quick:
        return 1 if bad else 0

    flush = torch.empty(64 * 2**20, device=dev)
    for name, (B, H, KV, S, D) in TIMED.items():
        q, k, v, do, out, lse = operands(B, H, KV, S, S, D, True, 0)
        big = S > 1000
        for tag, plan in plans(q, k, True):
            ms = chip_smoke.flushed_ms(
                lambda: k7.gqa_flash_bwd(q, k, v, out, do, lse, plan=plan),
                flush, reps=5 if big else 50, warmup=1 if big else 3)
            passes = "; ".join(
                f"{kname.split('(')[0].split('::')[-1]} {kms:.4f}"
                for kms, _, kname in chip_smoke.profiled_kernels(
                    lambda: k7.gqa_flash_bwd(q, k, v, out, do, lse,
                                             plan=plan), calls=3))
            print(f"[{card}] K7 {name} {tag} {plan.args()}: {ms:.4f} ms "
                  f"cold L2 (warm, by kernel: {passes})", flush=True)
        lib_ms, how = chip_smoke.k7_library_ms(t(q), t(k), t(v), t(do), 0)
        print(f"[{card}] SDPA backward {name}: {lib_ms:.4f} ms ({how})",
              flush=True)
        del q, k, v, do, out, lse
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
