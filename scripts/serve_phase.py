#!/usr/bin/env python3
"""Run phase 18 of `chip_smoke.py` (many-model serving) alone on a CUDA
card: build the kernels, fit phase 4's full-width COKE cell (the
featurizer and the 20 per-agent models the serving cells use), then call
`chip_smoke.serve_phase` with the script's own launch counters and print
its K6 entry.

    python3 scripts/serve_phase.py

Prints the card's name and power limit beside every number, as the whole
script does. Exits 2 without a card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("serve_phase: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.api import build_problem, fit
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    bw, fp32, _, _ = cs.card_peaks(torch.cuda.get_device_name(0))

    cfg = cs.full_width_config().replace(algorithm="coke")
    built = build_problem(cfg, device=dev)
    coke = fit(cfg, problem=built.problem, device=dev)
    torch.cuda.synchronize()
    print(f"[{card}] built the kernels and fitted phase 4's COKE cell in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    entry = cs.serve_phase(dev, card, cs.reset_counts, cs.counts,
                           built=built, coke=coke, bw=bw, fp32=fp32)
    print(card)
    print(json.dumps(entry))
    return 0


if __name__ == "__main__":
    sys.exit(main())
