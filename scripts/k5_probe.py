#!/usr/bin/env python3
"""Build K5 (`csrc/threefry.cu`) on a CUDA card, print its ptxas report and
its SASS instructions per word, check it bitwise against its plain version
and time one draw of each at the participation draw's size (N = 20 words)
and a Quantize draw's (N x D = 81 920 words).

    python3 scripts/k5_probe.py

Times are CUDA events around 100 back-to-back calls (device time, which
for a draw this small is the host's time to make the call) and the host's
perf_counter over the same window; printed with the card's name and power
limit. Exits 2 without a card.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("k5_probe: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core import prng
    from repro_torch.kernels import build
    from repro_torch.kernels.threefry.ref import uniform_ref

    t0 = time.perf_counter()
    report = build.build(("threefry",))
    print(f"built in {time.perf_counter() - t0:.1f} s")
    print(report["threefry"]["log"])
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass",
                           str(build.library_path("threefry"))],
                          capture_output=True, text=True, check=True).stdout
    print(chip_smoke.k5_sass_counts(sass)[1])
    dev = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    for n in (20, 81920):
        key = prng.fold_in(prng.PRNGKey(3), n)
        got = prng.uniform(key, (n,), dev).cpu()
        if not torch.equal(got.view(torch.int32),
                           uniform_ref(key, (n,), cpu).view(torch.int32)):
            raise AssertionError(f"K5 differs from its plain version at {n}")
        for what, fn in (("K5", lambda: prng.uniform(key, (n,), dev)),
                         ("plain", lambda: uniform_ref(key, (n,), dev))):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            h0 = time.perf_counter()
            for _ in range(100):
                fn()
            h1 = time.perf_counter()
            end.record()
            torch.cuda.synchronize()
            print(f"{what} n={n}: {start.elapsed_time(end) / 100:.4f} ms "
                  f"device, {(h1 - h0) * 10:.4f} ms host per call")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
