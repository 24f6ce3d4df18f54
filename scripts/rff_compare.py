#!/usr/bin/env python3
"""Time K1 (`csrc/rff.cu`) beside other sources of it on a CUDA card.

    python3 scripts/rff_compare.py [--rounds N] NAME=SOURCE.cu ...

Builds each SOURCE with the port's nvcc flags beside the kernel. A source
has the kernel's entry point (`rff_cos_bias(x, omega, bias, out, M, d, L,
scale, bulk, strip, rows, blocks, smem, stream)`, launched with the
kernel's plan) or the earlier one, `rff_cos_bias(x, omega, bias, out, M,
d, L, scale, stream)` (for example the first design, from `git show
<commit>:src/repro_torch/csrc/rff.cu`). At the predict shape (M = 30 000,
d = 5, L = 4096) it times the kernel, each source and `out.fill_(1.0)` on
an output of the same size, in turns forward and back (--rounds), with
CUDA events, and prints each median with the card's name and power limit.
It prints each build's ptxas register report, and whether each source
gives the kernel's bits at the predict shape and at (1001, 5, 513) (the
4-byte instance). Exits 1 if the kernel's two calls differ, 2 without a
card.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.rff import rff as k1  # noqa: E402

SHAPE = (30000, 5, 4096)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def compile_source(name: str, src: Path) -> ctypes.CDLL:
    out = build.BUILD_DIR / "compare" / f"rff-{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    res = subprocess.run([nvcc, *build.NVCC_FLAGS, "-o", str(out), str(src)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}"
                           f"{res.stderr}")
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"{name} ptxas: {line.strip()}", flush=True)
    return ctypes.CDLL(str(out))


def launcher(lib: ctypes.CDLL, x, omega, bias):
    """A call of `lib`'s rff_cos_bias that returns its output."""
    M, d = x.shape
    L = omega.shape[1]
    out = torch.empty((M, L), device=x.device)
    fn = lib.rff_cos_bias
    fn.restype = _I
    head = [x.data_ptr(), omega.data_ptr(), bias.data_ptr(), out.data_ptr(),
            M, d, L, math.sqrt(2.0 / L)]
    if hasattr(lib, "rff_limits"):         # the kernel's entry point
        plan = k1.rff_device_plan(M, d, L, out)
        fn.argtypes = [_P] * 4 + [_I, _I, _I, _F] + [_I] * 5 + [_P]
        head += [int(plan.instance == "bulk"), plan.strip, plan.rows,
                 plan.blocks, plan.smem_bytes]
    else:
        fn.argtypes = [_P] * 4 + [_I, _I, _I, _F, _P]

    def call():
        code = fn(*head, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code}")
        return out
    return call


def ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def inputs(M, d, L, gen):
    x = torch.rand((M, d), generator=gen, device=gen.device)
    omega = torch.randn((d, L), generator=gen, device=gen.device)
    bias = torch.rand((L,), generator=gen, device=gen.device) * 2 * math.pi
    return x, omega, bias


def same_bits(tag, got, want) -> bool:
    torch.cuda.synchronize()
    diff = int((got != want).sum())
    print(f"{tag}: {diff} of {got.numel()} values differ from the kernel's",
          flush=True)
    return diff == 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("sources", nargs="*", metavar="NAME=SOURCE.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rff_compare: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    build.build(("rff",))
    libs = {}
    for spec in args.sources:
        name, src = spec.split("=", 1)
        libs[name] = compile_source(name, Path(src))
    gen = torch.Generator(device="cuda").manual_seed(11)
    x, omega, bias = inputs(*SHAPE, gen)
    x2, omega2, bias2 = inputs(1001, 5, 513, gen)
    kernel = k1.rff_cos_bias(x, omega, bias)
    ok = same_bits("the kernel's second call", k1.rff_cos_bias(x, omega, bias),
                   kernel)
    kernel2 = k1.rff_cos_bias(x2, omega2, bias2)
    calls = {"kernel": lambda: k1.rff_cos_bias(x, omega, bias)}
    for name, lib in libs.items():
        calls[name] = launcher(lib, x, omega, bias)
        same_bits(f"{name} at {SHAPE}", calls[name](), kernel)
        same_bits(f"{name} at (1001, 5, 513)",
                  launcher(lib, x2, omega2, bias2)(), kernel2)
    fill = torch.empty(SHAPE[0], SHAPE[2], device="cuda")
    calls["fill_"] = lambda: fill.fill_(1.0)
    names = list(calls)
    times = {name: [] for name in names}
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            times[name].append(ms(calls[name]))
    for name in names:
        print(f"[{card}] {name}: {statistics.median(times[name]):.4f} ms "
              f"(runs {', '.join(f'{t:.4f}' for t in times[name])})",
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
