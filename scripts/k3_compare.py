#!/usr/bin/env python3
"""Time K3 (`csrc/coke_fused_update.cu`) beside other sources of it on a
CUDA card.

    python3 scripts/k3_compare.py [--rounds N] [NAME=SOURCE.cu[@PLAN] ...]

Builds each SOURCE with the port's nvcc flags beside the kernel. A source
has the kernel's entry point or the first design's (`coke_fused_update(
theta, theta_hat, gamma, grad, left, right, g_aug, partial, N, D, vec, rho,
deg, c1, stream)` with `coke_fused_update_tiles(D)`, whose per-tile
partials are summed by `torch.sum` as its wrapper did; for example `git
show 12e0a31:src/repro_torch/csrc/coke_fused_update.cu`). Each is called
the way the wrapper calls it, allocations included; a source with the
kernel's entry point takes the kernel's plan, or with `@C` the plan for
clusters of C blocks, or with `@C:THREADS:U` that plan with other threads
per block and loads in flight. In turns forward and
back (--rounds) it times:

  - the fused fallback's shape, N=20, D=4096, with one tensor as both
    neighbour operands (as the path passes them): 100 calls captured in one
    CUDA graph and replayed, per call; beside it the floor probe, a graph
    of 100 `zero_()` calls on a 1-element tensor;
  - the streaming shape, N=20, D=65536, aliased and with distinct
    neighbour operands: per-call CUDA events with a 256 MB buffer written
    before each call (a cold L2 full of dirty lines), and written then read
    back (a cold L2 of clean lines), median;
  - a large shape, N=20, D=2^20 (0.5 GB, ten L2s), aliased: CUDA events
    around back-to-back calls, where a call's fixed costs are a small
    share of its transfer.

It also prints each variant's kernels' device time by the profiler at the
path's shape, one wrapper call's host time, the byte bounds, each build's ptxas
report, and whether each source gives the kernel's bits. Prints every
median with the card's name and power limit. Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (card_peaks, flushed_ms, graph_ms,  # noqa: E402
                        host_call_ms, profiled_kernels, time_ms)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.coke_update import coke_update as k3  # noqa: E402

PATH_SHAPE = (20, 4096)
STREAM_SHAPE = (20, 65536)
LARGE_SHAPE = (20, 1 << 20)
RHO, DEG = 1e-2, 2.0
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def compile_source(name: str, src: Path) -> ctypes.CDLL:
    out = build.BUILD_DIR / "compare" / f"k3-{name}.so"
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


def launcher(lib: ctypes.CDLL, ops, plan_spec=""):
    """A call of `lib`'s coke_fused_update on the six operands, made as the
    wrapper of its design makes it; returns (g_aug, xi_sq)."""
    N, D = ops[0].shape
    dev = ops[0].device
    fn = lib.coke_fused_update
    fn.restype = _I
    ptrs = [t.data_ptr() for t in ops]
    scalars = [RHO, DEG, 2.0 * RHO * DEG]
    if hasattr(lib, "coke_fused_update_tiles"):       # the first design
        fn.argtypes = [_P] * 8 + [_I, _I, _I, _F, _F, _F, _P]
        tiles = lib.coke_fused_update_tiles(D)

        def call():
            g = torch.empty((N, D), device=dev)
            part = torch.empty((N, tiles), device=dev)
            vec = int(D % 4 == 0)
            code = fn(*ptrs, g.data_ptr(), part.data_ptr(), N, D, vec,
                      *scalars, torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")
            return g, torch.sum(part, dim=1)
        return call
    fn.argtypes = k3._FUSED_UPDATE_SIGNATURES["coke_fused_update"][1]
    plan, vec, shared = k3.fused_update_launch(ops)
    if plan_spec:   # the rule picks C for N C >= that many SMs
        c, *tu = map(int, plan_spec.split(":"))
        plan = k3.fused_update_plan(N, D, N * c, vec=vec)
        if tu:
            plan = dataclasses.replace(plan, threads=tu[0], unroll=tu[1])

    def call():
        g = torch.empty((N, D), device=dev)
        xi = torch.empty((N,), device=dev)
        code = fn(*ptrs, g.data_ptr(), xi.data_ptr(), N, D, int(vec),
                  int(shared), plan.clusters, plan.threads, plan.unroll,
                  plan.slice, *scalars,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code}")
        return g, xi
    return call


def operands(n, d, gen, aliased):
    ops = [0.1 * torch.randn((n, d), generator=gen, device="cuda")
           for _ in range(5)]
    return ops + [ops[4] if aliased else
                  0.1 * torch.randn((n, d), generator=gen, device="cuda")]


def same_bits(tag, got, want) -> bool:
    torch.cuda.synchronize()
    diff = [int((a != b).sum()) for a, b in zip(got, want)]
    print(f"{tag}: {diff[0]} g_aug and {diff[1]} xi_sq values differ from "
          "the kernel's (xi_sq is summed in each design's own order)",
          flush=True)
    return diff == [0, 0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("sources", nargs="*", metavar="NAME=SOURCE.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_compare: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    bw = card_peaks(torch.cuda.get_device_name(0))[0]
    for line in build.build(("coke_fused_update",))[
            "coke_fused_update"]["log"].splitlines():
        if "registers" in line or "spill" in line or "entry" in line:
            print(f"kernel ptxas: {line.strip()}", flush=True)
    libs = {}
    built, forced = {}, {}
    for spec in args.sources:
        name, src = spec.split("=", 1)
        src, _, c = src.partition("@")
        forced[name] = c
        if src not in built:
            built[src] = compile_source(name, Path(src))
        libs[name] = built[src]

    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = {"path": operands(*PATH_SHAPE, gen, True),
             "stream aliased": operands(*STREAM_SHAPE, gen, True),
             "stream distinct": operands(*STREAM_SHAPE, gen, False),
             "large aliased": operands(*LARGE_SHAPE, gen, True)}
    calls = {}       # (variant, case) -> call
    ok = True
    for case, ops in cases.items():
        kernel = lambda ops=ops: k3.coke_fused_update(*ops, rho=RHO, deg=DEG)
        calls[("kernel", case)] = kernel
        want = kernel()
        ok &= same_bits(f"the kernel's second call, {case}", kernel(), want)
        for name, lib in libs.items():
            calls[(name, case)] = launcher(lib, ops, forced[name])
            same_bits(f"{name}, {case}", calls[(name, case)](), want)
    for case, (n, d) in (("path", PATH_SHAPE),
                         ("stream aliased", STREAM_SHAPE),
                         ("stream distinct", STREAM_SHAPE),
                         ("large aliased", LARGE_SHAPE)):
        arrays = 6 if "distinct" not in case else 7
        nbytes = 4.0 * (arrays * n * d + n)
        print(f"[{card}] {case} N={n} D={d}: {arrays} (N, D) arrays and "
              f"xi_sq, {nbytes / 1e6:.4f} MB, byte bound "
              f"{nbytes / bw * 1e3:.6f} ms at {bw / 1e12:g} TB/s", flush=True)

    # the same bytes through PyTorch: the five or six distinct (N, D)
    # operands stacked, summed over the stack into one (N, D) output
    for case, ops in cases.items():
        unique = list({t.data_ptr(): t for t in ops}.values())
        stack = torch.stack(unique)
        out = torch.empty_like(ops[0])
        calls[("torch.sum", case)] = (
            lambda s=stack, o=out: torch.sum(s, dim=0, out=o))
    tiny = torch.zeros(1, device="cuda")
    flush = torch.empty(64 * 2**20, device="cuda")      # 256 MB
    variants = ["kernel", *libs, "torch.sum"]
    streams = [(c, clean) for c in ("stream aliased", "stream distinct")
               for clean in (False, True)]
    times = {(v, c, False): [] for v in variants for c in cases}
    times.update({(v, c, True): [] for v in variants for c, _ in streams})
    times["floor probe"] = []
    for r in range(args.rounds):
        for v in (variants if r % 2 == 0 else variants[::-1]):
            times[(v, "path", False)].append(graph_ms(calls[(v, "path")]))
            for c, clean in streams:
                times[(v, c, clean)].append(
                    flushed_ms(calls[(v, c)], flush, clean=clean))
            times[(v, "large aliased", False)].append(
                time_ms(calls[(v, "large aliased")], reps=5, runs=3))
        times["floor probe"].append(graph_ms(tiny.zero_))
    for key, runs in times.items():
        what = (key if isinstance(key, str) else
                f"{key[0]}, {key[1]}"
                + (" (graph replay, per call)" if key[1] == "path"
                   else " (back-to-back calls)" if key[1].startswith("large")
                   else " (cold L2 of clean lines, per call)" if key[2]
                   else " (cold L2 of dirty lines, per call)"))
        print(f"[{card}] {what}: {statistics.median(runs):.6f} ms (runs "
              f"{', '.join(f'{t:.6f}' for t in runs)})", flush=True)

    for v in variants:
        for ms, count, key in profiled_kernels(calls[(v, "path")]):
            print(f"[{card}] profiler, one {v} call at the path's shape: "
                  f"{ms:.6f} ms  {count:g} launches  {key[:70]}", flush=True)
    path = calls[("kernel", "path")]
    print(f"[{card}] one wrapper call's host time at the path's shape: "
          f"{host_call_ms(path):.6f} ms", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
