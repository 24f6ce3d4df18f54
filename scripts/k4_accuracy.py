#!/usr/bin/env python3
"""K4's fp32 error along the row and its time, beside other sources of it,
on a CUDA card.

    python3 scripts/k4_accuracy.py [--times] [--k7] [--rounds N] \
        [--k7-source NAME=SOURCE.cu ...] [NAME=SOURCE.cu ...]

Builds K4 (`csrc/flash_attention.cu`) and each SOURCE, a K4 source with
the same C entry points (for example an earlier design, from `git show
<commit>:src/repro_torch/csrc/flash_attention.cu`), with the port's nvcc
flags, and prints each build's ptxas report per instance. For the kernel
and each source, swapped in as the library `gqa_flash` launches, it prints
the error along the row against float64 (`chip_smoke.k4_row_curve`, phase
24(a)'s curve: (1, S, 8/8, 128) causal, max|v| 5, S = 512 ... 8192).

--times: at qwen3's (2, 4096, 16/8, 128), deepseek-v2-lite's (2, 4096,
16/16, Dh 192 / Dv 128) and zamba2's (2, 4096, 32/32, 80) causal fp32
shapes, times the kernel and each source in turns, forward then backward
(--rounds), with CUDA events, beside F.scaled_dot_product_attention and
the 3xTF32 bound; prints each median with the card's name and power limit.

--k7: K7's dQ, dK and dV against the float64 backward at (1, S, 8/8, 128)
causal, S = 1024, 2048, 4096 and 8192 (or --k7-lengths), on phase 24(a)'s
operands (dO drawn as v is): each gradient's max|err| over its max|exact|
and its mean signed error (err * sign(exact)) over its mean|exact|, beside
the plain backward's; for the kernel and each --k7-source, a K7 source
with the kernel's C entry points (for an earlier design, its entry given
the current `Dv` argument), built with the port's flags beside the kernel.
With --times also K7 at qwen3's (2, 4096, 16/8, 128) and zamba2's (2,
4096, 32/32, 80) causal shapes, the kernel and each --k7-source in turns
(--rounds), each call with a cold L2 (`chip_smoke.flushed_ms`).

Exits 2 without a card.
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
sys.path.insert(0, str(ROOT))

# (label, B, H, KV, S, Dh, Dv), causal fp32
TIMED = (("qwen3-1.7b", 2, 16, 8, 4096, 128, 128),
         ("deepseek-v2-lite-16b", 2, 16, 16, 4096, 192, 128),
         ("zamba2-2.7b", 2, 32, 32, 4096, 80, 80))
K7_LENGTHS = (1024, 2048, 4096, 8192)
# (label, B, H, KV, S, D), causal fp32
K7_TIMED = (("qwen3-1.7b", 2, 16, 8, 4096, 128),
            ("zamba2-2.7b", 2, 32, 32, 4096, 80))


def compile_sources(specs, kernel: str = "flash_attention"
                    ) -> dict[str, ctypes.CDLL]:
    """Each NAME=SOURCE.cu of `specs` built with the port's flags beside
    the kernel, one nvcc each, all started together (a library newer than
    its source is reused); prints each build's ptxas report per instance.
    Returns {NAME: library}."""
    import chip_smoke
    from repro_torch.kernels import build
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    jobs = {}
    for spec in specs:
        name, src = spec.split("=", 1)
        out = build.BUILD_DIR / "compare" / f"{kernel}-{name}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        fresh = (out.exists()
                 and out.stat().st_mtime >= Path(src).stat().st_mtime)
        jobs[name] = (out, src, None if fresh else subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(out), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, src, proc) in jobs.items():
        if proc is not None:
            log, _ = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{log}")
            for fn, props in chip_smoke.ptxas_report(log).items():
                print(f"{name} ptxas {fn}: {props}", flush=True)
        lib = ctypes.CDLL(str(out))
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        libs[name] = lib
    return libs


def exact_backward(q, k, v, do, heads_at_once=2):
    """(dq, dk, dv) of the causal attention in float64, (B, H, S, D)
    operands, a few heads at a time."""
    S, scale = q.shape[2], q.shape[3] ** -0.5
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
    outs = ([], [], [])
    for h in range(0, q.shape[1], heads_at_once):
        hs = slice(h, h + heads_at_once)
        qq, kk, vv, dd = (x[:, hs].double() for x in (q, k, v, do))
        s = (qq @ kk.transpose(-1, -2)) * scale
        s.masked_fill_(mask, -math.inf)
        p = torch.softmax(s, dim=-1)
        del s
        o = p @ vv
        dp = dd @ vv.transpose(-1, -2)
        ds = p * (dp - (dd * o).sum(-1, keepdim=True)) * scale
        del dp
        for acc, g in zip(outs, (ds @ kk, ds.transpose(-1, -2) @ qq,
                                 p.transpose(-1, -2) @ dd)):
            acc.append(g)
        del p, ds
    return tuple(torch.cat(x, dim=1) for x in outs)


def k7_drift(dev, libs, card, lengths=K7_LENGTHS):
    """K7's error along the row against float64 at each S of `lengths`,
    for each K7 library in `libs` (name -> library) swapped in as the one
    `gqa_flash_bwd` launches. Past 8192 rows the plain and float64
    backwards run one head at a time."""
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.kernels.flash_attention import flash_attention_bwd as k7
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    t = lambda x: x.transpose(1, 2)
    H, D = chip_smoke.K4_CURVE_HEADS, 128
    for S in lengths:
        gen = torch.Generator(device=dev).manual_seed(24)
        q, k = (torch.randn((1, S, H, D), generator=gen, device=dev)
                for _ in range(2))
        v, do = (chip_smoke.coherent_normal(gen, (1, S, H, D))
                 for _ in range(2))
        lse = torch.empty((1, H, S), device=dev)
        out = k4.launch(q, k, v, heads_dim=2, causal=True, window=0, lse=lse)
        hs = 2 if S <= 8192 else 1
        plain = [torch.cat(x, dim=1) for x in zip(*(
            attention_bwd_ref(*(t(x)[:, h:h + hs]
                                for x in (q, k, v, out, do)), causal=True)
            for h in range(0, H, hs)))]
        exact = exact_backward(t(q), t(k), t(v), t(do), heads_at_once=hs)

        def stats(x, e):
            d = x.double() - e
            return (float(d.abs().max()) / float(e.abs().max()),
                    float((d * e.sign()).mean()) / float(e.abs().mean()))

        ref = [stats(p, e) for p, e in zip(plain, exact)]
        for name, lib in libs.items():
            build._LIBS["flash_attention_bwd"] = lib
            got = k7.gqa_flash_bwd(q, k, v, out, do, lse, causal=True)
            parts = []
            for gname, g, e, r in zip(("dq", "dk", "dv"), got, exact, ref):
                m = stats(t(g), e)
                parts.append(f"{gname} max|err| {m[0]:.3e} of max, mean "
                             f"signed {m[1]:+.3e} of mean|exact| (plain "
                             f"{r[0]:.3e}, {r[1]:+.3e})")
            print(f"[{card}] K7 {name} (1, {S}, {H}/{H}, {D}) causal fp32 "
                  f"against float64: " + "; ".join(parts), flush=True)
            del got
        del q, k, v, do, lse, out, plain, exact
        torch.cuda.empty_cache()
    build._LIBS["flash_attention_bwd"] = libs["kernel"]


def k7_times(dev, libs, card, rounds):
    """K7 at K7_TIMED's shapes, each library of `libs` in turns (the order
    reversed every other round), each call with a cold L2."""
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.kernels.flash_attention import flash_attention_bwd as k7
    flush = torch.empty(64 * 2**20, device=dev)
    names = list(libs)
    for label, B, H, KV, S, D in K7_TIMED:
        gen = torch.Generator(device=dev).manual_seed(28)
        q, k, v, do = chip_smoke.k7_operands(gen, dev, B, H, KV, S, D)
        lse = torch.empty((B, H, S), device=dev)
        out = k4.launch(q, k, v, heads_dim=2, causal=True, window=0, lse=lse)
        times = {name: [] for name in names}
        for r in range(rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                build._LIBS["flash_attention_bwd"] = libs[name]
                times[name].append(chip_smoke.flushed_ms(
                    lambda: k7.gqa_flash_bwd(q, k, v, out, do, lse,
                                             causal=True),
                    flush, reps=5, warmup=1))
        for name in names:
            build._LIBS["flash_attention_bwd"] = libs[name]
            passes = "; ".join(
                f"{kms:.4f}" for kms, _, _ in chip_smoke.profiled_kernels(
                    lambda: k7.gqa_flash_bwd(q, k, v, out, do, lse,
                                             causal=True), calls=3))
            print(f"[{card}] K7 {name} at {label}'s (B={B}, S={S}, H={H}, "
                  f"KV={KV}, Dh=Dv={D}, causal, fp32): "
                  f"{statistics.median(times[name]):.4f} ms cold L2 (runs "
                  f"{', '.join(f'{x:.4f}' for x in times[name])}; warm by "
                  f"kernel, largest first: {passes})", flush=True)
        build._LIBS["flash_attention_bwd"] = libs["kernel"]
        del q, k, v, do, lse, out
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--k7", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--k7-lengths", default=",".join(map(str, K7_LENGTHS)),
                    help="--k7's row counts, comma-separated")
    ap.add_argument("--k7-source", action="append", default=[],
                    metavar="NAME=SOURCE.cu")
    ap.add_argument("sources", nargs="*", metavar="NAME=SOURCE.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_accuracy: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import gqa_flash

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    report = build.build(("flash_attention", "flash_attention_bwd"))
    for kernel in ("flash_attention", "flash_attention_bwd"):
        for fn, props in chip_smoke.ptxas_report(
                report[kernel]["log"]).items():
            print(f"kernel ptxas {fn}: {props}", flush=True)
    dev = torch.device("cuda", 0)
    k7_libs = {"kernel": build.load("flash_attention_bwd", {})}
    k7_libs.update(compile_sources(args.k7_source, "flash_attention_bwd"))
    libs = {"kernel": build.load("flash_attention", {})}
    libs.update(compile_sources(args.sources))

    def use(name):
        build._LIBS["flash_attention"] = libs[name]

    for name in libs:
        use(name)
        for row in chip_smoke.k4_row_curve(dev):
            print(f"[{card}] {name}: " + chip_smoke.k4_curve_line(row),
                  flush=True)
    use("kernel")
    if args.k7:
        k7_drift(dev, k7_libs, card,
                 tuple(int(x) for x in args.k7_lengths.split(",")))
        if args.times:
            k7_times(dev, k7_libs, card, args.rounds)
    if args.times:
        peaks = chip_smoke.card_peaks(torch.cuda.get_device_name(0))
        t = lambda x: x.transpose(1, 2)
        for label, B, H, KV, S, Dh, Dv in TIMED:
            gen = torch.Generator(device=dev).manual_seed(32)
            q = torch.randn((B, S, H, Dh), generator=gen, device=dev)
            k = torch.randn((B, S, KV, Dh), generator=gen, device=dev)
            v = torch.randn((B, S, KV, Dv), generator=gen, device=dev)
            times = {name: [] for name in libs}
            names = list(libs)
            for r in range(args.rounds):
                for name in (names if r % 2 == 0 else names[::-1]):
                    use(name)
                    times[name].append(chip_smoke.time_ms(
                        lambda: gqa_flash(q, k, v, causal=True), reps=3,
                        runs=5, warmup=1))
            use("kernel")
            pairs = S * (S + 1) // 2
            flops = 2.0 * B * H * (Dh + Dv) * pairs
            nbytes = 4.0 * B * S * (H * Dh + KV * Dh + KV * Dv + H * Dv)
            b_ms, b_by, b_how = chip_smoke.k4_bound(nbytes, flops,
                                                    torch.float32, peaks)
            lib_ms, lib_how = chip_smoke.sdpa_ms(t(q), t(k), t(v),
                                                 causal=True)
            for name in names:
                med = statistics.median(times[name])
                print(f"[{card}] K4 {name} at {label}'s (B={B}, S={S}, "
                      f"H={H}, KV={KV}, Dh={Dh}, Dv={Dv}, causal, fp32): "
                      f"{med:.4f} ms (runs "
                      f"{', '.join(f'{x:.4f}' for x in times[name])}); "
                      f"bound {b_ms:.4f} ms ({b_by}, {b_how}; "
                      f"{b_ms / med:.1%} of it)", flush=True)
            print(f"[{card}] F.scaled_dot_product_attention at {label}'s: "
                  f"{lib_ms:.4f} ms ({lib_how})", flush=True)
            del q, k, v
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
