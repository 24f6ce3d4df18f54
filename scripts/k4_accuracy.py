#!/usr/bin/env python3
"""K4's fp32 error along the row and its time, beside other sources of it,
on a CUDA card.

    python3 scripts/k4_accuracy.py [--times] [--k7] [--rounds N] \
        [NAME=SOURCE.cu ...]

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
causal, S = 1024 and 4096, on phase 24(a)'s operands (dO drawn as v is):
each gradient's max|err| over its max|exact| and its mean signed error
(err * sign(exact)) over its mean|exact|, beside the plain backward's.

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
K7_LENGTHS = (1024, 4096)


def compile_source(name: str, src: Path) -> ctypes.CDLL:
    """`src` built with the port's flags beside the kernel; prints its
    ptxas report per instance."""
    import chip_smoke
    from repro_torch.kernels import build
    out = build.BUILD_DIR / "compare" / f"flash_attention-{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    res = subprocess.run([nvcc, *build.NVCC_FLAGS, "-o", str(out), str(src)],
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}"
                           f"{res.stderr}")
    for fn, props in chip_smoke.ptxas_report(res.stdout + res.stderr).items():
        print(f"{name} ptxas {fn}: {props}", flush=True)
    lib = ctypes.CDLL(str(out))
    lib.error_string.restype = ctypes.c_char_p
    lib.error_string.argtypes = [ctypes.c_int]
    return lib


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


def k7_drift(dev):
    import chip_smoke
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.kernels.flash_attention import flash_attention_bwd as k7
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    t = lambda x: x.transpose(1, 2)
    H, D = chip_smoke.K4_CURVE_HEADS, 128
    for S in K7_LENGTHS:
        gen = torch.Generator(device=dev).manual_seed(24)
        q, k = (torch.randn((1, S, H, D), generator=gen, device=dev)
                for _ in range(2))
        v, do = (chip_smoke.coherent_normal(gen, (1, S, H, D))
                 for _ in range(2))
        lse = torch.empty((1, H, S), device=dev)
        out = k4.launch(q, k, v, heads_dim=2, causal=True, window=0, lse=lse)
        got = k7.gqa_flash_bwd(q, k, v, out, do, lse, causal=True)
        plain = attention_bwd_ref(t(q), t(k), t(v), t(out), t(do),
                                  causal=True)
        exact = exact_backward(t(q), t(k), t(v), t(do))
        parts = []
        for name, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
            sign, big, mean = e.sign(), float(e.abs().max()), \
                float(e.abs().mean())
            stats = []
            for x in (t(g), p):
                d = x.double() - e
                stats.append((float(d.abs().max()) / big,
                              float((d * sign).mean()) / mean))
            parts.append(f"{name} K7 max|err| {stats[0][0]:.3e} of max, mean "
                         f"signed {stats[0][1]:+.3e} of mean|exact|; plain "
                         f"{stats[1][0]:.3e}, {stats[1][1]:+.3e}")
        print(f"K7 (1, {S}, {H}/{H}, {D}) causal fp32 against float64: "
              + "; ".join(parts), flush=True)
        del q, k, v, do, lse, out, got, plain, exact
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--k7", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
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
    for fn, props in chip_smoke.ptxas_report(
            report["flash_attention"]["log"]).items():
        print(f"kernel ptxas {fn}: {props}", flush=True)
    dev = torch.device("cuda", 0)
    libs = {"kernel": build.load("flash_attention", {})}
    for spec in args.sources:
        name, src = spec.split("=", 1)
        libs[name] = compile_source(name, Path(src))

    def use(name):
        build._LIBS["flash_attention"] = libs[name]

    for name in libs:
        use(name)
        for row in chip_smoke.k4_row_curve(dev):
            print(f"[{card}] {name}: " + chip_smoke.k4_curve_line(row),
                  flush=True)
    use("kernel")
    if args.k7:
        k7_drift(dev)
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
