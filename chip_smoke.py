#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure raises and the script exits non-zero:
  0. the device, and `nvidia-smi --query-gpu=name,power.limit`;
  1. build the four hand-written kernels from src/repro_torch/csrc with
     nvcc (one process per source, started together) into
     build/repro_torch/; K1's ptxas report per instance, its launch plan at
     the predict shape and at d=96, and its SASS instructions per output
     (cuobjdump -sass); count K4's tensor-core instructions in its SASS
     (both HMMA kinds must be there) and print its launch plans;
  2. each kernel against its plain PyTorch version on the card, on inputs
     from seeded torch.Generators, at the main paths' shapes and at ragged
     ones, each error printed beside its tolerance; K1 with both store
     instances (TMA bulk, 4-byte), two calls giving the same bits, and its
     cosine against cosf on every fp32 value; K2 with both staging
     instances (bulk copies, 4-byte cp.async), its resid_sq output, and two
     calls on the same inputs giving the same bits; K4 (flash attention)
     over lengths, masks, head groups, both layouts, head dims and dtypes;
  3. small fits on the card against the same fits on the CPU (the plain
     versions): the megakernel path, the spmd backend and the fused
     fallback on a logistic problem; comms and bits equal, theta close;
  4. the megakernel path at full width: the paper's Sec. 5.1 synthetic
     setup with N=20 agents on a ring, 5000 samples per agent (3500 train,
     1500 test), D=4096 random features, backend="fused",
     primal="gradient", 50 iterations of COKE and of DKLA, then to_model()
     and predict / evaluate on the held-out rows. K2 must run on every
     iteration, K1 on predict, K3 never; the train MSE comes from K2's
     residuals, with one more Phi read per chunk (counted);
  5. the fused fallback at full width: the same features (no second copy)
     with +-1 labels on the logistic loss, backend="fused", primal="auto"
     (the gradient primal on this loss), 50 iterations of COKE and of
     DKLA, then predict. K3 must run exactly once per iteration, K2 never;
  6. the spmd backend at full width on phase 4's problem: COKE, DKLA and
     CTA, 50 iterations each; comms and bits equal phase 4's, theta close;
     then COKE and DKLA on phase 5's logistic problem, whose comms and bits
     equal phase 5's and theta is close (spmd forms g_aug by K3's plain
     formula); no kernel of the fit path runs;
  7. times from CUDA events (median of several runs after warm-up), each
     with the card's name and power limit: K2's ptxas report per instance
     and its launch plan; a megakernel
     iteration (chunks of ten) split into K2, the chunk's one train-MSE
     read of Phi per ten iterations and the rest; a fused-logistic
     iteration split into the local gradients, K3, the metric and the
     rest; an spmd iteration; each of these also as the host's time to
     enqueue it, from the same window; each kernel beside its bound and
     its plain version; K1 beside its earlier design's time and a write-
     floor probe (out.fill_ over the same output); predict;
  8. torch.profiler windows over ten megakernel COKE iterations and ten
     fused-logistic COKE iterations, recording device activity only:
     device busy and idle share, device time by kernel;
  9. the LM serving engine, small: the reduced qwen3-1.7b config with
     weights from one seed, on the card against the CPU (K4's plain
     version): equal greedy tokens, prefill logits close;
 10. the LM serving engine at full width: qwen3-1.7b (28 layers, d_model
     2048, 16 heads / 8 KV, head_dim 128, vocab 151936) in fp32 with
     weights drawn on the card, serving 2 prompts of 4096 tokens with
     max_new_tokens=16, greedy, cache_len=4112. K4 must launch exactly 28
     times (once per layer of the one prefill) and no other kernel; then
     layer 0's attention against the plain version, the prefill split into
     K4 and the rest, decode per token, and a profiler window over one
     prefill;
 11. K4 alone at the repo's prefill_32k length (S=32768, B=1, one layer),
     fp32 and bf16: qwen3-1.7b's heads (H=16, KV=8, causal), also without
     the causal mask beside it, and Mixtral's sliding window (H=32, KV=8,
     window 4096): the kernel's time, its bound (fp32: the least of the
     CUDA-core and 3xTF32 operation times), and
     F.scaled_dot_product_attention at the same shape as the yardstick.
Before each of phases 4-6 and 10 every launch counter is set to 0, and
read just after.
The line before the last is one JSON object describing the kernels; the
last is {"ok": true, "device": {...}}. Without a card, or outside a
checkout of the repo, it prints no result and exits 2.
"""
from __future__ import annotations

import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ITERS = 50
N_AGENTS = 20
SAMPLES = 5000            # per agent: 3500 train + 1500 test rows
FEATURES = 4096
# NVIDIA data-sheet peaks: (name fragment, memory bytes/s, fp32 flop/s
# outside the tensor cores, dense bf16 tensor-core flop/s, dense TF32
# tensor-core flop/s); the first fragment found in the card's name
CARD_PEAKS = (("H100 PCIe", 2.0e12, 51.2e12, 756e12, 378e12),
              ("H100 NVL", 3.9e12, 60.0e12, 835e12, 417.5e12),
              ("H100", 3.35e12, 67.0e12, 989e12, 494.7e12),
              ("H200", 4.8e12, 67.0e12, 989e12, 494.7e12))
# K2: theta', xi_sq and resid_sq are fp32 sums of T*D products taken in
# another order than cuBLAS's (per-thread column strips, a fixed block
# tree, segment order): relative error ~sqrt(T)*2^-24 ~ 4e-6 at T=3500
K2_RTOL = 1e-5
# K2 at the main shape in its earlier design (two launches over per-agent
# row chunks, PERF.md's kernel table): the time this design is held against
K2_EARLIER_MS = 0.6582
# K1 at the predict shape in its earlier design (a 32 x 64 tile per block,
# stored at the block's end; PERF.md's kernel table): the time this design
# is held against
K1_EARLIER_MS = 0.4569
# K3: g_aug is formed in the plain expression's order with round-to-nearest
# intrinsics, so it may differ from the plain version only where a compiler
# contracted a product into an FMA: 4 ulps of the largest term. xi_sq is an
# fp32 sum over D in another order than the plain torch.sum.
K3_ULPS = 4 * 2.0**-23
K3_XI_RTOL = 1e-5
# spmd vs the megakernel at full width: the same iteration with the T-sums
# of the gradient in another order (cuBLAS batched products vs K2's column
# strips), each ~sqrt(T)*2^-24 relative, carried through 50 iterations
SPMD_RTOL = 1e-5
# CTA stepsize on the spmd path (see phase 6)
CTA_LR = 0.3
# the reason no single PyTorch call is a yardstick
NO_LIBRARY = {
    "coke_megastep": "no single PyTorch call computes a whole gradient-"
                     "primal ADMM iteration (two matvecs over Phi, the ring "
                     "combine and the censor norm)",
    "rff_cos_bias": "no single PyTorch call fuses x @ omega with the cosine; "
                    "torch.addmm + torch.cos is two calls and writes the "
                    "projection to device memory",
    "coke_fused_update": "no single PyTorch call computes the augmented "
                         "gradient and the per-agent censor norm together",
}
# the LM serving path (phase 10): qwen3-1.7b serving 2 prompts of 4096
# tokens, 16 new tokens each, greedy, in a cache of 4112 slots
LM_ARCH = "qwen3-1.7b"
LM_BATCH = 2
LM_PROMPT = 4096
LM_NEW_TOKENS = 16
LM_CACHE = LM_PROMPT + LM_NEW_TOKENS
# K4 alone (phase 11): the prefill_32k length of src/repro/configs/
# shapes.py, and Mixtral-8x7B's attention (src/repro/configs/
# mixtral_8x7b.py: 32 heads, 8 KV heads, head_dim 128, window 4096)
PREFILL_32K = 32768
MIXTRAL_HEADS = (32, 8, 128, 4096)
# K4 against its plain version: fp32 scores and an online softmax against a
# full softmax (the reference's own tolerance, tests/test_kernels.py); bf16
# outputs within an ulp of bf16 (2^-7 relative) after rounding
K4_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# the tensor-core instructions each K4 instance must compile to (SASS):
# bf16 m16n8k16 and the TF32 m16n8k8 of the fp32 instance's 3xTF32
K4_HMMA = ("HMMA.16816.F32.BF16", "HMMA.1688.F32.TF32")
# the LM on the card against the CPU: fp32 through the layers with cuBLAS
# and K4 against ATen's CPU matmuls and the plain softmax, ~1e-6 relative
# per op: logits within 1e-5 of their largest magnitude
LM_RTOL = 1e-5
KERNEL_SOURCES = {   # name -> (port source, TPU kernel it replaces)
    "coke_megastep": ("src/repro_torch/csrc/coke_megastep.cu",
                      "src/repro/kernels/coke_update/coke_update.py:243"),
    "rff_cos_bias": ("src/repro_torch/csrc/rff.cu",
                     "src/repro/kernels/rff/rff.py:51"),
    "coke_fused_update": ("src/repro_torch/csrc/coke_fused_update.cu",
                          "src/repro/kernels/coke_update/coke_update.py:81"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/"
                        "flash_attention.py:97"),
}


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_peaks(name):
    for frag, bw, flops, bf16, tf32 in CARD_PEAKS:
        if frag in name:
            return bw, flops, bf16, tf32
    raise RuntimeError(f"no data-sheet peaks for {name!r}: add them to "
                       "CARD_PEAKS before quoting a bound")


def time_ms(fn, reps=10, runs=7, warmup=3):
    """Median over `runs` of the mean time of `reps` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def graph_ms(fn, reps=100, runs=7):
    """Device time of one call of `fn`: `reps` calls captured in one CUDA
    graph, replayed, median over `runs` (CUDA events). For a call whose
    host side (Python, allocation, launch) outlasts its device work, which
    `time_ms` would measure instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, reps=1, runs=runs, warmup=1) / reps


def paired_ms(fn, calls, runs=7, warmup=2):
    """(device ms, host ms) per call of the `calls` that `fn` makes, both
    from one window (medians over `runs`): CUDA events recorded on either
    side of `fn`, and perf_counter around the host's enqueue of the same
    work. The device cannot finish before the host has enqueued the last
    launch, so device >= host; where the two are close, the device waits
    on the host."""
    for _ in range(warmup):
        fn()
    dev, host = [], []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host.append((time.perf_counter() - t0) * 1e3 / calls)
        end.synchronize()
        dev.append(start.elapsed_time(end) / calls)
    return statistics.median(dev), statistics.median(host)


def hmma_count(library):
    """{opcode: count} of the tensor-core instructions (HMMA.*) in a built
    library's SASS, by `cuobjdump -sass`."""
    import collections
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return dict(collections.Counter(
        tok.rstrip(";") for line in sass.splitlines()
        for tok in line.split() if tok.startswith("HMMA")))


def k1_sass_counts(sass):
    """Instructions a thread issues per output on the cosine's fast path,
    in the SASS of K1's bulk instance for d = 5 (`cuobjdump -sass` text,
    where the loop over k is unrolled), as a line of text.

    Each fast-path cosine adds the 1.5 * 2^23 shifter once (`FADD ...,
    12582912`), so those count a step's outputs. The unit loop is the
    innermost loop holding them; its largest forward branch skips cosf's
    fallback."""
    import re
    body = next(p for p in sass.split("Function : ")[1:]
                if "rff_strip_kernelILb1ELi5E" in p.split("\n", 1)[0])
    ins = [(int(m.group(1), 16), m.group(2)) for m in (
        re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        for line in body.splitlines()) if m]
    shift = [a for a, t in ins if re.search(r"FADD\b.*, 12582912$", t)]
    jumps = [(a, int(m.group(1), 16)) for a, t in ins
             for m in [re.search(r"\bBRA\S*\s+.*?0x([0-9a-f]+)", t)] if m]
    lo, hi = min(((t, a) for a, t in jumps
                  if t <= shift[0] and shift[-1] <= a),
                 key=lambda r: r[1] - r[0])
    skip = max(((a, t) for a, t in jumps if lo <= a < t <= hi),
               key=lambda r: r[1] - r[0])
    fast = [t for a, t in ins if lo <= a <= hi and not skip[0] < a < skip[1]]
    ffma = sum(1 for t in fast if re.search(r"\bFFMA\b", t))
    return (f"{len(fast) / len(shift):.2f} instructions per output on the "
            f"fast path at d=5 ({len(fast)} per step of {len(shift)} "
            f"outputs, {ffma / len(shift):.2f} of them FFMA)")


def k4_plan(build, dh, dv, dtype):
    """K4's launch plan for (Dh, Dv, dtype) on this card, from the C entry
    `flash_attention_plan`: (query rows per block, keys per staged tile,
    cp.async stages, shared-memory bytes, blocks per SM)."""
    import ctypes
    lib = build.load("flash_attention", {"flash_attention_plan": (
        ctypes.c_int, [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])})
    out = (ctypes.c_int * 5)()
    build.check(lib, lib.flash_attention_plan(
        dh, dv, 0 if dtype == torch.float32 else 1, out),
        "flash_attention_plan")
    return tuple(out)


def k4_bound(nbytes, flops, dtype, peaks):
    """(ms, by, how) of K4's bound: the larger of the bytes over the memory
    rate and the operations over the rate of the cheapest way the card has
    to do them. bf16: the bf16 tensor cores. fp32: the least of the CUDA
    cores and 3xTF32 (three TF32 MMAs per product, fp32-level accuracy)."""
    bw, fp32, bf16, tf32 = peaks
    t_b = nbytes / bw * 1e3
    if dtype == torch.float32:
        t_f, how = min((flops / fp32 * 1e3, f"fp32 CUDA cores at "
                        f"{fp32 / 1e12:g} TFLOP/s"),
                       (3 * flops / tf32 * 1e3, f"3xTF32, 3 x the flops at "
                        f"{tf32 / 1e12:g} TFLOP/s"))
    else:
        t_f, how = flops / bf16 * 1e3, f"bf16 at {bf16 / 1e12:g} TFLOP/s"
    if t_b >= t_f:
        return t_b, "bytes", f"{bw / 1e12:g} TB/s"
    return t_f, "operations", how


def sdpa_ms(q, k, v, *, causal, mask=None):
    """(ms, how) of one torch.nn.functional.scaled_dot_product_attention
    call on q (B, H, S, Dh), k/v (B, KV, S, *): the library yardstick of K4,
    timed here and called nowhere in the port. Takes the first backend of
    flash, efficient and cuDNN that runs the call (math too where its S^2
    scores fit), with grouped heads through enable_gqa or, where a backend
    refuses that, with K and V repeated H/KV times before the timed call."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    H, KV = q.shape[1], k.shape[1]
    scores = 4.0 * q.shape[0] * H * q.shape[2] * k.shape[2]
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                SDPBackend.CUDNN_ATTENTION]
    if 3 * scores < 20e9:
        backends.append(SDPBackend.MATH)
    refused = []
    for backend in backends:
        for gqa in ((True, False) if H != KV else (False,)):
            kk, vv = k, v
            if H != KV and not gqa:
                kk = k.repeat_interleave(H // KV, dim=1)
                vv = v.repeat_interleave(H // KV, dim=1)

            def call():
                with sdpa_kernel([backend]):
                    return torch.nn.functional.scaled_dot_product_attention(
                        q, kk, vv, attn_mask=mask,
                        is_causal=causal and mask is None, enable_gqa=gqa)

            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    call()
                    torch.cuda.synchronize()
            except RuntimeError as e:          # includes OutOfMemoryError
                refused.append(f"{backend.name}{' enable_gqa' if gqa else ''}"
                               f": {str(e).splitlines()[0][:60]}")
                continue
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                ms = time_ms(call, reps=1, runs=3, warmup=1)
            heads = ("H = KV" if H == KV else "enable_gqa" if gqa
                     else f"K/V repeated {H // KV}x before the call")
            mask_how = ("boolean mask" if mask is not None
                        else "is_causal" if causal else "no mask")
            return ms, (f"backend {backend.name}, {heads}, {mask_how}"
                        + (f"; refused: {refused}" if refused else ""))
    raise RuntimeError(f"no SDPA backend ran the call: {refused}")


def ptxas_report(nvcc_log):
    """{kernel: "N registers, spill line"} from nvcc's -Xptxas -v output,
    K2's stream-kernel instances named by their template arguments
    (V float4 column groups per thread, R rows per stage, bulk or cp.async
    staging) and K1's by its store path (TMA bulk stores or 4-byte
    stores). Empty when the library came from the build cache."""
    import re
    out, fn = {}, None
    for line in nvcc_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            t = re.search(r"megastep_stream_kernelILi(\d+)ELi(\d+)ELb([01])E",
                          fn)
            k1 = re.search(r"rff_strip_kernelILb([01])ELi(\d+)E", fn)
            if t:
                fn = (f"stream<V={t.group(1)}, R={t.group(2)}, "
                      f"{'bulk' if t.group(3) == '1' else 'cp.async'}>")
            elif k1:
                d = "any d" if k1.group(2) == "0" else f"d={k1.group(2)}"
                fn = f"rff<{'bulk' if k1.group(1) == '1' else '4-byte'}, {d}>"
            elif "combine_kernel" in fn:
                fn = "combine"
            out[fn] = ""
        elif fn is not None and ("spill" in line or "registers" in line):
            out[fn] = (out[fn] + "; " if out[fn] else "") + line.strip()
    return out


def k1_tolerance(x, omega):
    """1e-6 absolute on phi, or 16 ulps of the largest |x @ omega| times
    sqrt(2/L) where that is larger: the kernel's fmaf chain and cuBLAS
    round the d-term projection differently, and cos passes that on."""
    proj = float((x.abs() @ omega.abs()).max())
    return max(1e-6, math.sqrt(2.0 / omega.shape[1]) * 16 * 2**-23 * proj)


def k3_tolerance(theta, hat, gamma, grad, left, right, rho, deg):
    """K3_ULPS of the largest term of g_aug."""
    terms = (grad, 2.0 * rho * deg * theta, gamma,
             rho * (deg * hat + left + right))
    return K3_ULPS * max(float(t.abs().max()) for t in terms)


def check_history(tag, h, iters):
    for k, v in h.items():
        if v.shape != (iters,) or not torch.isfinite(
                v.to(torch.float64)).all():
            raise AssertionError(f"{tag}: history {k} is not {iters} finite "
                                 "values")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run "
              "it from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.api import (FitConfig, KRRConfig, PAPER_SETUPS,
                                 build_problem, fit, get_solver, make_problem)
    from repro_torch.api.backends import _local_grads, consensus_runner
    from repro_torch.api.config import SolveContext
    from repro_torch.api.solvers import _stacked_metrics
    from repro_torch.core.graph import ring
    from repro_torch.kernels import build
    from repro_torch.kernels.coke_update import coke_update as k2
    from repro_torch.kernels.coke_update.ref import (coke_megastep_ref,
                                                     coke_update_ref)
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.kernels.flash_attention.ops import gqa_flash
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rff import rff as k1
    from repro_torch.kernels.rff.ref import rff_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # K1's predict shape: every agent's held-out rows (30 000 at full size)
    predict_rows = N_AGENTS * (SAMPLES - int(SAMPLES * 0.7))

    def reset_counts():
        k1.LAUNCHES = k2.LAUNCHES = k2.FUSED_UPDATE_LAUNCHES = 0
        k4.LAUNCHES = 0

    def counts():
        return {"coke_megastep": k2.LAUNCHES, "rff_cos_bias": k1.LAUNCHES,
                "coke_fused_update": k2.FUSED_UPDATE_LAUNCHES,
                "flash_attention": k4.LAUNCHES}

    # ---- 0. device -------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    card = smi
    peaks = card_peaks(name)
    bw, fp32, bf16_peak, tf32_peak = peaks
    log(0, f"device {name} (count {torch.cuda.device_count()}), torch "
           f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(0, f"nvidia-smi: {smi}; peaks used for bounds: {bw / 1e12} TB/s, "
           f"{fp32 / 1e12} TFLOP/s fp32, {bf16_peak / 1e12} TFLOP/s bf16, "
           f"{tf32_peak / 1e12} TFLOP/s TF32")

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    report = build.build()
    log(1, f"built {sorted(report)} in {time.perf_counter() - t0:.1f} s "
           f"into {build.BUILD_DIR.relative_to(ROOT)}")
    for src, r in sorted(report.items()):
        if src in ("coke_megastep", "rff"):   # per instance, below and in 7
            continue
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(1, f"  {src}: {line.strip()}")
    for fn, props in ptxas_report(report["rff"]["log"]).items():
        log(1, f"  rff {fn}: {props}")
    for shape in ((predict_rows, 5, FEATURES),
                  (predict_rows, 96, FEATURES)):
        out = torch.empty(shape[0], shape[2], device=dev)
        plan = k1.rff_device_plan(*shape, out)
        log(1, f"K1 plan (M, d, L)={shape}: {plan.instance} instance, "
               f"{plan.strips} strip(s) of {plan.strip} columns, "
               f"{plan.tiles} row tiles of {plan.rows} rows, "
               f"{plan.buffers} output tiles in shared memory, "
               f"{plan.smem_bytes} B of shared memory, {plan.blocks} "
               f"blocks; omega and bias slices "
               f"{4 * (shape[1] + 1) * plan.strip} B")
        del out
    try:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        k1_sass = k1_sass_counts(subprocess.run(
            [tool, "-sass", str(build.library_path("rff"))],
            capture_output=True, text=True, check=True, timeout=300).stdout)
    except Exception as exc:    # a diagnostic: a layout it misreads
        k1_sass = f"not read ({exc!r})"
    log(1, f"K1 SASS (cuobjdump -sass, bulk instance): {k1_sass}")
    hmma = hmma_count(build.library_path("flash_attention"))
    log(1, f"flash_attention SASS tensor-core instructions (cuobjdump "
           f"-sass): {hmma}")
    if not all(hmma.get(kind, 0) > 0 for kind in K4_HMMA):
        raise AssertionError(f"the flash_attention library lacks one of "
                             f"{K4_HMMA} (found {hmma}): K4 does not run on "
                             "the tensor cores")
    for dh, dv, dtype in ((128, 128, torch.float32),
                          (128, 128, torch.bfloat16),
                          (256, 256, torch.float32)):
        bq, bk, stages, smem, blocks = k4_plan(build, dh, dv, dtype)
        log(1, f"K4 plan Dh={dh} Dv={dv} {str(dtype).split('.')[-1]}: "
               f"{bq}-row query tiles, {bk}-key tiles in {stages} cp.async "
               f"stages, {smem} B of shared memory, {blocks} block(s) per "
               "SM")

    # ---- 2. kernels against their plain versions -------------------------
    gen = torch.Generator(device=dev).manual_seed(11)
    errs = {k: 0.0 for k in KERNEL_SOURCES}

    def rff_case(M, d, L, main=False):
        x = torch.rand((M, d), generator=gen, device=dev)
        omega = torch.randn((d, L), generator=gen, device=dev)
        bias = torch.rand((L,), generator=gen, device=dev) * (2 * math.pi)
        got = k1.rff_cos_bias(x, omega, bias)
        want = rff_ref(x, omega, bias)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = k1_tolerance(x, omega)
        instance = k1.rff_staging(L, got)
        log(2, f"K1 rff_cos_bias M={M} d={d} L={L} ({instance}): max|err| "
               f"{err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"M={M} d={d} L={L}: {err} > {tol}")
        if main:
            errs["rff_cos_bias"] = err
        return x, omega, bias, instance

    k1_inputs = rff_case(predict_rows, 5, FEATURES, main=True)
    instances = {k1_inputs[3]}
    for M, d, L in ((1001, 13, 100), (1001, 13, 513), (1001, 77, 100),
                    (1001, 77, 513), (1001, 96, 100), (1001, 96, 513),
                    (1001, 5, 513), (1, 5, FEATURES), (1001, 96, FEATURES),
                    (257, 5, FEATURES + 4), (1000, 96, 253)):
        instances.add(rff_case(M, d, L)[3])
    if instances != {"bulk", "4-byte"}:
        raise AssertionError(f"phase 2 ran K1's instances {instances}, "
                             "not both")
    again = k1.rff_cos_bias(*k1_inputs[:3])
    if not torch.equal(again, k1.rff_cos_bias(*k1_inputs[:3])):
        raise AssertionError("two K1 calls on the same inputs differ")
    del again
    bad, first_bad = k1.rff_cos_mismatches(dev)
    log(2, f"K1's cosine against cosf on all 2^32 fp32 values: {bad} "
           "differ; two calls at the predict shape give the same bits")
    if bad:
        raise AssertionError(f"K1's cosine differs from cosf on {bad} "
                             f"values, first 0x{first_bad:08x}")

    def mega_case(n, t, d, offsets, main=False, misalign=False):
        theta = torch.randn((n, d), generator=gen, device=dev)
        hat = torch.randn((n, d), generator=gen, device=dev)
        gamma = 0.1 * torch.randn((n, d), generator=gen, device=dev)
        # bounded features shaped like sqrt(2/D) cos(.), labels in [0, 1)
        # misaligned: a view 4 bytes off 16-byte alignment
        u = torch.rand(n * t * d + int(misalign), generator=gen,
                       device=dev)
        phi = u[int(misalign):].view(n, t, d)
        phi.copy_(math.sqrt(2.0 / d) * torch.cos(2 * math.pi * phi))
        y = torch.rand((n, t), generator=gen, device=dev)
        kw = dict(rho=1e-2, lam=5e-5, lr=0.1, offsets=offsets)
        want = coke_megastep_ref(theta, hat, gamma, phi, y,
                                 return_resid_sq=True, **kw)
        rsq = torch.empty((n,), device=dev)
        got = k2.coke_megastep(theta.clone(), hat, gamma, phi, y,
                               resid_sq=rsq, **kw) + (rsq,)
        torch.cuda.synchronize()
        errs_here = [float((o - w).abs().max()) for o, w in zip(got, want)]
        tols = [K2_RTOL * float(w.abs().max()) for w in want]
        plan = k2.megastep_plan(phi)
        log(2, f"K2 coke_megastep N={n} T={t} D={d} offsets={offsets} "
               f"[{k2.megastep_staging(phi)}, {plan.rows_per_stage} rows x "
               f"{plan.stages} stages, grid {plan.segments.grid}, "
               f"{plan.segments.num_segments} segments]: max|err| theta' "
               f"{errs_here[0]:.3e} (tol {tols[0]:.3e})")
        log(2, f"  and its sums at that shape: max|err| xi_sq "
               f"{errs_here[1]:.3e} (tol {tols[1]:.3e}), resid_sq "
               f"{errs_here[2]:.3e} (tol {tols[2]:.3e})")
        if not all(e <= tol for e, tol in zip(errs_here, tols)):
            raise AssertionError(f"K2 disagrees with its plain version at "
                                 f"N={n} T={t} D={d} offsets={offsets}")
        if main:
            # the kernels line's max_abs_err is theta''s error
            errs["coke_megastep"] = errs_here[0]
        return theta, hat, gamma, phi, y, kw

    k2_inputs = mega_case(N_AGENTS, int(SAMPLES * 0.7), FEATURES, (1,),
                          main=True)
    k2_staged = {k2.megastep_staging(k2_inputs[3])}
    for n, t, d, offsets, mis in (
            (20, 3500, 4096, (1,), True),     # the main shape, cp.async
            (4, 40, 32, (1,), False), (2, 33, 513, (1,), False),
            (8, 64, 100, (1, 2), False), (3, 17, 128, (1,), False),
            (5, 128, 256, (2,), False),
            (7, 1000, 256, (1,), False),      # ranges cross agents
            (200, 5, 64, (1, 3), False),      # N above the SM count
            (6, 1, 128, (1,), False),         # T = 1
            (3, 8, 16384, (1,), False),       # the widest instance
            (2, 5, 19370, (1,), False),       # earlier widest D, unaligned
            (4, 50, 1001, (1,), False)):
        phi = mega_case(n, t, d, offsets, misalign=mis)[3]
        k2_staged.add(k2.megastep_staging(phi))
    if k2_staged != {"bulk", "cp.async"}:
        raise AssertionError(f"K2's cases took only {k2_staged}")
    # no floating-point atomics: a second call gives the same bits
    theta2, hat2, gamma2, phi2, y2, kw2 = k2_inputs
    runs = []
    for _ in range(2):
        rsq = torch.empty((N_AGENTS,), device=dev)
        runs.append(k2.coke_megastep(theta2.clone(), hat2, gamma2, phi2, y2,
                                     resid_sq=rsq, **kw2) + (rsq,))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("two K2 calls on the same inputs differ")
    log(2, "K2: two calls at the main shape give bitwise-equal theta', xi_sq "
           "and resid_sq")

    def update_case(n, d, deg, main=False):
        # theta, theta_hat, gamma, grad, left, right at the scale of a fit
        ops = [0.1 * torch.randn((n, d), generator=gen, device=dev)
               for _ in range(6)]
        kw = dict(rho=1e-2, deg=deg)
        want, want_xi = coke_update_ref(*ops, **kw)
        before = k2.FUSED_UPDATE_LAUNCHES
        got, got_xi = k2.coke_fused_update(*ops, **kw)
        torch.cuda.synchronize()
        if k2.FUSED_UPDATE_LAUNCHES != before + 1:
            raise AssertionError("K3 did not launch exactly once per call")
        e_g = float((got - want).abs().max())
        e_xi = float((got_xi - want_xi).abs().max())
        tol_g = k3_tolerance(*ops, **kw)
        tol_xi = K3_XI_RTOL * float(want_xi.abs().max())
        log(2, f"K3 coke_fused_update N={n} D={d} deg={deg:g}: g_aug "
               f"max|err| {e_g:.3e} (tol {tol_g:.3e}, 4 ulps of the largest "
               f"term), xi_sq max|err| {e_xi:.3e} (tol {tol_xi:.3e}, rtol "
               f"{K3_XI_RTOL:g})")
        if not (e_g <= tol_g and e_xi <= tol_xi):
            raise AssertionError(f"K3 disagrees with its plain version at "
                                 f"N={n} D={d} deg={deg}")
        if main:
            errs["coke_fused_update"] = e_g
        return ops, kw

    k3_inputs = update_case(N_AGENTS, FEATURES, 2.0, main=True)
    for n, d, deg in ((1, 1, 2.0), (3, 513, 2.0), (7, 1000, 2.0),
                      (1, 1, 4.0), (3, 513, 4.0), (7, 1000, 4.0)):
        update_case(n, d, deg)

    def attention_cases():
        """K4 against its plain version over lengths (Sq = Sk, and not),
        masks, head groups, both layouts, head dims and dtypes."""
        worst = {}
        for sq, sk in ((100, 100), (257, 257), (1024, 1024), (300, 700),
                       (700, 300)):
            for dh, dv in ((64, 64), (128, 128), (192, 128)):
                for dtype in (torch.float32, torch.bfloat16):
                    errs_here = []
                    for kv in (8, 4, 2):          # H / KV = 1, 2, 4
                        q = torch.randn((2, 8, sq, dh), generator=gen,
                                        device=dev).to(dtype)
                        k = torch.randn((2, kv, sk, dh), generator=gen,
                                        device=dev).to(dtype)
                        v = torch.randn((2, kv, sk, dv), generator=gen,
                                        device=dev).to(dtype)
                        for causal in (True, False):
                            for window in (0, 32):
                                want = attention_ref(q, k, v, causal=causal,
                                                     window=window)
                                a = k4.flash_attention(q, k, v, causal=causal,
                                                       window=window)
                                b = gqa_flash(q.transpose(1, 2),
                                              k.transpose(1, 2),
                                              v.transpose(1, 2),
                                              causal=causal, window=window)
                                torch.cuda.synchronize()
                                for got in (a, b.transpose(1, 2)):
                                    errs_here.append(float(
                                        (got.float() - want.float()).abs()
                                        .max()))
                    err, tol = max(errs_here), K4_TOL[dtype]
                    key = str(dtype).split(".")[-1]
                    worst[key] = max(worst.get(key, 0.0), err)
                    log(2, f"K4 flash_attention Sq={sq} Sk={sk} Dh={dh} "
                           f"Dv={dv} {key}: H/KV 1, 2, 4 x causal x window "
                           f"0, 32 x both layouts ({len(errs_here)} calls): "
                           f"max|err| {err:.3e} (tol {tol:g})")
                    if not err <= tol:
                        raise AssertionError(
                            f"K4 disagrees with its plain version at Sq={sq} "
                            f"Sk={sk} Dh={dh} Dv={dv} {key}: {err} > {tol}")
        return worst

    k4_worst = attention_cases()
    log(2, f"K4 worst error over the sweep: {k4_worst}")

    # ---- 3. small fits, card against CPU ----------------------------------
    small = FitConfig(krr=KRRConfig(num_agents=4, samples_per_agent=40,
                                    num_features=32, lam=1e-2, rho=0.1),
                      graph="ring", censor_v=0.3, censor_mu=0.97,
                      num_iters=40, primal="gradient", inner_lr=0.05,
                      cta_lr=0.05, backend="fused")
    small_built = build_problem(small, device="cpu")
    small_logistic = dataclasses.replace(
        small_built.problem, loss="logistic", labels=torch.where(
            small_built.problem.labels > small_built.problem.labels.median(),
            1.0, -1.0))
    small_cases = [("fused", alg, small_built.problem, small)
                   for alg in ("coke", "dkla")]
    small_cases += [("spmd", alg, small_built.problem, small)
                    for alg in ("coke", "dkla", "cta")]
    # a threshold under which COKE sends some broadcasts on this loss
    small_cases += [("fused", alg, small_logistic,
                     small.replace(censor_v=0.03, censor_mu=0.8))
                    for alg in ("coke", "dkla")]
    for backend, alg, prob, base in small_cases:
        cfg = base.replace(algorithm=alg, backend=backend)
        if alg == "cta":
            cfg = cfg.replace(censor_v=None, censor_mu=None)
        cpu = fit(cfg, problem=prob, device="cpu")
        gpu = fit(cfg, problem=prob, device=dev)
        for k in ("comms", "bits"):
            if not torch.equal(gpu.history[k].cpu(), cpu.history[k]):
                raise AssertionError(f"small {backend} {alg} {prob.loss} fit:"
                                     f" {k} differs between card and CPU")
        e = float((gpu.theta.cpu() - cpu.theta).abs().max())
        e_mse = float((gpu.train_mse.cpu() - cpu.train_mse).abs().max())
        log(3, f"small {backend} {alg} fit ({prob.loss}) N=4 T=28 D=32, card "
               f"vs CPU: comms/bits equal ({int(cpu.comms[-1])} "
               f"transmissions), theta max|err| {e:.3e}, train_mse max|err| "
               f"{e_mse:.3e} (tol 1e-5)")
        if not (e <= 1e-5 and e_mse <= 1e-5):
            raise AssertionError(f"small {backend} {alg} fit differs on the "
                                 "card")

    # ---- 4. the megakernel path at full width -----------------------------
    krr = dataclasses.replace(PAPER_SETUPS["synthetic"],
                              samples_per_agent=SAMPLES,
                              num_features=FEATURES)
    cfg = FitConfig(krr=krr, backend="fused", graph="ring",
                    primal="gradient", num_iters=ITERS)
    t0 = time.perf_counter()
    built = build_problem(cfg, device=dev)
    torch.cuda.synchronize()
    problem = built.problem
    N, T, D = problem.feats.shape
    log(4, f"build_problem: feats {tuple(problem.feats.shape)} "
           f"({problem.feats.numel() * 4 / 1e9:.3f} GB), x_test "
           f"{tuple(built.x_test.shape)}, {time.perf_counter() - t0:.1f} s")

    # the megakernel path reads Phi in K2 once per iteration, and once more
    # per chunk for the last iteration's train MSE (backends.residual_sq)
    from repro_torch.api import backends as backends_mod
    metric_reads = [0]
    real_residual_sq = backends_mod.residual_sq

    def counted_residual_sq(*a, **k):
        metric_reads[0] += 1
        return real_residual_sq(*a, **k)

    backends_mod.residual_sq = counted_residual_sq
    reset_counts()
    results = {}
    for alg in ("coke", "dkla"):
        before2 = k2.LAUNCHES
        reads_before = metric_reads[0]
        t0 = time.perf_counter()
        res = fit(cfg.replace(algorithm=alg), problem=problem, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rose = k2.LAUNCHES - before2
        if rose != k2.LAUNCHES_PER_CALL * ITERS:
            raise AssertionError(f"{alg}: K2 launched {rose} times in "
                                 f"{ITERS} iterations")
        reads = metric_reads[0] - reads_before
        if reads != 1:       # one chunk: chunk_size is None
            raise AssertionError(f"{alg}: the train MSE read Phi {reads} "
                                 "times outside K2 in one chunk")
        log(4, f"{alg}: Phi reads {ITERS} in K2 (one per iteration) + "
               f"{reads} for the train MSE (one per chunk)")
        h = {k: v.cpu() for k, v in res.history.items()}
        check_history(alg, h, ITERS)
        if not h["train_mse"][-1] < h["train_mse"][0]:
            raise AssertionError(f"{alg}: train_mse did not fall")
        comms = int(h["comms"][-1])
        if alg == "dkla" and comms != N * ITERS:
            raise AssertionError(f"dkla sent {comms} != {N * ITERS}")
        if alg == "coke" and comms > N * ITERS:
            raise AssertionError(f"coke sent {comms} > {N * ITERS}")

        model = res.to_model(built.rff_params)
        before1 = k1.LAUNCHES
        preds = model.predict(built.x_test, backend="fused")
        torch.cuda.synchronize()
        if not k1.LAUNCHES > before1:
            raise AssertionError(f"{alg}: predict did not launch K1")
        ev = model.evaluate(built.x_test, built.y_test, backend="fused")
        ev_ref = model.evaluate(built.x_test, built.y_test, backend="ref")
        if preds.shape != built.y_test.shape or not torch.isfinite(
                preds).all():
            raise AssertionError(f"{alg}: predictions are not finite "
                                 f"{tuple(built.y_test.shape)}")
        if not math.isclose(ev["test_mse"], ev_ref["test_mse"], rel_tol=1e-4):
            raise AssertionError(f"{alg}: fused and ref test MSE differ: "
                                 f"{ev['test_mse']} vs {ev_ref['test_mse']}")
        log(4, f"{alg}: {ITERS} iterations in {wall:.2f} s wall (first "
               f"call); train_mse {float(h['train_mse'][0]):.5f} -> "
               f"{float(h['train_mse'][-1]):.5f}, comms {comms}/"
               f"{N * ITERS}, bits {float(h['bits'][-1]):.0f}, "
               f"consensus_gap {float(h['consensus_gap'][-1]):.3e}; test_mse "
               f"{ev['test_mse']:.5f} (fused) / {ev_ref['test_mse']:.5f} "
               f"(ref), consensus_mse {ev['consensus_mse']:.5f}")
        results[alg] = res
    backends_mod.residual_sq = real_residual_sq
    mega_counts = counts()
    log(4, f"launch counts over the megakernel path: {mega_counts}")
    if mega_counts["coke_fused_update"] != 0:
        raise AssertionError("K3 ran on the megakernel path")

    # ---- 5. the fused fallback on a logistic problem at full width --------
    labels_pm = torch.where(problem.labels > problem.labels.median(), 1.0,
                            -1.0)
    log_problem = make_problem(problem.feats, labels_pm, ring(N),
                               problem.lam, problem.rho, loss="logistic")
    if log_problem.feats.data_ptr() != problem.feats.data_ptr():
        raise AssertionError("the logistic problem copied Phi")
    log_cfg = FitConfig(krr=krr, backend="fused", graph="ring",
                        num_iters=ITERS)          # primal="auto"
    reset_counts()
    log_results = {}
    for alg in ("coke", "dkla"):
        before = (k2.FUSED_UPDATE_LAUNCHES, k2.LAUNCHES)
        t0 = time.perf_counter()
        res = fit(log_cfg.replace(algorithm=alg), problem=log_problem,
                  device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rose = (k2.FUSED_UPDATE_LAUNCHES - before[0], k2.LAUNCHES - before[1])
        if rose != (ITERS, 0):
            raise AssertionError(f"logistic {alg}: K3 launched {rose[0]} and "
                                 f"K2 {rose[1]} times in {ITERS} iterations")
        h = {k: v.cpu() for k, v in res.history.items()}
        check_history(f"logistic {alg}", h, ITERS)
        comms = int(h["comms"][-1])
        if alg == "dkla" and comms != N * ITERS:
            raise AssertionError(f"logistic dkla sent {comms} != {N * ITERS}")
        if alg == "coke" and comms > N * ITERS:
            raise AssertionError(f"logistic coke sent {comms} > {N * ITERS}")
        margins = torch.einsum("ntd,nd->nt", log_problem.feats, res.theta)
        acc = float((torch.sign(margins) == labels_pm).float().mean())
        before1 = k1.LAUNCHES
        preds = res.to_model(built.rff_params).predict(built.x_test,
                                                       backend="fused")
        torch.cuda.synchronize()
        if not k1.LAUNCHES > before1:
            raise AssertionError(f"logistic {alg}: predict did not launch K1")
        if preds.shape != built.y_test.shape or not torch.isfinite(
                preds).all():
            raise AssertionError(f"logistic {alg}: predictions are not "
                                 "finite")
        log(5, f"logistic {alg}: {ITERS} iterations in {wall:.2f} s wall "
               f"(first call); comms {comms}/{N * ITERS}, bits "
               f"{float(h['bits'][-1]):.0f}, train sign-accuracy {acc:.4f}, "
               f"consensus_gap {float(h['consensus_gap'][-1]):.3e}")
        log_results[alg] = res
    log_counts = counts()
    log(5, f"launch counts over the fused-fallback path: {log_counts}")

    # ---- 6. the spmd backend at full width --------------------------------
    reset_counts()
    spmd_cfg = cfg.replace(backend="spmd")
    for alg in ("coke", "dkla", "cta"):
        c = spmd_cfg.replace(algorithm=alg)
        if alg == "cta":
            # the ring runtime's CTA takes the gradient before the combine
            # (as the reference's spmd backend does); at the default
            # cta_lr=0.9 it diverges on this setup, at 0.3 it converges
            c = c.replace(censor_v=None, censor_mu=None, cta_lr=CTA_LR)
        t0 = time.perf_counter()
        res = fit(c, problem=problem, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        h = {k: v.cpu() for k, v in res.history.items()}
        check_history(f"spmd {alg}", h, ITERS)
        msg = (f"spmd {alg}: {ITERS} iterations in {wall:.2f} s wall (first "
               f"call); train_mse {float(h['train_mse'][0]):.5f} -> "
               f"{float(h['train_mse'][-1]):.5f}, comms "
               f"{int(h['comms'][-1])}/{N * ITERS}")
        if alg == "cta":
            if int(h["comms"][-1]) != N * ITERS:
                raise AssertionError("spmd cta did not send every iteration")
            if not h["train_mse"][-1] < h["train_mse"][0]:
                raise AssertionError("spmd cta: train_mse did not fall")
            log(6, msg)
            continue
        mega = results[alg]
        for k in ("comms", "bits"):
            if not torch.equal(h[k], mega.history[k].cpu()):
                raise AssertionError(f"spmd {alg}: {k} differs from the "
                                     "megakernel fit")
        e = float((res.theta - mega.theta).abs().max())
        tol = SPMD_RTOL * float(mega.theta.abs().max())
        log(6, f"{msg}; comms/bits equal the megakernel fit's, theta "
               f"max|err| {e:.3e} (tol {tol:.3e}, rtol {SPMD_RTOL:g} of "
               f"max|theta|)")
        if not e <= tol:
            raise AssertionError(f"spmd {alg}: theta differs from the "
                                 "megakernel fit")
    # phase 5's logistic fits on spmd, where g_aug is the plain formula:
    # holds K3 in place on the fused fallback at the main path's shapes
    for alg in ("coke", "dkla"):
        res = fit(log_cfg.replace(algorithm=alg, backend="spmd"),
                  problem=log_problem, device=dev)
        fused = log_results[alg]
        for k in ("comms", "bits"):
            if not torch.equal(res.history[k], fused.history[k]):
                raise AssertionError(f"spmd logistic {alg}: {k} differs from "
                                     "the fused fallback's")
        e = float((res.theta - fused.theta).abs().max())
        tol = SPMD_RTOL * float(fused.theta.abs().max())
        log(6, f"spmd logistic {alg}: comms {int(res.comms[-1])}/"
               f"{N * ITERS} and bits equal the fused fallback's (K3), theta "
               f"max|err| {e:.3e} (tol {tol:.3e}, rtol {SPMD_RTOL:g} of "
               f"max|theta|)")
        if not e <= tol:
            raise AssertionError(f"spmd logistic {alg}: theta differs from "
                                 "the fused fallback's")
    spmd_counts = counts()
    log(6, f"launch counts over the spmd path: {spmd_counts}")
    if spmd_counts["coke_fused_update"] or spmd_counts["coke_megastep"]:
        raise AssertionError("a fit kernel ran on the spmd path")

    # ---- 7. times ---------------------------------------------------------
    def runner(c, prob):
        carry0, chunk_fn, _ = consensus_runner(
            c, get_solver(c.algorithm), prob, SolveContext.from_config(c),
            None)
        state = {"carry": chunk_fn(carry0, 2)[0]}

        def ten_iterations():
            state["carry"] = chunk_fn(state["carry"], 10)[0]

        return state, ten_iterations

    def ten(fn):
        def calls():
            for _ in range(10):
                fn()
        return calls

    def pair(d_h):
        return f"{d_h[0]:.4f} ms on the device / {d_h[1]:.4f} ms host enqueue"

    # every iteration and every part below: device and host time from one
    # window of ten calls (paired_ms)
    plan = k2.megastep_plan(problem.feats)
    main_instance = (f"stream<V={plan.columns}, R={plan.max_rows}, "
                     f"{k2.megastep_staging(problem.feats)}>")
    for fn, props in ptxas_report(report["coke_megastep"]["log"]).items():
        log(7, f"[{card}] K2 ptxas {fn}: {props or 'no report'}"
               + (" (the main path's instance)" if fn == main_instance
                  else ""))
    log(7, f"[{card}] K2 plan at N={N} T={T} D={D}: grid "
           f"{plan.segments.grid} persistent blocks ({plan.blocks} fit on "
           f"the card at once), {plan.segments.num_segments} (block, agent) "
           f"segments, {k2.megastep_staging(problem.feats)} staging, "
           f"{plan.stages} stages of {plan.rows_per_stage} rows "
           f"({plan.stage_bytes} B each, {plan.smem_bytes} B of shared "
           f"memory), {plan.bytes_in_flight} B in flight per SM while the "
           f"consumers hold one stage; {plan.columns} float4 column groups "
           "per consumer thread")
    coke_cfg = cfg.replace(algorithm="coke")
    mega_state, mega_ten = runner(coke_cfg, problem)
    mega_iter = paired_ms(mega_ten, 10)
    iter_ms = mega_iter[0]
    st = mega_state["carry"]
    # the chunk's one train-MSE read of Phi, as _megastep_chunk makes it
    # after its last iteration: timed alone, and counted once per ten
    metric_read = paired_ms(ten(lambda: torch.sum(backends_mod.residual_sq(
        problem.feats, st.theta, problem.labels)) / (N * T)), 10)
    theta, hat, gamma = st.theta.clone(), st.theta_hat, st.gamma
    kw = dict(rho=problem.rho, lam=problem.lam, lr=coke_cfg.inner_lr,
              offsets=(1,))
    rsq_out = torch.empty((N,), device=dev)
    k2_path = paired_ms(ten(lambda: k2.coke_megastep(
        theta, hat, gamma, problem.feats, problem.labels, resid_sq=rsq_out,
        **kw)), 10)
    metric_share = metric_read[0] / 10
    log(7, f"[{card}] one megakernel COKE iteration at N={N} T={T} D={D} "
           f"(chunks of ten): {pair(mega_iter)}. Parts, each alone: K2 with "
           f"the train-MSE residuals folded in {pair(k2_path)}; the chunk's "
           f"one train-MSE read of Phi (einsum after its last iteration) "
           f"{pair(metric_read)}, {metric_share:.4f} ms per iteration over "
           f"ten; the rest (censor, dual, bookkeeping) "
           f"{iter_ms - k2_path[0] - metric_share:.4f} ms on the device. "
           f"Phi is read 11 times per ten iterations (20 when the metric "
           f"read it every iteration)")

    log_state, log_ten = runner(log_cfg.replace(algorithm="coke"),
                                log_problem)
    log_iter = paired_ms(log_ten, 10)
    log_iter_ms = log_iter[0]
    params, cst = log_state["carry"]
    th = params["theta"]
    grads_t = paired_ms(ten(lambda: _local_grads(log_problem, th)), 10)
    half = 0.5 * (cst["nbr_left"]["theta"] + cst["nbr_right"]["theta"])
    grads = _local_grads(log_problem, th)
    k3_path = paired_ms(ten(lambda: k2.coke_fused_update(
        th, cst["theta_hat"]["theta"], cst["gamma"]["theta"], grads, half,
        half, rho=log_problem.rho, deg=2.0)), 10)
    log_metrics = paired_ms(ten(lambda: _stacked_metrics(
        log_problem, th, cst["comms"], torch.sum(cst["comm"].bits))), 10)
    log(7, f"[{card}] one fused-logistic COKE iteration at N={N} T={T} "
           f"D={D}: {pair(log_iter)}. Parts, each alone: local gradients "
           f"(forward and backward, two Phi reads) {pair(grads_t)}; K3 "
           f"wrapper {pair(k3_path)}; train_mse metric {pair(log_metrics)}; "
           f"the rest (optimizer step, censor, dual, bookkeeping) "
           f"{log_iter_ms - grads_t[0] - k3_path[0] - log_metrics[0]:.4f} ms "
           f"on the device")

    _, spmd_ten = runner(spmd_cfg.replace(algorithm="coke"), problem)
    spmd_iter = paired_ms(spmd_ten, 10)
    log(7, f"[{card}] one spmd COKE iteration (quadratic) {pair(spmd_iter)}, "
           f"beside the megakernel's {pair(mega_iter)}")
    iteration_ms = {"megakernel": mega_iter, "fused-logistic": log_iter,
                    "spmd": spmd_iter}
    # the host's speed in this run: the ring runtime's iterations are
    # a few hundred such launches, so their time follows this figure
    tiny = torch.zeros(1, device=dev)
    probe = paired_ms(ten(lambda: [tiny.add_(1.0) for _ in range(100)]),
                      1000)
    log(7, f"[{card}] host dispatch probe: one add_ on a 1-element tensor "
           f"{pair(probe)}")

    theta2, hat2, gamma2, phi2, y2, kw2 = k2_inputs
    rsq2 = torch.empty((N_AGENTS,), device=dev)
    k2_ms = time_ms(lambda: k2.coke_megastep(theta2, hat2, gamma2, phi2, y2,
                                             resid_sq=rsq2, **kw2))
    k2_plain_ms = time_ms(lambda: coke_megastep_ref(
        theta2, hat2, gamma2, phi2, y2, return_resid_sq=True, **kw2))
    n2, t2, d2 = phi2.shape
    # Phi and y read; theta, theta_hat, gamma read, theta' written; xi_sq
    # and resid_sq written. Flops: the two matvecs, the combine, the
    # squared residuals
    k2_bytes = 4.0 * (n2 * t2 * d2 + n2 * t2 + 4 * n2 * d2 + 2 * n2)
    k2_flops = 4.0 * n2 * t2 * d2 + 12.0 * n2 * d2 + 2.0 * n2 * t2
    x1, omega1, bias1, _ = k1_inputs
    m1, d1 = x1.shape
    l1 = omega1.shape[1]
    # the card's own write stream over the same output: not K1's
    # library_ms (no call computes K1's function), a floor for its stores
    fill = torch.empty((m1, l1), device=dev)
    k1_ms = time_ms(lambda: k1.rff_cos_bias(x1, omega1, bias1))
    fill_ms = time_ms(lambda: fill.fill_(1.0))
    k1_plain_ms = time_ms(lambda: rff_ref(x1, omega1, bias1))
    del fill
    k1_bytes = 4.0 * (m1 * d1 + d1 * l1 + l1 + m1 * l1)
    k1_flops = 2.0 * m1 * l1 * d1 + 2.0 * m1 * l1
    ops3, kw3 = k3_inputs
    # K3's device work (~microseconds) is shorter than its wrapper's host
    # side: its time and its plain version's come from CUDA-graph replays
    k3_call_ms = time_ms(lambda: k2.coke_fused_update(*ops3, **kw3),
                         reps=100)
    k3_ms = graph_ms(lambda: k2.coke_fused_update(*ops3, **kw3))
    k3_plain_ms = graph_ms(lambda: coke_update_ref(*ops3, **kw3))
    n3, d3 = ops3[0].shape
    # six (N, D) reads, g_aug written, xi_sq (N,) written; 8 flops for
    # g_aug and 3 for the squared difference per element
    k3_bytes = 4.0 * (7 * n3 * d3 + n3)
    k3_flops = 11.0 * n3 * d3
    model = results["coke"].to_model(built.rff_params)
    predict_ms = time_ms(lambda: model.predict(built.x_test,
                                               backend="fused"))
    predict_ref_ms = time_ms(lambda: model.predict(built.x_test,
                                                   backend="ref"))

    def bound(nbytes, flops):
        t_b, t_f = nbytes / bw * 1e3, flops / fp32 * 1e3
        return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")

    launches = {"coke_megastep": mega_counts["coke_megastep"],
                "rff_cos_bias": mega_counts["rff_cos_bias"],
                "coke_fused_update": log_counts["coke_fused_update"]}
    kernels = []
    for kname, ms, plain, nbytes, flops in (
            ("coke_megastep", k2_ms, k2_plain_ms, k2_bytes, k2_flops),
            ("rff_cos_bias", k1_ms, k1_plain_ms, k1_bytes, k1_flops),
            ("coke_fused_update", k3_ms, k3_plain_ms, k3_bytes, k3_flops)):
        b_ms, b_by = bound(nbytes, flops)
        src, replaces = KERNEL_SOURCES[kname]
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": errs[kname], "ms": ms,
                        "plain_ms": plain, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None})
        log(7, f"[{card}] {kname}: {ms:.4f} ms, bound {b_ms:.4f} ms "
               f"({b_by}: {nbytes / 1e9:.4f} GB, {flops / 1e9:.3f} GFLOP; "
               f"{b_ms / ms:.1%} of it), plain {plain:.4f} ms; library_ms "
               f"null: {NO_LIBRARY[kname]}")
    k2_bound = bound(k2_bytes, k2_flops)[0]
    log(7, f"[{card}] K2 redesigned: {k2_ms:.4f} ms against its "
           f"{k2_bound:.4f} ms byte bound ({k2_bound / k2_ms:.1%}) and the "
           f"earlier design's {K2_EARLIER_MS} ms "
           f"({K2_EARLIER_MS / k2_ms:.2f}x faster)")
    k1_bound = bound(k1_bytes, k1_flops)[0]
    log(7, f"[{card}] K1 redesigned: {k1_ms:.4f} ms against its "
           f"{k1_bound:.4f} ms byte bound ({k1_bound / k1_ms:.1%}) and the "
           f"earlier design's {K1_EARLIER_MS} ms "
           f"({K1_EARLIER_MS / k1_ms:.2f}x faster); write-floor probe "
           f"out.fill_(1.0) on the same ({m1}, {l1}) fp32 output "
           f"{fill_ms:.4f} ms ({k1_bytes / fill_ms / 1e9:.2f} TB/s; K1 "
           f"{k1_bytes / k1_ms / 1e9:.2f} TB/s)")
    log(7, f"[{card}] K2 shape N={n2} T={t2} D={d2}; K1 shape M={m1} d={d1} "
           f"L={l1}; K3 shape N={n3} D={d3}")
    log(7, f"[{card}] K3 and its plain version timed as CUDA-graph replays "
           f"(device time); one K3 wrapper call from Python, CUDA events: "
           f"{k3_call_ms:.4f} ms")
    log(7, f"[{card}] predict on {tuple(built.x_test.shape)} held-out rows: "
           f"fused {predict_ms:.4f} ms, ref {predict_ref_ms:.4f} ms")

    # ---- 8. device traces of ten iterations -------------------------------
    from torch.profiler import (ProfilerActivity, profile,
                                supported_activities)

    def device_ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (e.self_cuda_time_total if us is None else us) / 1e3

    def trace(ten_iterations, activities):
        """(event window ms, rows of (device ms, count, kernel name)) of
        ten iterations under the profiler."""
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ten_iterations()
            end.record()
            end.synchronize()
        # device-side events only: the host ops that launched them
        # (aten::bmm, ...) carry the same device time again
        rows = sorted(((device_ms(e), e.count, e.key)
                       for e in prof.key_averages()
                       if getattr(e, "device_type", None)
                       == torch.autograd.DeviceType.CUDA
                       and device_ms(e) > 0), reverse=True)
        return start.elapsed_time(end), rows

    for label, path, ten_iterations in (
            ("megakernel COKE", "megakernel", mega_ten),
            ("fused-logistic COKE", "fused-logistic", log_ten)):
        # device activity alone first: recording host ops stretches the
        # window the busy share is read against
        options = [[ProfilerActivity.CPU, ProfilerActivity.CUDA]]
        if ProfilerActivity.CUDA in supported_activities():
            options.insert(0, [ProfilerActivity.CUDA])
        for activities in options:
            window, rows = trace(ten_iterations, activities)
            if rows:
                break
        if not rows:
            log(8, f"{label}: the profiler recorded no device time: the "
                   "device busy share is not measured")
            continue
        busy = sum(r[0] for r in rows)
        traced = "+".join(a.name for a in activities)
        unprofiled = 10 * iteration_ms[path][0]
        log(8, f"[{card}] ten {label} iterations under the profiler "
               f"({traced}): window {window:.4f} ms (unprofiled, phase 7: "
               f"{unprofiled:.4f} ms), kernels {busy:.4f} ms: device busy "
               f"{busy / window:.1%} of the traced window, idle "
               f"{1 - busy / window:.1%}; kernel time over the unprofiled "
               f"window {busy / unprofiled:.1%}")
        for ms, count, key in rows[:12]:
            log(8, f"  {ms / 10:.4f} ms/iter  {count / 10:>5.1f} calls/iter  "
                   f"{key[:100]}")
        for ms, count, key in rows:
            if "coke_fused_update_kernel" in key:
                log(8, f"[{card}] K3 kernel device time {ms / count:.4f} ms "
                       f"per launch ({count} launches)")

    # ---- 9. the LM serving engine, small: card against CPU ----------------
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.attention import _gqa_project_qkv
    from repro_torch.models.common import rms_norm
    from repro_torch.serve import Engine, ServeConfig

    small_cfg = get_config(LM_ARCH).reduced()
    small_gpu = M.init_params(small_cfg,
                              torch.Generator(device=dev).manual_seed(0))
    small_cpu = M.LM(small_cfg, device="cpu")
    small_cpu.load_state_dict({n: t.cpu() for n, t in
                               small_gpu.state_dict().items()})
    rng = np.random.default_rng(0)
    small_prompts = rng.integers(0, small_cfg.vocab_size, (2, 64))
    scfg = ServeConfig(max_new_tokens=8, cache_len=72)
    before = k4.LAUNCHES
    toks_gpu = Engine(small_cfg, small_gpu, scfg).generate(small_prompts)
    torch.cuda.synchronize()
    if k4.LAUNCHES - before != small_cfg.num_layers:
        raise AssertionError("the small engine did not launch K4 once per "
                             "layer")
    toks_cpu = Engine(small_cfg, small_cpu, scfg).generate(small_prompts)
    batch = {"tokens": torch.as_tensor(small_prompts)}
    lg_gpu, _ = M.prefill_with_state(small_gpu, small_cfg,
                                     {"tokens": batch["tokens"].to(dev)}, 72)
    lg_cpu, _ = M.prefill_with_state(small_cpu, small_cfg, batch, 72)
    e = float((lg_gpu.cpu() - lg_cpu).abs().max())
    tol = LM_RTOL * float(lg_cpu.abs().max())
    top2 = torch.topk(lg_cpu[..., :small_cfg.vocab_size], 2, dim=-1).values
    log(9, f"reduced {LM_ARCH} (2 layers, d_model 256) engine, 2 x 64 "
           f"prompt tokens, 8 new: card tokens {toks_gpu.tolist()}; equal "
           f"to the CPU's: {bool((toks_gpu == toks_cpu).all())}; prefill "
           f"logits max|err| {e:.3e} (tol {tol:.3e}, rtol {LM_RTOL:g} of "
           f"max|logit|); first-token top-1/top-2 margin "
           f"{float((top2[..., 0] - top2[..., 1]).min()):.3e}")
    if not ((toks_gpu == toks_cpu).all() and e <= tol):
        raise AssertionError("the small engine differs between card and CPU")
    del small_gpu, small_cpu

    # ---- 10. the LM serving engine at full width ---------------------------
    lm_cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    lm = M.init_params(lm_cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in lm.parameters())
    log(10, f"{LM_ARCH}: {n_params / 1e9:.3f} B parameters drawn on the card "
            f"in fp32 ({n_params * 4 / 1e9:.2f} GB) in "
            f"{time.perf_counter() - t0:.1f} s")
    prompts = rng.integers(0, lm_cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    engine = Engine(lm_cfg, lm, ServeConfig(max_new_tokens=LM_NEW_TOKENS,
                                            cache_len=LM_CACHE))
    reset_counts()
    t0 = time.perf_counter()
    served = engine.generate(prompts)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    lm_counts = counts()
    log(10, f"generate: {LM_BATCH} x {LM_PROMPT} prompt tokens, "
            f"{LM_NEW_TOKENS} new each, in {serve_wall:.2f} s wall (first "
            f"call); launch counts over the serving path: {lm_counts}")
    if lm_counts != {"coke_megastep": 0, "rff_cos_bias": 0,
                     "coke_fused_update": 0,
                     "flash_attention": lm_cfg.num_layers}:
        raise AssertionError(f"the serving path launched {lm_counts}, not "
                             f"K4 once per layer of the prefill")
    if served.shape != (LM_BATCH, LM_NEW_TOKENS) or not (
            (served >= 0) & (served < lm_cfg.vocab_size)).all():
        raise AssertionError(f"generate gave {served.shape} tokens outside "
                             "the vocabulary")
    log(10, f"generated ids (first 8 of each row): "
            f"{served[:, :8].tolist()}")

    lm_batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    with torch.inference_mode():
        logits, lm_state = M.prefill_with_state(lm, lm_cfg, lm_batch,
                                                LM_CACHE)
        torch.cuda.synchronize()
        if logits.shape != (LM_BATCH, 1, lm_cfg.padded_vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError("prefill logits are not finite "
                                 f"{(LM_BATCH, 1, lm_cfg.padded_vocab)}")
        # layer 0's attention: K4 against its plain version on one query
        # head of each KV group, over the last 512 query rows, which see
        # the whole causal key range
        pos = torch.arange(LM_PROMPT, dtype=torch.int32, device=dev)
        h0 = rms_norm(torch.nn.functional.embedding(lm_batch["tokens"],
                                                    lm.embed),
                      lm.blocks[0].ln1, lm_cfg.norm_eps)
        q0, k0, v0 = _gqa_project_qkv(lm.blocks[0].attn, lm_cfg, h0, pos)
        got = gqa_flash(q0, k0, v0, causal=True)
        group = lm_cfg.num_heads // lm_cfg.num_kv_heads
        heads = torch.arange(0, lm_cfg.num_heads, group, device=dev)
        want = attention_ref(q0[:, :, heads].transpose(1, 2),
                             k0.transpose(1, 2), v0.transpose(1, 2),
                             causal=True).transpose(1, 2)
        rows = slice(LM_PROMPT - 512, LM_PROMPT)
        err_k4 = float((got[:, rows][:, :, heads] - want[:, rows]).abs()
                       .max())
        errs["flash_attention"] = err_k4
        log(10, f"layer 0 attention, K4 against its plain version on heads "
                f"{heads.tolist()} (one per KV group), last 512 query rows: "
                f"max|err| {err_k4:.3e} (tol {K4_TOL[torch.float32]:g})")
        if not err_k4 <= K4_TOL[torch.float32]:
            raise AssertionError("K4 disagrees with its plain version on "
                                 "layer 0 of the full-width prefill")
        del want

        # times: prefill split into K4 and the rest, decode per token
        prefill_t = paired_ms(lambda: M.prefill_with_state(
            lm, lm_cfg, lm_batch, LM_CACHE), 1, runs=3, warmup=1)
        k4_call = paired_ms(ten(lambda: gqa_flash(q0, k0, v0, causal=True)),
                            10, runs=3, warmup=1)
        k4_share = lm_cfg.num_layers * k4_call[0]
        log(10, f"[{card}] prefill of {LM_BATCH} x {LM_PROMPT} tokens: "
                f"{pair(prefill_t)}. K4: {lm_cfg.num_layers} launches x "
                f"{pair(k4_call)} = {k4_share:.4f} ms on the device "
                f"({k4_share / prefill_t[0]:.1%} of the prefill); the rest "
                f"(projections, norms, rope, MLPs, cache packing, head) "
                f"{prefill_t[0] - k4_share:.4f} ms")
        token = torch.as_tensor(served[:, :1], dtype=torch.long, device=dev)

        def decode_steps():
            for i in range(LM_NEW_TOKENS - 1):
                M.decode_step(lm, lm_cfg, token, lm_state, LM_PROMPT + i)

        decode_t = paired_ms(decode_steps, LM_NEW_TOKENS - 1, runs=3,
                             warmup=1)
        weight_ms = n_params * 4 / bw * 1e3
        log(10, f"[{card}] decode per token (batch {LM_BATCH}, cache "
                f"{LM_CACHE}): {pair(decode_t)}; reading the fp32 weights "
                f"once takes {weight_ms:.4f} ms at {bw / 1e12} TB/s")
        for what, fn in (("one prefill", lambda: M.prefill_with_state(
                lm, lm_cfg, lm_batch, LM_CACHE)),
                         (f"{LM_NEW_TOKENS - 1} decode steps", decode_steps)):
            window, rows_p = trace(fn, [ProfilerActivity.CUDA]) \
                if ProfilerActivity.CUDA in supported_activities() \
                else (0, [])
            if not rows_p:
                log(10, f"the profiler recorded no device time over {what}: "
                        "its busy share is not measured")
                continue
            busy = sum(r[0] for r in rows_p)
            log(10, f"[{card}] {what} under the profiler (CUDA): window "
                    f"{window:.4f} ms, kernels {busy:.4f} ms, device busy "
                    f"{busy / window:.1%}, idle {1 - busy / window:.1%}")
            for ms, count, key in rows_p[:8]:
                log(10, f"  {ms:.4f} ms  {count:>5} calls  {key[:100]}")

        # K4 at the main path's shape: its bound, plain version, library
        n_pairs = LM_PROMPT * (LM_PROMPT + 1) // 2
        dh = lm_cfg.resolved_head_dim
        k4_flops = 2.0 * LM_BATCH * lm_cfg.num_heads * 2 * dh * n_pairs
        k4_bytes = 4.0 * LM_BATCH * LM_PROMPT * dh * (
            2 * lm_cfg.num_heads + 2 * lm_cfg.num_kv_heads)
        k4_ms = time_ms(lambda: gqa_flash(q0, k0, v0, causal=True), reps=3,
                        runs=5, warmup=1)
        k4_plain_ms = time_ms(lambda: attention_ref(
            q0.transpose(1, 2), k0.transpose(1, 2), v0.transpose(1, 2),
            causal=True), reps=1, runs=3, warmup=1)
        k4_lib_ms, k4_lib_how = sdpa_ms(q0.transpose(1, 2), k0.transpose(1, 2),
                                        v0.transpose(1, 2), causal=True)
        del q0, k0, v0, h0, got, lm_state, logits
    del lm, engine
    torch.cuda.empty_cache()
    b_ms, b_by, b_how = k4_bound(k4_bytes, k4_flops, torch.float32, peaks)
    src, replaces = KERNEL_SOURCES["flash_attention"]
    kernels.append({"name": "flash_attention", "route": "cuda",
                    "source": src, "replaces": replaces,
                    "launches": lm_counts["flash_attention"],
                    "max_abs_err": errs["flash_attention"], "ms": k4_ms,
                    "plain_ms": k4_plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": k4_lib_ms})
    log(10, f"[{card}] flash_attention at the prefill's shape (B={LM_BATCH}, "
            f"S={LM_PROMPT}, H={lm_cfg.num_heads}, KV={lm_cfg.num_kv_heads}, "
            f"Dh=Dv={dh}, causal, fp32): {k4_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}, {b_how}: {k4_bytes / 1e9:.4f} GB, "
            f"{k4_flops / 1e12:.4f} TFLOP "
            f"over {n_pairs} admissible pairs per head; {b_ms / k4_ms:.1%} "
            f"of it), plain {k4_plain_ms:.4f} ms, "
            f"F.scaled_dot_product_attention {k4_lib_ms:.4f} ms "
            f"({k4_lib_how})")

    # ---- 11. K4 alone at the prefill_32k length ----------------------------
    side = {}
    qwen3 = (lm_cfg.num_heads, lm_cfg.num_kv_heads, dh, 0)
    for label, (H, KV, D, window), dtype, causal in (
            ("qwen3", qwen3, torch.float32, True),
            ("qwen3", qwen3, torch.float32, False),
            ("qwen3", qwen3, torch.bfloat16, True),
            ("mixtral", MIXTRAL_HEADS, torch.float32, True),
            ("mixtral", MIXTRAL_HEADS, torch.bfloat16, True)):
        S = PREFILL_32K
        q = torch.randn((1, S, H, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((1, S, KV, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((1, S, KV, D), generator=gen, device=dev).to(dtype)
        ms = time_ms(lambda: gqa_flash(q, k, v, causal=causal,
                                       window=window), reps=1, runs=3,
                     warmup=1)
        if causal and window:
            n_pairs = (window * (window + 1) // 2 + (S - window) * window)
        elif causal:
            n_pairs = S * (S + 1) // 2
        else:
            n_pairs = S * S
        flops = 2.0 * H * 2 * D * n_pairs
        nbytes = dtype.itemsize * S * D * (2 * H + 2 * KV)
        b_ms, b_by, b_how = k4_bound(nbytes, flops, dtype, peaks)
        mask = None
        if window:
            i = torch.arange(S, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] >
                                                 i[:, None] - window)
        lib_ms, lib_how = sdpa_ms(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  mask=mask)
        key = str(dtype).split(".")[-1]
        side[(label, key, causal)] = ms
        log(11, f"[{card}] K4 {label} S={S} H={H} KV={KV} Dh=Dv={D} "
                f"{'causal' if causal else 'non-causal'} window={window} "
                f"{key}: {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                f"{b_how}: {flops / 1e12:.4f} TFLOP over {n_pairs} pairs "
                f"per head, {nbytes / 1e9:.4f} GB; "
                f"{b_ms / ms:.1%} of it); F.scaled_dot_product_attention "
                f"{lib_ms:.4f} ms ({lib_how})")
        del q, k, v, mask
        torch.cuda.empty_cache()
    ratio = side[("qwen3", "float32", True)] / side[("qwen3", "float32",
                                                     False)]
    log(11, f"[{card}] K4 qwen3 S={PREFILL_32K} fp32: causal "
            f"{side[('qwen3', 'float32', True)]:.4f} ms beside non-causal "
            f"{side[('qwen3', 'float32', False)]:.4f} ms: {ratio:.3f}x "
            "(key tiles above the diagonal are skipped)")
    if not ratio <= 0.6:
        raise AssertionError(f"the causal K4 call takes {ratio:.3f}x the "
                             "non-causal one: the skipped tiles did not show")

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
