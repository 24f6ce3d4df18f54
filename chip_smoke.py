#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure raises and the script exits non-zero:
  0. the device, and `nvidia-smi --query-gpu=name,power.limit`;
  1. build the three hand-written kernels from src/repro_torch/csrc with
     nvcc (one process per source, started together) into
     build/repro_torch/;
  2. each kernel against its plain PyTorch version on the card, on inputs
     from seeded torch.Generators, at the main paths' shapes and at ragged
     ones, each error printed beside its tolerance;
  3. small fits on the card against the same fits on the CPU (the plain
     versions): the megakernel path, the spmd backend and the fused
     fallback on a logistic problem; comms and bits equal, theta close;
  4. the megakernel path at full width: the paper's Sec. 5.1 synthetic
     setup with N=20 agents on a ring, 5000 samples per agent (3500 train,
     1500 test), D=4096 random features, backend="fused",
     primal="gradient", 50 iterations of COKE and of DKLA, then to_model()
     and predict / evaluate on the held-out rows. K2 must run on every
     iteration, K1 on predict, K3 never;
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
     with the card's name and power limit: a megakernel iteration split
     into K2, the train-MSE metric and the rest; a fused-logistic
     iteration split into the local gradients, K3, the metric and the
     rest; an spmd iteration; each of these also as the host's time to
     enqueue it, from the same window; each kernel beside its bound and
     its plain version; predict;
  8. torch.profiler windows over ten megakernel COKE iterations and ten
     fused-logistic COKE iterations, recording device activity only:
     device busy and idle share, device time by kernel.
Before each of phases 4-6 every launch counter is set to 0, and read
just after.
The line before the last is one JSON object describing the kernels; the
last is {"ok": true, "device": {...}}. Without a card, or outside a
checkout of the repo, it prints no result and exits 2.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
ITERS = 50
N_AGENTS = 20
SAMPLES = 5000            # per agent: 3500 train + 1500 test rows
FEATURES = 4096
# NVIDIA data-sheet peaks: (name fragment, memory bytes/s, fp32 flop/s
# outside the tensor cores); the first fragment found in the card's name
CARD_PEAKS = (("H100 PCIe", 2.0e12, 51.2e12), ("H100 NVL", 3.9e12, 60.0e12),
              ("H100", 3.35e12, 67.0e12), ("H200", 4.8e12, 67.0e12))
# K2: theta' and xi_sq are fp32 sums of T*D products taken in another order
# than cuBLAS's (per-thread column strips, a fixed block tree, chunk
# order): relative error ~sqrt(T)*2^-24 ~ 4e-6 at T=3500
K2_RTOL = 1e-5
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
KERNEL_SOURCES = {   # name -> (port source, TPU kernel it replaces)
    "coke_megastep": ("src/repro_torch/csrc/coke_megastep.cu",
                      "src/repro/kernels/coke_update/coke_update.py:243"),
    "rff_cos_bias": ("src/repro_torch/csrc/rff.cu",
                     "src/repro/kernels/rff/rff.py:51"),
    "coke_fused_update": ("src/repro_torch/csrc/coke_fused_update.cu",
                          "src/repro/kernels/coke_update/coke_update.py:81"),
}


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_peaks(name):
    for frag, bw, flops in CARD_PEAKS:
        if frag in name:
            return bw, flops
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
    from repro_torch.kernels.rff import rff as k1
    from repro_torch.kernels.rff.ref import rff_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    def reset_counts():
        k1.LAUNCHES = k2.LAUNCHES = k2.FUSED_UPDATE_LAUNCHES = 0

    def counts():
        return {"coke_megastep": k2.LAUNCHES, "rff_cos_bias": k1.LAUNCHES,
                "coke_fused_update": k2.FUSED_UPDATE_LAUNCHES}

    # ---- 0. device -------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    card = smi
    bw, fp32 = card_peaks(name)
    log(0, f"device {name} (count {torch.cuda.device_count()}), torch "
           f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(0, f"nvidia-smi: {smi}; peaks used for bounds: {bw / 1e12} TB/s, "
           f"{fp32 / 1e12} TFLOP/s fp32")

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    report = build.build()
    log(1, f"built {sorted(report)} in {time.perf_counter() - t0:.1f} s "
           f"into {build.BUILD_DIR.relative_to(ROOT)}")
    for src, r in sorted(report.items()):
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(1, f"  {src}: {line.strip()}")

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
        log(2, f"K1 rff_cos_bias M={M} d={d} L={L}: max|err| {err:.3e} "
               f"(tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"M={M} d={d} L={L}: {err} > {tol}")
        if main:
            errs["rff_cos_bias"] = err
        return x, omega, bias

    k1_inputs = rff_case(N_AGENTS * (SAMPLES - int(SAMPLES * 0.7)), 5,
                         FEATURES, main=True)
    for d in (13, 77, 96):
        for L in (100, 513):
            rff_case(1001, d, L)

    def mega_case(n, t, d, offsets, main=False):
        theta = torch.randn((n, d), generator=gen, device=dev)
        hat = torch.randn((n, d), generator=gen, device=dev)
        gamma = 0.1 * torch.randn((n, d), generator=gen, device=dev)
        # bounded features shaped like sqrt(2/D) cos(.), labels in [0, 1)
        phi = math.sqrt(2.0 / d) * torch.cos(
            2 * math.pi * torch.rand((n, t, d), generator=gen, device=dev))
        y = torch.rand((n, t), generator=gen, device=dev)
        kw = dict(rho=1e-2, lam=5e-5, lr=0.1, offsets=offsets)
        want, want_xi = coke_megastep_ref(theta, hat, gamma, phi, y, **kw)
        got, got_xi = k2.coke_megastep(theta.clone(), hat, gamma, phi, y,
                                       **kw)
        torch.cuda.synchronize()
        e_th = float((got - want).abs().max())
        e_xi = float((got_xi - want_xi).abs().max())
        tol_th = K2_RTOL * float(want.abs().max())
        tol_xi = K2_RTOL * float(want_xi.abs().max())
        log(2, f"K2 coke_megastep N={n} T={t} D={d} offsets={offsets}: "
               f"theta' max|err| {e_th:.3e} (tol {tol_th:.3e}), xi_sq "
               f"max|err| {e_xi:.3e} (tol {tol_xi:.3e})")
        if not (e_th <= tol_th and e_xi <= tol_xi):
            raise AssertionError(f"K2 disagrees with its plain version at "
                                 f"N={n} T={t} D={d} offsets={offsets}")
        if main:
            errs["coke_megastep"] = e_th
        return theta, hat, gamma, phi, y, kw

    k2_inputs = mega_case(N_AGENTS, int(SAMPLES * 0.7), FEATURES, (1,),
                          main=True)
    for n, t, d, offsets in ((4, 40, 32, (1,)), (2, 33, 513, (1,)),
                             (8, 64, 100, (1, 2)), (3, 17, 128, (1,)),
                             (5, 128, 256, (2,))):
        mega_case(n, t, d, offsets)

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

    reset_counts()
    results = {}
    for alg in ("coke", "dkla"):
        before2 = k2.LAUNCHES
        t0 = time.perf_counter()
        res = fit(cfg.replace(algorithm=alg), problem=problem, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rose = k2.LAUNCHES - before2
        if rose != k2.LAUNCHES_PER_CALL * ITERS:
            raise AssertionError(f"{alg}: K2 launched {rose} times in "
                                 f"{ITERS} iterations")
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
    coke_cfg = cfg.replace(algorithm="coke")
    mega_state, mega_ten = runner(coke_cfg, problem)
    mega_iter = paired_ms(mega_ten, 10)
    iter_ms = mega_iter[0]
    st = mega_state["carry"]
    metrics = paired_ms(ten(lambda: _stacked_metrics(
        problem, st.theta, st.comms, torch.sum(st.comm.bits))), 10)
    theta, hat, gamma = st.theta.clone(), st.theta_hat, st.gamma
    kw = dict(rho=problem.rho, lam=problem.lam, lr=coke_cfg.inner_lr,
              offsets=(1,))
    k2_path = paired_ms(ten(lambda: k2.coke_megastep(
        theta, hat, gamma, problem.feats, problem.labels, **kw)), 10)
    log(7, f"[{card}] one megakernel COKE iteration at N={N} T={T} D={D}: "
           f"{pair(mega_iter)}. Parts, each alone: K2 {pair(k2_path)}; "
           f"train_mse metric (Phi read again by einsum) {pair(metrics)}; "
           f"the rest (censor, dual, bookkeeping) "
           f"{iter_ms - k2_path[0] - metrics[0]:.4f} ms on the device")

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
    k2_ms = time_ms(lambda: k2.coke_megastep(theta2, hat2, gamma2, phi2, y2,
                                             **kw2))
    k2_plain_ms = time_ms(lambda: coke_megastep_ref(theta2, hat2, gamma2,
                                                    phi2, y2, **kw2))
    n2, t2, d2 = phi2.shape
    k2_bytes = 4.0 * (n2 * t2 * d2 + n2 * t2 + 4 * n2 * d2 + n2)
    k2_flops = 4.0 * n2 * t2 * d2 + 12.0 * n2 * d2
    x1, omega1, bias1 = k1_inputs
    k1_ms = time_ms(lambda: k1.rff_cos_bias(x1, omega1, bias1))
    k1_plain_ms = time_ms(lambda: rff_ref(x1, omega1, bias1))
    m1, d1 = x1.shape
    l1 = omega1.shape[1]
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

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
