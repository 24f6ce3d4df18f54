#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure raises and the script exits non-zero:
  0. the device, and `nvidia-smi --query-gpu=name,power.limit`;
  1. build both hand-written kernels from src/repro_torch/csrc with nvcc
     (one process per source, started together) into build/repro_torch/;
  2. each kernel against its plain PyTorch version on the card, on inputs
     from seeded torch.Generators, at the main path's shapes and at ragged
     ones, each error printed beside its tolerance;
  3. a small fit on the card against the same fit on the CPU (the plain
     versions): comms and bits equal, trajectories and theta close;
  4. the main path at full width: the paper's Sec. 5.1 synthetic setup with
     N=20 agents on a ring, 5000 samples per agent (3500 train, 1500
     test), D=4096 random features, backend="fused", primal="gradient",
     50 iterations of COKE and of DKLA, then to_model() and predict /
     evaluate on the held-out rows. The launch counters are set to 0
     just before and read just after: K2 must have run on every
     iteration and K1 on predict;
  5. times from CUDA events (median of several runs after warm-up), each
     with the card's name and power limit: one iteration split into K2,
     the train-MSE metric and the rest; each kernel beside its bound and
     its plain version; predict;
  6. a torch.profiler window over ten COKE iterations: device busy and
     idle share, device time by kernel.
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
# the reason no single PyTorch call is a yardstick
NO_LIBRARY = {
    "coke_megastep": "no single PyTorch call computes a whole gradient-"
                     "primal ADMM iteration (two matvecs over Phi, the ring "
                     "combine and the censor norm)",
    "rff_cos_bias": "no single PyTorch call fuses x @ omega with the cosine; "
                    "torch.addmm + torch.cos is two calls and writes the "
                    "projection to device memory",
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


def k1_tolerance(x, omega):
    """1e-6 absolute on phi, or 16 ulps of the largest |x @ omega| times
    sqrt(2/L) where that is larger: the kernel's fmaf chain and cuBLAS
    round the d-term projection differently, and cos passes that on."""
    proj = float((x.abs() @ omega.abs()).max())
    return max(1e-6, math.sqrt(2.0 / omega.shape[1]) * 16 * 2**-23 * proj)


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
                                 build_problem, fit, get_solver)
    from repro_torch.api.backends import consensus_runner
    from repro_torch.api.config import SolveContext
    from repro_torch.api.solvers import _stacked_metrics
    from repro_torch.kernels import build
    from repro_torch.kernels.coke_update import coke_update as k2
    from repro_torch.kernels.coke_update.ref import coke_megastep_ref
    from repro_torch.kernels.rff import rff as k1
    from repro_torch.kernels.rff.ref import rff_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

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
    errs = {"rff_cos_bias": 0.0, "coke_megastep": 0.0}

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

    # ---- 3. a small fit, card against CPU ---------------------------------
    small = FitConfig(krr=KRRConfig(num_agents=4, samples_per_agent=40,
                                    num_features=32, lam=1e-2, rho=0.1),
                      graph="ring", censor_v=0.3, censor_mu=0.97,
                      num_iters=40, primal="gradient", inner_lr=0.05,
                      backend="fused")
    small_built = build_problem(small, device="cpu")
    for alg in ("coke", "dkla"):
        cfg = small.replace(algorithm=alg)
        cpu = fit(cfg, problem=small_built.problem, device="cpu")
        gpu = fit(cfg, problem=small_built.problem, device=dev)
        for k in ("comms", "bits"):
            if not torch.equal(gpu.history[k].cpu(), cpu.history[k]):
                raise AssertionError(f"small {alg} fit: {k} differs "
                                     "between card and CPU")
        e = float((gpu.theta.cpu() - cpu.theta).abs().max())
        e_mse = float((gpu.train_mse.cpu() - cpu.train_mse).abs().max())
        log(3, f"small {alg} fit N=4 T=28 D=32, card vs CPU: comms/bits "
               f"equal ({int(cpu.comms[-1])} transmissions), theta max|err| "
               f"{e:.3e}, train_mse max|err| {e_mse:.3e} (tol 1e-5)")
        if not (e <= 1e-5 and e_mse <= 1e-5):
            raise AssertionError(f"small {alg} fit differs on the card")

    # ---- 4. the main path at full width -----------------------------------
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

    k1.LAUNCHES = 0
    k2.LAUNCHES = 0
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
        for k, v in h.items():
            if v.shape != (ITERS,) or not torch.isfinite(
                    v.to(torch.float64)).all():
                raise AssertionError(f"{alg}: history {k} is not {ITERS} "
                                     "finite values")
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
    launches = {"coke_megastep": k2.LAUNCHES, "rff_cos_bias": k1.LAUNCHES}
    log(4, f"launch counts over the main path: {launches}")

    # ---- 5. times ---------------------------------------------------------
    solver = get_solver("coke")
    coke_cfg = cfg.replace(algorithm="coke")
    carry0, chunk_fn, _ = consensus_runner(
        coke_cfg, solver, problem, SolveContext.from_config(coke_cfg), None)
    state = {"carry": chunk_fn(carry0, 2)[0]}

    def ten_iterations():
        state["carry"] = chunk_fn(state["carry"], 10)[0]

    iter_ms = time_ms(ten_iterations, reps=1) / 10
    st = state["carry"]
    metrics_ms = time_ms(lambda: _stacked_metrics(
        problem, st.theta, st.comms, torch.sum(st.comm.bits)))
    theta, hat, gamma = st.theta.clone(), st.theta_hat, st.gamma
    kw = dict(rho=problem.rho, lam=problem.lam, lr=coke_cfg.inner_lr,
              offsets=(1,))
    k2_path_ms = time_ms(lambda: k2.coke_megastep(
        theta, hat, gamma, problem.feats, problem.labels, **kw))
    log(5, f"[{card}] one COKE iteration at N={N} T={T} D={D}: "
           f"{iter_ms:.4f} ms = K2 {k2_path_ms:.4f} ms + train_mse metric "
           f"(Phi read again by einsum) {metrics_ms:.4f} ms + the rest "
           f"(censor, dual, bookkeeping) "
           f"{iter_ms - k2_path_ms - metrics_ms:.4f} ms")

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
    model = results["coke"].to_model(built.rff_params)
    predict_ms = time_ms(lambda: model.predict(built.x_test,
                                               backend="fused"))
    predict_ref_ms = time_ms(lambda: model.predict(built.x_test,
                                                   backend="ref"))

    def bound(nbytes, flops):
        t_b, t_f = nbytes / bw * 1e3, flops / fp32 * 1e3
        return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")

    kernels = []
    for kname, src, replaces, ms, plain, nbytes, flops in (
            ("coke_megastep", "src/repro_torch/csrc/coke_megastep.cu",
             "src/repro/kernels/coke_update/coke_update.py:243", k2_ms,
             k2_plain_ms, k2_bytes, k2_flops),
            ("rff_cos_bias", "src/repro_torch/csrc/rff.cu",
             "src/repro/kernels/rff/rff.py:51", k1_ms, k1_plain_ms,
             k1_bytes, k1_flops)):
        b_ms, b_by = bound(nbytes, flops)
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": errs[kname], "ms": ms,
                        "plain_ms": plain, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None})
        log(5, f"[{card}] {kname}: {ms:.4f} ms, bound {b_ms:.4f} ms "
               f"({b_by}: {nbytes / 1e9:.4f} GB, {flops / 1e9:.3f} GFLOP; "
               f"{b_ms / ms:.1%} of it), plain {plain:.4f} ms; library_ms "
               f"null: {NO_LIBRARY[kname]}")
    log(5, f"[{card}] K2 shape N={n2} T={t2} D={d2}; K1 shape M={m1} d={d1} "
           f"L={l1}")
    log(5, f"[{card}] predict on {tuple(built.x_test.shape)} held-out rows: "
           f"fused {predict_ms:.4f} ms, ref {predict_ref_ms:.4f} ms")

    # ---- 6. device trace of ten COKE iterations ---------------------------
    from torch.profiler import ProfilerActivity, profile

    def device_ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (e.self_cuda_time_total if us is None else us) / 1e3

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ten_iterations()
        end.record()
        end.synchronize()
    window = start.elapsed_time(end)
    # device-side events only: the host ops that launched them (aten::bmm,
    # ...) carry the same device time again
    rows = sorted(((device_ms(e), e.count, e.key)
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None)
                   == torch.autograd.DeviceType.CUDA and device_ms(e) > 0),
                  reverse=True)
    if not rows:
        log(6, "the profiler recorded no device time: the device busy share "
               "is not measured")
    else:
        busy = sum(r[0] for r in rows)
        log(6, f"[{card}] ten COKE iterations under the profiler: window "
               f"{window:.4f} ms, device busy {busy:.4f} ms "
               f"({busy / window:.1%}), idle {1 - busy / window:.1%}")
        for ms, count, key in rows[:10]:
            log(6, f"  {ms / 10:.4f} ms/iter  {count // 10:>3} calls/iter  "
                   f"{key[:100]}")

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
