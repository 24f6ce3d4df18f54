#!/usr/bin/env python3
"""Split the cost of one gather between ranks that share one CUDA card
(`chip_smoke.py` phase 28's transport, `distributed.sharding.gather_ranks`)
into its parts. W ranks on cuda:0 over gloo (a FileStore under build/),
the (2, 4) mesh of phase 28 cut as it cuts it (W = 2: (2, 1), W = 4:
(2, 2)); every rank gathers over its mesh sub-group (the batch axis at
W = 2, the model axis at W = 4) a (1, 2, 20) fp32 tensor, the size of a
CG step's psum, with KERNELS tiny kernels launched before each gather as
a CG step launches about ten. Per variant, ms per gather (the median over
the ranks of the mean over CALLS gathers, in turns A B A B):

  host      the gather of a CPU tensor alone: gloo's transport;
  sync      the kernels and torch.cuda.synchronize(), no gather: what
            the ranks' waits on the shared card cost;
  card      the kernels, then gather_ranks on the card tensor as the
            layer does it (gloo stages it through the host itself);
  staged    the kernels, then the tensor copied to the host, gathered
            there and copied back.

Then phase 28's COKE simulator CG cell (N=20, D=4096, CG_ITERS
iterations) with the layer's transport as it is and with the staged one
in its place, ms per iteration. Each spawn is run with torch's default
CPU threads and again with one thread a rank.

    python3 scripts/rank_gather_probe.py

Exits 2 without a card. Prints the card's name and power limit first.
"""
from __future__ import annotations

import datetime
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
WORLDS = ((2, (2, 1)), (4, (2, 2)))
KERNELS = 10
CALLS = 300
CG_ITERS = 3
TIMEOUT = datetime.timedelta(seconds=120)


def _staged(t, group, size, dim, on_card=False):
    """gather_ranks with the copies to and from the host made here."""
    import torch.distributed as dist
    h = t.detach().cpu()
    out = [torch.empty_like(h) for _ in range(size)]
    dist.all_gather(out, h, group=group)
    return torch.cat(out, dim=dim).to(t.device)


def _per_gather(fn, x):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        for _ in range(KERNELS):
            x.add_(1.0)
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / CALLS


def _rank(rank, world, split, tmp, threads):
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.api import build_problem, fit
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh

    if threads:
        torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(tmp) / "store"), world),
        rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        mesh = make_host_mesh(*chip_smoke.SHARD_MESH, device=dev,
                              group=dist.group.WORLD, split=split)
        kind = "model" if split[1] > 1 else "batch"
        group, size = mesh.axis_group(kind)
        x = torch.zeros(1, 2, 20, device=dev)
        h = torch.zeros(1, 2, 20)
        real = sharding.gather_ranks
        variants = {
            "host": lambda: real(h, group, size, 0),
            "sync": torch.cuda.synchronize,
            "card": lambda: real(x, group, size, 0),
            "staged": lambda: _staged(x, group, size, 0)}
        res = {k: [] for k in variants}
        for name, fn in list(variants.items()) * 2:
            _per_gather(fn, x)                     # warm
            res[name].append(_per_gather(fn, x))
        cfg = chip_smoke.full_width_config()
        sp = sharding.shard_problem(build_problem(cfg, device=dev).problem,
                                    mesh)
        c = cfg.replace(algorithm="coke", primal="cg", num_iters=CG_ITERS,
                        backend="simulator")
        cg = {"card": [], "staged": []}
        for name in ("card", "staged", "card", "staged"):
            sharding.gather_ranks = real if name == "card" else _staged
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit(c, problem=sp, device=dev, mesh=mesh)
            torch.cuda.synchronize()
            cg[name].append((time.perf_counter() - t0) * 1e3 / CG_ITERS)
        sharding.gather_ranks = real
        torch.save({"gather": res, "cg": cg, "kind": kind,
                    "threads": torch.get_num_threads()},
                   Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"nvidia-smi: {smi}; torch {torch.__version__}", flush=True)
    import torch.multiprocessing as mp
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    build.build()
    (ROOT / "build").mkdir(exist_ok=True)
    for world, split in WORLDS:
        for threads in (0, 1):
            tmp = tempfile.mkdtemp(prefix="gather-probe-", dir=ROOT / "build")
            try:
                mp.start_processes(_rank, args=(world, split, tmp, threads),
                                   nprocs=world, join=True,
                                   start_method="spawn")
                ranks = [torch.load(Path(tmp) / f"rank{r}.pt")
                         for r in range(world)]
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            line = {k: statistics.median(min(r["gather"][k]) for r in ranks)
                    for k in ranks[0]["gather"]}
            cg = {k: statistics.median(min(r["cg"][k]) for r in ranks)
                  for k in ranks[0]["cg"]}
            print(f"W={world} split {split}, gathers over the "
                  f"{ranks[0]['kind']} axis, {ranks[0]['threads']} CPU "
                  f"threads a rank: ms per gather (with {KERNELS} kernels "
                  "before each) "
                  + ", ".join(f"{k} {v:.4f}" for k, v in line.items())
                  + "; COKE simulator CG ms per iteration "
                  + ", ".join(f"{k} {v:.2f}" for k, v in cg.items()),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
