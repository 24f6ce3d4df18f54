#!/usr/bin/env python3
"""What a gather costs between ranks that share one CUDA card, by
transport (`distributed.sharding.gather_ranks`): two ranks on cuda:0 over
gloo (a FileStore under build/), a (2, 1) mesh of them, each rank
gathering a card tensor of 1, 64 and 1280 MB through the backend (gloo
stages it through the host) and by CUDA IPC (`on_card=True`), four
times each, the bits checked; then how long the host takes to copy 1
GB off the card into host memory and into shared memory
(`share_memory_`), what phase 29 of chip_smoke.py would pay to keep phase
20(c)'s whole parameters for its ranks.

    python3 scripts/card_gather_probe.py

Exits 2 without a card. Prints the card's name and power limit first.
"""
from __future__ import annotations

import datetime
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SIZES_MB = (1, 64, 1280)
REPEATS = 4
TIMEOUT = datetime.timedelta(seconds=120)


def _rank(rank, world, store):
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        mesh = make_host_mesh(world, 1, device="cuda:0",
                              group=dist.group.WORLD)
        group, size = mesh.axis_group("batch")
        if rank == 0:
            print(f"card shared by the ranks: {mesh.card_shared}", flush=True)
        for mb in SIZES_MB:
            n = mb * 2**20 // 4
            t = torch.arange(n, device="cuda:0", dtype=torch.float32) \
                * (rank + 1)
            for on_card in (False, True):
                ms, ok = [], True
                for _ in range(REPEATS):
                    t.add_(0)
                    torch.cuda.synchronize()
                    dist.barrier()
                    t0 = time.perf_counter()
                    out = sharding.gather_ranks(t, group, size, 0,
                                                on_card=on_card)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    ok = ok and all(torch.equal(o, torch.arange(
                        n, device="cuda:0", dtype=torch.float32) * (k + 1))
                        for k, o in enumerate(out.split(n)))
                    del out
                if rank == 0:
                    how = "CUDA IPC" if on_card else "gloo"
                    print(f"{mb} MB by {how}: "
                          f"{', '.join(f'{x:.2f}' for x in ms)} ms "
                          f"({mb / 1024 / min(ms) * 1e3:.2f} GB/s at best); "
                          f"bits equal: {ok}", flush=True)
            del t
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("card_gather_probe: no CUDA card", file=sys.stderr)
        return 2
    import torch.multiprocessing as mp
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    x = torch.randn(2**30 // 4, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = x.cpu()
    d2h = time.perf_counter() - t0
    t0 = time.perf_counter()
    y.share_memory_()
    shm = time.perf_counter() - t0
    print(f"1 GB off the card into host memory {d2h:.3f} s, then into "
          f"shared memory {shm:.3f} s", flush=True)
    del x, y
    torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="card-gather-", dir=ROOT / "build")
    try:
        mp.start_processes(_rank, args=(2, str(Path(tmp) / "store")),
                           nprocs=2, join=True, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
