"""Wrappers of the CUDA kernels `csrc/coke_megastep.cu` (K2) and
`csrc/coke_fused_update.cu` (K3).

`coke_megastep` ports `repro/kernels/coke_update/coke_update.py::
coke_megastep`: one gradient-primal COKE/DKLA ADMM iteration for all
agents. On CPU tensors it runs the plain version (`ref.coke_megastep_ref`);
on CUDA tensors it makes two launches on PyTorch's current stream (the
streamed partial sums on one persistent block per SM, then the consensus
combine), or raises. Either way theta' is written in place onto `theta`, as
the reference donates its output onto theta, and it can also return the
per-agent sum of squared residuals of the incoming theta (`resid_sq=`),
the train-MSE numerator that would otherwise cost a second read of Phi.
`LAUNCHES` counts its kernel launches: two per call on the card.

The card kernel stages Phi through shared memory with 1-D bulk copies
where every stage's address and size are 16-byte multiples (D % 4 == 0 and
a 16-byte-aligned Phi), and with 4-byte cp.async otherwise: two instances
of one kernel (`megastep_staging` says which a call takes). The rows are
cut among the blocks by `megastep_segments`, a pure function the CPU tests
reach.

`coke_fused_update` ports `coke_update.py::coke_fused_update`: the
augmented gradient and the per-agent censor norm of the ring runtime's
gradient primal. On CPU tensors it runs `ref.coke_update_ref`; on CUDA
tensors it makes one launch, or raises. `FUSED_UPDATE_LAUNCHES` counts its
launches, apart from K2's.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build

#: kernel launches made by `coke_megastep` (reset it to 0 to count a run)
LAUNCHES = 0
#: launches per `coke_megastep` call on the card
LAUNCHES_PER_CALL = 2
#: kernel launches made by `coke_fused_update`: one per call on the card
FUSED_UPDATE_LAUNCHES = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PI = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "coke_megastep_plan": (_I, [_I, _I, _I, _I, _PI]),
    "coke_megastep_stream": (_I, [_P] * 7 + [_I] * 9 + [_P]),
    "coke_megastep_combine": (_I, [_P] * 10 + [_I, _I, _PI, _I]
                              + [_F] * 6 + [_P]),
    "coke_megastep_combine_tiles": (_I, [_I]),
}
_MAX_OFFSETS = 8
# shared-memory bytes ahead of launch A's ring (csrc RING_OFFSET)
_RING_OFFSET = 1024
_FUSED_UPDATE_SIGNATURES = {
    "coke_fused_update_tiles": (_I, [_I]),
    "coke_fused_update": (_I, [_P] * 8 + [_I, _I, _I, _F, _F, _F, _P]),
}


def megastep_scalars(*, rho: float, lam: float, lr: float, n_agents: int,
                     n_samples: int, n_offsets: int) -> dict[str, float]:
    """Python-float constants shared by the kernel and its plain version."""
    deg = 2.0 * n_offsets
    return {
        "rho": float(rho),
        "deg": deg,
        "lam2": 2.0 * float(lam) / float(n_agents),
        "rho2deg": 2.0 * float(rho) * deg,
        "lr": float(lr),
        "inv_t2": 2.0 / float(n_samples),
    }


@dataclasses.dataclass(frozen=True)
class Segments:
    """How launch A cuts the N*T rows among its blocks.

    The rows, in agent-major order, form stages of `rows_per_stage` rows of
    one agent (an agent's last stage may be short); agent i owns global
    stages i*spa .. (i+1)*spa - 1 with spa = ceil(T / rows_per_stage).
    Block g walks stages stage_begin[g] .. stage_begin[g+1] - 1. A
    segment is one (block, agent) pair; segments are numbered in block
    order, which is also agent order: block g's first is block_seg[g],
    agent i's are agent_seg[i] .. agent_seg[i+1] - 1."""

    rows_per_stage: int
    stages_per_agent: int
    stage_begin: tuple[int, ...]     # (grid + 1,)
    block_seg: tuple[int, ...]       # (grid,)
    agent_seg: tuple[int, ...]       # (N + 1,)

    @property
    def grid(self) -> int:
        return len(self.block_seg)

    @property
    def num_segments(self) -> int:
        return self.agent_seg[-1]

    def table(self) -> list[int]:
        """The int32 `plan` the kernels read: stage_begin | block_seg |
        agent_seg."""
        return [*self.stage_begin, *self.block_seg, *self.agent_seg]


def megastep_segments(n_agents: int, n_samples: int, rows_per_stage: int,
                      blocks: int) -> Segments:
    """Cut the n_agents * ceil(n_samples / rows_per_stage) stages into at
    most `blocks` contiguous ranges, balanced to within one stage (block g
    starts at stage g * total // grid). No block is empty: the grid is
    min(blocks, total)."""
    if min(n_agents, n_samples, rows_per_stage, blocks) < 1:
        raise ValueError("megastep_segments needs positive sizes, got "
                         f"N={n_agents} T={n_samples} "
                         f"rows={rows_per_stage} blocks={blocks}")
    spa = -(-n_samples // rows_per_stage)
    total = n_agents * spa
    grid = min(blocks, total)
    begin = tuple(g * total // grid for g in range(grid + 1))
    block_seg, agent_seg = [], [None] * (n_agents + 1)
    nseg = 0
    for g in range(grid):
        block_seg.append(nseg)
        for a in range(begin[g] // spa, (begin[g + 1] - 1) // spa + 1):
            if agent_seg[a] is None:
                agent_seg[a] = nseg
            nseg += 1
    agent_seg[n_agents] = nseg
    return Segments(rows_per_stage, spa, begin, tuple(block_seg),
                    tuple(agent_seg))


@dataclasses.dataclass(frozen=True)
class MegastepPlan:
    """Launch A's plan on one device, from `coke_megastep_plan`."""

    bulk: bool                # 1-D bulk copies (else 4-byte cp.async)
    columns: int              # float4 column groups per consumer thread
    rows_per_stage: int
    stages: int               # ring depth in shared memory
    smem_bytes: int           # dynamic shared memory per block
    blocks: int               # blocks the card holds at once
    max_rows: int             # the instance's most rows per stage
    segments: Segments

    @property
    def stage_bytes(self) -> int:
        """Shared-memory bytes of one stage (rows_per_stage padded rows)."""
        return (self.smem_bytes - _RING_OFFSET) // self.stages

    @property
    def bytes_in_flight(self) -> int:
        """Bytes a block has in flight while its consumers hold one stage:
        the other stages of the ring."""
        return (self.stages - 1) * self.stage_bytes


def _lib():
    return build.load("coke_megastep", _SIGNATURES)


def megastep_staging(phi: torch.Tensor) -> str:
    """Which instance of launch A a CUDA call on `phi` takes: "bulk" (1-D
    bulk copies; every stage's address and size a 16-byte multiple) or
    "cp.async" (4-byte copies, for D % 4 != 0 or an unaligned Phi)."""
    aligned = phi.shape[-1] % 4 == 0 and phi.data_ptr() % 16 == 0
    return "bulk" if aligned else "cp.async"


@functools.lru_cache(maxsize=32)
def _plan(n: int, t: int, d: int, bulk: bool,
          device_index: int) -> MegastepPlan:
    """Launch A's plan for this shape and instance on this device."""
    lib = _lib()
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device_index):
        code = lib.coke_megastep_plan(n, t, d, int(bulk), out)
    if code == 1:   # cudaErrorInvalidValue
        raise ValueError(
            f"coke_megastep: D={d} is too wide for the card kernel: two "
            "one-row stages of Phi must fit in one block's shared memory, "
            "and a consumer thread holds at most 80 columns")
    build.check(lib, code, f"coke_megastep_plan(N={n}, T={t}, D={d}, "
                           f"bulk={int(bulk)})")
    v, rps, stages, smem, blocks, rmax = tuple(out)
    return MegastepPlan(bulk, v, rps, stages, smem, blocks, rmax,
                        megastep_segments(n, t, rps, blocks))


@functools.lru_cache(maxsize=32)
def _plan_table(segments: Segments, device: torch.device) -> torch.Tensor:
    """The segmentation as the int32 device table the kernels read; made
    once per shape and device, so a call copies nothing to the card."""
    return torch.tensor(segments.table(), dtype=torch.int32, device=device)


def megastep_plan(phi: torch.Tensor) -> MegastepPlan:
    """The plan a CUDA `coke_megastep` call on `phi` launches with."""
    N, T, D = phi.shape
    dev = phi.device
    return _plan(N, T, D, megastep_staging(phi) == "bulk",
                 dev.index if dev.index is not None
                 else torch.cuda.current_device())


def _check_operands(theta, theta_hat, gamma, phi, y, offsets,
                    resid_sq) -> None:
    if phi.ndim != 3:
        raise ValueError(f"phi must be (N, T, D), got {tuple(phi.shape)}")
    N, T, D = phi.shape
    for name, t in (("theta", theta), ("theta_hat", theta_hat),
                    ("gamma", gamma)):
        if tuple(t.shape) != (N, D):
            raise ValueError(f"{name} must be ({N}, {D}), got "
                             f"{tuple(t.shape)}")
    if tuple(y.shape) != (N, T):
        raise ValueError(f"y must be ({N}, {T}), got {tuple(y.shape)}")
    if resid_sq is not None and tuple(resid_sq.shape) != (N,):
        raise ValueError(f"resid_sq must be ({N},), got "
                         f"{tuple(resid_sq.shape)}")
    if T < 1:
        raise ValueError("coke_megastep needs at least one sample per agent")
    if not offsets or any(not 0 < o < N for o in offsets):
        raise ValueError(f"ring offsets {offsets} must lie in (0, {N})")
    ops = (theta, theta_hat, gamma, phi, y) + (
        () if resid_sq is None else (resid_sq,))
    devices = {t.device for t in ops}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {devices}")
    dev = phi.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"coke_megastep runs on cpu or cuda, not {dev}")


def coke_megastep(theta, theta_hat, gamma, phi, y, *, rho: float,
                  lam: float, lr: float, offsets: tuple[int, ...] = (1,),
                  resid_sq: torch.Tensor | None = None):
    """One fused COKE/DKLA gradient-primal iteration for all agents.

    theta/theta_hat/gamma (N, D); phi (N, T, D); y (N, T); `offsets` the
    ring offsets (neighbours at +-o for each o). Per agent i, with
    deg = 2 len(offsets):

        r      = phi theta - y
        g      = (2/T) phi^T r
        g_aug  = g + (2 lam / N) theta + 2 rho deg theta + gamma
                 - rho (deg theta_hat + sum_o theta_hat[i+-o])
        theta' = theta - lr * g_aug

    Writes theta' in place onto `theta` and returns (theta, xi_sq (N,))
    with xi_sq = ||theta' - theta_hat||^2. If `resid_sq` (an fp32 (N,)
    tensor) is given, it is filled with sum_t r_t^2 per agent, the squared
    residuals of the incoming theta.
    """
    offsets = tuple(int(o) for o in offsets)
    _check_operands(theta, theta_hat, gamma, phi, y, offsets, resid_sq)
    if phi.device.type == "cpu":
        from repro_torch.kernels.coke_update.ref import coke_megastep_ref

        new, xi_sq, rsq = coke_megastep_ref(
            theta, theta_hat, gamma, phi, y, rho=rho, lam=lam, lr=lr,
            offsets=offsets, return_resid_sq=True)
        theta.copy_(new)
        if resid_sq is not None:
            resid_sq.copy_(rsq)
        return theta, xi_sq
    ops = {"theta": theta, "theta_hat": theta_hat, "gamma": gamma,
           "phi": phi, "y": y}
    if resid_sq is not None:
        ops["resid_sq"] = resid_sq
    for name, t in ops.items():
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes fp32; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes contiguous tensors; "
                             f"{name} is not")
    if len(offsets) > _MAX_OFFSETS:
        raise ValueError(f"the CUDA kernel takes at most {_MAX_OFFSETS} "
                         f"ring offsets, got {len(offsets)}")
    N, T, D = phi.shape
    if N > 65535:
        raise ValueError(f"the CUDA kernel takes at most 65535 agents, "
                         f"got {N}")
    global LAUNCHES
    plan = megastep_plan(phi)
    seg = plan.segments
    dev = phi.device
    table = _plan_table(seg, dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    # one scratch allocation: partial (nseg, D) | rsq_part (nseg,) |
    # xi_part (N, tiles) | done (N,), launch B's int32 tile counters
    nseg, tiles = seg.num_segments, lib.coke_megastep_combine_tiles(D)
    work = torch.empty((nseg * (D + 1) + N * (tiles + 1),), device=dev,
                       dtype=torch.float32)
    partial = work.data_ptr()
    rsq_part = partial + 4 * nseg * D
    xi_part = rsq_part + 4 * nseg
    done = xi_part + 4 * N * tiles
    xi_sq = torch.empty((N,), device=dev, dtype=torch.float32)
    code = lib.coke_megastep_stream(
        theta.data_ptr(), phi.data_ptr(), y.data_ptr(), table.data_ptr(),
        partial, rsq_part, done, seg.grid, N, T, D, int(plan.bulk),
        plan.columns, plan.rows_per_stage, plan.stages, plan.smem_bytes,
        stream)
    build.check(lib, code, f"coke_megastep_stream(N={N}, T={T}, D={D})")
    LAUNCHES += 1

    sc = megastep_scalars(rho=rho, lam=lam, lr=lr, n_agents=N, n_samples=T,
                          n_offsets=len(offsets))
    agent_seg = table.data_ptr() + 4 * (2 * seg.grid + 1)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    code = lib.coke_megastep_combine(
        theta.data_ptr(), theta_hat.data_ptr(), gamma.data_ptr(), partial,
        rsq_part, agent_seg, xi_part, done, xi_sq.data_ptr(),
        None if resid_sq is None else resid_sq.data_ptr(),
        N, D, offs, len(offsets), sc["rho"], sc["deg"], sc["lam2"],
        sc["rho2deg"], sc["lr"], sc["inv_t2"], stream)
    build.check(lib, code, "coke_megastep_combine")
    LAUNCHES += 1
    return theta, xi_sq


def _check_update_operands(ops: dict[str, torch.Tensor]) -> None:
    shapes = {tuple(t.shape) for t in ops.values()}
    if len(shapes) != 1 or len(next(iter(shapes))) != 2:
        raise ValueError("coke_fused_update takes six (N, D) operands; got "
                         + ", ".join(f"{k} {tuple(t.shape)}"
                                     for k, t in ops.items()))
    devices = {t.device for t in ops.values()}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {devices}")
    dev = next(iter(devices))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"coke_fused_update runs on cpu or cuda, not {dev}")


def coke_fused_update(theta, theta_hat, gamma, grad, left, right, *,
                      rho: float, deg: float = 2.0):
    """All operands (N, D). Returns (g_aug (N, D) fp32, xi_sq (N,) fp32):

        g_aug = g + 2 rho deg theta + gamma - rho (deg theta_hat + left + right)
        xi_sq = ||theta_hat - theta||^2 per agent

    xi_sq is the *squared* censor norm; `ops.coke_update_pytree` takes the
    sqrt. The CUDA kernel takes fp32 operands; the plain version casts."""
    global FUSED_UPDATE_LAUNCHES
    ops = {"theta": theta, "theta_hat": theta_hat, "gamma": gamma,
           "grad": grad, "left": left, "right": right}
    _check_update_operands(ops)
    if theta.device.type == "cpu":
        from repro_torch.kernels.coke_update.ref import coke_update_ref

        return coke_update_ref(theta, theta_hat, gamma, grad, left, right,
                               rho=rho, deg=deg)
    for name, t in ops.items():
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes fp32; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes contiguous tensors; "
                             f"{name} is not")
    N, D = theta.shape
    dev = theta.device
    g_aug = torch.empty((N, D), device=dev, dtype=torch.float32)
    if N == 0 or D == 0:
        return g_aug, torch.zeros((N,), device=dev, dtype=torch.float32)
    lib = build.load("coke_fused_update", _FUSED_UPDATE_SIGNATURES)
    partial = torch.empty((N, lib.coke_fused_update_tiles(D)), device=dev,
                          dtype=torch.float32)
    ptrs = [t.data_ptr() for t in (*ops.values(), g_aug)]
    vec = int(D % 4 == 0 and all(p % 16 == 0 for p in ptrs))
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.coke_fused_update(*ptrs, partial.data_ptr(), N, D, vec,
                                 float(rho), float(deg),
                                 2.0 * float(rho) * float(deg), stream)
    build.check(lib, code, "coke_fused_update")
    FUSED_UPDATE_LAUNCHES += 1
    return g_aug, torch.sum(partial, dim=1)
