"""The port's kernel modules against the JAX reference.

On the CPU the port's wrappers run their plain PyTorch versions (the
tensors lie on the CPU); those are held against the reference's Pallas
kernels in interpret mode and against its plain versions, on the same
numpy-made inputs. The hand-written CUDA kernels themselves run only on a
card: tests/test_torch_cuda.py compares them with these plain versions
there.

Tolerances are fp32 with a different summation order: the reference
contracts in XLA's order (blockwise for the megakernel), the port in
ATen's einsum order.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from repro.core import rff as jax_rff
from repro.kernels.coke_update import coke_update as jax_cu
from repro.kernels.coke_update import ops as jax_cu_ops
from repro.kernels.coke_update import ref as jax_cu_ref
from repro.kernels.coke_update.ref import coke_megastep_ref as jax_mega_ref
from repro.kernels.rff.ops import featurize_fused as jax_featurize_fused
from repro.kernels.rff.rff import rff_pallas

from repro_torch.core.rff import RFFParams
from repro_torch.kernels import build
from repro_torch.kernels.coke_update import coke_update as port_cu
from repro_torch.kernels.coke_update import ops as port_cu_ops
from repro_torch.kernels.coke_update.ref import (coke_megastep_ref,
                                                 coke_update_ref,
                                                 xi_sq_in_kernel_order)
from repro_torch.kernels.rff import rff as port_rff
from repro_torch.kernels.rff.ops import featurize_fused
from repro_torch.kernels.rff.ref import rff_ref

torch.set_num_threads(2)

# the reference's own fp32 kernel-vs-plain tolerance (tests/test_kernels.py):
# the projection x @ omega of unit normals reaches |.| ~ 40 at d = 96, and a
# few ulps of it (4e-6 each) move phi = sqrt(2/L) cos(.) by ~1e-6
RFF_ATOL = 1e-5
# theta' and xi_sq come from fp32 sums of up to T*D ~ 2e4 products of unit
# normals in a different order: relative error ~1e-6, so 1e-5 relative
MEGA_RTOL = 1e-5

RFF_SHAPES = [(64, 5, 32), (300, 77, 100), (128, 96, 200), (33, 13, 50)]
# the reference battery's shapes (tests/test_fused_megakernel.py)
MEGA_SHAPES = [
    (4, 40, 32, (1,), None),
    (2, 33, 513, (1,), 8),
    (8, 64, 100, (1, 2), None),
    (3, 17, 128, (1,), 8),
    (5, 128, 256, (2,), 32),
]
MEGA_IDS = ["fit", "ragged", "circulant", "lane", "offset2"]
MEGA_KW = dict(rho=0.3, lam=1e-2, lr=0.05)
# K3: g_aug is six elementwise terms in the reference's expression order; XLA
# may contract a product into an FMA where ATen rounds it, a few ulps of the
# largest term. xi_sq is an fp32 sum over D in another order.
UPDATE_ULPS = 4 * 2.0**-23
UPDATE_XI_RTOL = 1e-5
# (N, D, deg): ragged D against the reference's 512-wide blocks, deg 2 and 4
UPDATE_SHAPES = [(1, 1, 2.0), (3, 513, 2.0), (7, 1000, 4.0), (4, 512, 4.0),
                 (20, 4096, 2.0)]


def _rff_inputs(T, d, L, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    omega = rng.standard_normal((d, L)).astype(np.float32)
    bias = rng.uniform(0.0, 2 * np.pi, L).astype(np.float32)
    return x, omega, bias


def _mega_inputs(n, t, d, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(n, d), f(n, d), (0.1 * f(n, d)).astype(np.float32), \
        f(n, t, d), f(n, t)


def _reference_megakernel(theta, hat, gamma, phi, y, *, rho, lam, lr,
                          offsets, block_t):
    """The reference Pallas body `_megastep_kernel`, in interpret mode.

    The reference wrapper `coke_megastep` cannot build its launch on jax
    0.9.0: it passes float flops to `pl.CostEstimate`, which now takes only
    ints. This replays that wrapper's padding and grid around the same
    kernel body, without the cost estimate."""
    N, T, D = phi.shape
    n_nbr = 2 * len(offsets)
    lp = jax_cu.megastep_launch_params(N, T, D, n_nbr, block_t)
    bt, Tp, Dp = lp.block_t, lp.padded_t, lp.padded_d
    sc = jax_cu.megastep_scalars(rho=rho, lam=lam, lr=lr, n_agents=N,
                                 n_samples=T, n_offsets=len(offsets))
    pad_row = lambda a: jnp.pad(a, ((0, 0), (0, Dp - D)))
    theta, hat, gamma = map(pad_row, (theta, hat, gamma))
    phi = jnp.pad(phi, ((0, 0), (0, Tp - T), (0, Dp - D)))
    y = jnp.pad(y, ((0, 0), (0, Tp - T)))
    row_spec = pl.BlockSpec((1, Dp), lambda i, t: (i, 0))
    nbr_specs = []
    for o in offsets:
        nbr_specs.append(
            pl.BlockSpec((1, Dp), lambda i, t, o=o: ((i + o) % N, 0)))
        nbr_specs.append(
            pl.BlockSpec((1, Dp), lambda i, t, o=o: ((i - o) % N, 0)))
    theta_new, xisq = pl.pallas_call(
        functools.partial(jax_cu._megastep_kernel, n_nbr=n_nbr,
                          nt=Tp // bt, **sc),
        grid=(N, Tp // bt),
        in_specs=[row_spec, row_spec, row_spec, *nbr_specs,
                  pl.BlockSpec((1, bt, Dp), lambda i, t: (i, t, 0)),
                  pl.BlockSpec((1, bt), lambda i, t: (i, t))],
        out_specs=[pl.BlockSpec((1, Dp), lambda i, t: (i, 0)),
                   pl.BlockSpec((1, 1), lambda i, t: (i, 0))],
        out_shape=[jax.ShapeDtypeStruct((N, Dp), jnp.float32),
                   jax.ShapeDtypeStruct((N, 1), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((1, Dp), jnp.float32)],
        interpret=True,
    )(theta, hat, gamma, *([hat] * n_nbr), phi, y)
    return np.asarray(theta_new[:, :D]), np.asarray(xisq[:, 0])


# ---------------------------------------------------------------------------
# K1: the fused RFF featurizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,d,L", RFF_SHAPES, ids=str)
def test_rff_plain_matches_reference_kernel(T, d, L):
    """Port K1 (plain, on CPU tensors) vs the reference Pallas kernel in
    interpret mode and vs the reference's plain featurizer."""
    x, omega, bias = _rff_inputs(T, d, L)
    port = port_rff.rff_cos_bias(torch.tensor(x), torch.tensor(omega),
                                 torch.tensor(bias)).numpy()
    kernel = np.asarray(rff_pallas(jnp.asarray(x), jnp.asarray(omega),
                                   jnp.asarray(bias), interpret=True))
    params = jax_rff.RFFParams(jnp.asarray(omega), jnp.asarray(bias))
    core = np.asarray(jax_rff.featurize(params, jnp.asarray(x)))
    assert port.shape == (T, L) and port.dtype == np.float32
    np.testing.assert_allclose(port, kernel, atol=RFF_ATOL, rtol=0)
    np.testing.assert_allclose(port, core, atol=RFF_ATOL, rtol=0)


def test_featurize_fused_batches_leading_dims():
    """`featurize_fused` flattens leading dims like the reference's ops.py."""
    x, omega, bias = _rff_inputs(200, 5, 64, seed=3)
    x = x.reshape(4, 50, 5)
    port = featurize_fused(RFFParams(torch.tensor(omega), torch.tensor(bias)),
                           torch.tensor(x)).numpy()
    ref = np.asarray(jax_featurize_fused(
        jax_rff.RFFParams(jnp.asarray(omega), jnp.asarray(bias)),
        jnp.asarray(x), interpret=True))
    assert port.shape == (4, 50, 64)
    np.testing.assert_allclose(port, ref, atol=RFF_ATOL, rtol=0)


# an H100's limits: 132 SMs, 232,448 bytes of shared memory per block
H100_SMS, H100_SMEM = 132, 232448
# (M, d, L, bulk, SMs): the predict shape (30 000 held-out rows, d = 5,
# L = 4096) and its d = 96 sibling (several strips); M = 1; a ragged last
# tile; L one past a strip (252 columns at d = 96, 4096 at d = 5); ragged L
# on the 4-byte instance; cards of a few SMs; more blocks than items
RFF_PLAN_CASES = [(30000, 5, 4096, True, 132), (30000, 96, 4096, True, 132),
                  (1, 5, 4096, True, 132), (1001, 5, 4096, True, 132),
                  (300, 96, 256, True, 132), (1000, 96, 253, False, 7),
                  (257, 5, 4100, True, 16), (1001, 13, 513, False, 132),
                  (33, 77, 50, False, 5), (64, 1, 4, True, 132),
                  (10, 5, 1, False, 132), (128, 96, 200, True, 3)]


@pytest.mark.parametrize("M,d,L,bulk,sms", RFF_PLAN_CASES, ids=str)
def test_rff_plan_covers_every_output_once(M, d, L, bulk, sms):
    """K1's launch plan: the blocks' (strip, tile) items, walked in block
    order, give every (row, column) of the output exactly once; the ranges
    are balanced to within one item; every strip's omega and bias slices
    fit the budget and the strip is the widest that does; the block's
    shared memory fits the card."""
    plan = port_rff.rff_plan(M, d, L, bulk=bulk, sm_count=sms,
                             smem_per_block=H100_SMEM)
    assert plan.instance == ("bulk" if bulk else "4-byte")
    assert plan.strip % 4 == 0 and plan.rows % 4 == 0 and plan.rows >= 4
    assert plan.rows <= -(-M // 4) * 4
    slice_bytes = 4 * (d + 1) * plan.strip
    assert slice_bytes <= port_rff.OMEGA_BUDGET_BYTES
    assert (plan.strip >= L or slice_bytes + 4 * (d + 1) * 4
            > port_rff.OMEGA_BUDGET_BYTES)
    assert plan.smem_bytes == port_rff.rff_smem_bytes(d, plan.strip,
                                                      plan.rows,
                                                      plan.buffers)
    assert plan.smem_bytes <= H100_SMEM
    assert plan.buffers == (port_rff.BUFFERS if bulk else 0)
    assert plan.blocks == min(plan.items, sms)
    items = port_rff.rff_work_items(plan)
    assert len(items) == plan.blocks
    sizes = [len(b) for b in items]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    walked = [it for b in items for it in b]
    assert walked == [(s, t) for s in range(plan.strips)
                      for t in range(plan.tiles)]
    # (row, column) counts, per row tile and per strip: the output is their
    # product, so this is every (row, column) once without an (M, L) array
    rows, cols = np.zeros(M, np.int32), np.zeros(L, np.int32)
    for t in range(plan.tiles):
        rows[t * plan.rows:(t + 1) * plan.rows] += 1
    for s in range(plan.strips):
        cols[s * plan.strip:(s + 1) * plan.strip] += 1
    assert (rows == 1).all() and (cols == 1).all()
    assert plan.rows * (plan.tiles - 1) < M <= plan.rows * plan.tiles
    assert plan.strip * (plan.strips - 1) < L <= plan.strip * plan.strips


def test_rff_plan_at_the_predict_shape():
    """At the predict shape on an H100 one strip spans the row: a tile is
    4 whole rows (64 KB, one bulk store), two such tiles and the 96 KB of
    omega and bias in 229,536 bytes, one block on each of the 132 SMs."""
    plan = port_rff.rff_plan(30000, 5, 4096, bulk=True, sm_count=H100_SMS,
                             smem_per_block=H100_SMEM)
    assert (plan.strip, plan.rows, plan.buffers, plan.smem_bytes,
            plan.blocks, plan.strips, plan.tiles) == (
        4096, 4, 2, 229536, 132, 1, 7500)
    wide = port_rff.rff_plan(30000, 96, 4096, bulk=True, sm_count=H100_SMS,
                             smem_per_block=H100_SMEM)
    assert (wide.strip, wide.strips) == (252, 17)


def test_rff_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="L % 4"):
        port_rff.rff_plan(10, 5, 513, bulk=True, sm_count=132,
                          smem_per_block=H100_SMEM)
    with pytest.raises(ValueError, match="too large"):
        port_rff.rff_plan(10, 7000, 4096, bulk=True, sm_count=132,
                          smem_per_block=H100_SMEM)
    with pytest.raises(ValueError):
        port_rff.rff_plan(0, 5, 16, bulk=True, sm_count=132,
                          smem_per_block=H100_SMEM)


@pytest.mark.parametrize("L,offset,want", [
    (4096, 0, "bulk"), (100, 0, "bulk"), (513, 0, "4-byte"), (50, 0,
                                                             "4-byte"),
    (4096, 1, "4-byte"), (4, 4, "bulk")], ids=str)
def test_rff_staging_picks_the_instance(L, offset, want):
    """Bulk stores need L % 4 == 0 and a 16-byte-aligned output; anything
    else takes the 4-byte instance."""
    buf = torch.empty(3 * L + 8)
    out = buf[offset:offset + 3 * L].view(3, L)
    assert port_rff.rff_staging(L, out) == want


@pytest.mark.parametrize("M,d,L,bulk,sms", RFF_PLAN_CASES[2:], ids=str)
def test_rff_kernel_walk_matches_plain(M, d, L, bulk, sms):
    """The card kernel's walk replayed in plain PyTorch: each block's
    items, each a (rows, strip) tile of the plain featurizer on the tile's
    x rows, omega and bias slices, assemble the plain output."""
    x, omega, bias = map(torch.tensor, _rff_inputs(M, d, L, seed=5))
    plan = port_rff.rff_plan(M, d, L, bulk=bulk, sm_count=sms,
                             smem_per_block=H100_SMEM)
    scale = math.sqrt(2.0 / L)
    out = torch.full((M, L), float("nan"))
    for block in port_rff.rff_work_items(plan):
        for s, t in block:
            rs = slice(t * plan.rows, (t + 1) * plan.rows)
            cs = slice(s * plan.strip, (s + 1) * plan.strip)
            out[rs, cs] = scale * torch.cos(x[rs] @ omega[:, cs] + bias[cs])
    torch.testing.assert_close(out, rff_ref(x, omega, bias), rtol=0,
                               atol=RFF_ATOL)


# ---------------------------------------------------------------------------
# K2: the full-iteration megakernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,t,d,offsets,bt", MEGA_SHAPES, ids=MEGA_IDS)
def test_megastep_plain_matches_reference(n, t, d, offsets, bt):
    """Port K2 (plain, on CPU tensors) vs the reference Pallas megakernel
    body in interpret mode and vs its blockwise `coke_megastep_ref`, on
    theta' and xi_sq."""
    ops = _mega_inputs(n, t, d)
    th, hat, gm, phi, y = (torch.tensor(a) for a in ops)
    out, xi = port_cu.coke_megastep(th, hat, gm, phi, y, offsets=offsets,
                                    **MEGA_KW)
    k_out, k_xi = _reference_megakernel(*map(jnp.asarray, ops),
                                        offsets=offsets, block_t=bt,
                                        **MEGA_KW)
    r_out, r_xi = jax_mega_ref(*map(jnp.asarray, ops), offsets=offsets,
                               block_t=bt, **MEGA_KW)
    np.testing.assert_array_equal(k_out, np.asarray(r_out))  # ref contract
    for want, got in ((k_out, out), (k_xi, xi)):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=MEGA_RTOL,
                                   atol=MEGA_RTOL * scale)


def test_megastep_writes_theta_in_place():
    """Like the reference's donated output, theta' lands in `theta`; the
    other operands stay untouched; the plain version is a pure function."""
    ops = [torch.tensor(a) for a in _mega_inputs(3, 20, 40, seed=5)]
    before = [a.clone() for a in ops]
    want, want_xi = coke_megastep_ref(*before, offsets=(1,), **MEGA_KW)
    th = ops[0]
    out, xi = port_cu.coke_megastep(*ops, offsets=(1,), **MEGA_KW)
    assert out is th
    torch.testing.assert_close(th, want, rtol=0, atol=0)
    torch.testing.assert_close(xi, want_xi, rtol=0, atol=0)
    for a, b in zip(ops[1:], before[1:]):
        assert torch.equal(a, b)


# (N, T, rows per stage, blocks): the paper-scale fit on 132 SMs; N > SMs
# at gossip size; T < one stage; ranges that cross agent boundaries; more
# blocks than stages; a card of a few SMs
SEGMENT_CASES = [(20, 3500, 3, 132), (200, 5, 4, 132), (6, 1, 8, 132),
                 (7, 1000, 4, 132), (4, 40, 8, 132), (3, 17, 3, 5),
                 (5, 128, 2, 7)]


@pytest.mark.parametrize("n,t,rows,blocks", SEGMENT_CASES, ids=str)
def test_megastep_segments_cover_every_row_once(n, t, rows, blocks):
    """Launch A's segmentation: the blocks' stages, walked in block order,
    give every (agent, row) once and in agent-major order; no stage
    crosses an agent; the ranges are balanced to within one stage; and
    the segment numbering is consistent between blocks and agents."""
    seg = port_cu.megastep_segments(n, t, rows, blocks)
    spa = seg.stages_per_agent
    assert seg.grid == min(blocks, n * spa)
    assert seg.stage_begin[0] == 0 and seg.stage_begin[-1] == n * spa
    sizes = [b - a for a, b in zip(seg.stage_begin, seg.stage_begin[1:])]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    walked, owner = [], {}
    for g in range(seg.grid):
        k, agent = seg.block_seg[g] - 1, None
        for gs in range(seg.stage_begin[g], seg.stage_begin[g + 1]):
            a, row0 = gs // spa, (gs % spa) * rows
            assert 0 < min(rows, t - row0) <= rows
            if a != agent:
                agent, k = a, k + 1
            assert owner.setdefault(k, a) == a
            walked += [(a, row0 + b) for b in range(min(rows, t - row0))]
    assert walked == [(i, r) for i in range(n) for r in range(t)]
    assert sorted(owner) == list(range(seg.num_segments))
    for i in range(n):
        mine = [k for k, a in owner.items() if a == i]
        assert mine == list(range(seg.agent_seg[i], seg.agent_seg[i + 1]))
    assert seg.table() == [*seg.stage_begin, *seg.block_seg, *seg.agent_seg]


def _megastep_in_kernel_order(theta, hat, gamma, phi, y, *, rows, blocks,
                              rho, lam, lr, offsets):
    """Launch A and launch B of the card kernel, in their order, in plain
    PyTorch: per-stage residuals and partial sums into one slot per
    (block, agent) segment, then the fixed-order combine per agent."""
    N, T, D = phi.shape
    seg = port_cu.megastep_segments(N, T, rows, blocks)
    spa = seg.stages_per_agent
    partial = torch.zeros((seg.num_segments, D))
    rsq = torch.zeros((seg.num_segments,))
    for g in range(seg.grid):
        k, agent = seg.block_seg[g] - 1, None
        for gs in range(seg.stage_begin[g], seg.stage_begin[g + 1]):
            a, row0 = gs // spa, (gs % spa) * rows
            if a != agent:
                agent, k = a, k + 1
            tile = phi[a, row0:row0 + rows]
            r = tile @ theta[a] - y[a, row0:row0 + rows]
            partial[k] += r @ tile
            rsq[k] += torch.sum(r * r)
    sc = port_cu.megastep_scalars(rho=rho, lam=lam, lr=lr, n_agents=N,
                                  n_samples=T, n_offsets=len(offsets))
    new, xi, resid = torch.empty_like(theta), torch.empty(N), torch.empty(N)
    for i in range(N):
        g, r_i = torch.zeros(D), torch.zeros(())
        for k in range(seg.agent_seg[i], seg.agent_seg[i + 1]):
            g, r_i = g + partial[k], r_i + rsq[k]
        acc = sc["deg"] * hat[i]
        for o in offsets:
            acc = acc + hat[(i + o) % N] + hat[(i - o) % N]
        gaug = (sc["inv_t2"] * g + sc["lam2"] * theta[i]
                + sc["rho2deg"] * theta[i] + gamma[i] - sc["rho"] * acc)
        new[i] = theta[i] - sc["lr"] * gaug
        # one partial per 256-column tile, summed in tile order
        sq = (new[i] - hat[i]) ** 2
        xi[i] = torch.zeros(())
        for c in range(0, D, 256):
            xi[i] = xi[i] + torch.sum(sq[c:c + 256])
        resid[i] = r_i
    return new, xi, resid


@pytest.mark.parametrize("n,t,d,offsets,rows,blocks", [
    (4, 40, 32, (1,), 8, 132), (2, 33, 513, (1,), 8, 3),
    (8, 64, 100, (1, 2), 4, 11), (7, 50, 64, (1,), 3, 13),
    (12, 3, 16, (1, 5), 4, 5), (3, 1, 40, (1,), 8, 132)], ids=str)
def test_megastep_kernel_order_matches_plain(n, t, d, offsets, rows, blocks):
    """The card kernel's summation structure (segment partials, then the
    fixed-order combine) against `coke_megastep_ref`, including ranges
    that cross agent boundaries and agents split over several blocks."""
    th, hat, gm, phi, y = map(torch.tensor, _mega_inputs(n, t, d, seed=7))
    want = coke_megastep_ref(th, hat, gm, phi, y, offsets=offsets,
                             return_resid_sq=True, **MEGA_KW)
    got = _megastep_in_kernel_order(th, hat, gm, phi, y, rows=rows,
                                    blocks=blocks, offsets=offsets,
                                    **MEGA_KW)
    for w, o in zip(want, got):
        scale = float(w.abs().max())
        torch.testing.assert_close(o, w, rtol=MEGA_RTOL,
                                   atol=MEGA_RTOL * scale)


def test_megastep_resid_sq_matches_numpy():
    """resid_sq = sum_t (phi_t . theta - y_t)^2 of the incoming theta, from
    the plain version and through the wrapper's `resid_sq=` output, against
    float64 numpy; a default call still returns (theta, xi_sq)."""
    ops = _mega_inputs(5, 30, 24, seed=2)
    th, hat, gm, phi, y = ops
    want = np.sum((np.einsum("ntd,nd->nt", phi.astype(np.float64), th)
                   - y) ** 2, axis=-1)
    t = [torch.tensor(a) for a in ops]
    _, _, plain = coke_megastep_ref(*t, offsets=(1,), return_resid_sq=True,
                                    **MEGA_KW)
    out = torch.full((5,), float("nan"))
    res = port_cu.coke_megastep(*[a.clone() for a in t], offsets=(1,),
                                resid_sq=out, **MEGA_KW)
    assert len(res) == 2
    assert len(coke_megastep_ref(*t, offsets=(1,), **MEGA_KW)) == 2
    for got in (plain, out):
        np.testing.assert_allclose(got.numpy(), want, rtol=MEGA_RTOL)
    with pytest.raises(ValueError, match="resid_sq"):
        port_cu.coke_megastep(*t, offsets=(1,), resid_sq=torch.empty(4),
                              **MEGA_KW)


def test_megastep_scalars_match_reference():
    kw = dict(rho=0.3, lam=1e-2, lr=0.05, n_agents=7, n_samples=33,
              n_offsets=2)
    assert port_cu.megastep_scalars(**kw) == jax_cu.megastep_scalars(**kw)


@pytest.mark.parametrize("case", ["shape", "device", "meta"])
def test_wrappers_reject_operands_they_do_not_take(case):
    """No silent fallback: bad shapes, mixed devices and devices other
    than cpu/cuda raise before anything runs."""
    x, omega, bias = map(torch.tensor, _rff_inputs(8, 5, 16))
    ops = [torch.tensor(a) for a in _mega_inputs(3, 10, 16)]
    if case == "shape":
        with pytest.raises(ValueError):
            port_rff.rff_cos_bias(x, omega[:4], bias)
        with pytest.raises(ValueError):
            port_cu.coke_megastep(ops[0][:2], *ops[1:], **MEGA_KW)
    elif case == "device":
        with pytest.raises(ValueError):
            port_rff.rff_cos_bias(x, omega.to("meta"), bias)
    else:
        with pytest.raises(ValueError, match="cpu or cuda"):
            port_cu.coke_megastep(*[a.to("meta") for a in ops], **MEGA_KW)


def test_build_names_libraries_by_source_hash():
    """Every kernel is built from csrc/ for sm_90a; the library name
    carries a hash of the source and flags, so an edit forces a rebuild."""
    assert build.SOURCES == ("coke_fused_update", "coke_megastep",
                             "flash_attention", "flash_attention_bwd",
                             "gather_rowdot", "rff", "threefry")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for name in build.SOURCES:
        p = build.library_path(name)
        assert p.parent == build.BUILD_DIR and p.name.startswith(name + "-")
        assert p == build.library_path(name)
    assert build.library_path("rff") != build.library_path("coke_megastep")


def test_chip_smoke_counts_every_kernel_it_reports():
    """chip_smoke.py keeps one table of launch counters, shared by every
    phase and by scripts/serve_phase.py: it names each kernel of the
    `kernels` line, each counter exists, and reset_counts zeroes them."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert set(smoke.LAUNCH_COUNTERS) == set(smoke.KERNEL_SOURCES)
    port_rff.LAUNCHES += 3
    try:
        assert smoke.counts()["rff_cos_bias"] >= 3
    finally:
        smoke.reset_counts()
    assert smoke.counts() == dict.fromkeys(smoke.KERNEL_SOURCES, 0)


def test_build_reports_the_log_of_a_cached_library(tmp_path, monkeypatch):
    """A library built earlier is not rebuilt, and its report carries the
    nvcc output kept beside it (the ptxas lines chip_smoke.py prints)."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    lib = build.library_path("coke_megastep")
    lib.write_bytes(b"")
    report = build.build(("coke_megastep",))["coke_megastep"]
    assert report["cached"] and report["log"] == ""
    lib.with_suffix(".log").write_text("ptxas info    : Used 96 registers")
    report = build.build(("coke_megastep",))["coke_megastep"]
    assert report["cached"] and "96 registers" in report["log"]


# ---------------------------------------------------------------------------
# K3: the ring runtime's fused consensus combine
# ---------------------------------------------------------------------------

def _update_inputs(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, d)).astype(np.float32) for _ in range(6)]


def _largest_term(ops, rho, deg):
    """max |term| of g + 2 rho deg theta + gamma - rho (deg hat + l + r)."""
    th, hat, gm, g, l, r = ops
    terms = (g, 2.0 * rho * deg * th, gm, rho * (deg * hat + l + r))
    return max(float(np.abs(t).max()) for t in terms)


def _assert_update_close(got, want, got_xi, want_xi, scale):
    np.testing.assert_allclose(got, want, rtol=0, atol=UPDATE_ULPS * scale)
    np.testing.assert_allclose(got_xi, want_xi, rtol=UPDATE_XI_RTOL,
                               atol=UPDATE_XI_RTOL * float(np.max(want_xi)))


@pytest.mark.parametrize("n,d,deg", UPDATE_SHAPES, ids=str)
def test_fused_update_plain_matches_reference_kernel(n, d, deg):
    """Port K3 (plain, on CPU tensors) vs the reference Pallas kernel in
    interpret mode (which pads D to its 512-wide block) and its plain
    `coke_update_ref`."""
    ops = _update_inputs(n, d)
    kw = dict(rho=0.37, deg=deg)
    got, got_xi = port_cu.coke_fused_update(*map(torch.tensor, ops), **kw)
    k, k_xi = jax_cu.coke_fused_update(*map(jnp.asarray, ops), interpret=True,
                                       **kw)
    r, r_xi = jax_cu_ref.coke_update_ref(*map(jnp.asarray, ops), **kw)
    assert got.shape == (n, d) and got_xi.shape == (n,)
    assert got.dtype == torch.float32
    scale = _largest_term(ops, **kw)
    for want, want_xi in ((k, k_xi), (r, r_xi)):
        _assert_update_close(got.numpy(), np.asarray(want), got_xi.numpy(),
                             np.asarray(want_xi), scale)


def test_fused_update_plain_casts_other_floats():
    """As the reference kernel does, any float operand is computed in fp32."""
    ops = _update_inputs(3, 40, seed=2)
    half = [torch.tensor(a).to(torch.float16) for a in ops]
    got, xi = port_cu.coke_fused_update(*half, rho=0.1, deg=2.0)
    want, want_xi = port_cu.coke_fused_update(*[h.float() for h in half],
                                              rho=0.1, deg=2.0)
    assert got.dtype == xi.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(xi, want_xi, rtol=0, atol=0)


def test_update_pytree_matches_reference():
    """The tree-level wrapper: two leaves flattened to one (N, D_total)
    message, g_aug unflattened, xi_norm = sqrt(xi_sq)."""
    rng = np.random.default_rng(4)
    trees = [{"a": rng.standard_normal((5, 3, 7)).astype(np.float32),
              "b": rng.standard_normal((5, 11)).astype(np.float32)}
             for _ in range(6)]
    kw = dict(rho=0.2, deg=4.0)
    port, xi = port_cu_ops.coke_update_pytree(
        *[{k: torch.tensor(v) for k, v in t.items()} for t in trees], **kw)
    ref, ref_xi = jax_cu_ops.coke_update_pytree(
        *[{k: jnp.asarray(v) for k, v in t.items()} for t in trees],
        interpret=True, **kw)
    assert set(port) == {"a", "b"}
    for k in ("a", "b"):
        assert tuple(port[k].shape) == ref[k].shape
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(xi.numpy(), np.asarray(ref_xi), rtol=1e-5)


def test_fused_update_rejects_operands_it_does_not_take():
    ops = [torch.tensor(a) for a in _update_inputs(3, 8)]
    with pytest.raises(ValueError, match="six"):
        port_cu.coke_fused_update(ops[0][:2], *ops[1:], rho=0.1)
    with pytest.raises(ValueError, match="six"):
        port_cu.coke_fused_update(*[a[0] for a in ops], rho=0.1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        port_cu.coke_fused_update(*[a.to("meta") for a in ops], rho=0.1)


# ---------------------------------------------------------------------------
# K3 on the card: the launch plan, the order of the xi_sq sum, the dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vec", [True, False], ids=["vec", "scalar"])
@pytest.mark.parametrize("sm_count", [132, 114, 78, 16])
def test_fused_update_plan_tiles_every_row(sm_count, vec):
    """One cluster of a portable size per agent row; its blocks' slices
    (multiples of 4) tile [0, D) exactly in rank order; N C covers the SMs
    where D leaves every block 512 features; C = 1 once N fills the card."""
    for N in (1, 3, 20, 66, 131, 132, 200):
        for D in (1, 3, 4, 511, 512, 1023, 1024, 2048, 4096, 4099, 8192,
                  65536, 65537):
            if vec and D % 4:
                continue
            plan = port_cu.fused_update_plan(N, D, sm_count, vec=vec)
            C = plan.clusters
            assert C in port_cu.FUSED_UPDATE_CLUSTERS
            assert plan.grid == (C, N)               # (C k, N) with k = 1
            assert plan.slice % 4 == 0
            cuts = plan.slices(D)
            assert len(cuts) == C and cuts[0][0] == 0 and cuts[-1][1] == D
            assert all(lo < hi for lo, hi in cuts)
            assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
            assert plan.threads in (128, 256) and plan.unroll in (1, 2, 4)
            items = -(-plan.slice // (4 if vec else 1))
            assert -(-items // plan.threads) <= plan.unroll or (
                plan.unroll == 4 and plan.threads == 256)
            if N >= sm_count or D < 1024:
                assert C == 1
            else:
                assert N * C >= sm_count or C == 8 or D < 2 * C * 512
                assert C == 1 or N * C // 2 < sm_count


def test_fused_update_plan_at_the_paths_shapes():
    """N=20, D=4096 on 132 SMs: clusters of 8 blocks of 512 features, one
    16-byte load per operand for each of 128 threads, 160 blocks; D=65536
    streams 8192 features a block through 256 threads, four loads each in
    flight per operand."""
    plan = port_cu.fused_update_plan(20, 4096, 132, vec=True)
    assert (plan.clusters, plan.threads, plan.unroll, plan.slice) == (
        8, 128, 1, 512)
    assert plan.grid[0] * plan.grid[1] == 160
    plan = port_cu.fused_update_plan(20, 65536, 132, vec=True)
    assert (plan.clusters, plan.threads, plan.unroll, plan.slice) == (
        8, 256, 4, 8192)
    assert port_cu.fused_update_plan(200, 65536, 132, vec=True).clusters == 1
    assert port_cu.fused_update_plan(20, 100, 132, vec=True).clusters == 1


def _xi_sq_by_hand(th, hat, plan, vec):
    """The kernel's xi_sq order written out one fp32 addition at a time, as
    scalar code: per block, per thread its items in order, a float4's
    squares left to right; the shuffle tree; warps; ranks."""
    f = np.float32
    N, D = th.shape
    out = np.zeros(N, np.float32)
    for i in range(N):
        total = f(0)
        for lo, hi in plan.slices(D):
            d = (hat[i, lo:hi] - th[i, lo:hi]).astype(np.float32)
            w = 4 if vec else 1
            items = [d[k:k + w] for k in range(0, hi - lo, w)]
            lanes = []
            for t in range(plan.threads):
                sq = f(0)
                for item in items[t::plan.threads]:
                    acc = f(item[0] * item[0])
                    for x in item[1:]:
                        acc = f(acc + f(x * x))
                    sq = f(sq + acc)
                lanes.append(sq)
            block = f(0)
            for wp in range(plan.threads // 32):
                v = lanes[32 * wp:32 * wp + 32]
                for off in (16, 8, 4, 2, 1):
                    v = [f(v[l] + v[l + off]) if l + off < 32 else v[l]
                         for l in range(32)]
                block = f(block + v[0])
            total = f(total + block)
        out[i] = total
    return out


@pytest.mark.parametrize("n,d,vec", [(2, 1024, True), (2, 1030, False),
                                     (1, 4096, True), (3, 513, False),
                                     (2, 5, False)], ids=str)
def test_xi_sq_emulation_is_the_kernels_order(n, d, vec):
    """`ref.xi_sq_in_kernel_order` (vectorised) against the same order
    written out as scalar fp32 code: the same bits."""
    th, hat = _update_inputs(n, d, seed=6)[:2]
    plan = port_cu.fused_update_plan(n, d, 132, vec=vec)
    got = xi_sq_in_kernel_order(torch.tensor(th), torch.tensor(hat), plan,
                                vec=vec)
    np.testing.assert_array_equal(got.numpy(),
                                  _xi_sq_by_hand(th, hat, plan, vec))


@pytest.mark.parametrize("n,d,vec", [(20, 4096, True), (20, 65536, True),
                                     (20, 4099, False), (3, 513, False),
                                     (7, 1000, True), (7, 1000, False),
                                     (1, 1, False), (200, 64, True)],
                         ids=str)
def test_xi_sq_emulation_matches_exact_sums(n, d, vec):
    """The kernel's order, emulated on the CPU in fp32, against a float64
    sum (rel 1e-6) and against the plain version (the K3 tolerance)."""
    ops = _update_inputs(n, d, seed=7)
    plan = port_cu.fused_update_plan(n, d, 132, vec=vec)
    got = xi_sq_in_kernel_order(torch.tensor(ops[0]), torch.tensor(ops[1]),
                                plan, vec=vec).numpy()
    exact = np.sum((ops[1].astype(np.float64) - ops[0]) ** 2, axis=1)
    np.testing.assert_allclose(got, exact, rtol=1e-6)
    _, plain = coke_update_ref(*map(torch.tensor, ops), rho=0.1)
    np.testing.assert_allclose(got, plain.numpy(), rtol=UPDATE_XI_RTOL,
                               atol=UPDATE_XI_RTOL * float(np.max(exact)))


def test_fused_update_reads_one_neighbour_operand_only_for_one_memory():
    """The one-read instance is taken for one memory under two names, not
    for an equal copy, overlapping views, another shape, another dtype or
    a non-contiguous view of the same start."""
    share = port_cu.shares_neighbour_operand
    t = torch.tensor(_update_inputs(4, 16)[0])
    assert share(t, t) and share(t, t.view(4, 16)) and share(t, t[:])
    assert share(t, t.reshape(4, 16))
    assert not share(t, t.clone())
    base = torch.zeros(5, 16)
    assert not share(base[:4], base[1:])
    assert not share(base[:4, :8], base[:4, 8:])
    assert not share(t, t.view(torch.int32))
    buf = torch.zeros(64)
    assert not share(buf.as_strided((4, 16), (16, 1)),
                     buf.as_strided((4, 16), (1, 4)))
    assert not share(t[:2], t.view(2, 32))
