"""K6, the gathered row-dot of many-model serving (`kernels/rowdot`), on
the CPU: its plain version against the reference's
einsum('bd,bd->b', phi, stack[slots]) (`serve/kernel_server.py:164-169`),
and the wrapper's contracts, which hold on every device: fp32, contiguous,
matching shapes, host int32 slots in range, checked before any dispatch;
CPU tensors take the plain version and launch nothing.

Tolerance: both sides sum D fp32 products in their own order; ROWDOT_RTOL
of sum_k |phi[i, k] stack[slots[i], k]| covers any two orders at D <= 4096
(a chain of D/32 + 5 adds in the kernel's order, fewer in the others').
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.api.model import score_rows
from repro_torch.core.rff import RFFParams
from repro_torch.kernels.rowdot import rowdot as k6
from repro_torch.kernels.rowdot.ops import gather_rowdot, rowdot
from repro_torch.kernels.rowdot.ref import gather_rowdot_ref

torch.set_num_threads(2)

ROWDOT_RTOL = 1e-5
SHAPES = [(1, 64, 16), (2, 64, 16), (31, 100, 4093), (64, 1000, 4096),
          (1024, 40, 16), (5, 3, 1), (0, 4, 8)]


def _operands(b, m, d, seed=0):
    rng = np.random.default_rng(seed)
    phi = (np.sqrt(2.0 / d) * np.cos(rng.uniform(0, 6.3, (b, d)))
           ).astype(np.float32)
    stack = rng.normal(size=(m, d)).astype(np.float32)
    slots = rng.integers(0, m, size=b).astype(np.int32)
    return phi, stack, slots


@pytest.mark.parametrize("b,m,d", SHAPES, ids=str)
def test_plain_version_matches_the_reference_einsum(b, m, d):
    phi, stack, slots = _operands(b, m, d)
    want = np.asarray(jnp.einsum("bd,bd->b", jnp.asarray(phi),
                                 jnp.asarray(stack)[jnp.asarray(slots)]))
    got = gather_rowdot(torch.from_numpy(phi), torch.from_numpy(stack), slots)
    assert got.shape == (b,) and got.dtype == torch.float32
    scale = np.abs(phi * stack[slots]).sum(-1)
    assert np.all(np.abs(got.numpy() - want) <= ROWDOT_RTOL * scale)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    phi, stack, slots = _operands(37, 50, 128)
    before = k6.LAUNCHES
    got = gather_rowdot(torch.from_numpy(phi), torch.from_numpy(stack),
                        torch.from_numpy(slots))
    assert k6.LAUNCHES == before
    want = gather_rowdot_ref(torch.from_numpy(phi), torch.from_numpy(stack),
                             torch.from_numpy(slots))
    assert torch.equal(got, want)


@pytest.mark.parametrize("d", [16, 4093, 4096])
def test_rows_do_not_depend_on_the_batch(d):
    """Row i's bits depend only on phi[i] and stack[slots[i]]: the same row
    alone, in a short batch and in a 1024-row batch, gathered or not."""
    phi, stack, slots = _operands(1024, 300, d, seed=1)
    phi_t, stack_t = torch.from_numpy(phi), torch.from_numpy(stack)
    full = gather_rowdot(phi_t, stack_t, slots)
    for lo, n in ((0, 1), (5, 2), (100, 3), (512, 32), (0, 512)):
        part = gather_rowdot(phi_t[lo:lo + n], stack_t, slots[lo:lo + n])
        assert torch.equal(part, full[lo:lo + n]), (lo, n)
    rows = torch.from_numpy(stack[slots[:7]]).contiguous()
    assert torch.equal(rowdot(phi_t[:7].contiguous(), rows), full[:7])


def test_score_rows_is_featurize_then_the_row_dot():
    rng = np.random.default_rng(2)
    params = RFFParams(omega=torch.tensor(rng.normal(size=(5, 64)),
                                          dtype=torch.float32),
                       bias=torch.tensor(rng.uniform(0, 6.28, 64),
                                         dtype=torch.float32))
    x = torch.tensor(rng.uniform(size=(9, 5)), dtype=torch.float32)
    stack = torch.tensor(rng.normal(size=(20, 64)), dtype=torch.float32)
    slots = rng.integers(0, 20, 9).astype(np.int32)
    for backend in ("ref", "fused"):
        got = score_rows(params, x, stack, slots, backend=backend)
        thetas = stack[torch.from_numpy(slots).long()]
        assert torch.equal(got, score_rows(params, x, thetas,
                                           backend=backend))
    with pytest.raises(ValueError, match="backend"):
        score_rows(params, x, stack, slots, backend="quantum")


def test_staging_picks_the_instance_from_width_and_alignment():
    aligned = torch.zeros(8, 4096)
    assert k6.staging(aligned, aligned) == "16-byte"
    assert k6.staging(torch.zeros(8, 4093), torch.zeros(3, 4093)) \
        == "4-byte"
    off = torch.zeros(8 * 4096 + 1)[1:].view(8, 4096)
    assert k6.staging(off, aligned) == "4-byte"
    assert k6.staging(aligned, off) == "4-byte"


def test_wrapper_contracts_raise_before_any_dispatch():
    phi, stack, slots = (torch.from_numpy(a) for a in _operands(4, 6, 8))
    s = slots.numpy()
    with pytest.raises(TypeError, match="fp32"):
        gather_rowdot(phi.double(), stack, s)
    with pytest.raises(TypeError, match="fp32"):
        gather_rowdot(phi, stack.half(), s)
    with pytest.raises(ValueError, match="contiguous"):
        gather_rowdot(torch.zeros(8, 4).t(), stack, s)
    with pytest.raises(ValueError, match="contiguous"):
        gather_rowdot(phi, torch.zeros(8, 6).t(), s)
    with pytest.raises(ValueError, match="phi \\(B, D\\)"):
        gather_rowdot(phi[None], stack, s)
    with pytest.raises(ValueError, match="shape mismatch"):
        gather_rowdot(phi, torch.zeros(6, 9), s)
    with pytest.raises(ValueError, match="shape mismatch"):
        gather_rowdot(phi, stack, s[:3])
    with pytest.raises(ValueError, match="1-D integer"):
        gather_rowdot(phi, stack, s.astype(np.float32))
    with pytest.raises(ValueError, match="1-D integer"):
        gather_rowdot(phi, stack, s[None])
    for bad in (-1, 6):
        wrong = s.copy()
        wrong[2] = bad
        with pytest.raises(IndexError, match="\\[0, 6\\)"):
            gather_rowdot(phi, stack, wrong)
    # device slots could only be range-checked by waiting for the card
    with pytest.raises(ValueError, match="host int32"):
        gather_rowdot(phi, stack, torch.zeros(4, dtype=torch.int32,
                                              device="meta"))
    with pytest.raises(ValueError, match="lies on"):
        gather_rowdot(phi, torch.zeros(6, 8, device="meta"), s)
    # int64 slots and read-only arrays are taken (copied to int32)
    ro = s.astype(np.int64)
    ro.setflags(write=False)
    assert torch.equal(gather_rowdot(phi, stack, ro),
                       gather_rowdot(phi, stack, s))
