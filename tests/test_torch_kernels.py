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
from repro_torch.kernels.coke_update.ref import coke_megastep_ref
from repro_torch.kernels.rff import rff as port_rff
from repro_torch.kernels.rff.ops import featurize_fused

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
                             "flash_attention", "rff")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for name in build.SOURCES:
        p = build.library_path(name)
        assert p.parent == build.BUILD_DIR and p.name.startswith(name + "-")
        assert p == build.library_path(name)
    assert build.library_path("rff") != build.library_path("coke_megastep")


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
