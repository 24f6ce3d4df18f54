"""The threefry draw (K5, `kernels/threefry`) on the CPU: its plain version
against `jax.random` and the pinned values, and its wrapper's dispatch.

The plain version (`kernels/threefry/ref.py`) is what `core.prng` runs on
CPU tensors; the CUDA kernel (`csrc/threefry.cu`) runs only on the card,
where `tests/test_torch_cuda.py` and `chip_smoke.py` phase 2 hold it to
this plain version bit for bit. Here every draw must equal jax's
`random.uniform` / `random.bits` bitwise, for single keys and for (G, 2)
key tensors (the reference's `vmap` over keys).
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.kernels.threefry import ops
from repro_torch.kernels.threefry import threefry as k5
from repro_torch.kernels.threefry.ref import (random_bits_ref, threefry2x32,
                                              uniform_ref)

torch.set_num_threads(2)

CPU = torch.device("cpu")
SHAPES = ((1,), (20,), (512,), (20, 4096), (3, 5, 7), (1027,))


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jkey(key):
    return jax.random.wrap_key_data(jnp.asarray(key, jnp.uint32))


def test_plain_version_gives_the_pinned_values():
    """chip_smoke.py's JAX_PRNG_PINS (checked against jax in
    tests/test_torch_prng.py) and JAX_UNIFORM_PIN, through the plain
    version directly and through the wrapper on the CPU."""
    smoke = _chip_smoke()
    for seed, folds, shape, key_want, bits_want in smoke.JAX_PRNG_PINS:
        key = prng.PRNGKey(seed)
        for f in folds:
            key = prng.fold_in(key, f)
        assert key == key_want
        for bits in (random_bits_ref(key, shape, CPU),
                     ops.random_bits(key, shape, CPU)):
            flat = bits.reshape(-1)
            assert {i: int(flat[i]) for i in bits_want} == bits_want
    u = uniform_ref(prng.fold_in(prng.PRNGKey(0), 3), (4,), CPU)
    assert tuple(int(v) for v in u.view(torch.int32)) == \
        smoke.JAX_UNIFORM_PIN


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_single_key_draws_equal_jax(shape):
    for seed, d in ((0, 3), (7, 2**32 - 1), (2**31 - 1, 12345)):
        key = prng.fold_in(prng.PRNGKey(seed), d)
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), d)
        u = ops.uniform(key, shape, CPU)
        assert u.dtype == torch.float32 and tuple(u.shape) == shape
        np.testing.assert_array_equal(
            u.numpy().view(np.uint32),
            np.asarray(jax.random.uniform(jkey, shape)).view(np.uint32))
        bits = ops.random_bits(key, shape, CPU)
        assert bits.dtype == torch.int64
        assert int(bits.min()) >= 0 and int(bits.max()) <= 0xFFFFFFFF
        np.testing.assert_array_equal(
            bits.numpy(),
            np.asarray(jax.random.bits(jkey, shape)).astype(np.int64))


@pytest.mark.parametrize("shape", ((20,), (8, 33)), ids=str)
def test_lane_keys_equal_jax_vmap(shape):
    """(G, 2) key tensors: lane g is jax's draw under key g (vmap), and the
    single draw under key g."""
    keys = [prng.fold_in(prng.PRNGKey(s), 5 * s + 2) for s in range(8)]
    lanes = torch.tensor(keys, dtype=torch.int64)
    u = ops.uniform(lanes, shape, CPU)
    assert tuple(u.shape) == (8,) + shape
    jkeys = jax.vmap(_jkey)(jnp.asarray(keys, jnp.uint32))
    ju = jax.vmap(lambda k: jax.random.uniform(k, shape))(jkeys)
    np.testing.assert_array_equal(u.numpy().view(np.uint32),
                                  np.asarray(ju).view(np.uint32))
    for g, key in enumerate(keys):
        assert torch.equal(u[g].view(torch.int32),
                           ops.uniform(key, shape, CPU).view(torch.int32))
    bits = ops.random_bits(lanes, shape, CPU)
    jbits = jax.vmap(lambda k: jax.random.bits(k, shape))(jkeys)
    np.testing.assert_array_equal(bits.numpy(),
                                  np.asarray(jbits).astype(np.int64))


def test_the_hash_runs_over_ints_arrays_and_tensors_alike():
    key = (2467461003, 3840466878)
    x = np.arange(6, dtype=np.int64)
    want = [threefry2x32(key, 0, int(i)) for i in x]
    hi, lo = threefry2x32(key, 0, x)
    assert list(zip(hi.tolist(), lo.tolist())) == want
    thi, tlo = threefry2x32(key, 0, torch.from_numpy(x))
    assert list(zip(thi.tolist(), tlo.tolist())) == want
    assert prng.fold_in(key, 5) == want[5]


def test_cpu_draws_launch_nothing_and_check_their_operands():
    before = k5.LAUNCHES
    ops.uniform((1, 2), (16,), "cpu")
    ops.random_bits(torch.zeros((2, 2), dtype=torch.int64), (4,), "cpu")
    assert k5.LAUNCHES == before
    assert tuple(ops.uniform((1, 2), (0, 3), "cpu").shape) == (0, 3)
    with pytest.raises(ValueError, match="int64"):
        ops.uniform(torch.zeros((2, 2), dtype=torch.int32), (4,), "cpu")
    with pytest.raises(ValueError, match=r"\(G, 2\)"):
        ops.uniform(torch.zeros((2, 3), dtype=torch.int64), (4,), "cpu")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.uniform((1, 2), (4,), "meta")


def test_launch_blocks_cover_every_word():
    assert k5.launch_blocks(1) == 1
    assert k5.launch_blocks(20) == 1
    assert k5.launch_blocks(k5.THREADS + 1) == 2
    assert k5.launch_blocks(81920) == 320
    assert k5.launch_blocks(10**9) == k5.MAX_BLOCKS
    for n in (1, 255, 256, 257, 81920, 10**7):
        b = k5.launch_blocks(n)
        # the grid-stride loop: every word has a thread's turn
        assert 1 <= b <= k5.MAX_BLOCKS and b * k5.THREADS * -(
            -n // (b * k5.THREADS)) >= n
