"""The port's threefry generator (`repro_torch.core.prng`) against
`jax.random` (threefry2x32, `jax_threefry_partitionable=True`), on the CPU.

Keys, `fold_in` chains, and the bits and floats of `uniform` must be equal
bitwise: the comm chain's Quantize and Drop stages draw from them, and a
fit with those stages gives the reference's send decisions and bit counts
only if every draw is the reference's."""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

torch.set_num_threads(2)

SEEDS = (0, 1, 42, 2**31 - 1, 2**32 - 1, -1, 2**40 + 3)
DATA = (0, 1, 3, 2**31, 2**32 - 1)
SHAPES = ((0,), (1,), (7,), (20, 4096), (3, 5, 7))


def _key(jkey) -> tuple[int, int]:
    return tuple(int(v) for v in np.asarray(jkey))


def test_partitionable_threefry_is_the_reference_default():
    assert jax.config.jax_threefry_partitionable


def test_pinned_values():
    key = prng.fold_in(prng.PRNGKey(0), 3)
    assert key == (2467461003, 3840466878)
    u = prng.uniform(key, (4,)).numpy()
    want = np.array([0.26698947, 0.73395014, 0.9537231, 0.20954156],
                    np.float32)
    np.testing.assert_array_equal(u, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_match_jax(seed):
    jkey = jax.random.PRNGKey(seed)
    key = prng.PRNGKey(seed)
    assert key == _key(jkey)
    for d in DATA:
        assert prng.fold_in(key, d) == _key(jax.random.fold_in(jkey, d))


def test_fold_in_chains_match_jax():
    """The chain's derivation: several folds deep, with data up to
    2^32 - 1 (the round counter k and float32 bit patterns)."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        jkey, key = jax.random.PRNGKey(0), prng.PRNGKey(0)
        for d in rng.integers(0, 2**32, size=6, dtype=np.uint64):
            jkey = jax.random.fold_in(jkey, int(d))
            key = prng.fold_in(key, int(d))
            assert key == _key(jkey)


def test_fold_in_rejects_data_outside_uint32():
    for d in (-1, 2**32):
        with pytest.raises(OverflowError):
            jax.random.fold_in(jax.random.PRNGKey(0), d)
        with pytest.raises(OverflowError):
            prng.fold_in(prng.PRNGKey(0), d)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_and_bits_match_jax_bitwise(shape):
    for seed, d in ((0, 3), (7, 2**32 - 1), (2**31 - 1, 12345)):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), d)
        key = prng.fold_in(prng.PRNGKey(seed), d)
        ju = np.asarray(jax.random.uniform(jkey, shape))
        u = prng.uniform(key, shape)
        assert u.dtype == torch.float32 and tuple(u.shape) == shape
        np.testing.assert_array_equal(u.numpy().view(np.uint32),
                                      ju.view(np.uint32))
        jb = np.asarray(jax.random.bits(jkey, shape, jnp.uint32))
        np.testing.assert_array_equal(
            prng.random_bits(key, shape).numpy(), jb.astype(np.int64))


def test_uniform_odd_size_above_2_16_and_range():
    n = 2**16 + 3
    key = prng.fold_in(prng.PRNGKey(5), 9)
    u = prng.uniform(key, (n,))
    ju = np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(5), 9), (n,)))
    np.testing.assert_array_equal(u.numpy(), ju)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_threefry_on_host_ints_equals_the_tensor_form():
    """Keys are derived on the host in Python ints and draws on tensors:
    the one function gives the same words in both forms."""
    key = (123456789, 987654321)
    x0 = torch.tensor([0, 1, 2**32 - 1], dtype=torch.int64)
    x1 = torch.tensor([5, 2**31, 77], dtype=torch.int64)
    t0, t1 = prng.threefry2x32(key, x0, x1)
    for i in range(3):
        h0, h1 = prng.threefry2x32(key, int(x0[i]), int(x1[i]))
        assert (h0, h1) == (int(t0[i]), int(t1[i]))


def test_chip_smoke_pins_are_jax_values():
    """chip_smoke.py (and the card tests) hold the card's draws to values
    hard-coded from jax, since jax is not installed beside the card: each
    must be what jax gives."""
    from repro.core import comm as jax_comm
    from repro_torch.core import comm as port_comm

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for seed, folds, shape, key_want, bits_want in smoke.JAX_PRNG_PINS:
        jkey = jax.random.PRNGKey(seed)
        for f in folds:
            jkey = jax.random.fold_in(jkey, f)
        assert _key(jkey) == key_want
        flat = np.asarray(jax.random.bits(jkey, shape, jnp.uint32)).ravel()
        assert {i: int(flat[i]) for i in bits_want} == bits_want
    ju = np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(0), 3), (4,)))
    assert tuple(int(v) for v in ju.view(np.uint32)) == smoke.JAX_UNIFORM_PIN
    stages = (smoke.CHAIN_BITS, smoke.CHAIN_DROP)
    jchain = jax_comm.Chain([jax_comm.Censor(1.0, 0.95),
                             jax_comm.Quantize(bits=stages[0]),
                             jax_comm.Drop(p=stages[1])])
    pchain = port_comm.Chain([port_comm.Censor(1.0, 0.95),
                              port_comm.Quantize(bits=stages[0]),
                              port_comm.Drop(p=stages[1])])
    assert smoke.JAX_CHAIN_KEYS == {
        "coke": _key(jchain.chain_key()),
        "dkla": _key(jax_comm.uncensored(jchain).chain_key())}
    assert pchain.chain_key() == smoke.JAX_CHAIN_KEYS["coke"]
