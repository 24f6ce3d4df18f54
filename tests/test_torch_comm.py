"""The port's communication chain (`repro_torch.core.comm`: Censor,
Quantize, Drop, Chain) against the reference's `repro.core.comm`, on the
CPU.

The stages draw from jax's threefry, which the port repeats bit for bit
(`core.prng`), so on identical numpy inputs the send and delivered masks
and the bits must be equal exactly, and the payload within 1 ulp (the
payload's arithmetic is the reference's, op for op). Fits with a full
chain must give the reference's comms and bits exactly and theta within
1e-5 on every backend.

A note on what a mismatch would mean: stochastic rounding compares a draw u
with the fractional part of x = innovation / scale * levels. Where the two
packages' x differ by an ulp (their iterates drift apart by ~1e-7 in a fit)
and a draw lies within that ulp, the rounding differs: that is a rounding
difference of the iterate, not a PRNG difference. The stage tests below
feed both packages the same x, so their draws and decisions must agree
exactly; no seed here was chosen to avoid a mismatch.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FitConfig as JFitConfig
from repro.api import KRRConfig as JKRRConfig
from repro.api import backends as jax_backends
from repro.api import build_problem as jax_build_problem
from repro.api import fit as jax_fit
from repro.core import comm as J

from repro_torch import convert
from repro_torch.api import FitConfig, KRRConfig, fit
from repro_torch.core import comm as P

torch.set_num_threads(2)

INF = float("inf")
TOL = 1e-5
# the reference's RING6 configuration (tests/test_comm.py), 40 iterations
RING6_KRR = dict(num_agents=6, samples_per_agent=40, num_features=32,
                 lam=1e-2, rho=0.1, seed=0)
RING6 = dict(graph="ring", algorithm="coke", num_iters=40,
             primal="gradient", inner_steps=1, inner_lr=0.05)


def _both(*stages):
    """(reference Chain, port Chain) from ("Censor", v, mu) / ("Quantize",
    bits, seed[, stochastic]) / ("Drop", p, seed) tuples."""
    make = {"Censor": (J.Censor, P.Censor), "Quantize": (J.Quantize,
                                                         P.Quantize),
            "Drop": (J.Drop, P.Drop)}
    return (J.Chain([make[n][0](*a) for n, *a in stages]),
            P.Chain([make[n][1](*a) for n, *a in stages]))


CHAINS = {
    "coke": (("Censor", 0.3, 0.97),),
    "full": (("Censor", 0.3, 0.97), ("Quantize", 5.0, 7),
             ("Drop", 0.15, 11)),
    "identity": (("Censor", 1.0, 0.95), ("Quantize", INF, 0),
                 ("Drop", 0.0, 1)),
    "mixed": (("Drop", 0.5, 3), ("Quantize", 3.0, 2, False),
              ("Censor", 0.05, 0.9)),
    "quantize-only": (("Quantize", 8.0, 0),),
}


def _key(jkey):
    return tuple(int(v) for v in np.asarray(jkey))


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_key_equals_the_reference(name):
    """COKE's chain and DKLA's (`uncensored`: v * 0, another key) and
    mixed chains: stage indices, seeds and float32 parameters folded in
    the reference's leaf order."""
    jc, pc = _both(*CHAINS[name])
    assert pc.chain_key() == _key(jc.chain_key())
    assert pc.init_state(6).key == _key(jc.init_state(6).key)
    ju, pu = J.uncensored(jc), P.uncensored(pc)
    assert pu.chain_key() == _key(ju.chain_key())
    if any(s[0] == "Censor" for s in CHAINS[name]):
        assert pu.chain_key() != pc.chain_key()


def _msgs(theta, hat):
    n = theta.shape[0]
    jm = J.Msg(jnp.asarray(theta), jnp.asarray(hat), jnp.ones((n,), bool),
               jnp.ones((n,), bool), jnp.asarray(32.0, jnp.float32),
               jnp.zeros((), jnp.float32))
    pm = P.Msg(torch.tensor(theta), torch.tensor(hat),
               torch.ones((n,), dtype=torch.bool),
               torch.ones((n,), dtype=torch.bool), 32.0, 0.0)
    return jm, pm


def _ulps(got, want):
    """|got - want| in units of the float32 spacing at want."""
    want = np.asarray(want, np.float32)
    return np.max(np.abs(np.asarray(got, np.float32) - want)
                  / np.spacing(np.abs(want) + np.float32(1e-30)))


STAGES = {
    "quantize-4": ("Quantize", 4.0, 0),
    "quantize-8-seed-9": ("Quantize", 8.0, 9),
    "quantize-2": ("Quantize", 2.0, 3),
    "quantize-round": ("Quantize", 4.0, 0, False),
    "quantize-inf": ("Quantize", INF, 0),
    "drop-0": ("Drop", 0.0, 1),
    "drop-0.15": ("Drop", 0.15, 11),
    "drop-0.5": ("Drop", 0.5, 4),
}


@pytest.mark.parametrize("name", sorted(STAGES))
def test_stage_transform_equals_the_reference(name):
    """One stage on identical inputs, at several rounds k, with the key a
    Chain would pass and with the bare-stage key: send and delivered masks
    exact, payload within 1 ulp, bits_per_value and overhead equal."""
    kind, *args = STAGES[name]
    jstage = getattr(J, kind)(*args)
    pstage = getattr(P, kind)(*args)
    rng = np.random.default_rng(len(name))
    theta = rng.standard_normal((7, 33)).astype(np.float32)
    hat = (0.5 * rng.standard_normal((7, 33))).astype(np.float32)
    hat[3] = theta[3]                     # a zero innovation (scale 0)
    for k in (1, 2, 17, 2**31 + 5):
        for chain_key in (False, True):
            jkey = key = None
            if chain_key:
                jkey = jax.random.fold_in(jax.random.PRNGKey(k), 2)
                key = _key(jkey)
            jm, pm = _msgs(theta, hat)
            jo, _ = jstage.transform(jm, (), jnp.uint32(k), key=jkey)
            po, _ = pstage.transform(pm, (), k, key=key)
            np.testing.assert_array_equal(po.send.numpy(),
                                          np.asarray(jo.send))
            np.testing.assert_array_equal(po.delivered.numpy(),
                                          np.asarray(jo.delivered))
            assert _ulps(po.payload.numpy(), jo.payload) <= 1, (name, k)
            assert np.float32(po.bits_per_value) == np.asarray(
                jo.bits_per_value)
            assert np.float32(po.overhead_bits) == np.asarray(
                jo.overhead_bits)


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_apply_equals_the_reference(name):
    """Six rounds of Chain.apply from the chain's own state: send exact,
    cumulative bits exact, the broadcast within 1 ulp."""
    jc, pc = _both(*CHAINS[name])
    rng = np.random.default_rng(11)
    n, d = 8, 40
    theta = rng.standard_normal((n, d)).astype(np.float32)
    hat = np.zeros((n, d), np.float32)
    js, ps = jc.init_state(n), pc.init_state(n)
    for k in range(1, 7):
        jh, jsend, js = jc.apply(jnp.asarray(theta), jnp.asarray(hat),
                                 jnp.int32(k), js)
        ph, psend, ps = pc.apply(torch.tensor(theta), torch.tensor(hat), k,
                                 ps)
        np.testing.assert_array_equal(psend.numpy(), np.asarray(jsend))
        np.testing.assert_array_equal(ps.bits.numpy(), np.asarray(js.bits))
        assert _ulps(ph.numpy(), jh) <= 1, (name, k)
        hat = np.asarray(jh)
        theta = theta + 0.2 * rng.standard_normal((n, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# the reference's stage behaviours (tests/test_comm.py), on the port
# ---------------------------------------------------------------------------

def test_quantize_infinite_bits_is_exact_identity():
    g = torch.Generator().manual_seed(0)
    theta = torch.randn((5, 16), generator=g)
    hat = torch.randn((5, 16), generator=g)
    chain = P.Chain((P.Quantize(bits=INF),))
    hat2, _, state = chain.apply(theta, hat, 3, chain.init_state(5))
    assert torch.equal(hat2, theta)
    assert torch.equal(state.bits, torch.full((5,), 16 * 32.0))


def test_quantize_is_unbiased_and_bounded():
    theta = torch.randn((4, 64), generator=torch.Generator().manual_seed(0))
    hat = torch.zeros((4, 64))
    stage = P.Quantize(bits=4.0)
    outs = []
    for k in range(200):
        msg = P.Msg(theta, hat, torch.ones(4, dtype=torch.bool),
                    torch.ones(4, dtype=torch.bool), 32.0, 0.0)
        out, _ = stage.transform(msg, (), k + 1)
        outs.append(out.payload.numpy())
    outs = np.stack(outs)
    step = theta.abs().amax(-1, keepdim=True).numpy() / (2.0**3 - 1)
    assert np.max(np.abs(outs - theta.numpy()[None])) <= step.max() + 1e-6
    assert np.max(np.abs(outs.mean(0) - theta.numpy())) < 0.3 * step.max()


def test_quantize_accounts_payload_plus_scale_overhead():
    chain = P.Chain((P.Quantize(bits=4.0),))
    _, _, state = chain.apply(torch.ones((2, 16)), torch.zeros((2, 16)), 1,
                              chain.init_state(2))
    assert torch.equal(state.bits, torch.full((2,), 16 * 4 + 32.0))


def test_drop_pays_but_does_not_deliver():
    theta, hat = torch.ones((400, 4)), torch.zeros((400, 4))
    chain = P.Chain((P.Drop(p=0.5),))
    hat2, send, state = chain.apply(theta, hat, 1, chain.init_state(400))
    delivered = torch.all(hat2 == 1.0, dim=-1)
    assert bool(torch.all(send))
    assert torch.equal(state.bits, torch.full((400,), 4 * 32.0))
    assert 0.3 < float(delivered.float().mean()) < 0.7
    assert torch.equal(hat2[~delivered], hat[~delivered])


def test_drop_is_deterministic_in_k_and_seed():
    theta, hat = torch.ones((64, 4)), torch.zeros((64, 4))

    def run(seed, k):
        chain = P.Chain((P.Drop(p=0.5, seed=seed),))
        return chain.apply(theta, hat, k, chain.init_state(64))[0]

    assert torch.equal(run(1, 7), run(1, 7))
    assert not torch.equal(run(1, 7), run(1, 8))
    assert not torch.equal(run(1, 7), run(2, 7))


def test_ensure_state_keeps_bits_and_rekeys_a_new_structure():
    chain = P.Chain((P.Censor(0.3, 0.9), P.Drop(p=0.2)))
    old = P.Chain((P.Censor(0.3, 0.9),)).init_state(4)
    old = old._replace(bits=torch.full((4,), 7.0))
    new = chain.ensure_state(old, 4)
    assert torch.equal(new.bits, old.bits) and len(new.stages) == 2
    assert new.key == chain.chain_key()
    assert chain.ensure_state(new, 4) is new


# ---------------------------------------------------------------------------
# fits against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ring6():
    """(reference problem, port copy of it) at the RING6 size."""
    jp = jax_build_problem(JFitConfig(krr=JKRRConfig(**RING6_KRR),
                                      **RING6)).problem
    return jp, convert.problem_from_numpy(
        np.asarray(jp.feats), np.asarray(jp.labels),
        np.asarray(jp.adjacency), jp.lam, jp.rho, device="cpu")


def _fit_pair(ring6, jchain, pchain, **over):
    ref = jax_fit(JFitConfig(krr=JKRRConfig(**RING6_KRR), comm=jchain,
                             **{**RING6, **over}), problem=ring6[0])
    port = fit(FitConfig(krr=KRRConfig(**RING6_KRR), comm=pchain,
                         **{**RING6, **over}), problem=ring6[1],
               device="cpu")
    return ref, port


@pytest.mark.parametrize("alg", ["coke", "dkla"])
@pytest.mark.parametrize("backend", ["simulator", "spmd", "fused"])
def test_full_chain_fit_matches_the_reference(backend, alg, ring6,
                                              monkeypatch):
    """Chain([Censor(0.3, 0.97), Quantize(bits=5, seed=7), Drop(p=0.15,
    seed=11)]): comms and bits exact, theta and the train MSE within 1e-5.
    The fused fit is held against the reference's unfused switch (its
    megakernel wrapper cannot build on jax 0.9.0), which the reference
    pins bit-identical to its megakernel."""
    monkeypatch.setattr(jax_backends, "_MEGASTEP_USE_KERNEL", False)
    jchain, pchain = _both(*CHAINS["full"])
    ref, port = _fit_pair(ring6, jchain, pchain, backend=backend,
                          algorithm=alg)
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(port.history[k].numpy(),
                                      np.asarray(ref.history[k]), err_msg=k)
    np.testing.assert_allclose(port.train_mse.numpy(),
                               np.asarray(ref.train_mse), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(port.theta.numpy(), np.asarray(ref.theta),
                               atol=TOL, rtol=0)
    # the quantizer's accounting: sends x (D * 5 + 32) exactly
    d = RING6_KRR["num_features"]
    assert float(port.bits[-1]) == int(port.comms[-1]) * (d * 5 + 32)
    if alg == "dkla":   # censoring stripped, compression kept
        assert int(port.comms[-1]) == 40 * RING6_KRR["num_agents"]


@pytest.mark.parametrize("backend", ["simulator", "spmd", "fused"])
def test_identity_chain_is_bitwise_plain_coke(backend, ring6):
    """Chain([Censor(v, mu), Quantize(bits=inf), Drop(p=0)]) reproduces
    the censor-only fit bit for bit (the Drop stage still draws)."""
    plain = fit(FitConfig(krr=KRRConfig(**RING6_KRR), censor_v=0.3,
                          censor_mu=0.97, backend=backend, **RING6),
                problem=ring6[1], device="cpu")
    ident = fit(FitConfig(krr=KRRConfig(**RING6_KRR), backend=backend,
                          comm=P.Chain([P.Censor(0.3, 0.97),
                                        P.Quantize(bits=INF),
                                        P.Drop(p=0.0)]), **RING6),
                problem=ring6[1], device="cpu")
    assert torch.equal(plain.theta, ident.theta)
    for k in plain.history:
        assert torch.equal(plain.history[k], ident.history[k]), k


def test_quantized_coke_converges_under_drops(ring6):
    """The reference's own factor: COKE with quantized innovations over
    lossy links ends within 2.5x the censor-only train MSE."""
    base = dict(censor_v=None, censor_mu=None, backend="simulator",
                num_iters=150)
    chained = fit(FitConfig(krr=KRRConfig(**RING6_KRR), **{**RING6, **base},
                            comm=P.Chain([P.Censor(0.3, 0.97),
                                          P.Quantize(bits=6),
                                          P.Drop(p=0.1)])),
                  problem=ring6[1], device="cpu")
    plain = fit(FitConfig(krr=KRRConfig(**RING6_KRR), **{**RING6, **base},
                          comm=P.Chain([P.Censor(0.3, 0.97)])),
                problem=ring6[1], device="cpu")
    assert math.isfinite(float(chained.train_mse[-1]))
    assert float(chained.train_mse[-1]) < 2.5 * float(plain.train_mse[-1])
