"""The port's MoE layer (`repro_torch.models.moe`) against the JAX
reference's (`repro.models.moe`), on the CPU.

The reference's `init_moe_params` weights are carried into the port's `MoE`
module by name (`load_state_dict(strict=True)`), and the same numpy input
goes through both. Routing is integer arithmetic and is held exactly: the
top-k expert indices, each slot's position in its expert's queue and the
keep mask (the capacity drop set), against the reference's own routing
lines evaluated by jax (`_jax_routing`, a transcription of
`repro/models/moe.py::moe_forward`'s routing, whose intermediates the
reference does not return). Each case also prints the smallest gap
between the k-th and the (k+1)-th router probability, the margin that the
equality of the indices rests on.

Tolerance: fp32 through a softmax and three matmuls in other summation
orders (XLA's dots against ATen's): y within 1e-5 of its largest
magnitude, the aux loss (a sum of E products of means) within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.common import ModelConfig as JaxModelConfig

from repro_torch.models import moe
from repro_torch.models.common import ModelConfig

torch.set_num_threads(2)

RTOL = 1e-5
AUX_ATOL = 1e-6
CASES = [(4, 2, 0), (8, 2, 0), (4, 2, 1), (8, 3, 2)]
# ample (no token-slot dropped) and starved (C = 4 for 64 or more slots)
CAPACITY = {"ample": 8.0, "starved": 0.25}


def _cfgs(E=4, k=2, shared=0, cf=8.0, group=32):
    kw = dict(name="t", arch_type="moe", num_layers=1, d_model=16,
              num_heads=2, num_kv_heads=2, d_ff=24, vocab_size=64,
              num_experts=E, top_k=k, num_shared_experts=shared,
              moe_capacity_factor=cf, moe_group_size=group)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _pair(E, k, shared, cf=8.0, group=32, seed=0):
    """(jax cfg, jax params, port cfg, port MoE) on the same weights."""
    jcfg, cfg = _cfgs(E, k, shared, cf, group)
    jp = jmoe.init_moe_params(jcfg, jax.random.PRNGKey(seed))
    layer = moe.MoE(cfg, device="cpu")
    layer.load_state_dict({n: torch.tensor(np.asarray(a))
                           for n, a in jp.items()}, strict=True)
    return jcfg, jp, cfg, layer


def _x(shape=(2, 32, 16), seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


def _jax_routing(params, cfg, x):
    """The reference's routing of x (B, S, d), by its own lines: (probs,
    gate_vals, expert_idx, position, keep, dispatch, combine), position
    and keep per (group, token, slot)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    Sg = min(cfg.moe_group_size, B * S)
    G = B * S // Sg
    C = jmoe._capacity(cfg, Sg)
    xg = x.reshape(G, Sg, d)
    probs = jax.nn.softmax(xg.astype(jnp.float32) @ params["router"], -1)
    gate_vals, expert_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.sum(gate_vals, -1, keepdims=True)
    onehot = jax.nn.one_hot(expert_idx, E, dtype=jnp.int32)
    pos_base = jnp.zeros((G, 1, E), jnp.int32)
    dispatch = jnp.zeros((G, Sg, E, C), x.dtype)
    combine = jnp.zeros((G, Sg, E, C), jnp.float32)
    position, kept = [], []
    for slot in range(k):
        oh = onehot[:, :, slot]
        pos = jnp.cumsum(oh, axis=1) - oh + pos_base
        keep = (pos < C) & (oh > 0)
        disp_slot = (jax.nn.one_hot(jnp.clip(pos, 0, C - 1), C,
                                    dtype=x.dtype)
                     * keep[..., None].astype(x.dtype)
                     * oh[..., None].astype(x.dtype))
        dispatch = dispatch + disp_slot
        combine = combine + disp_slot * gate_vals[:, :, slot, None, None]
        position.append(jnp.sum(pos * oh, -1))
        kept.append(jnp.any(keep, -1))
        pos_base = pos_base + jnp.sum(oh, axis=1, keepdims=True)
    return tuple(np.asarray(a) for a in (
        probs, gate_vals, expert_idx, jnp.stack(position, -1),
        jnp.stack(kept, -1), dispatch, combine))


def _top_k_margin(probs, k):
    """The smallest gap between the k-th and (k+1)-th probability of any
    token: how far the top-k sets are from a tie."""
    s = -np.sort(-probs, axis=-1)
    return float((s[..., k - 1] - s[..., k]).min()) if k < s.shape[-1] \
        else float("inf")


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("E,k,shared", CASES)
def test_routing_and_drop_set_equal_reference(E, k, shared, capacity):
    """expert_idx, positions and the keep mask exactly; the one-hot
    dispatch exactly and the combine weights within the tolerance."""
    jcfg, jp, cfg, layer = _pair(E, k, shared, CAPACITY[capacity])
    x = _x()
    probs, gates, idx, pos, keep, disp, comb = _jax_routing(
        jp, jcfg, jnp.asarray(x))
    C = moe._capacity(cfg, 32)
    assert C == jmoe._capacity(jcfg, 32)
    r = moe.route(layer.router, cfg, torch.from_numpy(x).reshape(2, 32, 16),
                  C)
    margin = _top_k_margin(probs, k)
    print(f"E={E} k={k} shared={shared} {capacity} (C={C}): top-k margin "
          f"{margin:.3e}, dropped {int((~keep).sum())} of {keep.size}")
    np.testing.assert_array_equal(r.expert_idx.numpy(), idx,
                                  err_msg=f"top-k margin {margin:.3e}")
    np.testing.assert_array_equal(r.position.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if capacity == "starved":
        assert (~keep).any(), "the starved case drops no token-slot"
    else:
        assert keep.all()
    _close(r.probs, probs)
    _close(r.gate_vals, gates)
    dispatch, combine = moe.dispatch_combine(r, E, C, torch.float32)
    np.testing.assert_array_equal(dispatch.numpy(), disp)
    _close(combine, comb)


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("E,k,shared", CASES)
def test_moe_forward_matches_reference(E, k, shared, capacity):
    jcfg, jp, cfg, layer = _pair(E, k, shared, CAPACITY[capacity])
    x = _x()
    want, want_aux = jmoe.moe_forward(jp, jcfg, jnp.asarray(x))
    got, aux = moe.moe_forward(layer, cfg, torch.from_numpy(x))
    assert got.shape == x.shape and aux.dtype == torch.float32
    _close(got, want)
    assert abs(float(aux) - float(want_aux)) <= AUX_ATOL, (float(aux),
                                                           float(want_aux))
    assert float(aux) >= 1.0 - 1e-5  # >= 1 by Cauchy-Schwarz


@pytest.mark.parametrize("E,k,shared", CASES)
def test_dense_oracle_matches_reference_and_ample_dispatch(E, k, shared):
    """The port's dense oracle equals the reference's, and with ample
    capacity the dispatch path equals the oracle."""
    jcfg, jp, cfg, layer = _pair(E, k, shared)
    x = _x()
    want = jmoe.moe_forward_dense_ref(jp, jcfg, jnp.asarray(x))
    oracle = moe.moe_forward_dense_ref(layer, cfg, torch.from_numpy(x))
    _close(oracle, want)
    got, _ = moe.moe_forward(layer, cfg, torch.from_numpy(x))
    _close(got, oracle.numpy())


@pytest.mark.parametrize("group", [8, 16, 64])
def test_grouping_invariance_with_ample_capacity(group):
    """With ample capacity the group size moves no token: every grouping
    gives the ungrouped (group = all tokens) output, in the port as in the
    reference."""
    jcfg, jp, cfg, layer = _pair(4, 2, 1, group=group)
    x = _x()
    want, _ = jmoe.moe_forward(jp, jcfg, jnp.asarray(x))
    got, _ = moe.moe_forward(layer, cfg, torch.from_numpy(x))
    _close(got, want)
    whole, _ = moe.moe_forward(layer, cfg.with_overrides(moe_group_size=64),
                               torch.from_numpy(x))
    _close(got, whole.numpy())


def test_decode_sized_batches_and_indivisible_groups():
    """One token per sequence (decode) routes within one group of B
    tokens, as the reference; tokens that do not divide into groups raise,
    where the reference asserts."""
    jcfg, jp, cfg, layer = _pair(8, 3, 2, cf=1.25)
    x = _x((3, 1, 16), seed=4)
    want, want_aux = jmoe.moe_forward(jp, jcfg, jnp.asarray(x))
    got, aux = moe.moe_forward(layer, cfg, torch.from_numpy(x))
    _close(got, want)
    assert abs(float(aux) - float(want_aux)) <= AUX_ATOL
    with pytest.raises(ValueError, match="not divisible"):
        moe.moe_forward(layer, cfg, torch.zeros((2, 20, 16)))


def test_ties_take_the_lower_expert():
    """Equal router probabilities: the lower expert index wins, slot by
    slot, as jax.lax.top_k orders them."""
    _, cfg = _cfgs(E=8, k=3)
    probs = torch.tensor([[[0.1, 0.2, 0.2, 0.05, 0.2, 0.1, 0.1, 0.05]]])
    vals, idx = moe._top_k(probs, 3)
    assert idx.tolist() == [[[1, 2, 4]]]
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_own_draw_has_the_reference_shapes():
    """The port's own draw: the reference's names and shapes, the router
    in fp32, deterministic for one generator seed."""
    jcfg, cfg = _cfgs(E=8, k=3, shared=2)
    shapes = jax.eval_shape(lambda key: jmoe.init_moe_params(jcfg, key),
                            jax.random.PRNGKey(0))
    a = moe.init_moe_params(cfg, torch.Generator().manual_seed(0))
    b = moe.init_moe_params(cfg, torch.Generator().manual_seed(0))
    assert {n: tuple(p.shape) for n, p in a.named_parameters()} == {
        n: tuple(s.shape) for n, s in shapes.items()}
    assert a.router.dtype == torch.float32
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
