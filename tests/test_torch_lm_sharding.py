"""The LM's sharding rules in the port (`repro_torch.distributed.sharding`:
`param_specs`, `param_shardings`, `decode_state_specs`, `step_in_specs`,
`activation_spec`; `models.model.param_shapes`;
`models.common.shard_activations`) against the JAX reference's, on the
CPU.

The meshes are the reference test's fake ones (tests/test_sharding.py):
{"data": 16, "model": 16} and {"pod": 2, "data": 16, "model": 16}, axis
sizes and names only. The reference stacks each model's layers along
leading dims; the port keeps a leaf per layer, whose spec is the
reference's spec of the stack (its leading entries index the layer), so
every spec must equal the reference's entry for entry, for every
architecture, with fsdp and without. `seq_parallel=True` gives the
logits it gives off, and the reference's within the LM's 1e-5.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.distributed import sharding as jax_shd
from repro.models import model as JM

from repro_torch.configs import SHAPES, get_config, input_specs, list_archs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M

torch.set_num_threads(2)

RTOL = 1e-5


class FakeMesh:
    """Metadata-only mesh stand-in (axis sizes + names)."""

    def __init__(self, shape_by_axis):
        self.shape = shape_by_axis
        self.axis_names = tuple(shape_by_axis)


SINGLE = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"single": SINGLE, "multi": MULTI}


def _norm(spec) -> tuple:
    """A spec's entries, one-name tuples read as the name (as both P's
    normalize them)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _jax_specs(tree) -> dict:
    """{reference path: spec} over a tree of jax PartitionSpecs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jax_shd._path_str(path): spec for path, spec in flat}


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_the_reference(arch, mesh, fsdp):
    """Every per-layer leaf's spec is the reference's for its stack."""
    cfg, jcfg, mesh = get_config(arch), jax_get_config(arch), MESHES[mesh]
    shapes = M.param_shapes(cfg)
    got = shd.param_specs(cfg, shapes, mesh, fsdp=fsdp)
    want = _jax_specs(jax_shd.param_specs(jcfg, JM.param_shapes(jcfg), mesh,
                                          fsdp=fsdp))
    seen = set()
    for name, spec in got.items():
        path, index = shd._ref_path(name)
        assert isinstance(spec, shd.P)
        assert _norm(spec) == _norm(want[path]), name
        n = shd._stack_depth(cfg, path)
        assert len(index) == n and len(spec) == n + shapes[name].ndim, name
        seen.add(path)
    assert seen == set(want)


# the leaves whose fsdp spec cuts the stack dim: no dim of the leaf divides
# the batch extent (16, or 32 with "pod") but mamba2's 64 layers do
STACKED_BY_FSDP = {
    ("mamba2-2.7b", "single"): ["blocks/ssm/conv_bx", "blocks/ssm/conv_x",
                                "blocks/ssm/norm"],
    ("mamba2-2.7b", "multi"): ["blocks/ssm/A_log", "blocks/ssm/D",
                               "blocks/ssm/conv_bx", "blocks/ssm/conv_x",
                               "blocks/ssm/dt_bias", "blocks/ssm/norm"]}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_shardings_place_each_layer(arch, mesh_name):
    """`param_shardings` pairs each spec with the mesh: the leaf's own
    dims divide by it, and where fsdp put the batch axes on the stack dim
    (no weight dim divides), the layer's batch block is its index over the
    layers a block holds. Those leaves are pinned (`STACKED_BY_FSDP`;
    their specs equal the reference's by the test above)."""
    cfg, mesh = get_config(arch), MESHES[mesh_name]
    shapes = M.param_shapes(cfg)
    stacked = []
    extent = math.prod(mesh.shape[a] for a in ("pod", "data")
                       if a in mesh.shape)
    for fsdp in (False, True):
        for name, sh in shd.param_shardings(cfg, shapes, mesh,
                                            fsdp=fsdp).items():
            path, index = shd._ref_path(name)
            assert sh.mesh is mesh and sh.n_stack == len(index)
            leaf = shapes[name]
            own = sh.leaf_spec
            assert len(own) == leaf.ndim
            for dim, axis in zip(leaf.shape, own):
                if axis is not None:
                    axes = axis if isinstance(axis, tuple) else (axis,)
                    assert dim % math.prod(mesh.shape[a] for a in axes) == 0
            if sh.layer_block is None:
                assert all(e is None for e in sh.spec[:sh.n_stack])
                continue
            assert fsdp and sh.spec[0] is not None
            layers = shd._stack_extents(cfg, path)[0]
            assert sh.layer_block == index[0] // (layers // extent)
            stacked.append(path)
    assert sorted(set(stacked)) == STACKED_BY_FSDP.get((arch, mesh_name),
                                                       [])


def test_param_shardings_place_a_model_on_a_mesh():
    """On a real (2, 2) mesh of the CPU, every reduced-model leaf placed by
    its sharding (fsdp on) and gathered again is the leaf, bit for bit."""
    cfg = get_config("qwen3-1.7b").reduced()
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    params = M.param_dict(model)
    mesh = make_host_mesh(2, 2, device="cpu")
    cut = 0
    for name, sh in shd.param_shardings(cfg, params, mesh,
                                        fsdp=True).items():
        placed = sh.place(params[name])
        cut += isinstance(placed, shd.Blocked)
        assert torch.equal(shd.unshard(placed), params[name]), name
    assert cut > 0


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_step_in_specs_match_the_reference(arch, shape_name):
    """Batches and the decode state: each per-layer cache's spec is the
    reference's for its stack, on both meshes."""
    rcfg, kind, specs = input_specs(get_config(arch), shape_name)
    jrcfg, jkind, jspecs = jax_input_specs(jax_get_config(arch), shape_name)
    if jrcfg is None:
        assert rcfg is None
        return
    for mesh in MESHES.values():
        got = shd.step_in_specs(rcfg, kind, specs, mesh)
        want = jax_shd.step_in_specs(jrcfg, jkind, jspecs, mesh)
        assert set(got) == set(want)
        for key, spec in want.items():
            if key != "state":
                assert _norm(got[key]) == _norm(spec), key
                continue
            flat = _jax_specs(spec)
            for top, caches in got["state"].items():
                for c in caches:
                    fields = (c._fields if hasattr(c, "_fields")
                              else (None,))
                    for f in fields:
                        path = top if f is None else f"{top}/{f}"
                        mine = c if f is None else getattr(c, f)
                        assert _norm(mine) == _norm(flat[path]), \
                            (arch, shape_name, path)


def test_kv_cache_sequence_parallel_fallback():
    """The reference test's case: granite decode, 8 KV heads under 16
    model shards: the KV heads replicate and the cache length is cut."""
    rcfg, _, specs = input_specs(get_config("granite-3-8b"), "decode_32k")
    state = shd.decode_state_specs(rcfg, specs["state"], SINGLE)
    assert len(state["layers"]) == rcfg.num_layers
    k_spec = state["layers"][0].k
    assert k_spec[3] is None and k_spec[2] == "model"


def test_activation_spec_is_the_reference_constraint():
    """The spec `shard_activations` names under seq_parallel, as the
    reference builds it (`models/common.py::shard_activations`)."""
    for axes in (("data",), ("pod", "data")):
        cfg = get_config("qwen3-1.7b").with_overrides(
            seq_parallel=True, act_batch_axes=axes)
        ba = axes if len(axes) > 1 else axes[0]
        assert _norm(shd.activation_spec(cfg)) == _norm(JP(ba, "model",
                                                           None))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x7b",
                                  "mamba2-2.7b", "zamba2-2.7b",
                                  "internvl2-1b"])
def test_seq_parallel_logits_match_the_reference(arch):
    """seq_parallel=True: the port's logits are its logits without it, bit
    for bit, and the reference's (run under a one-device mesh, where its
    constraint is a layout) within 1e-5 of their largest magnitude."""
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(5))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    rng = np.random.default_rng(5)
    S = 64 if cfg.is_moe else 40
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, S)).astype(
        np.int32)}
    if cfg.prefix_len:
        batch["prefix_embeds"] = rng.normal(
            size=(2, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = M.forward(model, cfg.with_overrides(seq_parallel=True), tb)[0]
    assert torch.equal(got, M.forward(model, cfg, tb)[0])
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    with jax.set_mesh(mesh):
        want = JM.forward(jp, jcfg.with_overrides(seq_parallel=True),
                          {k: jnp.asarray(v) for k, v in batch.items()})[0]
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=RTOL * float(np.abs(want).max()))
