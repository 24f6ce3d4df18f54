"""The port's input shapes (`repro_torch.configs.shapes`) against the JAX
reference's (`repro.configs.shapes`), on the CPU.

For every architecture and each of the four shapes: the resolved config
(long_500k's window variant, the pairs skipped), the step kind, and every
stand-in's shape and dtype, the decode state's caches included. The
reference's stand-ins are ShapeDtypeStructs and its serve state stacks
the layers along leading dims; the port's are meta tensors, one cache per
layer in a list (a hybrid's SSM caches as groups x every in order). The
check is exact: shapes and dtypes equal, nothing allocated.
"""
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.configs import shapes as jax_shapes

from repro_torch.configs import SHAPES, get_config, input_specs, list_archs
from repro_torch.configs import long_context_mode
from repro_torch.configs import shapes

DTYPES = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _same(got: torch.Tensor, want, where: str):
    assert got.device.type == "meta", where
    assert tuple(got.shape) == tuple(want.shape), where
    assert got.dtype == DTYPES[jnp.dtype(want.dtype)], where


def _same_state(cfg, got: dict, want: dict, where: str):
    """The port's per-layer caches against the reference's stacks."""
    assert set(got) == set(want), where
    for key, stack in want.items():
        lead = 2 if key == "ssm" and cfg.arch_type == "hybrid" else 1
        caches = got[key]
        if hasattr(stack, "_fields"):
            assert all(type(c).__name__ == type(stack).__name__
                       for c in caches), where
            pairs = [(f, getattr(stack, f)) for f in stack._fields]
        else:
            pairs = [(None, stack)]
        for field, leaf in pairs:
            assert len(caches) == math.prod(leaf.shape[:lead]), where
            for c in caches:
                _same(c if field is None else getattr(c, field),
                      jax.ShapeDtypeStruct(leaf.shape[lead:], leaf.dtype),
                      f"{where} {key}.{field}")


def test_shape_table_is_the_reference_table():
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, spec in SHAPES.items():
        want = JAX_SHAPES[name]
        assert (spec.name, spec.seq_len, spec.global_batch, spec.kind) == (
            want.name, want.seq_len, want.global_batch, want.kind)
    assert shapes.LONG_WINDOW == jax_shapes.LONG_WINDOW
    assert shapes.AUDIO_DECODE_ENC_LEN == jax_shapes.AUDIO_DECODE_ENC_LEN


@pytest.mark.parametrize("arch", list_archs())
def test_long_context_mode_and_cache_len_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert long_context_mode(cfg) == jax_shapes.long_context_mode(jcfg)
    for S in (1, 4096, 32768, 524288):
        assert shapes.cache_len_for(cfg, S) == jax_shapes.cache_len_for(jcfg,
                                                                        S)
    for name in SHAPES:
        got, want = shapes.resolve(cfg, name), jax_shapes.resolve(jcfg, name)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.sliding_window == want.sliding_window


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_the_reference(arch, shape_name):
    """Kinds, skips, every stand-in's shape and dtype, the decode state's
    caches; the port's are meta tensors (decode_32k's 128 x 32768 caches
    allocate nothing)."""
    rcfg, kind, specs = input_specs(get_config(arch), shape_name)
    jrcfg, jkind, jspecs = jax_input_specs(jax_get_config(arch), shape_name)
    if jrcfg is None:
        assert (rcfg, kind, specs) == (None, None, None)
        return
    assert kind == jkind
    assert rcfg.sliding_window == jrcfg.sliding_window
    assert set(specs) == set(jspecs)
    where = f"{arch} {shape_name}"
    for key, want in jspecs.items():
        if key == "state":
            _same_state(rcfg, specs[key], want, where)
        else:
            _same(specs[key], want, f"{where} {key}")


@pytest.mark.parametrize("arch", ["internvl2-1b", "seamless-m4t-medium",
                                  "qwen3-1.7b"])
def test_token_specs_split_the_sequence_as_the_reference(arch):
    """The VLM's prefix rows before the text, the enc-dec model's frames
    and tokens: the split phase 27 of chip_smoke.py trains on."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for B, S, labels in ((2, 4096, True), (3, 1001, False)):
        got = shapes._token_specs(cfg, B, S, labels)
        want = jax_shapes._token_specs(jcfg, B, S, labels)
        assert list(got) == list(want)
        for key in want:
            _same(got[key], want[key], f"{arch} {B} {S} {key}")
