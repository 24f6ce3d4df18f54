"""K7's launch plan (`flash_attention_bwd.attention_bwd_plan`), a pure
function of the shapes and the card's figures, checked on the CPU at an
H100's: 132 SMs, 227 KB (232 448 bytes) of shared memory per block."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_bwd as k7

torch.set_num_threads(2)

SMS = 132
SMEM = 232448
SMEM_PER_SM = 233472            # 228 KB an SM shares among its blocks
RESERVED = 1024                 # the runtime's share of each block
TRAINING = (8, 16, 8, 64, 64, 128)
PREFILL = (2, 16, 8, 4096, 4096, 128)
SOURCE = (Path(k7.__file__).resolve().parents[2] / "csrc" /
          "flash_attention_bwd.cu")


def plan(B, H, KV, Sq, Sk, D):
    return k7.attention_bwd_plan(B, H, KV, Sq, Sk, D, sm_count=SMS,
                                 smem_per_block=SMEM)


@pytest.mark.parametrize("lo,hi", [(1, 64), (65, 128), (129, 256)])
def test_every_head_dim_maps_to_a_built_instance(lo, hi):
    width = {1: 64, 65: 128, 129: 256}[lo]
    for D in range(lo, hi + 1):
        assert k7.head_dim_width(D) == width
        p = plan(2, 4, 2, 100, 100, D)
        assert p.width == width and p.columns == min(width, 128)
        for pp in (p.kv, p.q):
            assert (pp.rw, pp.cw, pp.ns) in k7.INSTANCES[width]
            assert pp.grid[2] * p.columns == width


@pytest.mark.parametrize("D", [0, 257])
def test_head_dims_past_the_instances_raise(D):
    with pytest.raises(ValueError, match="head dim"):
        plan(1, 2, 2, 16, 16, D)


@pytest.mark.parametrize("shape", [TRAINING, PREFILL, (1, 2, 2, 130, 130, 256),
                                   (2, 2, 1, 100, 100, 40),
                                   (1, 8, 1, 200, 200, 128),
                                   (1, 2, 2, 90, 40, 64),
                                   (1, 1, 1, 1, 1, 1),
                                   (4, 32, 8, 8192, 8192, 256)], ids=str)
def test_every_plan_fits_the_shared_memory(shape):
    p = plan(*shape)
    for kvp, pp in ((True, p.kv), (False, p.q)):
        assert pp.smem == k7.pass_smem_bytes(p.width, pp.rw, pp.cw, pp.ns,
                                             kvp)
        assert pp.smem <= SMEM
        assert SMEM_PER_SM // (pp.smem + RESERVED) >= 1
        assert pp.warps * 32 <= 1024


@pytest.mark.parametrize("shape", [TRAINING, PREFILL, (3, 16, 8, 77, 77, 128),
                                   (2, 16, 8, 1000, 1000, 128)], ids=str)
def test_grids_cover_every_row_once(shape):
    B, H, KV, Sq, Sk, D = shape
    p = plan(*shape)
    for pp, rows, heads in ((p.kv, Sk, KV), (p.q, Sq, H)):
        assert pp.grid[0] * pp.rows >= rows > (pp.grid[0] - 1) * pp.rows
        assert pp.grid[1] == B * heads


def test_training_shape_grids_cover_the_sms():
    p = plan(*TRAINING)
    assert p.kv.blocks >= SMS and p.q.blocks >= SMS
    # short sequences take 16- or 32-row tiles
    assert p.kv.rows in (16, 32) and p.q.rows in (16, 32)


def test_prefill_plan_keeps_a_block_on_every_sm():
    p = plan(*PREFILL)
    for pp in (p.kv, p.q):
        assert pp.blocks >= SMS
        assert SMEM_PER_SM // (pp.smem + RESERVED) >= 1
    # long sequences take the largest stationary tile
    assert p.kv.rows == 64 and p.q.rows == 64


@pytest.mark.parametrize("width", [64, 128, 256])
def test_instances_tile_the_steps_and_fit(width):
    """64 streamed rows a step at 64-row tiles (8 warps of 4 n8 tiles), 32
    at 16- and 32-row tiles; every instance fits one block, largest first."""
    rows = []
    for rw, cw, ns in k7.INSTANCES[width]:
        assert 8 * ns * cw == (64 if rw == 4 else 32)
        assert rw * cw in (4, 8)
        for kvp in (True, False):
            assert k7.pass_smem_bytes(width, rw, cw, ns, kvp) <= SMEM
        rows.append(16 * rw)
    assert rows == sorted(rows, reverse=True)


def test_instances_are_the_ones_the_source_builds():
    cases = re.findall(r"K7_CASE\((\d+), (\d+), (\d+), (\d+)\)",
                       SOURCE.read_text())
    built = {}
    for dp, rw, cw, ns in cases:
        built.setdefault(int(dp), []).append((int(rw), int(cw), int(ns)))
    assert built == {w: list(v) for w, v in k7.INSTANCES.items()}


def test_a_small_card_takes_smaller_tiles_or_raises():
    p = k7.attention_bwd_plan(*PREFILL, sm_count=SMS, smem_per_block=140000)
    assert p.kv.rows == 32 and p.kv.smem <= 140000
    assert p.q.rows == 32 and p.q.smem <= 140000
    with pytest.raises(ValueError, match="shared memory"):
        k7.attention_bwd_plan(*PREFILL, sm_count=SMS, smem_per_block=64 * 1024)


def test_plan_args_follow_the_c_entry():
    p = plan(*PREFILL)
    assert p.args() == (p.kv.rw, p.kv.cw, p.kv.ns, p.q.rw, p.q.cw, p.q.ns)


@pytest.mark.parametrize("bad", [dict(KV=3), dict(B=0), dict(Sk=-1)])
def test_bad_shapes_raise(bad):
    shape = dict(B=1, H=4, KV=2, Sq=16, Sk=16, D=64) | bad
    with pytest.raises(ValueError):
        k7.attention_bwd_plan(**shape, sm_count=SMS, smem_per_block=SMEM)
