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


# Dh != Dv (MLA): (B, H, KV, Sq, Sk, Dh, Dv) at deepseek-v2-lite's and
# minicpm3-4b's training and prefill shapes, and the reduced models' heads
MLA_SHAPES = [(8, 16, 16, 64, 64, 192, 128), (2, 16, 16, 4096, 4096, 192, 128),
              (8, 40, 40, 64, 64, 96, 64), (2, 40, 40, 4096, 4096, 96, 64),
              (2, 4, 4, 96, 96, 48, 32), (2, 40, 40, 300, 300, 96, 64),
              (2, 4, 4, 77, 77, 48, 32)]


def mla_plan(B, H, KV, Sq, Sk, Dh, Dv, **card):
    card = dict(sm_count=SMS, smem_per_block=SMEM) | card
    return k7.attention_bwd_plan(B, H, KV, Sq, Sk, Dh, Dv=Dv, **card)


@pytest.mark.parametrize("pair", list(k7.PAIR_INSTANCES), ids=str)
def test_pair_instances_tile_the_steps_and_fit(pair):
    """Each width pair's instances: 32 or 64 streamed rows a step, 4 or 8
    warps, largest first, and the shared memory of both passes, 4 x (BR x
    (ST_h + ST_v) + 2 x BC x (ST_h + ST_v) + L and delta) bytes, within a
    block's opt-in maximum."""
    wh, wv = pair
    assert wh > wv
    rows = []
    for rw, cw, ns in k7.PAIR_INSTANCES[pair]:
        assert 8 * ns * cw in (32, 64) and rw * cw in (4, 8)
        br, bc, st = 16 * rw, 8 * ns * cw, (wh + 4) + (wv + 4)
        for kvp in (True, False):
            smem = k7.pass_smem_bytes(wh, rw, cw, ns, kvp, width_v=wv)
            assert smem == 4 * (br * st + 2 * bc * st +
                                (4 * bc if kvp else 2 * br))
            assert smem <= SMEM
        rows.append(br)
    assert rows == sorted(rows, reverse=True)


def test_the_64_row_64_step_tile_does_not_fit_deepseeks_widths():
    """At (256, 128) the (4, 2, 4) block would need ~302 KB, so the table
    streams 32 rows a step at 64-row tiles there."""
    assert k7.pass_smem_bytes(256, 4, 2, 4, True, width_v=128) > SMEM
    assert (4, 2, 4) not in k7.PAIR_INSTANCES[(256, 128)]
    assert k7.PAIR_INSTANCES[(256, 128)][0] == (4, 2, 2)


def test_pair_instances_are_the_ones_the_source_builds():
    cases = re.findall(r"K7_PAIR\((\d+), (\d+), (\d+), (\d+), (\d+)\)",
                       SOURCE.read_text())
    built = {}
    for wh, wv, rw, cw, ns in cases:
        built.setdefault((int(wh), int(wv)), []).append(
            (int(rw), int(cw), int(ns)))
    assert built == {w: list(v) for w, v in k7.PAIR_INSTANCES.items()}


@pytest.mark.parametrize("shape", MLA_SHAPES, ids=str)
def test_mla_plans_fit_and_cover_every_row_once(shape):
    B, H, KV, Sq, Sk, Dh, Dv = shape
    p = mla_plan(*shape)
    wh, wv = k7.head_dim_width(Dh), k7.head_dim_width(Dv)
    assert (p.width, p.width_v) == (wh, wv) and p.columns == min(wh, 128)
    for kvp, pp, rows, heads in ((True, p.kv, Sk, KV), (False, p.q, Sq, H)):
        assert pp.instance in k7.instances(wh, wv)
        assert pp.smem == k7.pass_smem_bytes(wh, *pp.instance, kvp,
                                             width_v=wv) <= SMEM
        assert SMEM_PER_SM // (pp.smem + RESERVED) >= 1
        assert pp.grid[0] * pp.rows >= rows > (pp.grid[0] - 1) * pp.rows
        assert pp.grid[1] == B * heads
        # at Dh's width 256 both outputs split into two column blocks
        assert pp.grid[2] == (2 if wh == 256 else 1)
    if Sq >= 4096:
        assert p.kv.blocks >= SMS and p.q.blocks >= SMS
        assert p.kv.rows == 64 and p.q.rows == 64


@pytest.mark.parametrize("dh,dv", [(192, 128), (96, 64), (48, 32), (24, 16),
                                   (128, 64), (256, 128), (100, 100)])
def test_built_width_pairs_pass_the_operand_check(dh, dv):
    q, k = torch.zeros(1, 4, 2, dh), torch.zeros(1, 4, 2, dh)
    k7.check_operands(q, k, torch.zeros(1, 4, 2, dv))
    p = mla_plan(1, 2, 2, 4, 4, dh, dv)
    assert (p.width, p.width_v) == (k7.head_dim_width(dh),
                                    k7.head_dim_width(dv))


@pytest.mark.parametrize("dh,dv", [(32, 128), (64, 65), (192, 64), (256, 1)])
def test_unbuilt_width_pairs_raise_naming_the_roadmap(dh, dv):
    q, k, v = (torch.zeros(1, 4, 2, d) for d in (dh, dh, dv))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        k7.check_operands(q, k, v)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        mla_plan(1, 2, 2, 4, 4, dh, dv)


def test_operand_check_raises_for_bf16_and_bad_head_dims():
    q = torch.zeros(1, 4, 2, 48)
    v = torch.zeros(1, 4, 2, 32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        k7.check_operands(q.bfloat16(), q.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError, match="head dim"):
        k7.check_operands(q, torch.zeros(1, 4, 2, 40), v)
    with pytest.raises(ValueError, match="head dim"):
        k7.check_operands(q, q, torch.zeros(1, 4, 2, 257))
