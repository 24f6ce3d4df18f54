"""The port's roofline and flop counts (`repro_torch.launch.analysis`)
against the JAX reference's (`repro.launch.analysis`), on the CPU.

`collective_bytes` is the reference's parser: the same bytes on the HLO
snippets of the reference's own tests (tests/test_hlo_analyzer.py) and on
a few lines here. `roofline` gives the reference's terms once its
constants are set to the reference's (the port's are the H100's);
`count_params`, `active_params` and `model_flops` count over the port's
per-layer parameter dicts what the reference counts over its stacked
trees, for every architecture, exactly.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import analysis as jax_analysis
from repro.models import model as JM

from repro_torch.configs import get_config, list_archs
from repro_torch.launch import analysis
from repro_torch.models import model as M

ROOT = Path(__file__).resolve().parent


def _reference_snippets() -> dict[str, str]:
    spec = importlib.util.spec_from_file_location(
        "reference_hlo_tests", ROOT / "test_hlo_analyzer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {k: v for k, v in vars(mod).items()
            if k.startswith("HLO_") and isinstance(v, str)}


EXTRA_HLO = {
    "start_and_tuple": """\
  %ag = f32[8,128]{1,0} all-gather-start(f32[2,128]{1,0} %x), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = (bf16[4,4]{1,0}, f32[3]{0}) all-reduce(bf16[4,4]{1,0} %a, f32[3]{0} %b), replica_groups={}, to_apply=%sum
  %cp = s32[16]{0} collective-permute(s32[16]{0} %c), source_target_pairs={{0,1},{1,0}}
  %rs = f32[2]{0} reduce-scatter(f32[8]{0} %d), dimensions={0}
  %a2a = u8[64]{0} all-to-all(u8[64]{0} %e), replica_groups={{0,1}}
  %dot = f32[8,8]{1,0} dot(f32[8,4]{1,0} %p, f32[4,8]{1,0} %q)
""",
    "scalars_and_layouts": """\
  %s = f32[] all-reduce(f32[] %z), to_apply=%sum
  %t = pred[7]{0} all-gather(pred[7]{0} %m), dimensions={0}, metadata={op_name="f32[1000]"}
""",
}


@pytest.mark.parametrize("name", sorted(_reference_snippets()) +
                         sorted(EXTRA_HLO))
def test_collective_bytes_match_the_reference(name):
    text = _reference_snippets().get(name) or EXTRA_HLO[name]
    got = analysis.collective_bytes(text)
    assert got == jax_analysis.collective_bytes(text)
    if name in EXTRA_HLO:
        assert sum(got.values()) > 0


def test_the_h100_figures():
    """NVIDIA's H100 SXM5 data-sheet peaks, the ones chip_smoke.py bounds
    with; NVLink 4's 18 links at 25 GB/s each way."""
    assert analysis.PEAK_FLOPS[torch.float32] == 67e12
    assert analysis.PEAK_FLOPS["tf32"] == 494.7e12
    assert analysis.PEAK_FLOPS[torch.bfloat16] == 989e12
    assert analysis.HBM_BW == 3.35e12
    assert analysis.NVLINK_BW == 18 * 25e9 == 450e9


@pytest.mark.parametrize("cost,coll", [
    ({"flops": 3.2e15, "bytes accessed": 1.1e12},
     {"all-reduce": 4 << 30, "all-gather": 1 << 20}),
    ({"flops": 1.0e9, "bytes accessed": 8.0e11}, {"all-to-all": 0}),
    ({"flops": 2.0e10, "bytes accessed": 1.0e6},
     {"collective-permute": 3 << 33}),
    ({}, {})])
def test_roofline_terms_equal_once_the_constants_agree(monkeypatch, cost,
                                                       coll):
    monkeypatch.setitem(analysis.PEAK_FLOPS, torch.bfloat16,
                        jax_analysis.PEAK_FLOPS)
    monkeypatch.setattr(analysis, "HBM_BW", jax_analysis.HBM_BW)
    monkeypatch.setattr(analysis, "NVLINK_BW", jax_analysis.ICI_BW)
    assert analysis.roofline(cost, coll) == jax_analysis.roofline(cost, coll)


def test_roofline_takes_the_peak_of_the_dtype():
    cost = {"flops": 67e12, "bytes accessed": 0.0}
    fp32 = analysis.roofline(cost, {}, dtype=torch.float32)
    assert fp32["compute_s"] == 1.0 and fp32["dominant"] == "compute"
    bf16 = analysis.roofline(cost, {})
    assert bf16["compute_s"] == 67e12 / 989e12
    coll = analysis.roofline({}, {"all-reduce": 450e9})
    assert coll["collective_s"] == 1.0 and coll["dominant"] == "collective"


@pytest.mark.parametrize("arch", list_archs())
def test_counts_and_model_flops_match_the_reference(arch):
    """Every parameter, the active ones (MoE: top_k of the routed experts
    and every shared one), and model flops for each step kind."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    shapes, jshapes = M.param_shapes(cfg), JM.param_shapes(jcfg)
    assert all(t.device.type == "meta" for t in shapes.values())
    n = analysis.count_params(shapes)
    assert n == jax_analysis.count_params(jshapes)
    active = analysis.active_params(cfg, shapes)
    assert active == jax_analysis.active_params(jcfg, jshapes)
    assert (active < n) == cfg.is_moe
    for kind in ("train", "prefill", "decode"):
        for B, S in ((256, 4096), (2, 4096), (1, 524288)):
            assert analysis.model_flops(cfg, kind, B, S, active) == \
                jax_analysis.model_flops(jcfg, kind, B, S, active)


@pytest.mark.parametrize("args", [(1e15, 8, 6e15), (2.5e12, 1, 1e12),
                                  (0.0, 4, 1e9)])
def test_efficiency_matches_the_reference(args):
    assert analysis.efficiency(*args) == jax_analysis.efficiency(*args)
