"""The port's capability table (`repro_torch.api.capabilities`) against the
reference's (`repro.api.capabilities`), on the CPU.

The reference's rules are copied word for word: every trigger of the
reference's `tests/test_capabilities.py` goes through both packages' real
entry points (config construction, fit, fit_stream, sweep) and must raise
the same ValueError text. Every combination the reference admits runs in
the port, on a mesh too: the two rows the port once held back (a mesh
under gossip, a mesh with personalization) run against the reference's
unsharded fit. The port's README matrix block must be in sync with its
table (the reference's block is pinned by the reference's test).
"""
import pathlib

import pytest
import torch

from repro.api import Censor as JCensor
from repro.api import Chain as JChain
from repro.api import ChurnSchedule as JChurnSchedule
from repro.api import FitConfig as JFitConfig
from repro.api import Personalization as JPersonalization
from repro.api import TopologySchedule as JTopologySchedule
from repro.api import capabilities as jcap
from repro.api.registry import get_solver as jax_get_solver
from repro.api.registry import list_solvers as jax_list_solvers

from repro_torch.api import (Censor, Chain, ChurnSchedule, FitConfig,
                             Personalization, fit, fit_stream, sweep)
from repro_torch.api import capabilities as cap
from repro_torch.api.registry import get_solver, list_solvers
from repro_torch.core.graph import TopologySchedule

torch.set_num_threads(2)

#: each package's probe objects
OBJS = {
    "ref": dict(topo=JTopologySchedule.circulant_cycle(8, [(1,)]),
                churn=JChurnSchedule(leave=((2, 0),)),
                pz=JPersonalization(), comm=JChain((JCensor(0.3, 0.97),))),
    "port": dict(topo=TopologySchedule.circulant_cycle(8, [(1,)]),
                 churn=ChurnSchedule(leave=((2, 0),)),
                 pz=Personalization(), comm=Chain((Censor(0.3, 0.97),))),
}

#: rule id -> (driver mode, FitConfig knobs naming probe objects by key):
#: the reference's TRIGGERS (tests/test_capabilities.py)
TRIGGERS = {
    "sync-gossip-knobs": ("config", dict(participation=0.5)),
    "comm-censor-knobs": ("config", dict(comm="comm", censor_v=0.3)),
    "personalization-topology": ("config", dict(personalization="pz",
                                                topology="topo")),
    "personalization-churn": ("config", dict(exec="gossip",
                                             personalization="pz",
                                             churn="churn")),
    "solver-backend": ("batch", dict(algorithm="ridge_oracle",
                                     backend="spmd")),
    "comm-unaware-solver": ("batch", dict(algorithm="cta", comm="comm")),
    "topology-unaware-solver": ("batch", dict(algorithm="cta",
                                              topology="topo")),
    "primal-unaware-solver": ("batch", dict(algorithm="ridge_oracle",
                                            primal="cg")),
    "gossip-unaware-solver": ("batch", dict(algorithm="cta",
                                            exec="gossip")),
    "gossip-topology": ("batch", dict(algorithm="coke", exec="gossip",
                                      topology="topo")),
    "churn-fused": ("batch", dict(algorithm="coke", exec="gossip",
                                  churn="churn", backend="fused")),
    "churn-cholesky": ("batch", dict(algorithm="coke", exec="gossip",
                                     churn="churn", primal="cholesky")),
    "personalization-unaware-solver": ("batch", dict(
        algorithm="cta", personalization="pz")),
    "personalization-fused": ("batch", dict(algorithm="coke",
                                            personalization="pz",
                                            backend="fused")),
    "personalization-cholesky": ("batch", dict(algorithm="coke",
                                               personalization="pz",
                                               primal="cholesky")),
    "stream-batch-solver": ("stream", dict(algorithm="coke")),
    "stream-backend": ("stream", dict(algorithm="online_coke",
                                      backend="fused")),
    "stream-topology": ("stream", dict(algorithm="online_coke",
                                       topology="topo")),
    "sweep-streaming": ("sweep", dict(algorithm="online_coke")),
    "sweep-backend": ("sweep", dict(algorithm="coke", backend="spmd")),
}

#: the rows the port held back until a mesh ran under gossip and
#: personalization: id -> FitConfig knobs (coke, CG, on spmd)
FORMERLY_NOT_PORTED = {
    "mesh-gossip": dict(exec="gossip", participation=0.5),
    "mesh-personalization": dict(personalization="pz"),
}


def _config(side, knobs):
    objs = OBJS[side]
    kw = {k: objs[v] if isinstance(v, str) and v in objs
          and k in ("comm", "topology", "churn", "personalization") else v
          for k, v in knobs.items()}
    return (JFitConfig if side == "ref" else FitConfig)(**kw)


def _ref_call(mode, knobs):
    config = _config("ref", knobs)
    if mode == "config":
        return
    check = {"batch": jcap.check_fit, "stream": jcap.check_stream,
             "sweep": jcap.check_sweep}[mode]
    check(config, jax_get_solver(config.algorithm))


def _port_call(mode, knobs, **fit_kw):
    """The port's real entry points: fit / fit_stream / sweep admit before
    they touch a problem (fit_stream and sweep before they resolve their
    device, so these run without a card)."""
    config = _config("port", knobs)
    if mode == "config":
        return
    if mode == "batch":
        fit(config, device="cpu", **fit_kw)
    elif mode == "stream":
        fit_stream(config)
    else:
        sweep(config)


def test_the_reference_rules_are_copied_word_for_word():
    for ours, theirs in ((cap.CONFIG_RULES, jcap.CONFIG_RULES),
                         (cap.RUN_RULES, jcap.RUN_RULES)):
        assert [(r.id, r.when, r.reason, r.alternative) for r in ours] == \
            [(r.id, r.when, r.reason, r.alternative) for r in theirs]


def test_every_rule_has_a_trigger():
    ids = {r.id for r in jcap.CONFIG_RULES + jcap.RUN_RULES}
    assert set(TRIGGERS) == ids
    assert not hasattr(cap, "NOT_PORTED")


@pytest.mark.parametrize("rule_id", sorted(TRIGGERS))
def test_reference_rule_raises_the_same_value_error(rule_id):
    """Each trigger fires its own rule in both packages, with the same
    text: ValueError rules come before the port's NOT_PORTED rows."""
    mode, knobs = TRIGGERS[rule_id]
    with pytest.raises(ValueError) as ref_err:
        _ref_call(mode, knobs)
    with pytest.raises(ValueError) as port_err:
        _port_call(mode, knobs)
    assert str(port_err.value) == str(ref_err.value)
    rule = {r.id: r for r in cap.CONFIG_RULES + cap.RUN_RULES}[rule_id]
    assert rule.alternative in str(port_err.value)


@pytest.mark.parametrize("rule_id", sorted(FORMERLY_NOT_PORTED))
def test_formerly_not_ported_row_runs_on_a_mesh(rule_id):
    """The reference admits each of these and the port now runs it on a
    (2, 4) mesh. The reference's own sharded run cannot run on this jax
    (ROADMAP.md, tests/test_torch_mesh_gossip.py), so the port is held to
    the reference's unsharded fit of the same problem: comms and bits
    exact, theta within 1e-4 (CG), or 1e-3 relative and the learned
    graph's support equal under personalization."""
    import numpy as np
    from repro.api import KRRConfig as JKRRConfig
    from repro.api import build_problem as jax_build_problem
    from repro.api import fit as jax_fit

    from repro_torch import convert
    from repro_torch.api import KRRConfig
    from repro_torch.launch.mesh import make_host_mesh

    krr = dict(num_agents=8, samples_per_agent=12, num_features=16,
               lam=1e-3, rho=0.1, seed=0)
    knobs = dict(algorithm="coke", backend="spmd", graph="ring",
                 num_iters=20, primal="cg", **FORMERLY_NOT_PORTED[rule_id])
    jcfg = _config("ref", dict(knobs, krr=JKRRConfig(**krr)))
    tcfg = _config("port", dict(knobs, krr=KRRConfig(**krr)))
    jp = jax_build_problem(jcfg).problem
    ref = jax_fit(jcfg, problem=jp)
    port = fit(tcfg, problem=convert.problem_from_numpy(
        np.asarray(jp.feats), np.asarray(jp.labels),
        np.asarray(jp.adjacency), jp.lam, jp.rho, device="cpu"),
        device="cpu", mesh=make_host_mesh(2, 4, device="cpu"))
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(port.history[k].numpy(),
                                      np.asarray(ref.history[k]))
    want = np.asarray(ref.theta)
    if tcfg.personalization is None:
        np.testing.assert_allclose(port.theta.numpy(), want, rtol=0,
                                   atol=1e-4)
    else:
        np.testing.assert_array_equal(port.learned_adjacency.numpy() > 0,
                                      np.asarray(ref.learned_adjacency) > 0)
        np.testing.assert_allclose(port.theta.numpy(), want, rtol=0,
                                   atol=1e-3 * max(1.0, np.abs(want).max()))


def tuple_or(value):
    return tuple(value) if isinstance(value, (tuple, list)) else value


def test_registry_specs_carry_the_reference_flags():
    flags = ("backends", "stream_backends", "comm_aware", "topology_aware",
             "primal_aware", "gossip_aware", "personalization_aware",
             "streaming")
    assert list_solvers() == sorted(jax_list_solvers())
    for name in list_solvers():
        ours, theirs = get_solver(name), jax_get_solver(name)
        for f in flags:
            empty = () if f.endswith("backends") else False
            assert tuple_or(getattr(ours, f, empty)) == tuple_or(
                getattr(theirs, f, empty)), (name, f)


def test_supported_cells_admit():
    """The ✅ cells through the same entry points: a schedule on the
    batch ADMM solvers; gossip on every backend, churn off the fused one;
    gossip streams and sweeps."""
    topo = OBJS["port"]["topo"]
    churn = OBJS["port"]["churn"]
    for backend in ("simulator", "spmd", "fused"):
        cap.check_fit(FitConfig(algorithm="coke", backend=backend,
                                topology=topo), get_solver("coke"))
        cap.check_fit(FitConfig(algorithm="dkla", backend=backend,
                                exec="gossip", participation=0.5),
                      get_solver("dkla"))
    for backend in ("simulator", "spmd"):
        cap.check_fit(FitConfig(algorithm="coke", backend=backend,
                                exec="gossip", churn=churn),
                      get_solver("coke"))
        cap.check_stream(FitConfig(algorithm="qc_odkla", backend=backend,
                                   exec="gossip", churn=churn),
                         get_solver("qc_odkla"))
    cap.check_sweep(FitConfig(algorithm="coke", exec="gossip",
                              participation=0.5), get_solver("coke"))
    pz = OBJS["port"]["pz"]
    for backend in ("simulator", "spmd"):
        for exec_ in ("sync", "gossip"):
            cap.check_fit(FitConfig(algorithm="dkla", backend=backend,
                                    exec=exec_, personalization=pz),
                          get_solver("dkla"))
            cap.check_stream(FitConfig(algorithm="online_coke",
                                       backend=backend, exec=exec_,
                                       personalization=pz),
                             get_solver("online_coke"))
    cap.check_sweep(FitConfig(algorithm="coke", personalization=pz),
                    get_solver("coke"))


def test_gossip_cell_runs_like_the_reference():
    """The row NOT_PORTED held for gossip (dkla on spmd at participation
    0.5) now runs: the reference's problem through both packages' fit,
    comms and bits exactly equal, theta within 1e-5."""
    import numpy as np
    from repro.api import KRRConfig as JKRRConfig
    from repro.api import build_problem as jax_build_problem
    from repro.api import fit as jax_fit

    from repro_torch import convert
    from repro_torch.api import KRRConfig

    krr = dict(num_agents=8, samples_per_agent=12, num_features=16,
               lam=1e-3, rho=0.1, seed=0)
    knobs = dict(algorithm="dkla", exec="gossip", participation=0.5,
                 backend="spmd", graph="ring", num_iters=20)
    jcfg = JFitConfig(krr=JKRRConfig(**krr), **knobs)
    jp = jax_build_problem(jcfg).problem
    ref = jax_fit(jcfg, problem=jp)
    port = fit(FitConfig(krr=KRRConfig(**krr), **knobs),
               problem=convert.problem_from_numpy(
                   np.asarray(jp.feats), np.asarray(jp.labels),
                   np.asarray(jp.adjacency), jp.lam, jp.rho, device="cpu"),
               device="cpu")
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(port.history[k].numpy(),
                                      np.asarray(ref.history[k]))
    np.testing.assert_allclose(port.theta.numpy(), np.asarray(ref.theta),
                               atol=1e-5, rtol=0)


def test_personalization_cell_runs_like_the_reference():
    """The row NOT_PORTED held for personalization (coke on spmd, here with
    a live learned graph) now runs: the reference's problem through both
    packages' fit, comms and bits exactly equal, the learned graph's
    support equal, theta within 1e-3 relative (the reference's own
    tolerance between two personalized runs)."""
    import numpy as np
    from repro.api import KRRConfig as JKRRConfig
    from repro.api import build_problem as jax_build_problem
    from repro.api import fit as jax_fit

    from repro_torch import convert
    from repro_torch.api import KRRConfig

    krr = dict(num_agents=8, samples_per_agent=12, num_features=16,
               lam=1e-3, rho=0.1, seed=0)
    knobs = dict(algorithm="coke", backend="spmd", graph="ring",
                 num_iters=20, primal="cg")
    jcfg = JFitConfig(krr=JKRRConfig(**krr), **knobs,
                      personalization=JPersonalization(k=2, every=3,
                                                       warmup=5))
    jp = jax_build_problem(jcfg).problem
    ref = jax_fit(jcfg, problem=jp)
    port = fit(FitConfig(krr=KRRConfig(**krr), **knobs,
                         personalization=Personalization(k=2, every=3,
                                                         warmup=5)),
               problem=convert.problem_from_numpy(
                   np.asarray(jp.feats), np.asarray(jp.labels),
                   np.asarray(jp.adjacency), jp.lam, jp.rho, device="cpu"),
               device="cpu")
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(port.history[k].numpy(),
                                      np.asarray(ref.history[k]))
    np.testing.assert_array_equal(port.learned_adjacency.numpy() > 0,
                                  np.asarray(ref.learned_adjacency) > 0)
    want = np.asarray(ref.theta)
    np.testing.assert_allclose(port.theta.numpy(), want, rtol=0,
                               atol=1e-3 * max(1.0, np.abs(want).max()))


def test_port_matrix_marks_follow_the_reference_matrix():
    """Where the reference's matrix has ✅ the port's has ✅; where the
    reference's has — the port's has — too."""
    def rows(text):
        out = {}
        for line in text.splitlines():
            if line.startswith("| `"):
                cells = [c.strip() for c in line.strip("|").split("|")]
                out[(cells[0], cells[1])] = cells[2:]
        return out

    ours, theirs = rows(cap.support_matrix()), rows(jcap.support_matrix())
    assert set(ours) == set(theirs)
    for key, cells in theirs.items():
        for mine, ref in zip(ours[key], cells):
            if ref == "—":
                assert mine == "—", key
            else:
                assert mine == "✅", key


def test_readme_port_matrix_in_sync():
    """The README's port block equals the generated matrix; regenerate
    with `PYTHONPATH=src python -m repro_torch.api.capabilities`."""
    readme = pathlib.Path(__file__).resolve().parents[1] / "README.md"
    text = readme.read_text()
    start = text.index(cap.BEGIN_MARK)
    end = text.index(cap.END_MARK) + len(cap.END_MARK)
    assert text[start:end] == cap.support_matrix()
