"""A mesh across ranks in the port (`make_host_mesh(..., group=)`: the
blocked layout with each rank holding its own cells' blocks, the
collectives over `torch.distributed`) on the CPU, against the one-process
mesh and the reference.

Each split of the (2, 4) mesh runs in one spawn of W gloo ranks over a
FileStore (a group timeout of two minutes; one thread a rank): W = 2 cut
over the batch axis (2, 1) and over the model axis (1, 2), and W = 4 cut
(2, 2). Every rank runs every case (SPMD) and writes what it got to a
file; the parent holds each rank's results BITWISE to the one-process run
of the same mesh (the layer folds gathered partials over all blocks in
ascending order whatever the split, and its products are one batched
product of the rank's blocks whose bits do not depend on how many it
holds), and the one-process run to the reference's unsharded run within
tests/test_torch_sharding.py's and tests/test_torch_mesh_gossip.py's
tolerances: comms and bits exact, theta within 1e-5 (CG under gossip
1e-4, a personalized fit 1e-3 relative).

The cases: COKE on the simulator (Cholesky, CG), spmd (CG) and fused (K3's
plain version, once per block a rank holds); a Chain([Censor, Quantize(8),
Drop(0.05)]) fit; gossip at participation 0.5; a personalized fit; a fit
whose problem every rank builds from the seed; `KernelModel.shard(mesh)
.predict`; and per-agent gradient clipping (item 14d) in
`consensus_update` (serving on such a mesh is
tests/test_torch_serve_ranks.py). The runs are cut to 8
iterations and 8 CG steps (the reference's runs too): every CG step psums
four times, and a gloo gather between processes on one host costs about a
millisecond.
"""
import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import repro_torch.api as tapi
from repro_torch import convert
from repro_torch.api import FitConfig, KRRConfig, Personalization, fit
from repro_torch.distributed import consensus as port_cns
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import optimizers as port_opt

CPU = "cpu"
MESH = (2, 4)
SPLITS = {"W2-batch": (2, 1), "W2-model": (1, 2), "W4": (2, 2)}
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
TOL = 1e-5         # tests/test_torch_sharding.py
CG_TOL = 1e-4      # tests/test_torch_mesh_gossip.py, CG under gossip
PZ_RTOL = 1e-3     # tests/test_torch_mesh_gossip.py, a personalized theta

KRR = dict(num_agents=4, samples_per_agent=40, num_features=64, lam=1e-2,
           rho=0.1, seed=0)
SHARD = dict(graph="ring", algorithm="coke", censor_v=0.3, censor_mu=0.97,
             num_iters=8, primal="cg", cg_maxiter=8)
KRR_P = dict(dataset="heterogeneous", num_agents=12, samples_per_agent=60,
             num_tasks=3, num_features=32, lam=1e-3, rho=0.1, censor_v=0.3,
             censor_mu=0.97, seed=0)
PZ = dict(k=3, every=5, warmup=15)   # refreshes at iterations 16, 21, 26
CHAIN = (("Censor", (0.3, 0.97)), ("Quantize", (8,)), ("Drop", (0.05,)))

#: case -> (problem, the config's knobs beside SHARD, theta tolerance,
#: relative?); problem None: every rank builds the port's own from KRR
FITS = {
    "simulator-cholesky": ("krr", dict(backend="simulator",
                                       primal="cholesky"), TOL, False),
    "simulator-cg": ("krr", dict(backend="simulator"), TOL, False),
    "spmd-cg": ("krr", dict(backend="spmd"), TOL, False),
    "fused-k3": ("krr", dict(backend="fused", primal="gradient"), TOL,
                 False),
    "chain": ("krr", dict(backend="spmd", comm=CHAIN, censor_v=None,
                          censor_mu=None), TOL, False),
    "gossip": ("krr", dict(backend="spmd", exec="gossip",
                           participation=0.5), CG_TOL, False),
    "personalized": ("pz", dict(backend="spmd", primal="gradient", pz=PZ,
                                num_iters=28), PZ_RTOL, True),
    "built-from-seed": (None, dict(backend="simulator", primal="cholesky"),
                        None, False),
}
KRRS = {"krr": KRR, "pz": KRR_P, None: KRR}
CLIP = dict(kinds=("sgd", "adamw"), clip=0.5, rounds=2, n=4, d=64)


def _chain(pkg):
    return pkg.Chain([getattr(pkg, name)(*args) for name, args in CHAIN])


def _configs(case):
    """(reference FitConfig kwargs, port FitConfig) of a fit case."""
    kind, knobs, _, _ = FITS[case]
    kw = dict(SHARD, **knobs)
    port = dict(kw)
    if "comm" in kw:
        port["comm"] = _chain(tapi)
    if "pz" in kw:
        port["personalization"] = Personalization(**port.pop("pz"))
    return kw, FitConfig(krr=KRRConfig(**KRRS[kind]), **port)


# ---------------------------------------------------------------------------
# What every rank runs, and the one-process run of the same mesh
# ---------------------------------------------------------------------------

def _problem(arrays, kind):
    return convert.problem_from_numpy(
        arrays[f"{kind}_feats"], arrays[f"{kind}_labels"],
        arrays[f"{kind}_adj"], float(arrays[f"{kind}_lam"]),
        float(arrays[f"{kind}_rho"]), device=CPU)


def _whole(x):
    return sharding.unshard(x).detach().cpu().clone()


def _clip_run(mesh, arrays, kind):
    """CLIP["rounds"] coke rounds of `consensus_update` with grad_clip on a
    blocked tree: params, duals, broadcasts and comms, gathered."""
    n = CLIP["n"]
    ccfg = port_cns.ConsensusConfig(strategy="coke", rho=0.05,
                                    censor_v=0.02, censor_mu=0.9)
    opt = port_opt.OptConfig(kind=kind, lr=0.05, grad_clip=CLIP["clip"])
    tp = {"theta": torch.from_numpy(arrays["clip_x0"])}
    ts = sharding.shard_features(port_cns.init_consensus_state(ccfg, opt, tp),
                                 mesh, n)
    tp = sharding.shard_features(tp, mesh, n)
    comms = []
    for g in arrays["clip_grads"]:
        tp, ts, _ = port_cns.consensus_update(
            ccfg, opt, tp, sharding.shard_features(
                {"theta": torch.from_numpy(g)}, mesh, n), ts)
        comms.append(int(ts["comms"]))
    return {"theta": _whole(tp["theta"]),
            "theta_hat": _whole(ts["theta_hat"]["theta"]),
            "gamma": _whole(ts["gamma"]["theta"]),
            "comms": torch.tensor(comms)}


def run_all(mesh, arrays) -> dict:
    """Every case on `mesh` (one process's or a rank's): {case: {name:
    plain CPU tensor}}."""
    out = {}
    for case, (kind, _, _, _) in FITS.items():
        _, cfg = _configs(case)
        prob = None if kind is None else _problem(arrays, kind)
        r = fit(cfg, problem=prob, device=CPU, mesh=mesh)
        out[case] = {"theta": r.theta.clone(),
                     **{k: v.clone() for k, v in r.history.items()}}
    model = convert.model_from_numpy(
        {k: arrays[f"model_{k}"] for k in ("omega", "bias", "theta",
                                           "thetas")},
        {"mapping": "cos_bias", "bandwidth": 1.0}, device=CPU)
    sm = model.shard(mesh)
    x = arrays["model_x"]
    out["predict"] = {
        "ref": sm.predict(x, backend="ref"),
        "fused": sm.predict(x, backend="fused"),
        "agent1": sm.predict(x, backend="fused", agent=1)}
    for kind in CLIP["kinds"]:
        out[f"clip-{kind}"] = _clip_run(mesh, arrays, kind)
    return out


def _block_lookups(x, mesh):
    """{(b, m): True where x.block(b, m) is local_block(x, b, m), False
    where both raise KeyError} over every cell of the mesh."""
    out = {}
    for b in range(MESH[0]):
        for m in range(MESH[1]):
            try:
                got = x.block(b, m)
            except KeyError:
                with pytest.raises(KeyError):
                    sharding.local_block(x, b, m)
                out[(b, m)] = False
                continue
            out[(b, m)] = torch.equal(got, sharding.local_block(x, b, m))
    return out


def _rank_main(rank, world, store, split, npz, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    try:
        arrays = dict(np.load(npz))
        mesh = make_host_mesh(*MESH, device=CPU, group=dist.group.WORLD,
                              split=split)
        res = run_all(mesh, arrays)
        sp = sharding.shard_problem(_problem(arrays, "krr"), mesh)
        res["layout"] = {"cells": mesh.local_cells(),
                         "blocks": sorted(k[:2] for k in sp.feats.blocks),
                         "data": tuple(sp.feats.data.shape),
                         "ranks": mesh.ranks.tolist(),
                         "block": _block_lookups(sp.feats, mesh)}
        res["traffic"] = dict(sharding.TRAFFIC)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _failing_rank(rank, world, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    mesh = make_host_mesh(*MESH, device=CPU, group=dist.group.WORLD)
    x = sharding.shard(torch.arange(32.0).reshape(4, 8), mesh,
                       sharding.P("data", "model"))
    if rank == 1:
        raise RuntimeError("rank 1 fails before the collective")
    sharding.unshard(x)      # the others wait in the gather


# ---------------------------------------------------------------------------
# Fixtures: the inputs, the reference's runs, the one-process and the
# ranked runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The reference's problems and model as arrays (every rank loads the
    same file), and the reference's unsharded results of every case."""
    import jax.numpy as jnp

    import repro.api as japi
    from repro.api import FitConfig as JFitConfig
    from repro.api import KRRConfig as JKRRConfig
    from repro.api import Personalization as JPersonalization
    from repro.api import build_problem as jax_build_problem
    from repro.api import fit as jax_fit
    from repro.distributed import consensus as jax_cns
    from repro.optim import optimizers as jax_opt

    arrays, refs = {}, {}
    for kind in ("krr", "pz"):
        jb = jax_build_problem(JFitConfig(krr=JKRRConfig(**KRRS[kind]),
                                          graph="ring"))
        p = jb.problem
        arrays.update({f"{kind}_feats": np.asarray(p.feats),
                       f"{kind}_labels": np.asarray(p.labels),
                       f"{kind}_adj": np.asarray(p.adjacency),
                       f"{kind}_lam": np.float32(p.lam),
                       f"{kind}_rho": np.float32(p.rho)})
        if kind == "krr":
            jm = jax_fit(JFitConfig(krr=JKRRConfig(**KRR), **SHARD),
                         problem=p).to_model(jb.rff_params)
            for k, v in jm._array_tree().items():
                arrays[f"model_{k}"] = np.asarray(v)
            x = np.asarray(jb.x_test).reshape(-1, jb.x_test.shape[-1])[:40]
            arrays["model_x"] = x
            refs["predict"] = {
                "ref": np.asarray(jm.predict(x, backend="ref")),
                "fused": np.asarray(jm.predict(x, backend="fused")),
                "agent1": np.asarray(jm.predict(x, backend="fused",
                                                agent=1))}
        for case, (ck, _, _, _) in FITS.items():
            if ck != kind:
                continue
            kw, _ = _configs(case)
            if kw["backend"] == "fused":
                # the reference's megakernel cannot run on this jax; on a
                # mesh the port's fused fit is the ring runtime through
                # K3, the reference's spmd fit (tests/test_torch_sharding)
                kw["backend"] = "spmd"
            if "comm" in kw:
                kw["comm"] = _chain(japi)
            if "pz" in kw:
                kw["personalization"] = JPersonalization(**kw.pop("pz"))
            refs[case] = jax_fit(JFitConfig(krr=JKRRConfig(**KRRS[kind]),
                                            **kw), problem=p)
    rng = np.random.default_rng(14)
    n, d = CLIP["n"], CLIP["d"]
    arrays["clip_x0"] = rng.normal(size=(n, d)).astype(np.float32)
    arrays["clip_grads"] = (3.0 * rng.normal(
        size=(CLIP["rounds"], n, d))).astype(np.float32)
    for kind in CLIP["kinds"]:
        ccfg = jax_cns.ConsensusConfig(strategy="coke", rho=0.05,
                                       censor_v=0.02, censor_mu=0.9)
        opt = jax_opt.OptConfig(kind=kind, lr=0.05, grad_clip=CLIP["clip"])
        jp = {"theta": jnp.asarray(arrays["clip_x0"])}
        js = jax_cns.init_consensus_state(ccfg, opt, jp)
        comms = []
        for g in arrays["clip_grads"]:
            jp, js, _ = jax_cns.consensus_update(ccfg, opt, jp,
                                                 {"theta": jnp.asarray(g)},
                                                 js)
            comms.append(int(js["comms"]))
        refs[f"clip-{kind}"] = {
            "theta": np.asarray(jp["theta"]),
            "theta_hat": np.asarray(js["theta_hat"]["theta"]),
            "gamma": np.asarray(js["gamma"]["theta"]),
            "comms": np.asarray(comms)}
    npz = str(tmp_path_factory.mktemp("mesh_ranks") / "inputs.npz")
    np.savez(npz, **arrays)
    return npz, arrays, refs


@pytest.fixture(scope="module")
def one_process(inputs):
    """The one-process run of the same (2, 4) mesh, at one thread as the
    ranks run."""
    npz, arrays, _ = inputs
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_all(make_host_mesh(*MESH, device=CPU), arrays)
    finally:
        torch.set_num_threads(threads)


_RANKED: dict = {}


def _ranked(split_name, inputs, tmp_path_factory):
    """Every rank's results of one split, from one spawn (made once)."""
    if split_name not in _RANKED:
        npz = inputs[0]
        split = SPLITS[split_name]
        world = split[0] * split[1]
        tmp = tmp_path_factory.mktemp(f"ranks_{split_name}")
        t0 = time.perf_counter()
        mp.start_processes(_rank_main, args=(world, str(tmp / "store"),
                                             split, npz, str(tmp)),
                           nprocs=world, join=True, start_method="spawn")
        _RANKED[split_name] = (
            [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(world)], time.perf_counter() - t0)
    return _RANKED[split_name][0]


@pytest.fixture(scope="module", params=list(SPLITS))
def ranked(request, inputs, tmp_path_factory):
    return request.param, _ranked(request.param, inputs, tmp_path_factory)


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

def _same(a, b, err):
    assert a.keys() == b.keys(), err
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), \
            f"{err}:{k}"


@pytest.mark.parametrize("case", list(FITS) + ["predict", "clip-sgd",
                                               "clip-adamw"])
def test_every_rank_gets_the_one_process_bits(ranked, one_process, case):
    """theta, every history, the predictions and the clipped rounds on
    every rank bitwise the one-process run of the same mesh."""
    name, ranks = ranked
    for r, res in enumerate(ranks):
        _same(res[case], one_process[case], f"{name}:rank{r}:{case}")


@pytest.mark.parametrize("case", list(FITS))
def test_the_one_process_run_is_the_reference_run(inputs, one_process,
                                                  case):
    """The (2, 4) mesh's fit against the reference's unsharded fit: comms
    and bits exact, theta within the case's tolerance (so every rank's,
    bitwise the same, is too)."""
    _, _, refs = inputs
    got = one_process[case]
    tol, rel = FITS[case][2], FITS[case][3]
    if tol is None:      # the port's own problem: no reference to hold
        assert got["comms"][-1] > 0
        return
    ref = refs[case]
    assert set(got) - {"theta"} == set(ref.history), case
    for k in ("comms", "bits"):
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(ref.history[k]),
                                      err_msg=f"{case}:{k}")
    want = np.asarray(ref.theta)
    scale = np.abs(want).max() if rel else 1.0
    np.testing.assert_allclose(got["theta"].numpy(), want, rtol=0,
                               atol=tol * scale, err_msg=f"{case}:theta")
    assert got["comms"][-1] > 0


def test_predict_and_clip_match_the_reference(inputs, one_process):
    """The sharded model's predictions within 1e-5 of the reference
    model's; the clipped rounds (item 14d) within 1e-5, comms exact."""
    _, _, refs = inputs
    for k, want in refs["predict"].items():
        np.testing.assert_allclose(one_process["predict"][k].numpy(), want,
                                   rtol=0, atol=TOL, err_msg=k)
    for kind in CLIP["kinds"]:
        got, want = one_process[f"clip-{kind}"], refs[f"clip-{kind}"]
        np.testing.assert_array_equal(got["comms"].numpy(), want["comms"])
        for k in ("theta", "theta_hat", "gamma"):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                       atol=TOL, err_msg=f"{kind}:{k}")


def test_each_rank_holds_its_own_blocks(ranked, inputs):
    """Each rank holds the (B_loc, M_loc) blocks of its own rectangle of
    cells, the ranks in row-major order over (batch, model), and together
    they hold every block of Phi exactly once; `Blocked.block` by global
    index gives its own cells' blocks and raises KeyError for its peers',
    as `local_block` does."""
    name, ranks = ranked
    w_b, w_m = SPLITS[name]
    B, M = MESH
    N, T, D = inputs[1]["krr_feats"].shape
    seen = []
    for r, res in enumerate(ranks):
        lay = res["layout"]
        rb, rm = divmod(r, w_m)
        want = [(b, m) for b in range(rb * B // w_b, (rb + 1) * B // w_b)
                for m in range(rm * M // w_m, (rm + 1) * M // w_m)]
        assert lay["cells"] == want and lay["blocks"] == want, (name, r)
        assert lay["data"] == (B // w_b, M // w_m, N // B, T, D // M)
        assert all(lay["ranks"][b][m] == r for b, m in want)
        assert lay["block"] == {(b, m): (b, m) in want for b in range(B)
                                for m in range(M)}, (name, r)
        seen += lay["blocks"]
    assert sorted(seen) == [(b, m) for b in range(B) for m in range(M)]


def test_collectives_move_bytes_only_across_a_cut_axis(ranked):
    """Every rank gathered something, and the same amount as its peers
    (the program is the same on every rank)."""
    name, ranks = ranked
    traffic = [res["traffic"] for res in ranks]
    assert all(t["bytes"] > 0 and t["calls"] > 0 for t in traffic), name
    assert len({t["calls"] for t in traffic}) == 1, name


def test_a_failing_rank_fails_the_spawn_not_a_hang(tmp_path):
    """Rank 1 raises while rank 0 waits in a gather: the spawn raises the
    child's error at once (it stops the other ranks), well inside the
    group's timeout."""
    t0 = time.perf_counter()
    with pytest.raises(mp.ProcessRaisedException, match="rank 1 fails"):
        mp.start_processes(_failing_rank, args=(2, str(tmp_path / "store")),
                           nprocs=2, join=True, start_method="spawn")
    assert time.perf_counter() - t0 < GROUP_TIMEOUT.total_seconds()


def test_a_group_must_be_initialized_and_split_evenly():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="initialized process group"):
        make_host_mesh(*MESH, device=CPU, group=object())
    assert tmesh._split_of(2, 2, 4, None) == (2, 1)
    assert tmesh._split_of(4, 2, 4, None) == (2, 2)
    assert tmesh._split_of(8, 2, 4, None) == (2, 4)
    assert tmesh._split_of(2, 2, 4, (1, 2)) == (1, 2)
    with pytest.raises(ValueError, match="equal rectangles"):
        tmesh._split_of(3, 2, 4, None)
    with pytest.raises(ValueError, match="equal rectangles"):
        tmesh._split_of(4, 2, 4, (4, 1))
    with pytest.raises(ValueError, match="without a group"):
        make_host_mesh(*MESH, device=CPU, split=(2, 1))


def test_world_size_one_is_the_one_process_layout():
    """A mesh without a group holds every block: B_loc = B, M_loc = M."""
    mesh = make_host_mesh(*MESH, device=CPU)
    assert not mesh.ranked and mesh.split == (1, 1)
    assert mesh.local_cells() == [(b, m) for b in range(2) for m in range(4)]
    x = sharding.shard(torch.arange(32.0).reshape(4, 8), mesh,
                       sharding.P("data", "model"))
    assert tuple(x.data.shape) == (2, 4, 2, 2)
    assert mesh.axis_group("batch") == (None, 1)
