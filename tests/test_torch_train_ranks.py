"""The port's deep-net trainer with its agents on their own ranks
(`train.steps.make_train_step(..., mesh=)` on a `make_host_mesh(N or W,
1, group=)` mesh; `launch/train.py` under a process group), on the CPU,
against the one-process mesh, the unmeshed step and the reference.

The reduced qwen3-1.7b (2 layers, d_model 256) and its grouped variant
(2 KV heads) on the reference's `init_params` weights, the batches of
tests/test_torch_train.py (B = 8, S = 48), the launcher's AdamW (lr 3e-3,
grad_clip 1.0). Each world size runs in one spawn of W gloo ranks over a
FileStore (a group timeout of two minutes; one thread a rank): N = 4
agents on a (4, 1) mesh at W = 2 (split (2, 1): two agents a rank) and
W = 4 (one agent a rank), dkla, coke (v = 20, mu = 0.5: it skips and
sends within the run), coke_et (a local step, then a consensus step) and
cta for 4 steps each; allreduce on a (W, 1) mesh.

Tolerances, each stated beside its check:
- every rank's own rows of the parameters, theta_hat and gamma, and its
  per-step loss, comms, send_frac, bits and consensus_gap BITWISE the
  one-process (4, 1) mesh run's (the layer folds the ranks' partials in
  ascending block order whatever the split; the rows are compared by a
  sha256 of their bytes);
- allreduce over W ranks BITWISE the one-process step with microbatches
  = W (the gradients folded in rank order as microbatches are);
- the one-process mesh run against the unmeshed port step: comms and
  send_frac exact, losses and consensus_gap within 1e-3 relative
  (tests/test_torch_train.py's whole runs), every parameter leaf within
  1e-5 of its largest magnitude (its gradients' tolerance);
- the one-process mesh run against the reference's `make_train_step` on
  the same weights and batches: comms and send_frac exact, losses within
  RUN_RTOL = 1e-3.
"""
import contextlib
import datetime
import hashlib
import io
import json
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data import tokens
from repro_torch.distributed import consensus as cns
from repro_torch.distributed import sharding
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.optim import optimizers as opt
from repro_torch.train import steps

CPU = "cpu"
N = 4
STEPS = 4
WORLDS = (2, 4)
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
RUN_RTOL = 1e-3     # tests/test_torch_train.py, whole runs' losses
GRAD_RTOL = 1e-5    # tests/test_torch_train.py, a leaf against its max
OPT = dict(lr=3e-3, grad_clip=1.0)
VARIANTS = {"mha": {}, "gqa": {"num_kv_heads": 2}}
#: strategy -> (model variant, ConsensusConfig knobs beside rho = 1e-3)
CASES = {"dkla": ("mha", {}),
         "coke": ("gqa", dict(censor_v=20.0, censor_mu=0.5)),
         "coke_et": ("mha", dict(local_steps=2, censor_v=20.0,
                                 censor_mu=0.5)),
         "cta": ("gqa", {})}
ALLREDUCE = "gqa"
STREAM = dict(seq_len=48, global_batch=8, structure=0.9)
TREES = ("params", "theta_hat", "gamma")
# the launcher's runs: its --reduced qwen3-1.7b at a short batch
LAUNCH = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
          "--strategy", "coke", "--agents", str(N), "--steps", "3",
          "--log-every", "1", "--batch", "8", "--seq", "16"]


def _cfg(variant):
    return get_config("qwen3-1.7b").reduced().with_overrides(
        **VARIANTS[variant])


def _weights(trees, variant):
    cfg = _cfg(variant)
    return cfg, M.param_dict(lm_params_from_numpy(cfg, trees[variant],
                                                  device=CPU))


def _batch(stream, i, agents=None):
    toks, labels = stream.batch(i)
    b = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    return steps.agent_batch(b, agents) if agents else b


def _stream(cfg):
    return tokens.TokenStream(tokens.TokenStreamConfig(
        vocab_size=cfg.vocab_size, **STREAM))


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()) \
        .hexdigest()


def _own_rows(x):
    """This process's rows of an agent-stacked leaf, (n_own, ...)."""
    if isinstance(x, sharding.Blocked):
        return x.data.reshape(-1, *x.shape[1:])
    return x


class _Calls:
    """Counts the attention Function's forward and backward calls: K4's
    and K7's plain versions on the CPU, one of each per layer per agent a
    process steps."""

    def __enter__(self):
        self.fwd = self.bwd = 0
        cls = fa_ops.FlashAttention
        self._saved = (cls.__dict__["forward"], cls.__dict__["backward"])
        fwd, bwd = cls.forward, cls.backward

        def forward(*a):
            self.fwd += 1
            return fwd(*a)

        def backward(*a):
            self.bwd += 1
            return bwd(*a)
        cls.forward, cls.backward = staticmethod(forward), \
            staticmethod(backward)
        return self

    def __exit__(self, *exc):
        cls = fa_ops.FlashAttention
        cls.forward, cls.backward = self._saved
        return False


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


# ---------------------------------------------------------------------------
# What every rank runs, and the one-process runs
# ---------------------------------------------------------------------------

def run_consensus(mesh, trees, *, full=False) -> dict:
    """Every strategy of CASES, STEPS steps on `mesh` (None: the unmeshed
    step): per step the metrics; the attention calls; each tree's rows
    this process holds, as digests (and with full=True gathered whole)."""
    out = {}
    for strategy, (variant, knobs) in CASES.items():
        cfg, weights = _weights(trees, variant)
        ccfg = cns.ConsensusConfig(strategy=strategy, rho=1e-3, **knobs)
        init_fn, step_fn, local_fn = steps.make_train_step(
            cfg, opt.OptConfig(**OPT), ccfg, num_agents=N, mesh=mesh)
        state = init_fn(weights)
        stream, rows = _stream(cfg), []
        with _Calls() as calls:
            for i in range(STEPS):
                local = (i + 1) % ccfg.local_steps != 0
                state, m = (local_fn if local else step_fn)(
                    state, _batch(stream, i, N))
                rows.append(_metrics(m))
        c = state["consensus"]
        held = {"params": state["params"], "theta_hat": c.get("theta_hat"),
                "gamma": c.get("gamma")}
        res = {"metrics": rows, "calls": (calls.fwd, calls.bwd),
               "digests": {t: {n: _digest(_own_rows(x))
                               for n, x in tree.items()}
                           for t, tree in held.items() if tree is not None},
               "data": {n: tuple(x.data.shape) if isinstance(
                   x, sharding.Blocked) else None
                   for n, x in state["params"].items()}}
        if full:
            res["whole"] = {t: {n: sharding.unshard(x).clone()
                                for n, x in tree.items()}
                            for t, tree in held.items() if tree is not None}
        out[strategy] = res
    return out


def run_allreduce(trees, *, mesh=None, microbatches=1) -> dict:
    cfg, weights = _weights(trees, ALLREDUCE)
    init_fn, step_fn, _ = steps.make_train_step(
        cfg, opt.OptConfig(**OPT), microbatches=microbatches, mesh=mesh)
    state = init_fn(weights)
    stream, rows = _stream(cfg), []
    with _Calls() as calls:
        for i in range(STEPS):
            state, m = step_fn(state, _batch(stream, i))
            rows.append(_metrics(m))
    return {"metrics": rows, "calls": (calls.fwd, calls.bwd),
            "digests": {n: _digest(p) for n, p in state["params"].items()},
            "opt": _digest(torch.cat([state["opt"][k][n].reshape(-1)
                                      for k in ("m", "v")
                                      for n in state["params"]]))}


def ring_fetch(mesh, trees, *, full=False) -> dict:
    """One two-offset ring fetch of an agent-stacked tree
    (`consensus._ring_neighbors`): the gathers it made and the digests of
    the rows it gave this process (with full=True the halves whole)."""
    cfg, weights = _weights(trees, "mha")
    rng = torch.Generator().manual_seed(3)
    own = sharding.agent_range(mesh, N)
    tree = {n: sharding.from_rows(
        torch.stack([p + 0.01 * i * torch.randn(p.shape, generator=rng)
                     for i in range(N)])[own.start:own.stop], mesh, N)
            for n, p in weights.items()}
    before = dict(sharding.TRAFFIC)
    left, right = cns._ring_neighbors(tree, (1, 2))
    halves = {"left": left, "right": right}
    res = {"gathers": sharding.TRAFFIC["calls"] - before["calls"],
           "bytes": sharding.TRAFFIC["bytes"] - before["bytes"],
           "leaves": len(tree),
           "digests": {side: {n: _digest(_own_rows(x)) for n, x in t.items()}
                       for side, t in halves.items()}}
    if full:
        res["whole"] = {side: {n: sharding.unshard(x) for n, x in t.items()}
                        for side, t in halves.items()}
    return res


def _rank_main(rank, world, store, inputs, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    try:
        with open(inputs, "rb") as f:
            trees = pickle.load(f)
        mesh = make_host_mesh(N, 1, device=CPU, group=dist.group.WORLD)
        res = run_consensus(mesh, trees)
        res["allreduce"] = run_allreduce(trees, mesh=make_host_mesh(
            world, 1, device=CPU, group=dist.group.WORLD))
        res["ring"] = ring_fetch(mesh, trees)
        res["own"] = list(sharding.agent_range(mesh, N))
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _launcher_rank(rank, world, store, ckpt, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            launcher.main(LAUNCH + ["--ckpt", ckpt])
        with open(os.path.join(out, f"stdout{rank}.txt"), "w") as f:
            f.write(buf.getvalue())
    finally:
        dist.destroy_process_group()


def _failing_rank(rank, world, store, inputs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    with open(inputs, "rb") as f:
        trees = pickle.load(f)
    cfg, weights = _weights(trees, "mha")
    mesh = make_host_mesh(N, 1, device=CPU, group=dist.group.WORLD)
    init_fn, step_fn, _ = steps.make_train_step(
        cfg, opt.OptConfig(**OPT), cns.ConsensusConfig(strategy="dkla"),
        num_agents=N, mesh=mesh)
    state = init_fn(weights)
    if rank == 1:
        raise RuntimeError("rank 1 fails before its first step")
    step_fn(state, _batch(_stream(cfg), 0, N))   # rank 0 waits in a gather


# ---------------------------------------------------------------------------
# Fixtures: the weights, the one-process runs, the ranked runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The reference's weights of both variants as numpy trees (every rank
    loads the same file)."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models import model as JM
    trees = {}
    for variant, kw in VARIANTS.items():
        jcfg = jax_get_config("qwen3-1.7b").reduced().with_overrides(**kw)
        trees[variant] = jax.tree.map(
            np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    path = str(tmp_path_factory.mktemp("train_ranks") / "weights.pkl")
    with open(path, "wb") as f:
        pickle.dump(trees, f)
    return path, trees


@pytest.fixture(scope="module")
def one_process(inputs):
    """The one-process (4, 1) mesh run, the unmeshed run, the
    microbatched allreduce steps and the ring fetch, at one thread as the
    ranks run."""
    _, trees = inputs
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mesh = make_host_mesh(N, 1, device=CPU)
        return {"mesh": run_consensus(mesh, trees, full=True),
                "unmeshed": run_consensus(None, trees, full=True),
                "allreduce": {w: run_allreduce(trees, microbatches=w)
                              for w in WORLDS},
                "ring": ring_fetch(mesh, trees, full=True)}
    finally:
        torch.set_num_threads(threads)


_RANKED: dict = {}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"W{w}")
def ranked(request, inputs, tmp_path_factory):
    """Every rank's results of one world size, from one spawn."""
    world = request.param
    if world not in _RANKED:
        tmp = tmp_path_factory.mktemp(f"train_ranks_W{world}")
        mp.start_processes(_rank_main, args=(world, str(tmp / "store"),
                                             inputs[0], str(tmp)),
                           nprocs=world, join=True, start_method="spawn")
        _RANKED[world] = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                          for r in range(world)]
    return world, _RANKED[world]


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", list(CASES))
def test_every_rank_gets_the_one_process_bits(ranked, one_process,
                                              strategy):
    """Each rank's per-step metrics, and its own rows of the parameters,
    theta_hat and gamma after the last step, bitwise the one-process
    (4, 1) mesh run's."""
    world, ranks = ranked
    want = one_process["mesh"][strategy]
    for r, res in enumerate(ranks):
        got = res[strategy]
        assert got["metrics"] == want["metrics"], (world, r, strategy)
        own = slice(res["own"][0], res["own"][-1] + 1)
        for t, leaves in want["whole"].items():
            assert got["digests"][t] == {
                n: _digest(x[own]) for n, x in leaves.items()}, \
                (world, r, strategy, t)


def test_allreduce_over_ranks_is_the_microbatched_step(ranked, one_process):
    """allreduce on a (W, 1) mesh of W ranks: every rank's losses, nll,
    aux, parameters and AdamW slots bitwise the one-process step's with
    microbatches = W."""
    world, ranks = ranked
    want = one_process["allreduce"][world]
    for r, res in enumerate(ranks):
        got = res["allreduce"]
        assert got["metrics"] == want["metrics"], (world, r)
        assert got["digests"] == want["digests"], (world, r)
        assert got["opt"] == want["opt"], (world, r)


def test_each_rank_holds_and_steps_its_own_agents(ranked):
    """Rank r holds agents [r N/W, (r + 1) N/W): every leaf's data is its
    N/W blocks of one agent, (N/W, 1, 1, *leaf); its forward and backward
    attention ran N/W times per layer per step (the whole N on one
    process), and allreduce's once per layer per step (its 1/W of the
    batch)."""
    world, ranks = ranked
    per = N // world
    for r, res in enumerate(ranks):
        assert res["own"] == list(range(r * per, (r + 1) * per))
        for strategy, (variant, _) in CASES.items():
            cfg = _cfg(variant)
            shapes = {n: tuple(p.shape) for n, p in M.param_dict(
                M.init_params(cfg, torch.Generator().manual_seed(0))).items()}
            assert res[strategy]["data"] == {
                n: (per, 1, 1, *s) for n, s in shapes.items()}, (r, strategy)
            layers = cfg.num_layers
            assert res[strategy]["calls"] == (per * layers * STEPS,) * 2
        assert res["allreduce"]["calls"] == (_cfg(ALLREDUCE).num_layers
                                             * STEPS,) * 2


def test_the_ring_fetch_gathers_each_leaf_once(ranked, one_process):
    """A two-offset ring fetch (four rolls) of each rank's agent rows
    makes one gather per leaf, and gives each rank the rows of the
    one-process fetch (which gathers nothing) bitwise."""
    world, ranks = ranked
    want = one_process["ring"]
    assert want["gathers"] == want["bytes"] == 0
    for r, res in enumerate(ranks):
        got = res["ring"]
        assert got["gathers"] == got["leaves"], (world, r)
        assert got["bytes"] > 0
        own = slice(res["own"][0], res["own"][-1] + 1)
        for side, leaves in want["whole"].items():
            assert got["digests"][side] == {
                n: _digest(x[own]) for n, x in leaves.items()}, (r, side)


@pytest.mark.parametrize("strategy", list(CASES))
def test_the_one_process_mesh_run_is_the_unmeshed_step(one_process,
                                                       strategy):
    got = one_process["mesh"][strategy]
    want = one_process["unmeshed"][strategy]
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        assert set(g) == set(w), i
        for k in ("comms", "send_frac"):
            if k in w:
                assert g[k] == w[k], (i, k)
        for k in ("loss", "consensus_gap"):
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=RUN_RTOL,
                                           err_msg=f"step {i} {k}")
    for t, leaves in want["whole"].items():
        for n, x in leaves.items():
            np.testing.assert_allclose(
                got["whole"][t][n].numpy(), x.numpy(), rtol=0,
                atol=GRAD_RTOL * max(float(x.abs().max()), 1e-30),
                err_msg=f"{t} {n}")
    assert got["calls"] == want["calls"] == (N * 2 * STEPS,) * 2


@pytest.fixture(scope="module")
def reference_runs(inputs):
    """The reference's make_train_step on the same weights and batches:
    per strategy, per step (loss, comms, send_frac)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.data import tokens as jax_tokens
    from repro.distributed import consensus as jax_cns
    from repro.optim import optimizers as jax_opt
    from repro.train import steps as jax_steps
    _, trees = inputs
    out = {}
    for strategy, (variant, knobs) in CASES.items():
        jcfg = jax_get_config("qwen3-1.7b").reduced().with_overrides(
            **VARIANTS[variant])
        jp = jax.tree.map(jnp.asarray, trees[variant])
        jccfg = jax_cns.ConsensusConfig(strategy=strategy, rho=1e-3, **knobs)
        jopt = jax_opt.OptConfig(**OPT)
        _, jstep, jlocal = jax_steps.make_train_step(jcfg, jopt, jccfg,
                                                     num_agents=N)
        stacked = jax_cns.stack_params(jp, N)
        js = {"params": stacked,
              "consensus": jax_cns.init_consensus_state(jccfg, jopt,
                                                        stacked)}
        jstep, jlocal = jax.jit(jstep), jax.jit(jlocal)
        stream = jax_tokens.TokenStream(jax_tokens.TokenStreamConfig(
            vocab_size=jcfg.vocab_size, **STREAM))
        rows = []
        for i in range(STEPS):
            toks, labels = stream.batch(i)
            jb = jax_steps.agent_batch({"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels)}, N)
            local = (i + 1) % jccfg.local_steps != 0
            js, m = (jlocal if local else jstep)(js, jb)
            rows.append({k: float(v) for k, v in m.items()})
        out[strategy] = rows
    return out


@pytest.mark.parametrize("strategy", list(CASES))
def test_the_one_process_mesh_run_is_the_reference_run(one_process,
                                                       reference_runs,
                                                       strategy):
    """comms and send_frac exact, losses within RUN_RTOL = 1e-3 relative;
    coke both skips and sends within the run."""
    got = one_process["mesh"][strategy]["metrics"]
    want = reference_runs[strategy]
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), i
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RUN_RTOL,
                                   err_msg=f"step {i}")
        for k in ("comms", "send_frac"):
            if k in w:
                assert g[k] == w[k], (i, k)
    if strategy == "coke":
        sends = [g["send_frac"] for g in got]
        assert min(sends) < 1.0 and max(sends) > 0.0, sends


def test_the_state_is_laid_out_by_the_agent_stack_rule(inputs):
    """On the (4, 1) mesh every agent-stacked leaf of the state (the
    parameters, AdamW's slots and step counts, theta_hat, gamma, the
    neighbour cache, the per-agent bits) is cut by `agent_stack_spec`,
    which is the reference's `_agent_stack_specs` at model extent 1; the
    scalars stay plain."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jax_get_config
    from repro.distributed import consensus as jax_cns
    from repro.optim import optimizers as jax_opt
    from repro.train import steps as jax_steps
    saved = os.environ.get("XLA_FLAGS")
    try:     # the dry run sets XLA_FLAGS at import: keep this process's
        from repro.launch.dryrun import _agent_stack_specs
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    _, trees = inputs
    mesh = make_host_mesh(N, 1, device=CPU)
    jcfg = jax_get_config("qwen3-1.7b").reduced()
    jopt = jax_opt.OptConfig(**OPT)
    jinit, _, _ = jax_steps.make_train_step(
        jcfg, jopt, jax_cns.ConsensusConfig(strategy="coke"), num_agents=N)
    shapes = jax.eval_shape(jinit, jax.random.PRNGKey(0))
    ref = _agent_stack_specs(jcfg, shapes, AbstractMesh(
        (N, 1), ("data", "model")), False)
    flat_s = jax.tree_util.tree_leaves(shapes)
    flat_r = jax.tree_util.tree_leaves(
        ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(flat_s) == len(flat_r)
    for leaf, spec in zip(flat_s, flat_r):
        want = sharding.P(*(None if e == "model" else e for e in spec))
        assert sharding.agent_stack_spec(leaf.shape, mesh, N) == want, \
            (leaf.shape, spec)
    # the port's state on the mesh
    cfg, weights = _weights(trees, "mha")
    init_fn, _, _ = steps.make_train_step(
        cfg, opt.OptConfig(**OPT), cns.ConsensusConfig(strategy="coke"),
        num_agents=N, mesh=mesh)
    state = init_fn(weights)
    seen = 0
    for x in _leaves([state["params"], state["consensus"]]):
        spec = sharding.agent_stack_spec(tuple(x.shape), mesh, N)
        if isinstance(x, sharding.Blocked):
            assert x.spec == spec
            seen += 1
        else:
            assert x.ndim == 0 and spec == sharding.P()
    # params, m, v, theta_hat, gamma and the two caches (theta_hat itself
    # at the start); the step counts and the bits
    assert state["consensus"]["nbr_left"] is state["consensus"]["theta_hat"]
    assert seen == 7 * len(weights) + 2


def _leaves(tree):
    """The array leaves of a tree (dicts, lists and named tuples)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if hasattr(tree, "shape") else []


@pytest.mark.parametrize("case", ["model axis", "fsdp", "not dividing",
                                  "two agents a block", "allreduce model",
                                  "allreduce fsdp"])
def test_what_raises(case):
    """An agent's layers over "model" and fsdp name ROADMAP item 14f, as
    does a mesh whose batch extent is not the agent count."""
    cfg = _cfg("mha")
    o = opt.OptConfig(**OPT)
    coke = cns.ConsensusConfig(strategy="coke")
    kw = {"model axis": dict(ccfg=coke, mesh=make_host_mesh(4, 2,
                                                            device=CPU)),
          "fsdp": dict(ccfg=coke, mesh=make_host_mesh(4, 1, device=CPU),
                       fsdp=True),
          "not dividing": dict(ccfg=coke, mesh=make_host_mesh(3, 1,
                                                              device=CPU)),
          "two agents a block": dict(ccfg=coke, mesh=make_host_mesh(
              2, 1, device=CPU)),
          "allreduce model": dict(mesh=make_host_mesh(2, 2, device=CPU)),
          "allreduce fsdp": dict(fsdp=True)}[case]
    with pytest.raises(NotImplementedError, match="item 14f"):
        steps.make_train_step(cfg, o, num_agents=N, **kw)


def test_a_failing_rank_fails_the_spawn_not_a_hang(inputs, tmp_path):
    """Rank 1 raises while rank 0 waits in its first step's gather: the
    spawn raises the child's error at once, well inside the group's
    timeout."""
    t0 = time.perf_counter()
    with pytest.raises(mp.ProcessRaisedException, match="rank 1 fails"):
        mp.start_processes(_failing_rank, args=(2, str(tmp_path / "store"),
                                                inputs[0]),
                           nprocs=2, join=True, start_method="spawn")
    assert time.perf_counter() - t0 < GROUP_TIMEOUT.total_seconds()


def _json_lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def test_the_launcher_runs_under_a_process_group(tmp_path):
    """`launch/train.py`'s main in W = 2 gloo ranks (--device cpu
    --strategy coke --agents 4): only rank 0 prints; its steps' comms and
    send_frac are the unranked launcher's, its losses within RUN_RTOL; the
    --ckpt it writes (the agent stack gathered from both ranks) restores
    with the reference's `repro.ckpt.restore`; the unranked launcher
    prints what it printed before (the same keys and steps)."""
    import jax

    from repro.ckpt import restore as jax_restore
    from repro.configs import get_config as jax_get_config
    from repro.models import model as JM
    ckpt = tmp_path / "run"
    mp.start_processes(_launcher_rank, args=(2, str(tmp_path / "store"),
                                             str(ckpt), str(tmp_path)),
                       nprocs=2, join=True, start_method="spawn")
    out0 = (tmp_path / "stdout0.txt").read_text()
    assert (tmp_path / "stdout1.txt").read_text() == ""
    ranked = _json_lines(out0)
    assert out0.rstrip().endswith(f"saved checkpoint to {ckpt}.npz")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launcher.main(LAUNCH)
    plain = _json_lines(buf.getvalue())
    assert [x["step"] for x in plain] == [0, 1, 2]
    assert list(plain[0]) == ["step", "bits", "comms", "consensus_gap",
                              "loss", "send_frac", "wall_s"]
    assert [list(x) for x in ranked] == [list(x) for x in plain]
    for a, b in zip(ranked, plain):
        assert (a["comms"], a["send_frac"], a["bits"]) == (
            b["comms"], b["send_frac"], b["bits"])
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=RUN_RTOL)
    jcfg = jax_get_config("qwen3-1.7b").reduced()
    like = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct((N, *s.shape), s.dtype),
        jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0))))
    got, step = jax_restore(str(ckpt), like)
    assert step == 3
    leaves = jax.tree.leaves(got)
    assert [x.shape for x in leaves] == [x.shape for x in
                                         jax.tree.leaves(like)]
    assert all(np.all(np.isfinite(np.asarray(x))) for x in leaves)
