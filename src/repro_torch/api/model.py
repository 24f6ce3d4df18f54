"""`KernelModel` — the deployable artifact: the common-seed RFF map plus the
fitted thetas, scored as f(x) = phi(x)' theta.

    model = fit(config).to_model()
    y_hat = model.predict(x_new, backend="fused")   # K1 kernel on the card
    model.evaluate(x_test, y_test, backend="fused")
    model.score_rows(x, thetas, backend="fused")    # row i against theta i
    model.save("artifacts/coke")                    # npz + JSON sidecar
    model = KernelModel.load("artifacts/coke", device="cuda")
    refined, result = model.partial_fit(x_stream, labels=y_stream)

Scoring backends: "ref" is the plain `core.rff.featurize`; "fused" routes
featurization through the hand-written `kernels/rff` kernel (the plain
version on CPU tensors). The artifact format is the reference's
(`"format": "repro.api.KernelModel/v1"`), so a model saved by `repro` loads
here and predicts the same.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import rff
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.kernels.rff.ops import featurize_fused
from repro_torch.kernels.rff.rff import rff_cos_bias
from repro_torch.kernels.rowdot.ops import gather_rowdot, rowdot

PREDICT_BACKENDS = ("ref", "fused")
FORMAT = "repro.api.KernelModel/v1"


def featurize(params: rff.RFFParams, x: torch.Tensor,
              backend: str = "ref", mesh=None) -> torch.Tensor:
    """phi(x) on the chosen backend — the one routing point of every
    scoring path (predict, evaluate, score_rows, the KernelServer).
    `mesh`: the params of a sharded model (`KernelModel.shard`); phi
    comes back in feature blocks (`_featurize_sharded`)."""
    if mesh is not None:
        return _featurize_sharded(params, x, backend, mesh)
    if backend == "ref":
        return rff.featurize(params, x)
    if backend == "fused":
        if params.mapping != "cos_bias":
            raise ValueError(
                "the fused featurizer implements the 'cos_bias' mapping "
                f"(Eq. 13); this model uses {params.mapping!r} — use "
                "backend='ref'")
        return featurize_fused(params, x)
    raise ValueError(
        f"unknown predict backend {backend!r}; choose from "
        f"{PREDICT_BACKENDS}")


def _featurize_sharded(params: rff.RFFParams, x, backend: str, mesh):
    """phi(x) of a sharded model, cut over "model" as its theta is
    (`_div(D, mesh, "model")`); x may be cut into row blocks over the
    batch axes (the server's buckets). cos_bias: each feature block is
    its own map, omega_s and bias_s scaled for the whole width L: on
    backend="fused" one K1 launch per (row, feature) block. cos_sin: the
    cos and sin halves of an omega block are not one theta block (omega
    splits L, theta splits 2L), so omega is gathered, phi made whole per
    row block and cut into theta's blocks."""
    if backend not in PREDICT_BACKENDS:
        raise ValueError(
            f"unknown predict backend {backend!r}; choose from "
            f"{PREDICT_BACKENDS}")
    L = params.omega.shape[1]
    D = params.num_features
    feat = sharding._div(D, mesh, "model") \
        if "model" in mesh.axis_names else None
    flat = x.reshape(-1, x.shape[-1])
    rows = sharding.spec_of(flat, 0)[0]
    if params.mapping == "cos_bias":
        if backend == "fused":
            def block(xb, om, b):
                return rff_cos_bias(xb.contiguous(), om, b, num_features=L)
        else:
            def block(xb, om, b):
                return math.sqrt(2.0) * torch.cos(xb @ om + b) \
                    * math.sqrt(1.0 / L)
        # a model placed by .shard(mesh) is in this layout already
        omega = sharding.shard(params.omega, mesh, sharding.P(None, feat))
        bias = sharding.shard(params.bias, mesh, sharding.P(feat))
        phi = sharding.blockwise(block, flat, omega, bias,
                                 out=sharding.P(rows, feat), mesh=mesh)
    elif backend == "fused":
        raise ValueError(
            "the fused featurizer implements the 'cos_bias' mapping "
            f"(Eq. 13); this model uses {params.mapping!r} — use "
            "backend='ref'")
    else:
        whole = rff.RFFParams(omega=sharding.unshard(params.omega),
                              bias=sharding.unshard(params.bias),
                              mapping=params.mapping)
        phi = sharding.blockwise(
            lambda xb: rff.featurize(whole, xb), flat,
            out=sharding.P(rows, None), mesh=mesh)
        phi = sharding.shard(sharding.unshard(phi), mesh,
                             sharding.P(rows, feat))
    return phi.reshape(*x.shape[:-1], D)


def _dot(phi, theta):
    """phi (..., D) @ theta (D,); on feature blocks the psum of the
    blocks' partials, in ascending block order, gathered."""
    if isinstance(phi, sharding.Blocked) or isinstance(theta,
                                                       sharding.Blocked):
        lead = "abc"[:phi.ndim - 1]
        return sharding.unshard(torch.einsum(f"{lead}d,d->{lead}", phi,
                                             theta))
    return phi @ theta


def score_rows(params: rff.RFFParams, x: torch.Tensor, thetas: torch.Tensor,
               slots=None, *, backend: str = "ref", mesh=None
               ) -> torch.Tensor:
    """The many-model scorer: featurize x (b, d) once, then row i of phi
    against theta row i — thetas (b, D) with slots None, or the gathered
    row thetas[slots[i]] of a resident (M, D) stack, slots host int32
    (b,). The row-dot is K6 on the card (`kernels/rowdot`), whose row bits
    depend only on that row's phi and theta; with backend="fused" the
    featurizer is K1, whose row bits do not depend on b either. So a row
    scores the same whatever else shares its batch, and `KernelModel.
    score_rows` and the `KernelServer` give the same bits by
    construction.

    mesh: a sharded model's scorer. phi comes in feature blocks (and row
    blocks where x is cut over the batch axes), the stack (or thetas) in
    the same feature blocks; K6 runs once per (row, feature) block on its
    slots, and a row's answer is the psum of its blocks' partials in
    ascending block order, so it is still independent of the batch."""
    if mesh is not None:
        return _score_rows_sharded(params, x, thetas, slots, backend, mesh)
    phi = featurize(params, x, backend)
    if slots is None:
        return rowdot(phi, thetas)
    return gather_rowdot(phi, thetas, slots)


def _score_rows_sharded(params, x, thetas, slots, backend: str, mesh):
    phi = featurize(params, x, backend, mesh=mesh)
    if not isinstance(phi, sharding.Blocked):   # nothing cut: one block
        stack = sharding.unshard(thetas)
        return rowdot(phi, stack) if slots is None \
            else gather_rowdot(phi, stack, slots)
    if slots is None:          # thetas (b, D): row i against row i
        stack = sharding.recut(thetas, phi)
    else:
        stack = sharding.shard(thetas, mesh, sharding.P(None, phi.spec[1]))
        slots = np.asarray(slots)

    def score(cell, p, st):
        """K6 on one (row, feature) block, on that row block's slots."""
        if slots is None:      # this block's own rows of the thetas
            sl = np.arange(p.shape[0], dtype=np.int32)
        else:
            sl = slots[sharding.block_index(phi, 0, *cell)]
        return gather_rowdot(p, st, sl)
    return sharding.unshard(sharding.blockwise(
        score, phi, stack, out=sharding.P(phi.spec[0]), partial=True,
        index=True))


class KernelModel(nn.Module):
    """A fitted decentralized-kernel-learning function, ready to deploy.

    rff_params — the random-feature map (omega (d, L), bias (L,), mapping);
                 omega and bias are held as buffers.
    theta      — (D,) consensus-averaged parameters (a buffer).
    thetas     — optional (N, D) per-agent stack (the per-agent test
                 protocol of `evaluate`; a buffer).
    bandwidth, kernel, meta, model_id, version — provenance, as in the
                 reference.

    `model(x)` is `model.predict(x)`; `model.to(device)` moves every
    buffer.
    """

    def __init__(self, rff_params: rff.RFFParams, theta: torch.Tensor,
                 thetas: torch.Tensor | None = None, *,
                 bandwidth: float = 1.0, kernel: str = "gaussian",
                 meta: dict[str, Any] | None = None,
                 model_id: str | None = None, version: int | None = None,
                 mesh=None):
        super().__init__()
        self.mapping = rff_params.mapping
        self.mesh = mesh
        for name, t in (("omega", rff_params.omega),
                        ("bias", rff_params.bias), ("theta", theta),
                        ("thetas", thetas)):
            if isinstance(t, sharding.Blocked):
                # a sharded array holds its blocks on their cells'
                # devices: not a buffer, which `.to` would move
                object.__setattr__(self, name, t)
            else:
                self.register_buffer(name, t)
        self.bandwidth = float(bandwidth)
        self.kernel = kernel
        self.meta = dict(meta or {})
        self.model_id = model_id
        self.version = version

    @property
    def rff_params(self) -> rff.RFFParams:
        return rff.RFFParams(omega=self.omega, bias=self.bias,
                             mapping=self.mapping)

    @property
    def input_dim(self) -> int:
        return self.rff_params.input_dim

    @property
    def num_features(self) -> int:
        return self.rff_params.num_features

    @property
    def num_agents(self) -> int | None:
        return None if self.thetas is None else self.thetas.shape[0]

    @property
    def device(self) -> torch.device:
        return self.theta.device

    # ---- placement -------------------------------------------------------
    def shard(self, mesh) -> "KernelModel":
        """This model with its feature-dim arrays cut over the mesh's
        "model" axis, as the reference places them: omega (d, L) and bias
        (L,) split L, theta (D,) splits D, thetas (N, D) also spreads its
        agents over the batch axes. A dim that does not divide stays
        whole (replicated). `featurize`, `predict`, `evaluate`,
        `score_rows` and a `KernelServer` built with the same mesh run on
        the blocks: with backend="fused" one K1 launch per feature block,
        then phi . theta as the psum of the blocks' partials. On one card
        the blocks are a layout, not a saving: they hold the same bytes.
        On a mesh across ranks each rank keeps its own blocks, runs K1 on
        its feature blocks and gets the whole scores."""
        has_model = "model" in mesh.axis_names
        omega_l = self.omega.shape[1]
        spec_feat = sharding._div(omega_l, mesh, "model") \
            if has_model else None
        feat = sharding._div(self.num_features, mesh, "model") \
            if has_model else None
        ba = sharding.batch_axes(mesh)

        def put(x, spec):
            return None if x is None else sharding.shard(
                sharding.unshard(x), mesh, spec)

        lead = (sharding._div(self.thetas.shape[0], mesh, ba)
                if self.thetas is not None and ba else None)
        params = rff.RFFParams(
            omega=put(self.omega, sharding.P(None, spec_feat)),
            bias=put(self.bias, sharding.P(spec_feat)),
            mapping=self.mapping)
        return self.replace(rff_params=params,
                            theta=put(self.theta, sharding.P(feat)),
                            thetas=put(self.thetas, sharding.P(lead, feat)),
                            mesh=mesh)

    # ---- scoring ---------------------------------------------------------
    def featurize(self, x: torch.Tensor, backend: str = "ref") -> torch.Tensor:
        """phi(x) on the chosen backend (module-level `featurize`); in
        feature blocks on a sharded model."""
        return featurize(self.rff_params, x, backend, mesh=self.mesh)

    def replace(self, **changes) -> "KernelModel":
        """A new KernelModel with `changes` (rff_params, theta, thetas,
        bandwidth, kernel, meta, model_id, version, mesh) and every other field
        shared with this one; this model is left as it was."""
        fields = dict(rff_params=self.rff_params, theta=self.theta,
                      thetas=self.thetas, bandwidth=self.bandwidth,
                      kernel=self.kernel, meta=self.meta,
                      model_id=self.model_id, version=self.version,
                      mesh=self.mesh)
        unknown = set(changes) - set(fields)
        if unknown:
            raise TypeError(f"KernelModel has no field(s) {sorted(unknown)}")
        fields.update(changes)
        return KernelModel(fields.pop("rff_params"), fields.pop("theta"),
                           fields.pop("thetas"), **fields)

    def forward(self, x, **kw) -> torch.Tensor:
        return self.predict(x, **kw)

    def _as_input(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x))   # copies read-only arrays
        return x.to(device=self.device, dtype=self.theta.dtype)

    def predict(self, x, *, batch_size: int | None = None,
                backend: str = "ref", agent: int | None = None
                ) -> torch.Tensor:
        """Score inputs: f(x) = phi(x)' theta.

        x          — (..., d) inputs; leading dims are preserved (a bare (d,)
                     vector returns a scalar).
        batch_size — featurize the flattened batch in chunks of this many
                     rows (bounds peak memory); None = one pass.
        backend    — "ref" (plain) or "fused" (the K1 kernel on the card).
        agent      — score with agent i's theta instead of the average.
        """
        if agent is None:
            theta = self.theta
        elif self.thetas is None:
            raise ValueError("this model was exported without per-agent "
                             "thetas; re-export with include_per_agent=True")
        else:
            theta = sharding.unshard(self.thetas)[agent]

        x = self._as_input(x)
        scalar = x.ndim == 1
        if scalar:
            x = x[None]
        lead = x.shape[:-1]
        flat = x.reshape(-1, x.shape[-1])
        n = flat.shape[0]
        if batch_size is None or batch_size >= n:
            preds = _dot(self.featurize(flat, backend), theta)
        else:
            if batch_size < 1:
                raise ValueError(f"batch_size must be >= 1, got {batch_size}")
            preds = torch.cat([_dot(self.featurize(flat[i:i + batch_size],
                                                   backend), theta)
                               for i in range(0, n, batch_size)])
        preds = preds.reshape(lead)
        return preds[0] if scalar else preds

    def score_rows(self, x, thetas, *, backend: str = "ref") -> torch.Tensor:
        """Row-tagged scoring: row i of x (b, d) against row i of thetas
        (b, D), on the model's device — the bit-level reference of the
        multi-tenant `KernelServer`, which runs the same module-level
        `score_rows` on its gathered stack rows. A row's answer depends
        only on its own input and theta, never on b; it differs from
        `predict`'s (b, D) @ (D,) matvec only by the order of the sum."""
        thetas = self._as_input(thetas).contiguous()
        return score_rows(self.rff_params, self._as_input(x).contiguous(),
                          thetas, backend=backend, mesh=self.mesh)

    def partial_fit(self, stream, config=None, *, labels=None,
                    progress_cb=None) -> tuple["KernelModel", Any]:
        """Warm-started online refinement: continue training this model on
        a fresh per-agent minibatch stream through `fit_stream`, on the
        model's device.

        stream — a `StreamProblem` featurized with this model's RFF map,
                 or a raw (R, N, b, d) input stream (pass `labels`
                 (R, N, b)); a raw stream is featurized here and its
                 consensus graph built from the config's graph family.
        config — the streaming FitConfig; None = `online_coke` on the
                 simulator, one iteration per stream round, with this
                 model's provenance lam / rho / seed / graph.

        Every agent starts from the deployed parameters (the per-agent
        stack when the model kept one, else the consensus average).
        Returns (refined KernelModel, FitResult)."""
        from repro_torch.api.fit import fit_stream  # local: import cycle
        from repro_torch.api.problems import (StreamProblem, build_graph,
                                              stream_from_arrays)

        if isinstance(stream, StreamProblem):
            if labels is not None:
                raise ValueError(
                    "a StreamProblem already carries its labels; pass "
                    "labels= only with a raw (R, N, b, d) input stream")
        else:
            if labels is None:
                raise ValueError(
                    "a raw stream needs its labels: partial_fit(x, "
                    "labels=y) with x (R, N, b, d) and y (R, N, b)")
            x = self._as_input(stream)
            if x.ndim != 4:
                raise ValueError(
                    f"a raw stream is x (R, N, b, d); got shape "
                    f"{tuple(x.shape)}")
            num_agents = x.shape[1]
            if config is None:
                # provenance defaults: what the model was trained with
                lam = float(self.meta.get("lam", 1e-4))
                rho = float(self.meta.get("rho", 1e-2))
                seed = int(self.meta.get("seed", 0))
                config = self._stream_config(num_agents, x.shape[0],
                                             lam, rho)
            else:
                # an explicit config owns the problem spec end to end
                lam, rho = config.krr.lam, config.krr.rho
                seed = config.krr.seed
            graph = build_graph(config, num_agents, seed=seed)
            stream = stream_from_arrays(self.rff_params, x,
                                        self._as_input(labels), graph,
                                        lam=lam, rho=rho)
        if stream.feature_dim != self.num_features:
            raise ValueError(
                f"stream is featurized to D={stream.feature_dim} but this "
                f"model has D={self.num_features} features; featurize with "
                "the model's own RFF map (see "
                "repro.api.problems.stream_from_arrays)")
        if config is None:
            config = self._stream_config(
                stream.num_agents, stream.num_rounds,
                float(stream.lam), float(stream.rho))
        if (self.thetas is not None
                and self.thetas.shape[0] != stream.num_agents):
            raise ValueError(
                f"model carries {self.thetas.shape[0]} per-agent thetas "
                f"but the stream has {stream.num_agents} agents")

        theta0 = self.thetas if self.thetas is not None else self.theta
        result = fit_stream(config, stream=stream, theta0=theta0,
                            progress_cb=progress_cb, device=self.device)
        refined = result.to_model(self.rff_params)
        refined.bandwidth = self.bandwidth
        refined.kernel = self.kernel
        refined.meta = {**refined.meta, "refined_from": dict(self.meta),
                        "warm_started": True}
        return refined, result

    def _stream_config(self, num_agents: int, num_rounds: int,
                       lam: float, rho: float):
        """The default partial_fit configuration: streaming COKE on the
        simulator, one iteration per stream round, on the graph family
        the model was trained with (its provenance)."""
        from repro_torch.api.config import FitConfig  # local: import cycle
        from repro_torch.configs.coke_krr import KRRConfig

        return FitConfig(
            algorithm="online_coke", num_iters=num_rounds,
            graph=str(self.meta.get("graph", "erdos_renyi")),
            graph_offsets=tuple(self.meta.get("graph_offsets", (1,))),
            krr=KRRConfig(num_agents=num_agents,
                          num_features=self.num_features,
                          bandwidth=self.bandwidth, lam=lam, rho=rho,
                          graph_p=float(self.meta.get("graph_p", 0.3)),
                          seed=int(self.meta.get("seed", 0))))

    def evaluate(self, x, y, *, backend: str = "ref") -> dict[str, Any]:
        """The paper's generalization metrics on held-out data. With
        per-agent x (N, S, d) / y (N, S) and a per-agent theta stack,
        `test_mse` scores agent i's shard with theta_i (Section 5
        protocol) and `consensus_mse` scores every shard with the averaged
        theta; with flat x (S, d) the two coincide."""
        x = self._as_input(x)
        y = self._as_input(y)
        out: dict[str, Any] = {}
        if x.ndim == 3 and self.thetas is not None:
            phi = self.featurize(x, backend)                 # (N, S, D)
            preds = sharding.unshard(torch.einsum("nsd,nd->ns", phi,
                                                  self.thetas))
            err = (y - preds) ** 2
            out["test_mse"] = float(torch.mean(err))
            out["per_agent_mse"] = torch.mean(err, dim=-1)
            consensus_preds = _dot(phi, self.theta)          # (N, S)
            out["consensus_mse"] = float(
                torch.mean((y - consensus_preds) ** 2))
        else:
            preds = self.predict(x, backend=backend)
            out["test_mse"] = float(torch.mean((y - preds) ** 2))
            out["consensus_mse"] = out["test_mse"]
        out["rmse"] = out["test_mse"] ** 0.5
        return out

    # ---- persistence -----------------------------------------------------
    def _array_tree(self) -> dict[str, torch.Tensor]:
        """The artifact's arrays, whole (a sharded model's gathered)."""
        tree = {"omega": self.rff_params.omega,
                "bias": self.rff_params.bias,
                "theta": self.theta}
        if self.thetas is not None:
            tree["thetas"] = self.thetas
        return {k: sharding.unshard(v) for k, v in tree.items()}

    def save(self, path: str) -> None:
        """Write `<path>.npz` (arrays) + `<path>.model.json` (mapping,
        kernel, bandwidth, meta and shapes), the reference's format."""
        arrays = {k: v.detach().cpu().numpy()
                  for k, v in self._array_tree().items()}
        ckpt.save(path, arrays)
        sidecar = {
            "format": FORMAT,
            "mapping": self.rff_params.mapping,
            "kernel": self.kernel,
            "bandwidth": self.bandwidth,
            "meta": self.meta,
            "model_id": self.model_id,
            "version": self.version,
            "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in arrays.items()},
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.model.json.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(sidecar, f)
        os.replace(tmp, path + ".model.json")

    @classmethod
    def load(cls, path: str, *,
             device: torch.device | str | None = None) -> "KernelModel":
        """Load an artifact (saved by either package) onto `device`
        (None = "cuda")."""
        dev = resolve_device(device)
        with open(path + ".model.json") as f:
            sidecar = json.load(f)
        if sidecar.get("format") != FORMAT:
            raise ValueError(
                f"{path}.model.json is not a KernelModel artifact "
                f"(format={sidecar.get('format')!r})")
        like = {k: (tuple(s["shape"]), s["dtype"])
                for k, s in sidecar["arrays"].items()}
        arrays, _ = ckpt.restore(path, like)
        return model_from_arrays(arrays, sidecar, dev)


def model_from_arrays(arrays: dict[str, np.ndarray], sidecar: dict,
                      device: torch.device) -> KernelModel:
    """Build a KernelModel from the reference's array names (omega, bias,
    theta, optional thetas) and a sidecar dict (mapping, bandwidth, ...)."""
    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    params = rff.RFFParams(omega=t(arrays["omega"]), bias=t(arrays["bias"]),
                           mapping=sidecar.get("mapping", "cos_bias"))
    thetas = arrays.get("thetas")
    version = sidecar.get("version")
    return KernelModel(rff_params=params, theta=t(arrays["theta"]),
                       thetas=None if thetas is None else t(thetas),
                       bandwidth=float(sidecar.get("bandwidth", 1.0)),
                       kernel=sidecar.get("kernel", "gaussian"),
                       meta=dict(sidecar.get("meta", {})),
                       model_id=sidecar.get("model_id"),
                       version=None if version is None else int(version))


def predict(model_or_result, x, **kw) -> torch.Tensor:
    """Score inputs with a KernelModel or, as a convenience, a FitResult."""
    model = (model_or_result if isinstance(model_or_result, KernelModel)
             else model_or_result.to_model())
    return model.predict(x, **kw)
