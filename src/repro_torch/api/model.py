"""`KernelModel` — the deployable artifact: the common-seed RFF map plus the
fitted thetas, scored as f(x) = phi(x)' theta.

    model = fit(config).to_model()
    y_hat = model.predict(x_new, backend="fused")   # K1 kernel on the card
    model.evaluate(x_test, y_test, backend="fused")
    model.save("artifacts/coke")                    # npz + JSON sidecar
    model = KernelModel.load("artifacts/coke", device="cuda")

Scoring backends: "ref" is the plain `core.rff.featurize`; "fused" routes
featurization through the hand-written `kernels/rff` kernel (the plain
version on CPU tensors). The artifact format is the reference's
(`"format": "repro.api.KernelModel/v1"`), so a model saved by `repro` loads
here and predicts the same.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import rff
from repro_torch.device import resolve_device
from repro_torch.kernels.rff.ops import featurize_fused

PREDICT_BACKENDS = ("ref", "fused")
FORMAT = "repro.api.KernelModel/v1"


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
                 model_id: str | None = None, version: int | None = None):
        super().__init__()
        self.mapping = rff_params.mapping
        self.register_buffer("omega", rff_params.omega)
        self.register_buffer("bias", rff_params.bias)
        self.register_buffer("theta", theta)
        self.register_buffer("thetas", thetas)
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

    # ---- scoring ---------------------------------------------------------
    def featurize(self, x: torch.Tensor, backend: str = "ref") -> torch.Tensor:
        """phi(x) on the chosen backend — the one routing point of every
        scoring path (predict, evaluate)."""
        if backend == "ref":
            return rff.featurize(self.rff_params, x)
        if backend == "fused":
            if self.rff_params.mapping != "cos_bias":
                raise ValueError(
                    "the fused featurizer implements the 'cos_bias' mapping "
                    f"(Eq. 13); this model uses {self.rff_params.mapping!r} "
                    "— use backend='ref'")
            return featurize_fused(self.rff_params, x)
        raise ValueError(
            f"unknown predict backend {backend!r}; choose from "
            f"{PREDICT_BACKENDS}")

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
            theta = self.thetas[agent]

        x = self._as_input(x)
        scalar = x.ndim == 1
        if scalar:
            x = x[None]
        lead = x.shape[:-1]
        flat = x.reshape(-1, x.shape[-1])
        n = flat.shape[0]
        if batch_size is None or batch_size >= n:
            preds = self.featurize(flat, backend) @ theta
        else:
            if batch_size < 1:
                raise ValueError(f"batch_size must be >= 1, got {batch_size}")
            preds = torch.cat([self.featurize(flat[i:i + batch_size],
                                              backend) @ theta
                               for i in range(0, n, batch_size)])
        preds = preds.reshape(lead)
        return preds[0] if scalar else preds

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
            preds = torch.einsum("nsd,nd->ns", phi, self.thetas)
            err = (y - preds) ** 2
            out["test_mse"] = float(torch.mean(err))
            out["per_agent_mse"] = torch.mean(err, dim=-1)
            consensus_preds = phi @ self.theta               # (N, S)
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
        tree = {"omega": self.rff_params.omega,
                "bias": self.rff_params.bias,
                "theta": self.theta}
        if self.thetas is not None:
            tree["thetas"] = self.thetas
        return tree

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
