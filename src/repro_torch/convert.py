"""Carry the reference's arrays into the port.

A port draw of the random features at a seed does not equal the
reference's `jax.random` draw, so a problem or a model moves between the
two packages by its arrays: these helpers take numpy arrays (from the JAX
package, `np.asarray(...)`) and build the port's objects on a device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.model import KernelModel, model_from_arrays
from repro_torch.core.admm import Problem
from repro_torch.core.rff import RFFParams
from repro_torch.device import resolve_device


def rff_params_from_numpy(omega, bias, mapping: str = "cos_bias", *,
                          device: torch.device | str | None = None
                          ) -> RFFParams:
    dev = resolve_device(device)
    return RFFParams(omega=torch.tensor(np.asarray(omega), device=dev),
                     bias=torch.tensor(np.asarray(bias), device=dev),
                     mapping=mapping)


def problem_from_numpy(feats, labels, adjacency, lam: float, rho: float,
                       loss: str = "quadratic",
                       device: torch.device | str | None = None) -> Problem:
    dev = resolve_device(device)
    feats = torch.tensor(np.asarray(feats), device=dev)
    return Problem(
        feats=feats,
        labels=torch.tensor(np.asarray(labels), device=dev),
        adjacency=torch.tensor(np.asarray(adjacency), dtype=feats.dtype,
                               device=dev),
        lam=float(lam), rho=float(rho), loss=loss)


def model_from_numpy(arrays: dict, sidecar: dict | None = None, *,
                     device: torch.device | str | None = None
                     ) -> KernelModel:
    """`arrays` uses the reference's `KernelModel._array_tree()` names
    (omega, bias, theta, optional thetas); `sidecar` the saved sidecar's
    keys (mapping, bandwidth, kernel, meta, ...)."""
    return model_from_arrays({k: np.asarray(v) for k, v in arrays.items()},
                             sidecar or {}, resolve_device(device))
