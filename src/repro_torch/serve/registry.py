"""`ModelRegistry` — the disk-backed catalog behind many-model serving.

One registry directory holds every published `KernelModel` artifact, keyed
by model id and version, in the reference's layout:

    <root>/<model_id>/v00000001/model.npz          (arrays)
    <root>/<model_id>/v00000001/model.model.json   (sidecar)
    <root>/<model_id>/v00000002/...

Each version is exactly one `KernelModel.save` artifact, in the format
both packages read and write, so a directory written by either loads in
the other with its arrays bitwise equal. The artifact is stamped with its
(model_id, version) identity on publish.

Publishes are atomic: the artifact is written into a hidden temp directory
and `os.rename`d into its version slot. A reader never sees a torn
version; of two concurrent publishers of one id, the loser of the rename
retries with the next version number. `KernelServer.publish` relies on
that: the registry gains the new version first, then the resident slot
flips, and a crash between the two leaves a valid catalog.

`load` puts the model on the registry's device (None = "cuda"; pass
device="cpu" without a card). The registry is the backing store
`ThetaStore` pages against: faults load the latest version, dirty
evictions publish back.
"""
from __future__ import annotations

import os
import re
import shutil

import torch

from repro_torch.api.model import KernelModel
from repro_torch.device import resolve_device

_ID_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9._\-]*")
_VERSION_RE = re.compile(r"v(\d{8})")
_ARTIFACT = "model"  # basename of the KernelModel artifact inside a version


def _check_id(model_id: str) -> str:
    if not isinstance(model_id, str) or not _ID_RE.fullmatch(model_id):
        raise ValueError(
            f"invalid model id {model_id!r}: ids are [A-Za-z0-9._-]+ and "
            "may not start with '.' (reserved for temp dirs)")
    return model_id


class ModelRegistry:
    """Versioned catalog of `KernelModel` artifacts under one root dir;
    loads go to `device`."""

    def __init__(self, root: str, *,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    # ---- paths -----------------------------------------------------------
    def _model_dir(self, model_id: str) -> str:
        return os.path.join(self.root, _check_id(model_id))

    def _version_dir(self, model_id: str, version: int) -> str:
        return os.path.join(self._model_dir(model_id), f"v{version:08d}")

    def artifact_path(self, model_id: str, version: int) -> str:
        """The `KernelModel.save`/`load` path of one published version."""
        return os.path.join(self._version_dir(model_id, version), _ARTIFACT)

    # ---- catalog ---------------------------------------------------------
    def models(self) -> list[str]:
        """All model ids with at least one published version, sorted."""
        try:
            entries = sorted(os.listdir(self.root))
        except FileNotFoundError:
            return []
        return [e for e in entries
                if _ID_RE.fullmatch(e) and self.versions(e)]

    def versions(self, model_id: str) -> list[int]:
        """Published versions of one model, ascending ([] if unknown)."""
        try:
            entries = os.listdir(self._model_dir(model_id))
        except FileNotFoundError:
            return []
        out = []
        for e in entries:
            m = _VERSION_RE.fullmatch(e)
            # a version exists iff its sidecar does: a temp dir mid-rename
            # or a half-deleted version never shows up in the catalog
            if m and os.path.exists(os.path.join(
                    self._model_dir(model_id), e, _ARTIFACT + ".model.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_version(self, model_id: str) -> int | None:
        vs = self.versions(model_id)
        return vs[-1] if vs else None

    def __contains__(self, model_id: str) -> bool:
        return bool(self.versions(model_id))

    def __len__(self) -> int:
        return len(self.models())

    # ---- publish / load --------------------------------------------------
    def publish(self, model_id: str, model: KernelModel, *,
                version: int | None = None) -> int:
        """Write one new version of `model_id` atomically; returns the
        version number. With `version=None` (the norm) the next free
        version is taken, retrying past concurrent publishers; an explicit
        `version` raises ValueError if that slot is already taken. The
        caller's model is not changed: a copy carries the stamp."""
        base = self._model_dir(model_id)
        os.makedirs(base, exist_ok=True)
        attempt = 0
        while True:
            v = version if version is not None \
                else (self.latest_version(model_id) or 0) + 1 + attempt
            final = self._version_dir(model_id, v)
            if os.path.exists(final):
                if version is not None:
                    raise ValueError(
                        f"{model_id} v{v} is already published; versions "
                        "are immutable — publish a new one")
                attempt += 1
                continue
            tmp = os.path.join(base, f".tmp-v{v:08d}-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            model.replace(model_id=model_id, version=v).save(
                os.path.join(tmp, _ARTIFACT))
            try:
                os.rename(tmp, final)  # atomic claim of the version slot
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)
                if version is not None:
                    raise ValueError(
                        f"{model_id} v{v} was published concurrently; "
                        "versions are immutable — publish a new one")
                attempt += 1
                continue
            return v

    def load(self, model_id: str, version: int | None = None) -> KernelModel:
        """Load one version (latest by default) onto the registry's device,
        bitwise what was published. Raises KeyError for an unknown
        id/version."""
        _check_id(model_id)
        if version is None:
            version = self.latest_version(model_id)
            if version is None:
                raise KeyError(
                    f"model {model_id!r} is not in the registry at "
                    f"{self.root!r}")
        path = self.artifact_path(model_id, version)
        if not os.path.exists(path + ".model.json"):
            raise KeyError(
                f"model {model_id!r} has no version {version} "
                f"(published: {self.versions(model_id) or 'none'})")
        return KernelModel.load(path, device=self.device)
