"""npz checkpointing in the reference's file format.

`save` writes `<path>.npz` (one array per flat key) and `<path>.json` (a
small manifest with the step), both atomically (temp file + os.replace), as
`repro/ckpt/checkpoint.py` does, so artifacts move between the packages.
"""
from __future__ import annotations

import json
import os

import numpy as np


def _write_atomic(path: str, write_fn) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save(path: str, arrays: dict[str, np.ndarray], step: int = 0) -> None:
    """Write a flat {name: numpy array} dict."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def _dump_npz(tmp):
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)

    _write_atomic(path + ".npz", _dump_npz)
    keys = ", ".join(f"{k!r}: *" for k in sorted(arrays))
    manifest = {"step": step, "num_leaves": len(arrays),
                "treedef": f"PyTreeDef({{{keys}}})"}

    def _dump_json(tmp):
        with open(tmp, "w") as f:
            json.dump(manifest, f)

    _write_atomic(path + ".json", _dump_json)


def restore(path: str, like: dict[str, tuple[tuple[int, ...], str]]
            ) -> tuple[dict[str, np.ndarray], int]:
    """`like`: {name: (shape, dtype name)}. Returns ({name: array}, step)."""
    out = {}
    with np.load(path + ".npz") as data:
        for key, (shape, dtype) in like.items():
            arr = data[key]
            if arr.shape != tuple(shape):
                raise ValueError(f"checkpoint leaf {key}: shape {arr.shape} "
                                 f"!= expected {tuple(shape)}")
            out[key] = arr.astype(dtype)
    with open(path + ".json") as f:
        step = json.load(f)["step"]
    return out, step
