"""Policy-grid sweeps (the reference's `api/sweep.py`): not ported yet."""
from __future__ import annotations


def sweep(config, *args, **kwargs):
    raise NotImplementedError(
        "sweep is not ported to repro_torch yet: ROADMAP.md Queue 1 item 12")
