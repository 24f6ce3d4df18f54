"""Policy-grid sweeps (the reference's `api/sweep.py`): not ported yet."""
from __future__ import annotations


def sweep(config, *args, **kwargs):
    """The capability table raises the reference's ValueError where the
    reference rejects the cell, else NotImplementedError naming ROADMAP.md
    item 12."""
    from repro_torch.api.capabilities import check_sweep
    from repro_torch.api.registry import solver_spec

    check_sweep(config, solver_spec(config.algorithm))
    raise AssertionError("the capability table admitted sweep")
