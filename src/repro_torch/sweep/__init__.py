"""Monte-Carlo sweeps over the scheduler simulator: cells (the
``fabric_contention``, ``elastic_churn`` and ``chaos`` families), the
lockstep executor whose fabric fills go through the batched CUDA fill
kernel, and the deterministic aggregation of per-cell metrics (a port of
``repro/sweep/``; the process pool, the result store and the ``selftest``
family that probes the pool are not ported yet)."""
from repro_torch.sweep.cells import (CELL_FAMILIES, LOCKSTEP_BUILDERS,
                                     CellSpec, make_params, matrix, run_cell,
                                     summary_metrics)
from repro_torch.sweep.engine import (SweepEngine, SweepStats,
                                      aggregate_cells, aggregate_json,
                                      run_serial)
from repro_torch.sweep.stats import aggregate, ci_regressed, stable_hash

_LOCKSTEP = ("DeferredFillBackend", "LockstepExecutor", "LockstepStats")


def __getattr__(name):
    # the lockstep names load on first use, so that ``python -m
    # repro_torch.sweep.lockstep`` does not import its module twice
    if name in _LOCKSTEP:
        from repro_torch.sweep import lockstep
        return getattr(lockstep, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "CELL_FAMILIES", "LOCKSTEP_BUILDERS", "CellSpec", "make_params",
    "matrix", "run_cell", "summary_metrics", "SweepEngine", "SweepStats",
    "aggregate_cells", "aggregate_json", "run_serial",
    "DeferredFillBackend", "LockstepExecutor", "LockstepStats",
    "aggregate", "ci_regressed", "stable_hash",
]
