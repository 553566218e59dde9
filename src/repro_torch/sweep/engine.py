"""Run-matrix orchestrator: (algorithm x scenario x seed) cells with
deterministic aggregation, a copy of ``repro/sweep/engine.py`` without its
process pool and its content-addressed store (not ported yet).

Guarantees the claim checks lean on:

  * **bit-identical cells** — a cell's metrics depend only on its
    :class:`repro_torch.sweep.cells.CellSpec` (the simulation seed is
    re-derived from the cell key), so the same matrix produces the same
    per-cell results for any cell submission order and either backend;
  * **order-independent aggregates** — results are keyed and iterated
    by canonical cell key, so the aggregate JSON is byte-identical for
    a shuffled matrix.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.device import DeviceLike
from repro_torch.sweep.cells import CellSpec, run_cell
from repro_torch.sweep.stats import aggregate

MetricRow = Dict[str, float]


@dataclasses.dataclass
class SweepStats:
    """Execution accounting for one ``SweepEngine.run``."""

    n_cells: int = 0
    n_cached: int = 0     # always 0: the store is not ported yet
    n_executed: int = 0   # actually simulated this run
    workers: int = 1
    wall_s: float = 0.0

    @property
    def cells_per_s(self) -> float:
        return self.n_cells / self.wall_s if self.wall_s > 0 else 0.0


class SweepEngine:
    """Executes cell matrices in this process: ``backend="pool"`` with
    ``workers=1`` runs the cells one after another (the JAX package's
    inline path), ``backend="lockstep"`` through
    :class:`repro_torch.sweep.lockstep.LockstepExecutor` on ``device``,
    whose accounting lands in ``self.lockstep_stats`` after ``run``. The
    JAX package's process pool (``workers > 1``) and its result store
    are not ported yet; asking for either raises."""

    def __init__(self, *, workers: int = 1, store=None,
                 backend: str = "pool", device: DeviceLike = None):
        if backend not in ("pool", "lockstep"):
            raise ValueError(f"unknown sweep backend {backend!r}")
        if int(workers) > 1 and backend == "pool":
            raise NotImplementedError(
                "the sweep's process pool is not ported yet (workers > 1)")
        if store is not None:
            raise NotImplementedError(
                "the sweep's result store is not ported yet")
        self.workers = max(1, int(workers))
        self.store = None
        self.backend = backend
        self.device = device
        self.lockstep_stats = None

    def run(self, specs: Sequence[CellSpec]
            ) -> Tuple[Dict[str, MetricRow], SweepStats]:
        """Execute every cell, returning ``{cell key: metrics}`` (keyed
        and sorted canonically — submission order never leaks out) plus
        execution stats. Duplicate specs are executed once."""
        t0 = time.perf_counter()
        stats = SweepStats(workers=self.workers)
        keys: List[str] = []
        seen = set()
        for spec in specs:
            k = spec.key()
            if k not in seen:
                seen.add(k)
                keys.append(k)
        stats.n_cells = len(keys)
        if self.backend == "lockstep":
            from repro_torch.sweep.lockstep import LockstepExecutor
            ex = LockstepExecutor(device=self.device)
            results = ex.run([CellSpec.from_key(k) for k in keys])
            self.lockstep_stats = ex.stats
        else:
            results = {k: run_cell(CellSpec.from_key(k)) for k in keys}
        stats.n_executed = len(results)
        stats.wall_s = time.perf_counter() - t0
        return {k: results[k] for k in sorted(results)}, stats


def run_serial(specs: Sequence[CellSpec]) -> Dict[str, MetricRow]:
    """The baseline the orchestrator's throughput is measured against:
    plain in-process loop, no cache, no pool."""
    return {s.key(): run_cell(s) for s in specs}


def aggregate_cells(results: Dict[str, MetricRow],
                    group_by: Iterable[str] = ("scenario", "algo"),
                    metrics: Optional[Sequence[str]] = None
                    ) -> List[dict]:
    """Aggregation layer: group per-cell metric dicts over seeds and
    emit one summary row (``repro_torch.sweep.stats.aggregate``) per
    (group, metric). Rows are sorted by (group values, metric), and the
    bootstrap key is the group+metric identity, so the output is
    byte-identical however the cells were scheduled."""
    group_by = tuple(group_by)
    groups: Dict[tuple, List[MetricRow]] = {}
    for key in sorted(results):
        spec = json.loads(key)
        gid = tuple(str(spec[g]) for g in group_by)
        groups.setdefault(gid, []).append(results[key])
    rows: List[dict] = []
    for gid in sorted(groups):
        cells = groups[gid]
        names = metrics if metrics is not None else sorted(cells[0])
        for m in names:
            values = [c[m] for c in cells if m in c]
            if not values:
                continue
            row = dict(zip(group_by, gid))
            row["metric"] = m
            row.update(aggregate(
                values, key=f"{'/'.join(gid)}:{m}"))
            rows.append(row)
    return rows


def aggregate_json(results: Dict[str, MetricRow], **kw) -> str:
    """Canonical serialized aggregate — the artifact the determinism
    claims compare byte-for-byte across worker counts and cell
    orders."""
    return json.dumps(aggregate_cells(results, **kw), sort_keys=True)
