"""Run-matrix orchestrator: (algorithm x scenario x seed) cells across
parallel worker processes, with content-addressed caching and
deterministic aggregation (a copy of ``repro/sweep/engine.py``; its
lockstep backend runs the fill kernel on ``device``).

Guarantees the claim checks lean on:

  * **bit-identical cells** — a cell's metrics depend only on its
    :class:`repro_torch.sweep.cells.CellSpec` (the simulation seed is
    re-derived from the cell key inside the worker), so the same matrix
    produces the same per-cell results for any worker count, any cell
    submission order, any backend and any mix of cached/fresh entries.
    Workers deliberately *poison* their inherited global RNGs at startup
    (``_poison_worker_rng``: ``random``, ``np.random`` and torch's default
    generator): a cell that accidentally consumed pool state would
    diverge between pool sizes and fail the determinism claims instead
    of silently biasing a distribution.
  * **order-independent aggregates** — results are keyed and iterated
    by canonical cell key, so the aggregate JSON is byte-identical for
    a shuffled matrix.
  * **free re-runs** — cells hit the content-addressed store
    (``repro_torch.sweep.cache.ResultStore``, keyed on code fingerprint +
    cell key) before any process is spawned; an unchanged matrix on
    unchanged code executes zero simulations.

Workers are spawned (not forked): a forked child of a parent that has
initialised CUDA cannot use it, and a fresh interpreter per worker makes
the "nothing inherited" property structural rather than accidental. A
pool cell is host code, so a worker never initialises CUDA (each would
hold a context of several hundred MB on the card); every worker reports
whether it did, in ``SweepStats.worker_cuda``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import random
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.sweep.cache import ResultStore
from repro_torch.sweep.cells import CellSpec, run_cell
from repro_torch.sweep.stats import aggregate

MetricRow = Dict[str, float]


@dataclasses.dataclass
class SweepStats:
    """Execution accounting for one ``SweepEngine.run``."""

    n_cells: int = 0
    n_cached: int = 0     # served from the content-addressed store
    n_executed: int = 0   # actually simulated this run
    workers: int = 1
    wall_s: float = 0.0
    # -- robustness accounting ------------------------------------------
    n_retried: int = 0        # cell attempts re-queued after crash/hang
    n_poisoned: int = 0       # cells abandoned after max_attempts
    n_timeouts: int = 0       # attempts killed by the per-cell timeout
    n_pool_rebuilds: int = 0  # pools rebuilt after a crash or a hang
    #: per-cell execution report, keyed by cell key: ``{"attempts",
    #: "crashes", "timeouts", "status"}`` with status one of
    #: ``ok | poisoned``. Only cells that missed the cache appear.
    cell_report: Dict[str, dict] = dataclasses.field(default_factory=dict)
    #: pool workers that ran a cell: pid -> whether CUDA was initialised
    #: in that worker after the cell (it never should be)
    worker_cuda: Dict[int, bool] = dataclasses.field(default_factory=dict)

    @property
    def cells_per_s(self) -> float:
        return self.n_cells / self.wall_s if self.wall_s > 0 else 0.0


def _poison_worker_rng() -> None:
    """Worker initializer: scramble the global RNGs with process-local
    garbage. Cells must re-derive every stream from their cell key; if
    one ever reads global state instead, pool-of-1 and pool-of-8 runs
    diverge and the determinism claims fail loudly."""
    noise = (os.getpid() * 2654435761 + int(time.time_ns() & 0xFFFF))
    random.seed(noise)
    np.random.seed(noise % (2 ** 32 - 1))
    # the CPU generator only: seeding CUDA's would be a CUDA call
    torch.default_generator.manual_seed(noise)


def _worker_run(key: str) -> Tuple[str, MetricRow]:
    spec = CellSpec.from_key(key)
    return key, run_cell(spec)


def _pool_worker_run(key: str) -> Tuple[str, MetricRow, int, bool]:
    """``_worker_run`` in a pool worker, plus the worker's pid and whether
    CUDA is initialised in it after the cell."""
    key, metrics = _worker_run(key)
    return key, metrics, os.getpid(), torch.cuda.is_initialized()


class SweepEngine:
    """Executes cell matrices; see the module docstring for the
    determinism and caching contract.

    ``workers=1`` runs cells inline (no pool, no RNG poisoning of the
    calling process); ``workers>1`` spawns that many fresh worker
    interpreters. ``store=None`` disables caching entirely.

    ``backend="lockstep"`` executes cache misses in-process through
    :class:`repro_torch.sweep.lockstep.LockstepExecutor` on ``device`` —
    many simulators advancing in synchronized epochs with their fabric
    fills batched into one launch of the fill kernel per epoch — instead
    of the process pool. Results are bit-compatible with the pool path
    (same per-cell metrics, same store entries), so the two backends
    share one cache; ``workers`` is ignored in lockstep mode. The
    executor's accounting lands in ``self.lockstep_stats`` after ``run``.

    ``cell_timeout`` bounds each cell attempt's wall-clock in
    the pool backend: an attempt still running past the deadline is
    charged a timeout, the pool (the only way to reclaim a hung spawned
    worker) is torn down and rebuilt, and innocent in-flight cells are
    re-queued uncharged. A worker hard-crash (``BrokenProcessPool``)
    likewise charges every in-flight attempt — the culprit is
    indistinguishable from the victims — rebuilds the pool, and retries
    after a capped exponential backoff. A cell that keeps failing is
    *poisoned* after ``max_attempts``: recorded with
    ``status="poisoned"`` in ``SweepStats.cell_report`` and omitted
    from the result dict, so one bad cell cannot sink a whole sweep —
    and because results are keyed by canonical cell key, the aggregate
    rows of unaffected cells stay byte-identical to a crash-free run.
    The inline (``workers=1``) and lockstep backends run in-process,
    where a hard crash cannot be contained; they do not retry. Lockstep
    lanes are instead guarded by the executor's own deadlock check,
    which raises if an epoch advances no lane.
    """

    def __init__(self, *, workers: int = 1,
                 store: Optional[ResultStore] = None,
                 backend: str = "pool",
                 cell_timeout: Optional[float] = None,
                 max_attempts: int = 3,
                 retry_backoff_s: float = 0.5,
                 retry_backoff_cap_s: float = 30.0,
                 device: DeviceLike = None):
        if backend not in ("pool", "lockstep"):
            raise ValueError(f"unknown sweep backend {backend!r}")
        self.workers = max(1, int(workers))
        self.store = store
        self.backend = backend
        self.device = device
        self.cell_timeout = cell_timeout
        self.max_attempts = max(1, int(max_attempts))
        self.retry_backoff_s = retry_backoff_s
        self.retry_backoff_cap_s = retry_backoff_cap_s
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

        results: Dict[str, MetricRow] = {}
        misses: List[str] = []
        for k in keys:
            hit = self.store.get(k) if self.store is not None else None
            if hit is not None:
                results[k] = hit
                stats.n_cached += 1
            else:
                misses.append(k)

        if misses:
            if self.backend == "lockstep":
                from repro_torch.sweep.lockstep import LockstepExecutor
                ex = LockstepExecutor(device=self.device)
                fresh = ex.run([CellSpec.from_key(k)
                                for k in misses]).items()
                self.lockstep_stats = ex.stats
            elif self.workers == 1:
                fresh = map(_worker_run, misses)
            else:
                fresh = self._execute_pool(misses, stats).items()
            for k, metrics in fresh:
                results[k] = metrics
                stats.n_executed += 1
                if self.store is not None:
                    self.store.put(k, metrics)

        stats.wall_s = time.perf_counter() - t0
        return {k: results[k] for k in sorted(results)}, stats

    # -- robust pool execution ------------------------------------------
    def _new_pool(self):
        # spawn: fresh interpreters, nothing inherited (see module
        # docstring)
        ctx = multiprocessing.get_context("spawn")
        return concurrent.futures.ProcessPoolExecutor(
            max_workers=self.workers, mp_context=ctx,
            initializer=_poison_worker_rng)

    @staticmethod
    def _kill_pool(pool) -> None:
        """Tear a pool down even when its workers are hung or dead:
        SIGTERM every worker, then a non-blocking shutdown (a blocking
        one would wait on a worker that is asleep forever)."""
        procs = list(getattr(pool, "_processes", {}).values())
        for p in procs:
            if p.is_alive():
                p.terminate()
        pool.shutdown(wait=False, cancel_futures=True)
        for p in procs:
            p.join(timeout=5.0)

    def _execute_pool(self, misses: Sequence[str], stats: SweepStats
                      ) -> Dict[str, MetricRow]:
        """Run cache-missed cells through spawned workers with crash
        recovery, per-cell timeouts, and poisoned-cell accounting (see
        the class docstring)."""
        from concurrent.futures.process import BrokenProcessPool
        report = stats.cell_report
        for k in misses:
            report[k] = {"attempts": 0, "crashes": 0, "timeouts": 0,
                         "status": "pending"}
        done: Dict[str, MetricRow] = {}
        queue: List[str] = list(misses)
        pool = None
        try:
            while queue:
                if pool is None:
                    pool = self._new_pool()
                futs: Dict[concurrent.futures.Future, str] = {}
                for k in queue:
                    report[k]["attempts"] += 1
                    futs[pool.submit(_pool_worker_run, k)] = k
                queue = []
                started: Dict[concurrent.futures.Future, float] = {}
                failed: List[str] = []
                while futs:
                    waited = concurrent.futures.wait(
                        set(futs),
                        timeout=None if self.cell_timeout is None
                        else min(0.05, self.cell_timeout / 4),
                        return_when=concurrent.futures.FIRST_COMPLETED)
                    now = time.monotonic()
                    broken = False
                    for f in waited.done:
                        k = futs.pop(f)
                        started.pop(f, None)
                        try:
                            _, metrics, pid, cuda = f.result()
                            done[k] = metrics
                            stats.worker_cuda[pid] = (
                                stats.worker_cuda.get(pid, False) or cuda)
                            report[k]["status"] = "ok"
                        except BrokenProcessPool:
                            report[k]["crashes"] += 1
                            failed.append(k)
                            broken = True
                    if broken:
                        # the pool is dead and every in-flight future is
                        # lost with it; the culprit is indistinguishable
                        # from the victims, so all of them are charged
                        for f, k in sorted(futs.items(),
                                           key=lambda i: i[1]):
                            report[k]["crashes"] += 1
                            failed.append(k)
                        futs.clear()
                        self._kill_pool(pool)
                        pool = None
                        stats.n_pool_rebuilds += 1
                        break
                    if self.cell_timeout is None:
                        continue
                    overdue: List[concurrent.futures.Future] = []
                    for f in list(futs):
                        if f.running():
                            t0 = started.setdefault(f, now)
                            if now - t0 > self.cell_timeout:
                                overdue.append(f)
                    if overdue:
                        # a hung spawned worker can only be reclaimed by
                        # killing the whole pool (there is no per-future
                        # kill); charge the overdue cells, re-queue the
                        # innocent in-flight ones uncharged
                        for f in overdue:
                            k = futs.pop(f)
                            report[k]["timeouts"] += 1
                            stats.n_timeouts += 1
                            failed.append(k)
                        for f, k in futs.items():
                            report[k]["attempts"] -= 1
                            queue.append(k)
                        futs.clear()
                        self._kill_pool(pool)
                        pool = None
                        stats.n_pool_rebuilds += 1
                        break
                for k in sorted(failed):
                    if report[k]["attempts"] >= self.max_attempts:
                        report[k]["status"] = "poisoned"
                        stats.n_poisoned += 1
                    else:
                        stats.n_retried += 1
                        queue.append(k)
                if failed and queue:
                    wave = max(report[k]["attempts"] for k in queue)
                    time.sleep(min(self.retry_backoff_cap_s,
                                   self.retry_backoff_s
                                   * (2 ** max(0, wave - 1))))
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        return done


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
