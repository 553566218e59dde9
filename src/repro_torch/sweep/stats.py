"""Deterministic aggregation statistics for sweep cells.

Every number here must be reproducible run-to-run and machine-to-machine
for the same inputs: the bootstrap resampler is seeded from a stable
hash of the aggregation key (never from global RNG state or the wall
clock), and percentiles use numpy's default linear interpolation on the
sorted sample. ``aggregate`` is the single shape every claim row in a
``BENCH_*.json`` file carries (``n``, ``mean``, ``ci_lo``/``ci_hi``,
percentiles), and ``ci_regressed`` is the statistical CI gate
``scripts/check_bench_regression.py`` applies to those rows: two
confidence intervals overlap => no verdict; disjoint *in the bad
direction* => regression.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Sequence

import numpy as np

#: bootstrap resamples behind every committed confidence interval
N_BOOT = 1000

#: two-sided confidence level of the bootstrap interval
CI_LEVEL = 0.95


def stable_hash(key: str, bits: int = 32) -> int:
    """Platform- and process-stable integer hash of a string (sha256
    prefix). Python's builtin ``hash`` is salted per process, so it can
    never seed anything that must reproduce across runs."""
    digest = hashlib.sha256(key.encode("utf-8")).digest()
    return int.from_bytes(digest[: bits // 8], "big")


def aggregate(values: Sequence[float], *, key: str = "",
              n_boot: int = N_BOOT) -> Dict[str, float]:
    """Summary row for one (cell-group, metric): mean, population std,
    5/50/95 percentiles and a ``CI_LEVEL`` bootstrap percentile CI of
    the mean. The resampler is seeded from ``key`` alone, so the same
    sample aggregated under the same key yields bit-identical CIs on
    every machine."""
    arr = np.asarray(list(values), dtype=float)
    if arr.size == 0:
        raise ValueError("aggregate() needs at least one value")
    p5, p50, p95 = (float(np.percentile(arr, q)) for q in (5, 50, 95))
    mean = float(arr.mean())
    if arr.size == 1:
        lo = hi = mean
    else:
        rng = np.random.RandomState(stable_hash(f"boot:{key}"))
        picks = rng.randint(0, arr.size, size=(n_boot, arr.size))
        means = arr[picks].mean(axis=1)
        alpha = 100.0 * (1.0 - CI_LEVEL) / 2.0
        lo = float(np.percentile(means, alpha))
        hi = float(np.percentile(means, 100.0 - alpha))
    return {"n": int(arr.size), "mean": mean,
            "std": float(arr.std(ddof=0)),
            "p5": p5, "p50": p50, "p95": p95,
            "ci_lo": lo, "ci_hi": hi}


def ci_regressed(stored: Dict[str, float], fresh: Dict[str, float], *,
                 higher_is_bad: bool) -> bool:
    """The statistical regression verdict: True when the fresh CI and
    the stored CI are *disjoint in the bad direction* — the entire
    fresh interval sits on the worse side of the entire stored one.
    Overlapping intervals (or a fresh interval disjoint in the *good*
    direction) never trip the gate."""
    if higher_is_bad:
        return fresh["ci_lo"] > stored["ci_hi"]
    return fresh["ci_hi"] < stored["ci_lo"]
