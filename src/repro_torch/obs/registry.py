"""Metric primitives for the telemetry subsystem.

Three shapes, all deterministic and allocation-light:

* :class:`Counter` — monotone accumulator (churn losses, flows done).
* :class:`Gauge` — last-written value (current backlog, fleet size).
  Gauges written from the *exact* objects control loops consume (e.g.
  the ``FleetObservation`` handed to the autoscaler) are what makes
  scoreboard-fed decisions provably bit-identical to direct reads.
* :class:`WindowSeries` — fixed-width time windows ``[i*w, (i+1)*w)``
  accumulating into dense buckets. ``add`` drops a point value into the
  window containing ``t``; ``add_range`` prorates an amount uniformly
  over ``[t0, t1)`` across every window it overlaps — the primitive
  behind per-window link-utilization integrals (a transfer spanning a
  window boundary charges each window its elapsed share).

The registry is get-or-create keyed by name; iteration order is
insertion order (plain dicts), which keeps every derived artifact —
summaries, traces, hashes — deterministic per seed.

Determinism rules (shared with the whole ``repro_torch.obs`` package): no RNG,
no wall clock, no event-heap entries. Everything here is pure arithmetic
on simulation timestamps.
"""
from __future__ import annotations

from typing import Dict, List, Optional


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v


class WindowSeries:
    """Fixed-width windowed accumulator. Bucket ``i`` covers
    ``[i*window, (i+1)*window)``; buckets are dense from t=0 (the
    simulation clock starts there) and extend lazily."""

    __slots__ = ("name", "window", "values")

    def __init__(self, name: str, window: float):
        if window <= 0.0:
            raise ValueError("window width must be positive")
        self.name = name
        self.window = window
        self.values: List[float] = []

    def _bucket(self, t: float) -> int:
        return int(t // self.window)

    def add(self, t: float, v: float) -> None:
        """Accumulate ``v`` into the window containing ``t``."""
        b = self._bucket(t)
        vals = self.values
        if b >= len(vals):
            vals.extend(0.0 for _ in range(b + 1 - len(vals)))
        vals[b] += v

    def add_range(self, t0: float, t1: float, v: float) -> None:
        """Prorate ``v`` uniformly over ``[t0, t1)``: each overlapped
        window receives ``v * (overlap / (t1 - t0))``. A zero-length
        range degenerates to a point ``add`` at ``t0``."""
        if t1 <= t0:
            if v:
                self.add(t0, v)
            return
        w = self.window
        b0, b1 = int(t0 // w), int(t1 // w)
        if b0 == b1:
            self.add(t0, v)
            return
        rate = v / (t1 - t0)
        self.add(t0, rate * ((b0 + 1) * w - t0))
        for b in range(b0 + 1, b1):
            self.add(b * w, rate * w)
        tail = t1 - b1 * w
        if tail > 0.0:
            self.add(b1 * w, rate * tail)

    # -- reads ---------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.values)

    def at(self, i: int) -> float:
        """Value of window ``i`` (0.0 for never-touched windows)."""
        return self.values[i] if 0 <= i < len(self.values) else 0.0

    def latest_closed(self, now: float) -> float:
        """Value of the last *fully closed* window at time ``now`` (the
        window containing ``now`` is still accumulating)."""
        return self.at(self._bucket(now) - 1)

    def closed_values(self, now: float) -> List[float]:
        """All fully-closed window values up to ``now`` (dense; windows
        nothing touched read 0.0)."""
        n = self._bucket(now)
        vals = self.values
        if n <= len(vals):
            return vals[:n]
        return vals + [0.0] * (n - len(vals))


class MetricRegistry:
    """Get-or-create store for counters, gauges and window series.
    ``window`` is the default series width; a per-series override is
    allowed at first creation."""

    def __init__(self, window: float = 30.0):
        self.window = window
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.series: Dict[str, WindowSeries] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def get_series(self, name: str,
                   window: Optional[float] = None) -> WindowSeries:
        s = self.series.get(name)
        if s is None:
            s = self.series[name] = WindowSeries(name,
                                                 window or self.window)
        return s

    def snapshot(self) -> dict:
        """Plain-data dump (counters, gauges, series buckets) for
        summaries and tests."""
        return {
            "counters": {k: c.value for k, c in self.counters.items()},
            "gauges": {k: g.value for k, g in self.gauges.items()},
            "series": {k: list(s.values) for k, s in self.series.items()},
        }
