"""Read-only scoreboard facade over the telemetry registry.

This is the *consumption* side of the observability layer: control
loops (autoscalers today, contention-aware schedulers next) read
cluster state from here instead of groping simulator internals. The
contract:

* **Read-only** — the scoreboard never mutates the registry, never
  consumes RNG, never touches the event heap. Handing it to a policy
  cannot perturb a trajectory.
* **Decision-exact gauges** — gauges written from the very objects the
  control loop would otherwise read (``TelemetrySubsystem.note_fleet``
  stores the ``FleetObservation``'s own integers before the autoscaler
  runs) make scoreboard-fed decisions bit-identical to direct reads;
  ``BacklogThresholdScaler.attach_scoreboard`` relies on this and the
  equivalence is tested (``tests/test_torch_obs.py``).
* **Windowed reads** — ``latest`` returns the last fully-closed window
  of a series; ``ewma`` smooths over all closed windows. The window
  containing *now* is still accumulating and is never exposed, so a
  policy's view doesn't depend on where inside a window it fires.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


class Scoreboard:
    def __init__(self, telemetry):
        self._tel = telemetry
        self._reg = telemetry.registry

    # -- raw reads -----------------------------------------------------------
    @property
    def window(self) -> float:
        return self._reg.window

    def counter(self, name: str) -> float:
        c = self._reg.counters.get(name)
        return c.value if c is not None else 0.0

    def gauge(self, name: str, default=0.0):
        g = self._reg.gauges.get(name)
        return g.value if g is not None else default

    def latest(self, name: str, now: float) -> float:
        """Last fully-closed window of series ``name`` (0.0 if the
        series doesn't exist or no window has closed)."""
        s = self._reg.series.get(name)
        return s.latest_closed(now) if s is not None else 0.0

    def series_values(self, name: str, now: float) -> List[float]:
        s = self._reg.series.get(name)
        return s.closed_values(now) if s is not None else []

    def ewma(self, name: str, now: float, alpha: float = None) -> float:
        """EWMA over the closed windows of ``name`` (most recent window
        weighted ``alpha``). Uses the telemetry config's ``ewma_alpha``
        unless overridden."""
        if alpha is None:
            alpha = self._tel.cfg.ewma_alpha
        vals = self.series_values(name, now)
        if not vals:
            return 0.0
        acc = vals[0]
        for v in vals[1:]:
            acc = alpha * v + (1.0 - alpha) * acc
        return acc

    # -- control-loop views ----------------------------------------------------
    def map_backlog(self) -> int:
        return self.gauge("backlog.map", 0)

    def red_backlog(self) -> int:
        return self.gauge("backlog.reduce", 0)

    def backlog(self) -> int:
        """Queued-but-unassigned maps + ready-but-unassigned reduces, as
        written from the last ``FleetObservation`` — the exact integers
        the autoscaler would read off the observation itself."""
        return self.map_backlog() + self.red_backlog()

    def n_hosts(self) -> int:
        return self.gauge("fleet.n_hosts", 0)

    def link_names(self) -> List[str]:
        """Every fabric link with a capacity ("up0"/"down0"/.../"wan");
        empty when the run has no fabric."""
        return list(self._tel.link_caps)

    def link_mb(self, link: str, now: float) -> float:
        """MB drained through ``link`` in the last closed window."""
        return self.latest(f"link.{link}.mb", now)

    def link_util(self, link: str, now: float) -> float:
        """Utilization fraction of ``link`` over the last closed window
        (windowed MB over capacity x window; 0.0 for unknown links or
        zero-capacity elastic links)."""
        cap = self._tel.link_caps.get(link, 0.0)
        if cap <= 0.0:
            return 0.0
        return self.link_mb(link, now) / (cap * self.window)

    def link_util_series(self, link: str, now: float) -> List[float]:
        cap = self._tel.link_caps.get(link, 0.0)
        if cap <= 0.0:
            return []
        w = self.window
        return [mb / (cap * w)
                for mb in self.series_values(f"link.{link}.mb", now)]

    def stall_s(self, kind: str, now: float) -> float:
        """Per-kind fabric stall seconds accrued in the last closed
        window (kinds: map_read/shuffle/ckpt_write/ckpt_read/rerep/
        migrate)."""
        return self.latest(f"stall.{kind}", now)

    def job_progress(self, job_id: int) -> Tuple[float, float]:
        """(map fraction done, reduce fraction done) for a live job —
        O(1) off the simulator's own counters."""
        return self._tel.job_progress(job_id)

    def snapshot(self) -> Dict[str, dict]:
        return self._reg.snapshot()
