"""Churn event model: host failures, spot preemptions, lease expiries.

All randomness comes from a ``ChurnModel``-owned RNG seeded by
``ChurnConfig.seed`` — the simulator's own RNG is never consumed, so a
churn-disabled elastic run is bit-identical to the static simulator and a
churn-enabled run is deterministic given (workload seed, churn seed).

Event kinds (the tenant-visible ways a rented VPS comes and goes):

  * ``fail``    — permanent host failure (hardware/VM death). When
    ``rejoin_delay`` is set, the engine schedules a ``join`` of a
    replacement VPS ``rejoin_delay`` seconds after each failure it
    actually applies (vetoed/no-op failures spawn no replacement).
  * ``preempt`` — the provider reclaims a *spot* VPS. Only hosts on spot
    leases are eligible.
  * ``expire``  — a lease term ends; the autoscaler decides renewal
    (renewed leases schedule their next expiry, non-renewed hosts depart).
  * ``join``    — a replacement/ordered VPS comes up in a pod.
  * ``notice``  — advance warning of a coming ``preempt``/``expire``
   : real providers announce spot reclaims 30-120 s ahead.
    Notices are derived events — ``notice_for`` places one exactly
    ``preempt_notice``/``expire_notice`` seconds before the kill it
    announces, consuming **no RNG draws**, so enabling notices moves no
    kill time and a zero window (the default) emits nothing at all
    (bit-identity with the pre-notice trace). ``fail`` events are
    unannounced by definition.

The initial trace is sampled host-by-host in (pod, index) order, so it is
a pure function of the config and the initial fleet shape.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.topology import HostId, VirtualCluster

from repro_torch.elastic.leases import ON_DEMAND, SPOT


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """One scheduled fleet mutation (times in sim seconds)."""

    time: float
    kind: str              # "fail" | "preempt" | "expire" | "join" | "notice"
    pod: int
    index: Optional[int]   # host index within the pod; None for "join"
    # -- notice events only -------------------------------------------
    target: Optional[str] = None     # the announced kind (preempt/expire)
    deadline: Optional[float] = None  # when the announced kill lands


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    """Scenario knobs. Rates are per host-hour; 0 disables that channel."""

    seed: int = 0
    horizon: float = 4 * 3600.0    # only events before this are generated
    fail_rate: float = 0.0         # permanent failures / host-hour
    rejoin_delay: Optional[float] = None  # replacement VPS latency (s)
    spot_fraction: float = 0.0     # fraction of the initial fleet on spot
    spot_preempt_rate: float = 0.0  # preemptions / spot-host-hour
    lease_term: Optional[float] = None  # lease length (s); None = open-ended
    # notice windows: seconds of advance warning before a preempt/
    # expire lands. 0 = no notice events at all (bit-identity default).
    preempt_notice: float = 0.0
    expire_notice: float = 0.0

    @property
    def enabled(self) -> bool:
        return (self.fail_rate > 0 or self.spot_fraction > 0
                or self.lease_term is not None)


class ChurnModel:
    """Samples churn for one simulation run (deterministic per seed)."""

    def __init__(self, cfg: ChurnConfig):
        self.cfg = cfg
        self.rng = np.random.RandomState(cfg.seed)

    # -- sampling helpers ----------------------------------------------------
    def _exp_delay(self, rate_per_hour: float) -> float:
        """Time to the next event of a per-hour Poisson process, seconds."""
        return float(self.rng.exponential(3600.0 / rate_per_hour))

    def first_expiry(self, now: float) -> float:
        """Initial leases stagger their first expiry over [term, 2*term) —
        rolling rentals rather than a synchronized cliff."""
        term = self.cfg.lease_term
        return now + term * (1.0 + float(self.rng.uniform(0.0, 1.0)))

    def next_expiry(self, now: float) -> float:
        return now + float(self.cfg.lease_term)

    def spot_preemption_after(self, now: float) -> Optional[float]:
        """Preemption time for a spot lease opened at ``now`` (None = the
        lease outlives the horizon)."""
        if self.cfg.spot_preempt_rate <= 0:
            return None
        t = now + self._exp_delay(self.cfg.spot_preempt_rate)
        return t if t < self.cfg.horizon else None

    def notice_for(self, ev: ChurnEvent, now: float
                   ) -> Optional[ChurnEvent]:
        """Advance-warning event for ``ev``, or None.

        Pure arithmetic on the already-drawn kill time — no RNG draw —
        so adding notices never moves a kill and disabling them (window
        0, the default) leaves the trace untouched. A window longer
        than the remaining lead time clamps to ``now`` (the notice
        arrives immediately; the drain gets whatever time is left)."""
        if ev.kind == "preempt":
            window = self.cfg.preempt_notice
        elif ev.kind == "expire":
            window = self.cfg.expire_notice
        else:
            return None             # failures are unannounced
        if window <= 0.0 or ev.index is None:
            return None
        return ChurnEvent(max(now, ev.time - window), "notice",
                          ev.pod, ev.index, target=ev.kind,
                          deadline=ev.time)

    def failure_after(self, now: float) -> Optional[float]:
        if self.cfg.fail_rate <= 0:
            return None
        t = now + self._exp_delay(self.cfg.fail_rate)
        return t if t < self.cfg.horizon else None

    # -- initial trace -------------------------------------------------------
    def initial_trace(self, cluster: VirtualCluster
                      ) -> Tuple[Set[HostId], List[ChurnEvent]]:
        """(spot hosts of the initial fleet, scheduled events).

        Hosts are visited in (pod, index) order; each consumes RNG draws in
        a fixed pattern, so the trace is reproducible per seed regardless
        of workload.
        """
        cfg = self.cfg
        hosts = sorted((h.hid for h in cluster.hosts()),
                       key=lambda h: (h.pod, h.index))
        spot: Set[HostId] = set()
        if cfg.spot_fraction > 0 and hosts:
            n_spot = int(round(cfg.spot_fraction * len(hosts)))
            if n_spot:
                picks = self.rng.choice(len(hosts), size=min(n_spot,
                                                             len(hosts)),
                                        replace=False)
                spot = {hosts[int(i)] for i in sorted(picks)}
        events: List[ChurnEvent] = []
        for hid in hosts:
            t_fail = self.failure_after(0.0)
            if t_fail is not None:
                events.append(ChurnEvent(t_fail, "fail", hid.pod, hid.index))
            if hid in spot:
                t_pre = self.spot_preemption_after(0.0)
                if t_pre is not None:
                    events.append(ChurnEvent(t_pre, "preempt",
                                             hid.pod, hid.index))
            if cfg.lease_term is not None:
                events.append(ChurnEvent(self.first_expiry(0.0), "expire",
                                         hid.pod, hid.index))
        events.sort(key=lambda e: (e.time, e.pod,
                                   -1 if e.index is None else e.index,
                                   e.kind))
        return spot, events
