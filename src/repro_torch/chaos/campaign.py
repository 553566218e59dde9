"""Deterministic fault campaigns for the chaos layer.

A *campaign* is the complete, pre-sampled fault schedule of one run:
every injection the :class:`~repro_torch.chaos.inject.ChaosSubsystem` will
perform, drawn up front from the campaign's **own** RNG (never the
simulator's) in a fixed per-category order. Pre-sampling is what makes
chaos reproducible: the schedule depends only on ``ChaosConfig`` — not
on how the trajectory unfolds — so per-seed injection logs are sha-
stable across runs, worker counts and submission orders, exactly like
the churn traces of ``repro_torch.elastic.churn``.

Times are drawn uniformly over ``[0, horizon)``; targets are drawn as
integer *ranks* resolved against the live cluster state at fire time
(``rank % len(candidates)`` over a sorted candidate list). Rank
resolution is the one trajectory-dependent step, and it is a pure
function of simulator state at the event instant — deterministic per
seed, like every other subsystem decision.

The taxonomy (motivation in ``docs/ARCHITECTURE.md``):

``outage``
    A correlated pod-scoped failure: one draw degrades a whole pod (a
    *gray prodrome* at ``outage_gray_factor``), then — when
    ``outage_kill`` — kills every host in it at once and rejoins them
    ``outage_down_s`` later. This is the co-tenant / rack-event failure
    mode the independent per-host churn model cannot express.
``gray``
    A time-varying host slowdown episode: a scheduled ramp (full
    factor, half factor at mid-episode, recovery) layered over the
    static ``SimConfig.slow_hosts`` map. The host keeps accepting and
    *completing* work — slowly — which fail-stop detection never sees.
``disk``
    A disk-degradation episode: checkpoint persists (and fabric-mode
    re-replication copies into the pod) stretch by ``disk_factor``
    while compute and network are unaffected.
``link`` / ``partition``
    Fabric faults: one link class (pod uplink/downlink or the WAN)
    derates to ``link_factor`` of its capacity — or to zero, a full
    partition — through the same settle-then-recapacitate discipline as
    ``ElasticLinks``. Ignored (and logged) in per-stream mode.
``hang``
    A running task stops progressing for ``hang_s`` without any churn
    event firing — the pure gray failure that only progress-based
    timeout detection (``repro_torch.chaos.response``) can catch.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """One campaign's knobs. The all-zero default injects nothing: an
    attached-but-empty chaos subsystem pushes no events, consumes none
    of the simulator's RNG, and is therefore bit-identical to a run
    without it (asserted against all 25 golden trajectories)."""

    enabled: bool = True
    seed: int = 0
    #: injection times are drawn uniformly over [0, horizon) seconds;
    #: events past the workload's makespan simply never fire
    horizon: float = 1800.0

    # -- correlated pod outages ---------------------------------------------
    n_outages: int = 0
    outage_gray_s: float = 150.0     # prodrome length before the kill
    outage_gray_factor: float = 4.0  # pod-wide slowdown during the prodrome
    outage_kill: bool = True         # False = degrade-only episode
    outage_down_s: float = 240.0     # killed hosts rejoin after this

    # -- gray host episodes (time-varying slowdown ramps) -------------------
    n_gray: int = 0
    gray_factor: float = 5.0
    gray_s: float = 120.0            # episode length (half-factor at mid)

    # -- disk-slow episodes (stretch ckpt/rerep writes) ---------------------
    n_disk: int = 0
    disk_factor: float = 6.0
    disk_s: float = 150.0

    # -- link derating / partitions -----------------------------------------
    n_link: int = 0
    link_factor: float = 0.25        # surviving fraction of link capacity
    link_s: float = 120.0
    n_partition: int = 0
    partition_s: float = 45.0

    # -- hung tasks ----------------------------------------------------------
    n_hung: int = 0
    #: a hung task resumes on its own after this long, so detection-off
    #: runs still terminate — finite, but catastrophic for WTT
    hang_s: float = 600.0

    @property
    def n_events(self) -> int:
        return (self.n_outages + self.n_gray + self.n_disk + self.n_link
                + self.n_partition + self.n_hung)


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One pre-sampled injection: fire ``op`` at ``time`` against the
    target resolved from ``rank`` at that instant. ``draw`` is the
    global draw index — the stable tie-break for same-time events and
    the injection-log correlation id."""

    time: float
    op: str          # "outage" | "gray" | "disk" | "link" | "partition" | "hang"
    rank: int
    draw: int


def build_campaign(cfg: ChaosConfig) -> List[ChaosEvent]:
    """Pre-sample the full fault schedule from the campaign's own RNG.

    Categories are drawn in a fixed order (outages, gray, disk, link,
    partition, hung) so the schedule is a pure function of the config;
    the returned list is sorted by ``(time, draw)``.
    """
    rng = np.random.RandomState(cfg.seed)
    events: List[ChaosEvent] = []
    draw = 0

    def sample(op: str, n: int) -> None:
        nonlocal draw
        for _ in range(n):
            t = float(rng.uniform(0.0, cfg.horizon))
            r = int(rng.randint(0, 1 << 30))
            events.append(ChaosEvent(t, op, r, draw))
            draw += 1

    sample("outage", cfg.n_outages)
    sample("gray", cfg.n_gray)
    sample("disk", cfg.n_disk)
    sample("link", cfg.n_link)
    sample("partition", cfg.n_partition)
    sample("hang", cfg.n_hung)
    events.sort(key=lambda e: (e.time, e.draw))
    return events
