"""Autoscaler policies: how the tenant sizes the rented fleet over time.

A policy sees a ``FleetObservation`` (backlog counters, live fleet size,
accrued cost — exactly the scheduler's O(1) counters) and returns a
``ScaleDecision``; it also answers lease-renewal questions at expiry
events. Policies never touch the cluster directly — the ``ElasticEngine``
maps decisions onto pods/hosts so policy code stays deterministic and
cluster-agnostic.

Shipped policies:

  * ``FixedFleet``           — the paper's static testbed: never scales,
    always renews. The elastic machinery with this policy and no churn is
    bit-identical to the static simulator.
  * ``BacklogThresholdScaler`` — scale out when backlog per host exceeds a
    threshold, scale idle hosts in when the backlog drains; renew leases
    only while there is work (cost falls to the work's shape).
  * ``CostCappedSpotScaler``  — same triggers, but growth uses spot leases
    and stops at a dollar budget; spot leases are never renewed once the
    budget is spent.
  * ``CompactingScaler``      — backlog scaler that additionally *drains*
    lightly-loaded hosts once the backlog is gone: the migration
    subsystem moves their remaining work elsewhere, after which they show
    up idle and are released by the normal scale-in path — leases end
    early instead of idling out their last task.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.topology import HostId

from repro_torch.elastic.leases import ON_DEMAND, SPOT


@dataclasses.dataclass(frozen=True)
class FleetObservation:
    """What a policy may look at. Everything is O(1) to produce except the
    fleet walk behind ``idle_hosts``/``busy_hosts``, which runs only at
    autoscale ticks of policies that declare ``needs_idle_hosts`` (both
    fields are zero/empty everywhere else)."""

    now: float
    n_hosts: int
    map_backlog: int       # queued-but-unassigned map tasks
    red_backlog: int       # ready-but-unassigned reduce tasks
    busy_hosts: int        # hosts with at least one occupied slot
    cost: float            # $ accrued so far
    vps_hours: float
    idle_hosts: Tuple[HostId, ...] = ()   # fully-idle hosts, newest lease
    #                                       first (engine sorts by the book)
    #: hosts with exactly one occupied slot (compaction candidates),
    #: newest lease first; populated only for ``needs_light_hosts``
    #: policies and never includes already-draining hosts
    light_hosts: Tuple[HostId, ...] = ()

    @property
    def backlog(self) -> int:
        return self.map_backlog + self.red_backlog


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """add N hosts of `kind`, remove the given (idle) hosts, and/or drain
    the given lightly-loaded hosts (migrate their work off so the
    next ticks find them idle and can remove them)."""

    add: int = 0
    kind: str = ON_DEMAND
    remove: Tuple[HostId, ...] = ()
    drain: Tuple[HostId, ...] = ()

    @property
    def empty(self) -> bool:
        return self.add == 0 and not self.remove and not self.drain


class Autoscaler:
    """Base policy: a fixed fleet (no ticks, renew everything)."""

    name = "fixed"
    #: seconds between scaling decisions; None = the policy never ticks
    interval: Optional[float] = None
    #: whether decide() wants idle_hosts populated (costs O(hosts)/tick)
    needs_idle_hosts = False
    #: whether decide() wants light_hosts populated (same fleet walk)
    needs_light_hosts = False

    def decide(self, obs: FleetObservation) -> ScaleDecision:
        return ScaleDecision()

    def renew_lease(self, hid: HostId, kind: str,
                    obs: FleetObservation) -> bool:
        return True


class FixedFleet(Autoscaler):
    """The static-testbed policy, stated explicitly."""


class BacklogThresholdScaler(Autoscaler):
    """Scale out on backlog pressure, in on idleness.

    Out: when backlog / host > ``hi`` (and cooldown passed), lease ``step``
    more on-demand VPSs up to ``max_hosts``. In: when the backlog is zero,
    return up to ``step`` fully-idle VPSs down to ``min_hosts``, newest
    lease first (``obs.idle_hosts`` arrives in that order from the
    engine's lease book), so surge capacity with empty disks is returned
    before base hosts that hold shard replicas. Expiring leases are
    renewed only while there is backlog or the fleet is at ``min_hosts``
    — lease boundaries become free scale-in points.
    """

    name = "backlog"
    needs_idle_hosts = True

    def __init__(self, *, interval: float = 30.0, hi: float = 4.0,
                 step: int = 4, min_hosts: int = 2, max_hosts: int = 1 << 30,
                 cooldown: float = 60.0):
        self.interval = interval
        self.hi = hi
        self.step = step
        self.min_hosts = min_hosts
        self.max_hosts = max_hosts
        self.cooldown = cooldown
        self._last_change = -1e18
        self._scoreboard = None

    def attach_scoreboard(self, sb) -> None:
        """Read backlog from the telemetry ``Scoreboard`` instead of the
        observation. The simulator calls this when telemetry is enabled;
        ``fleet_observation`` publishes the observation's own counters to
        the scoreboard *before* any policy runs, so decisions are
        bit-identical either way (equivalence-tested)."""
        self._scoreboard = sb

    def _backlog(self, obs: FleetObservation) -> int:
        sb = self._scoreboard
        return obs.backlog if sb is None else sb.backlog()

    # hook so the cost-capped subclass can gate growth and pick lease kind
    def _grow(self, obs: FleetObservation, want: int) -> ScaleDecision:
        return ScaleDecision(add=want, kind=ON_DEMAND)

    def decide(self, obs: FleetObservation) -> ScaleDecision:
        if obs.now - self._last_change < self.cooldown:
            return ScaleDecision()
        backlog = self._backlog(obs)
        per_host = backlog / max(obs.n_hosts, 1)
        if per_host > self.hi and obs.n_hosts < self.max_hosts:
            want = min(self.step, self.max_hosts - obs.n_hosts)
            dec = self._grow(obs, want)
            if not dec.empty:
                self._last_change = obs.now
            return dec
        if backlog == 0 and obs.n_hosts > self.min_hosts:
            spare = obs.n_hosts - self.min_hosts
            victims = tuple(obs.idle_hosts[:min(self.step, spare)])
            if victims:
                self._last_change = obs.now
                return ScaleDecision(remove=victims)
        return ScaleDecision()

    def renew_lease(self, hid: HostId, kind: str,
                    obs: FleetObservation) -> bool:
        return self._backlog(obs) > 0 or obs.n_hosts <= self.min_hosts


class CostCappedSpotScaler(BacklogThresholdScaler):
    """Backlog-triggered growth on *spot* leases under a dollar budget.

    The base fleet (on-demand) is kept; surge capacity is spot. Growth
    stops once accrued cost reaches ``budget``; past the budget, expiring
    spot leases are never renewed (the fleet decays back to the base).
    """

    name = "spotcap"

    def __init__(self, *, budget: float, **kw):
        super().__init__(**kw)
        self.budget = budget

    def _grow(self, obs: FleetObservation, want: int) -> ScaleDecision:
        if obs.cost >= self.budget:
            return ScaleDecision()
        return ScaleDecision(add=want, kind=SPOT)

    def renew_lease(self, hid: HostId, kind: str,
                    obs: FleetObservation) -> bool:
        if kind == SPOT and obs.cost >= self.budget:
            return False
        return super().renew_lease(hid, kind, obs)


class CompactingScaler(BacklogThresholdScaler):
    """Backlog scaler + proactive fleet compaction.

    Once the backlog drains, hosts running a *single* task are tail
    capacity: one straggler pins a whole lease. Draining up to
    ``drain_step`` hosts per tick (idle hosts first — their disks may
    still hold shuffle inputs — then single-task hosts, newest lease
    first) asks the migration subsystem to move that work off; scale-in
    is gated on the drain, releasing only hosts drained on an *earlier*
    tick, so a lease ends with an evacuated disk instead of destroying
    finished map output the way the inherited kill-cold scale-in does.
    Drains are requested at most once per host (the ``_draining`` set),
    so an undrainable host is not hammered every tick. Requires the
    migration subsystem; without it a drain request is a no-op (no hook
    listens) and nothing is ever removed.
    """

    name = "compact"
    needs_light_hosts = True

    def __init__(self, *, drain_step: Optional[int] = None, **kw):
        super().__init__(**kw)
        # match the scale-in step by default, else the fleet decays at
        # half the inherited policy's rate (drains gate removals 1:1)
        self.drain_step = self.step if drain_step is None else drain_step
        self._draining = set()

    def decide(self, obs: FleetObservation) -> ScaleDecision:
        dec = super().decide(obs)
        if self._backlog(obs) == 0 and obs.n_hosts > self.min_hosts:
            ready = tuple(h for h in dec.remove if h in self._draining)
            spare = obs.n_hosts - self.min_hosts - len(ready)
            fresh = [h for h in obs.idle_hosts if h not in self._draining]
            light = [h for h in obs.light_hosts if h not in self._draining]
            cands = (fresh + light)[:max(0, min(self.drain_step, spare))]
            self._draining.update(cands)
            dec = dataclasses.replace(dec, remove=ready,
                                      drain=tuple(cands))
        return dec
