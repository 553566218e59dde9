"""The elastic engine: glue between churn/autoscaling and the simulator.

The simulator owns the event loop and the cluster mutation mechanics
(requeueing, slot bookkeeping, re-execution); the engine owns the *policy*
side: which hosts come and go, when, on what lease, and what it all costs.
The split keeps the engine free of simulator internals and keeps all
elastic randomness in the engine's own RNG (churn seed), so the
simulator's RNG stream — and therefore every churn-disabled run — is
untouched.

Protocol (driven by ``Simulator.run``):

    startup(now)            -> initial churn events to schedule
    on_churn(event, obs)    -> ElasticActions (losses, adds, follow-ups)
    autoscale(obs)          -> ElasticActions at each policy tick
    applied_add(hid, kind)  -> lease opened; may return follow-up events
                               (spot preemption, lease expiry) for the host
    applied_loss(hid, ...)  -> lease closed
    finalize(now)           -> ElasticSummary (VPS-hours, $, event counts)

The engine vetoes any loss that would leave the cluster with zero hosts
(the tenant always keeps one VPS, otherwise queued work could never
drain); vetoed events are counted in the summary.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.topology import HostId, VirtualCluster
from repro_torch.sim.engine import EventKernel, Subsystem

from repro_torch.elastic.autoscaler import Autoscaler, FleetObservation
from repro_torch.elastic.churn import ChurnConfig, ChurnEvent, ChurnModel
from repro_torch.elastic.durability import DurabilityConfig, DurabilityManager
from repro_torch.elastic.leases import ON_DEMAND, SPOT, LeaseBook, PriceSheet


@dataclasses.dataclass
class ElasticActions:
    """What the simulator should apply in response to one event."""

    losses: List[Tuple[HostId, str]] = dataclasses.field(default_factory=list)
    adds: List[Tuple[int, str]] = dataclasses.field(default_factory=list)
    followups: List[ChurnEvent] = dataclasses.field(default_factory=list)
    #: (host, announced kill time, announced kind) per notice to deliver
    #: to the migration seam
    notices: List[Tuple[HostId, float, str]] = dataclasses.field(
        default_factory=list)
    #: hosts the autoscaler wants proactively drained (fleet compaction)
    drains: List[HostId] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ElasticSummary:
    """Fleet/cost accounting for one run (merged into ``SimResult``)."""

    vps_hours: float = 0.0
    cost: float = 0.0
    n_leases: int = 0
    n_host_adds: int = 0
    n_host_losses: int = 0
    n_vetoed: int = 0
    #: scale-in victims dropped at *apply* time because they were no
    #: longer idle (the observation race fix)
    n_stale_victims: int = 0
    peak_hosts: int = 0
    #: DurabilitySummary when the run had a durability manager
    durability: object = None
    losses_by_reason: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: (time, hid, reason) per departure — lets tests assert that no task
    #: was ever assigned to a departed host
    loss_log: List[Tuple[float, HostId, str]] = dataclasses.field(
        default_factory=list)


class ElasticEngine:
    """One engine per simulation run (holds run-scoped lease/churn state)."""

    def __init__(self, cluster: VirtualCluster, *,
                 churn: Optional[ChurnConfig] = None,
                 autoscaler: Optional[Autoscaler] = None,
                 prices: Optional[PriceSheet] = None,
                 durability: Optional[DurabilityConfig] = None,
                 migration=None):
        self.cluster = cluster
        self.churn_cfg = churn
        # MigrationConfig (or None). The simulator attaches the
        # MigrationSubsystem when this is set and enabled; the engine
        # itself never touches it (migration is simulator mechanics).
        self.migration_cfg = migration
        self.model = ChurnModel(churn) if churn is not None else None
        self.autoscaler = autoscaler or Autoscaler()
        # policies carry run-scoped state (cooldown clocks in absolute sim
        # time); reusing one across engines would silently suppress scaling
        # in the second run and break per-seed determinism
        if getattr(self.autoscaler, "_engine_bound", False):
            raise ValueError(
                "autoscaler instances are single-run (they keep cooldown "
                "state in sim time); create a fresh policy per engine")
        self.autoscaler._engine_bound = True
        self.book = LeaseBook(prices)
        # durability: a disabled/absent config attaches no manager,
        # so those runs stay bit-identical to the durability-free elastic
        # simulator
        self.durability: Optional[DurabilityManager] = None
        if durability is not None and durability.enabled:
            self.durability = DurabilityManager(durability, cluster,
                                                prices=self.book.prices)
        self.summary = ElasticSummary()
        self._started = False

    # -- helpers -------------------------------------------------------------
    def _live_hosts(self) -> int:
        return sum(len(p.hosts) for p in self.cluster.pods)

    def _pick_pod(self, pending: Optional[Dict[int, int]] = None) -> int:
        """Least-populated pod for a new lease (ties -> lowest index), so
        growth keeps the fleet balanced across datacenters. ``pending``
        counts same-batch adds not yet applied to the cluster, so a
        multi-host scale-out spreads instead of piling into one pod."""
        pending = pending or {}
        pods = self.cluster.pods
        return min(pods, key=lambda p: (len(p.hosts)
                                        + pending.get(p.index, 0),
                                        p.index)).index

    def _veto_loss(self, hid: HostId, pending: int = 0) -> bool:
        """``pending`` = losses already approved in the same batch, so a
        multi-host scale-in cannot talk its way past the last-host guard."""
        if not self.cluster.has_host(hid):
            return True           # already departed (e.g. fail then expire)
        if self._live_hosts() - pending <= 1:
            self.summary.n_vetoed += 1
            return True           # never drop the last VPS
        return False

    # -- protocol ------------------------------------------------------------
    def startup(self, now: float = 0.0) -> List[ChurnEvent]:
        """Open leases for the initial fleet and return the churn trace."""
        assert not self._started, "engine is single-use"
        self._started = True
        events: List[ChurnEvent] = []
        spot = set()
        if self.model is not None:
            spot, events = self.model.initial_trace(self.cluster)
        for h in sorted((h.hid for h in self.cluster.hosts()),
                        key=lambda h: (h.pod, h.index)):
            self.book.open(h, SPOT if h in spot else ON_DEMAND, now)
        self.summary.peak_hosts = self._live_hosts()
        return events

    def notice_for(self, ev: ChurnEvent, now: float
                   ) -> Optional[ChurnEvent]:
        """Advance-warning event for a scheduled kill, or None."""
        if self.model is None:
            return None
        return self.model.notice_for(ev, now)

    def on_churn(self, ev: ChurnEvent, obs: FleetObservation
                 ) -> ElasticActions:
        out = ElasticActions()
        if ev.kind == "join":
            out.adds.append((ev.pod, ON_DEMAND))
            return out
        hid = HostId(ev.pod, ev.index)
        if ev.kind == "notice":
            if not self.cluster.has_host(hid):
                return out          # announced host already departed
            if ev.target == "expire":
                # pre-run the renewal decision: a lease the policy will
                # renew anyway should not trigger a drain. renew_lease is
                # pure for every shipped policy, so asking here and again
                # at the actual expiry is safe.
                kind = self.book.kind_of(hid) or ON_DEMAND
                if self.autoscaler.renew_lease(hid, kind, obs):
                    return out
            out.notices.append((hid, ev.deadline, ev.target))
            return out
        if ev.kind in ("fail", "preempt"):
            if not self._veto_loss(hid):
                out.losses.append((hid, ev.kind))
                if (ev.kind == "fail"
                        and self.churn_cfg.rejoin_delay is not None):
                    # replacement VPS provisioning starts at the applied
                    # failure (vetoed/no-op failures spawn no replacement)
                    out.followups.append(ChurnEvent(
                        obs.now + self.churn_cfg.rejoin_delay, "join",
                        ev.pod, None))
            return out
        if ev.kind == "expire":
            if not self.cluster.has_host(hid):
                return out
            kind = self.book.kind_of(hid) or ON_DEMAND
            if self.autoscaler.renew_lease(hid, kind, obs):
                out.followups.append(ChurnEvent(
                    self.model.next_expiry(obs.now), "expire",
                    hid.pod, hid.index))
            elif not self._veto_loss(hid):
                out.losses.append((hid, "expire"))
            else:   # vetoed non-renewal: keep the lease another term
                out.followups.append(ChurnEvent(
                    self.model.next_expiry(obs.now), "expire",
                    hid.pod, hid.index))
            return out
        raise ValueError(f"unknown churn event kind {ev.kind!r}")

    def autoscale(self, obs: FleetObservation) -> ElasticActions:
        out = ElasticActions()
        dec = self.autoscaler.decide(obs)
        for hid in dec.remove:
            if not self._veto_loss(hid, pending=len(out.losses)):
                out.losses.append((hid, "scale_in"))
        pending_adds: Dict[int, int] = {}
        for _ in range(dec.add):
            pod = self._pick_pod(pending_adds)
            pending_adds[pod] = pending_adds.get(pod, 0) + 1
            out.adds.append((pod, dec.kind))
        for hid in dec.drain:
            # proactive compaction: drain lightly-loaded hosts so
            # their leases can be released early once migrated off
            if self.cluster.has_host(hid):
                out.drains.append(hid)
        return out

    def applied_add(self, hid: HostId, kind: str, now: float
                    ) -> List[ChurnEvent]:
        """The simulator leased ``hid``; returns its personal churn events
        (spot preemption draw, lease expiry)."""
        self.book.open(hid, kind, now)
        self.summary.n_host_adds += 1
        self.summary.peak_hosts = max(self.summary.peak_hosts,
                                      self._live_hosts())
        events: List[ChurnEvent] = []
        if self.model is not None:
            # new hosts face the same hazards as the initial fleet: a
            # failure draw (sustaining the Poisson process past the first
            # wave), spot preemption, and a lease clock
            t_fail = self.model.failure_after(now)
            if t_fail is not None:
                events.append(ChurnEvent(t_fail, "fail",
                                         hid.pod, hid.index))
            if kind == SPOT:
                t = self.model.spot_preemption_after(now)
                if t is not None:
                    events.append(ChurnEvent(t, "preempt",
                                             hid.pod, hid.index))
            if self.churn_cfg.lease_term is not None:
                events.append(ChurnEvent(self.model.next_expiry(now),
                                         "expire", hid.pod, hid.index))
        return events

    def applied_loss(self, hid: HostId, now: float, reason: str) -> None:
        self.book.close(hid, now, reason)
        self.summary.n_host_losses += 1
        self.summary.loss_log.append((now, hid, reason))
        by = self.summary.losses_by_reason
        by[reason] = by.get(reason, 0) + 1

    def observe(self, now: float, *, map_backlog: int, red_backlog: int,
                busy_hosts: int,
                idle_hosts: Tuple[HostId, ...] = (),
                light_hosts: Tuple[HostId, ...] = ()) -> FleetObservation:
        # newest lease first (the book knows true lease starts; a raw
        # host index is only recency-ordered within one pod), so
        # scale-in/compaction policies can return surge capacity before
        # base hosts just by taking a prefix
        leases = self.book.open_leases
        recency = lambda h: (-leases[h].start, h.pod, h.index)
        if idle_hosts:
            idle_hosts = tuple(sorted(idle_hosts, key=recency))
        if light_hosts:
            light_hosts = tuple(sorted(light_hosts, key=recency))
        return FleetObservation(
            now=now, n_hosts=self._live_hosts(),
            map_backlog=map_backlog, red_backlog=red_backlog,
            busy_hosts=busy_hosts, cost=self.book.cost(now),
            vps_hours=self.book.vps_hours(now), idle_hosts=idle_hosts,
            light_hosts=light_hosts)

    def finalize(self, now: float) -> ElasticSummary:
        self.book.close_all(now)
        s = self.summary
        s.vps_hours = self.book.vps_hours()
        s.cost = self.book.cost()
        s.n_leases = self.book.n_leases()
        if self.durability is not None:
            s.durability = self.durability.finalize()
            s.cost += s.durability.storage_dollars
        return s


class ElasticSubsystem(Subsystem):
    """Simulator plug-in: owns the ``churn`` and ``scale`` event
    kinds and bridges the engine's policy decisions to the simulator's
    fleet mechanics (``Simulator.add_host`` / ``Simulator.lose_host``).
    Replaces the event arms once inlined into ``Simulator.run``;
    the apply order (losses, then adds with their follow-up draws, then
    policy follow-ups) is part of the bit-identity contract."""

    def __init__(self, engine: ElasticEngine):
        self.engine = engine

    def attach(self, sim, kernel: EventKernel) -> None:
        super().attach(sim, kernel)
        kernel.register("churn", self._on_churn)
        kernel.register("scale", self._on_scale)

    def start(self, now: float) -> None:
        for ev in self.engine.startup(now):
            self._push_churn(ev, now)
        tick = getattr(self.engine.autoscaler, "interval", None)
        if tick:
            self.kernel.push(now + tick, "scale", None)

    def _push_churn(self, ev: ChurnEvent, now: float) -> None:
        """Schedule a churn event plus its advance notice, if the
        configured notice window produces one. Zero windows (the default)
        produce none, keeping the pre-notice event stream bit-identical."""
        self.kernel.push(ev.time, "churn", ev)
        notice = self.engine.notice_for(ev, now)
        if notice is not None:
            self.kernel.push(notice.time, "churn", notice)

    def _on_churn(self, now: float, ev: ChurnEvent) -> None:
        self._apply(self.engine.on_churn(
            ev, self.sim.fleet_observation(now)), now)
        if (self.sim._hooks_host_survived
                and ev.kind in ("preempt", "expire")
                and ev.index is not None):
            # the announced kill did not remove the host (veto or lease
            # renewal): tell the migration seam to undrain it
            hid = HostId(ev.pod, ev.index)
            if self.sim.cluster.has_host(hid):
                for h in self.sim._hooks_host_survived:
                    h(hid, now)

    def _on_scale(self, now: float, _payload) -> None:
        if self.sim.unfinished > 0:
            actions = self.engine.autoscale(
                self.sim.fleet_observation(now, full=True))
            tel = getattr(self.sim, "telemetry", None)
            if tel is not None:
                tel.note_autoscale(now, (list(actions.losses)
                                         + list(actions.adds)
                                         + list(actions.drains)))
            self._apply(actions, now)
            self.kernel.push(now + self.engine.autoscaler.interval,
                             "scale", None)

    def _apply(self, actions: ElasticActions, now: float) -> None:
        engine = self.engine
        for hid, reason in actions.losses:
            if reason == "scale_in" and not self.sim.host_is_idle(hid):
                # observation race: the victim picked up
                # work between the autoscale observation and now — veto at
                # apply time rather than killing fresh tasks
                engine.summary.n_stale_victims += 1
                continue
            self.sim.lose_host(hid, now)
            engine.applied_loss(hid, now, reason)
        for pod, kind in actions.adds:
            hid = self.sim.add_host(pod, kind, now)
            for fev in engine.applied_add(hid, kind, now):
                self._push_churn(fev, now)
        for fev in actions.followups:
            self._push_churn(fev, now)
        for hid, deadline, target in actions.notices:
            for h in self.sim._hooks_host_notice:
                h(hid, deadline, target, now)
        for hid in actions.drains:
            for h in self.sim._hooks_host_notice:
                h(hid, None, "compact", now)
