"""The telemetry subsystem: time-resolved observability
riding the event kernel's subsystem seam.

``TelemetrySubsystem`` is a *pure observer*: it owns **no event kinds**,
pushes **no heap entries**, consumes **no RNG** and reads **no wall
clock** — attaching it cannot perturb a trajectory, so telemetry-on
runs are bit-identical to telemetry-off (held to the committed golden
hashes by ``tests/test_torch_obs.py`` and ``chip_smoke.py``'s
``scheduler`` phase). It listens on the subsystem hooks (task
start/finish, tick, host add/loss/notice, job submit/finish) plus
lightweight ``note_*`` call-ins from the fabric, the elastic
engine, durability and migration, and feeds three artifacts:

* a :class:`~repro_torch.obs.registry.MetricRegistry` of counters, gauges and
  fixed-window series — per-window link-MB integrals for every pod
  up/downlink + the WAN (sampled from the fabric's carried-MB integrals
  via a *read-only projection* ``carried + load * (now - last)``; the
  fabric's own ``_settle`` is never called, because re-settling at
  telemetry instants would change floating-point accrual order and
  break allocator bit-identity), per-kind stall, backlog and per-pod
  occupancy sampled at window close, per-class outstanding work, and
  churn/migration/rerep event rates;
* a :class:`~repro_torch.obs.trace.TraceExporter` (Chrome trace JSON +
  JSONL) when ``TelemetryConfig.trace`` is on — task attempts on
  per-host tracks, fabric flows on per-link tracks, churn and
  autoscale actions as instants; bounded by ``trace_limit``;
* a :class:`~repro_torch.obs.scoreboard.Scoreboard` — the read-only facade
  control loops consume (``BacklogThresholdScaler.attach_scoreboard``).

Sampling costs are O(links + kinds) per heartbeat and O(running tasks +
active jobs) per *window close*, never per event — the overhead
envelope (telemetry-on events/s >= 90% of telemetry-off at the
contended 4x1024-host point) is checked by ``chip_smoke.py``'s
``scheduler`` phase, as the JAX package's ``benchmarks/bench_obs.py``
checks it there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Set, Tuple

from repro_torch.core.job import MapTask
from repro_torch.sim.engine import EventKernel, Subsystem

from repro_torch.obs.registry import MetricRegistry
from repro_torch.obs.scoreboard import Scoreboard
from repro_torch.obs.trace import TraceExporter, link_name as _link_name


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Knobs for the telemetry subsystem (``SimConfig.telemetry``;
    ``None`` = no telemetry at all, the zero-cost default)."""

    window: float = 30.0        # series window width (s of sim time)
    ewma_alpha: float = 0.5     # scoreboard EWMA weight of newest window
    trace: bool = True          # build the structured trace
    #: max buffered trace events (à la ``FabricConfig.log_limit``):
    #: ``None`` = unbounded, N keeps the first N and counts the rest in
    #: ``TraceExporter.dropped``.
    trace_limit: Optional[int] = 100_000


class TelemetrySubsystem(Subsystem):
    def __init__(self, cfg: Optional[TelemetryConfig] = None):
        self.cfg = cfg or TelemetryConfig()
        self.registry = MetricRegistry(window=self.cfg.window)
        self._trace: Optional[TraceExporter] = (
            TraceExporter(self.cfg.trace_limit) if self.cfg.trace else None)
        #: set by :meth:`finalize`; the per-host task slices are
        #: rendered on the first ``.trace`` access after it
        self._pending_tasks = False
        self.scoreboard = Scoreboard(self)
        #: link name -> current capacity (MB/s); refreshed every sample
        #: so elastic capacity changes are visible to ``link_util``
        self.link_caps: Dict[str, float] = {}

    # -- subsystem protocol ---------------------------------------------------
    def attach(self, sim, kernel: EventKernel) -> None:
        # registers no event kinds: the kernel heap must be identical
        # with and without telemetry
        super().attach(sim, kernel)
        self._win_end = self.cfg.window
        self._sample_t = 0.0
        self._fab_prev: Dict[object, float] = {}    # LinkKey -> carried MB
        self._stall_prev: Dict[str, float] = {}     # kind -> stall_s
        self._class_jobs: Dict[str, Set[int]] = {}  # job class -> live ids
        self._pod_slots: Dict[int, int] = {}        # pod -> total slots
        # job ids are globally counted across runs in a process; traces
        # remap them to submission order (as full_signature does) so the
        # JSONL sha256 is identical run-to-run, not just process-to-process
        self._job_idx = {j.job_id: i for i, j in enumerate(sim.jobs)}
        # hot-path caches: these fire once per task attempt / flow, so
        # the registry lookups and f-string formatting are paid once
        reg = self.registry
        self._c_tasks = reg.counter("tasks.started")
        self._c_flows = reg.counter("flows.done")
        self._s_map_done = reg.get_series("tasks.map_done")
        self._s_red_done = reg.get_series("tasks.reduce_done")
        self._host_track: Dict[object, Tuple[str, str]] = {}
        self._link_names: Dict[object, str] = {}
        for h in sim.cluster.hosts():
            self._pod_slots[h.hid.pod] = (
                self._pod_slots.get(h.hid.pod, 0)
                + h.map_slots + h.reduce_slots)

    # start() inherited: pushes nothing (determinism rule)

    @property
    def trace(self) -> Optional[TraceExporter]:
        """The trace exporter, with the per-host task slices rendered
        from ``sim.task_logs`` on first access after :meth:`finalize` —
        one cold pass outside the simulated run instead of a dict build
        per completion on the hot path. ``task_logs`` append order is
        completion order, so the trace stays deterministic per seed."""
        tr = self._trace
        if tr is not None and self._pending_tasks:
            self._pending_tasks = False
            tracks = self._host_track
            for log in self.sim.task_logs:
                hid = log.host
                track = tracks.get(hid)
                if track is None:
                    track = tracks[hid] = (
                        f"pod{hid.pod}", f"host {hid.pod}.{hid.index}")
                kind = "map" if isinstance(log.task, MapTask) else "reduce"
                tr.complete(
                    track[0], track[1],
                    f"{kind}:{log.job.name}", log.start, log.finish,
                    args={"tid": self._tid_str(log.task.tid),
                          "job": self._jid(log.job.job_id),
                          "locality": (log.locality.value
                                       if log.locality is not None
                                       else None),
                          "mb": log.bytes_local + log.bytes_pod
                          + log.bytes_offpod,
                          "speculative": log.speculative,
                          "migrated": log.migrated})
        return tr

    def _jid(self, job_id: int) -> int:
        return self._job_idx.get(job_id, job_id)

    def _tid_str(self, tid) -> str:
        return str((tid[0], self._jid(tid[1])) + tuple(tid[2:]))

    # -- sampling -------------------------------------------------------------
    def on_tick(self, now: float) -> None:
        self._sample_fabric(now)
        if now >= self._win_end:
            self._close_window(now)

    def _sample_fabric(self, now: float) -> None:
        """Accrue per-link MB deltas since the last sample into the
        ``link.<name>.mb`` series, prorated across window boundaries.

        Read-only projection: the MB a link has carried by ``now`` is
        ``_carried[k] + _load[k] * (now - _last)`` — the same expression
        the fabric's next settle will apply. The fabric state is never
        mutated (no ``_settle`` call): settling at extra instants would
        reorder floating-point accrual and break the fast-vs-reference
        bit-identity contract."""
        fab = self.sim.fabric
        if fab is None:
            return
        dt = now - fab._last
        load = fab._load
        carried = fab._carried
        prev = self._fab_prev
        caps = self.link_caps
        reg = self.registry
        t0 = self._sample_t
        names = self._link_names
        for k, cap in fab._caps.items():
            cur = carried[k] + (load[k] * dt if dt > 0.0 else 0.0)
            name = names.get(k)
            if name is None:
                name = names[k] = _link_name(k)
            caps[name] = cap
            d = cur - prev.get(k, 0.0)
            if d > 0.0:
                reg.get_series(f"link.{name}.mb").add_range(t0, now, d)
                prev[k] = cur
        sprev = self._stall_prev
        for kind, agg in fab.summary.by_kind.items():
            d = agg[2] - sprev.get(kind, 0.0)
            if d > 0.0:
                reg.get_series(f"stall.{kind}").add_range(t0, now, d)
                sprev[kind] = agg[2]
        self._sample_t = now

    def _close_window(self, now: float) -> None:
        """Depth-style metrics (backlog, occupancy, outstanding work)
        are sampled once per window, at the first tick at-or-past the
        window edge, into the window just closed. O(running + active
        jobs), paid per window — never per event."""
        sim = self.sim
        w = self.cfg.window
        t = self._win_end - w       # start of the closing window
        reg = self.registry
        reg.get_series("backlog.map").add(t, sim.map_backlog)
        reg.get_series("backlog.reduce").add(t, sim.red_ready_backlog)
        busy: Dict[int, int] = {}
        for log in sim.running.values():
            p = log.host.pod
            busy[p] = busy.get(p, 0) + 1
        for pod in sorted(self._pod_slots):
            b = busy.get(pod, 0)
            reg.get_series(f"pod{pod}.busy").add(t, b)
            reg.get_series(f"pod{pod}.free").add(
                t, self._pod_slots[pod] - b)
        for cls in sorted(self._class_jobs):
            jids = self._class_jobs[cls]
            out = sum(sim.maps_left[j] + sim.reds_left[j] for j in jids)
            reg.get_series(f"class.{cls}.outstanding").add(t, out)
        self._win_end = (int(now // w) + 1) * w

    # -- task/job hooks -------------------------------------------------------
    def on_task_start(self, log, now: float) -> None:
        self._c_tasks.inc()

    def on_task_finish(self, log, now: float) -> None:
        # metrics only — the per-host trace slices are rendered from
        # ``sim.task_logs`` in :meth:`finalize`, off the hot path
        if isinstance(log.task, MapTask):
            self._s_map_done.add(now, 1.0)
        else:
            self._s_red_done.add(now, 1.0)

    def on_job_submit(self, job, now: float) -> None:
        self.registry.counter("jobs.submitted").inc()
        self.registry.get_series("rate.submit").add(now, 1.0)
        self._class_jobs.setdefault(job.name, set()).add(job.job_id)
        if self._trace is not None:
            self._trace.instant("fleet", "jobs", f"submit:{job.name}", now,
                               args={"job": self._jid(job.job_id),
                                     "maps": job.m,
                                     "reduces": len(job.reduce_tasks)})

    def on_job_finish(self, job, now: float) -> None:
        self.registry.counter("jobs.finished").inc()
        self.registry.get_series("rate.job_done").add(now, 1.0)
        jobs = self._class_jobs.get(job.name)
        if jobs is not None:
            jobs.discard(job.job_id)
        if self._trace is not None:
            self._trace.instant("fleet", "jobs", f"finish:{job.name}", now,
                               args={"job": self._jid(job.job_id)})

    # -- fleet hooks ----------------------------------------------------------
    def on_host_added(self, hid, now: float) -> None:
        self.registry.counter("churn.adds").inc()
        self.registry.get_series("rate.host_add").add(now, 1.0)
        h = self.sim.cluster.host(hid)
        self._pod_slots[hid.pod] = (self._pod_slots.get(hid.pod, 0)
                                    + h.map_slots + h.reduce_slots)
        if self._trace is not None:
            self._trace.instant("fleet", "churn", "host_add", now,
                               args={"host": str(hid)})

    def on_host_lost(self, host, now: float) -> None:
        self.registry.counter("churn.losses").inc()
        self.registry.get_series("rate.churn").add(now, 1.0)
        hid = host.hid
        self._pod_slots[hid.pod] = (self._pod_slots.get(hid.pod, 0)
                                    - host.map_slots - host.reduce_slots)
        if self._trace is not None:
            self._trace.instant("fleet", "churn", "host_lost", now,
                               args={"host": str(hid)})

    def on_host_notice(self, hid, deadline, reason: str,
                       now: float) -> None:
        self.registry.counter("churn.notices").inc()
        if self._trace is not None:
            self._trace.instant("fleet", "churn", f"notice:{reason}", now,
                               args={"host": str(hid),
                                     "deadline": deadline})

    # -- note_* call-ins (fabric / elastic / durability / migration) ----------
    def note_fleet(self, obs) -> None:
        """Record the exact ``FleetObservation`` about to be handed to
        the autoscaler — the scoreboard's backlog/fleet gauges are these
        integers verbatim, which is what makes scoreboard-fed scaling
        decisions bit-identical to observation-fed ones."""
        g = self.registry.gauge
        g("backlog.map").set(obs.map_backlog)
        g("backlog.reduce").set(obs.red_backlog)
        g("fleet.n_hosts").set(obs.n_hosts)
        g("fleet.cost").set(obs.cost)
        g("fleet.vps_hours").set(obs.vps_hours)

    def note_flow(self, f, now: float, stall: float) -> None:
        """A fabric flow completed (called from ``_complete_one`` of
        both allocators). The flow appears on every link of its path.
        This is the hottest telemetry call-in (one per flow at the
        scale point), so it buffers a single batch entry holding the
        allocator's *shared* path tuple — per-link expansion happens at
        export time (``TraceExporter.flow``), keeping the run-time cost
        to two allocations per flow regardless of hop count."""
        self._c_flows.inc()
        tr = self._trace
        if tr is not None:
            cls = getattr(f, "cls", None)
            path = cls.path if cls is not None else f.path
            tr.flow(path, f.kind, f.t0, now,
                    {"mb": f.mb, "stall_s": stall, "fid": f.fid})

    def note_autoscale(self, now: float, actions) -> None:
        if actions:
            self.registry.counter("autoscale.actions").inc(len(actions))
            self.registry.get_series("rate.autoscale").add(
                now, float(len(actions)))
        if self._trace is not None and actions:
            self._trace.instant("fleet", "autoscale", "actions", now,
                               args={"n": len(actions),
                                     "actions": [str(a) for a in actions]})

    def note_rerep(self, now: float, ev) -> None:
        self.registry.counter("durability.rerep").inc()
        self.registry.get_series("rate.rerep").add(now, 1.0)
        if self._trace is not None:
            self._trace.instant("fleet", "durability", "rerep", now,
                               args={"shard": str(ev.shard_id),
                                     "mb": ev.mb, "pod": ev.pod})

    def note_migration(self, now: float, what: str, tid=None,
                       **args) -> None:
        """Migration lifecycle note (``what`` in start/restore/abort)."""
        self.registry.counter(f"migration.{what}").inc()
        if what == "restore":
            self.registry.get_series("rate.migrate").add(now, 1.0)
        if self._trace is not None:
            if tid is not None:
                args["task"] = self._tid_str(tid)
            self._trace.instant("fleet", "migration", what, now,
                               args=args or None)

    def note_chaos(self, now: float, what: str) -> None:
        """Chaos layer note: one injection or response decision
        (``what`` is the log action, e.g. outage_kill / timeout /
        quarantine). Counter + trace instant, same shape as migration."""
        self.registry.counter(f"chaos.{what}").inc()
        if self._trace is not None:
            self._trace.instant("fleet", "chaos", what, now)

    # -- live O(1) views ------------------------------------------------------
    def job_progress(self, job_id: int) -> Tuple[float, float]:
        sim = self.sim
        job = sim.job_by_id[job_id]
        m, r = job.m, len(job.reduce_tasks)
        mf = 1.0 - (sim.maps_left[job_id] / m) if m else 1.0
        rf = 1.0 - (sim.reds_left[job_id] / r) if r else 1.0
        return (mf, rf)

    # -- finalize -------------------------------------------------------------
    def finalize(self, horizon: float) -> "TelemetrySubsystem":
        """Flush the last fabric sample up to the run horizon. The window
        containing ``horizon`` stays partial (never exposed as closed);
        the task slices materialize on the first ``.trace`` read."""
        self._sample_fabric(horizon)
        self._pending_tasks = self._trace is not None
        return self
