"""Discrete-event simulation of MapReduce execution on a virtual cluster.

Architecture: the event loop lives in the reusable kernel of
``repro_torch.sim.engine`` (event heap, deterministic sequencing, typed event
registry); optional machinery — elastic churn/autoscaling, durability,
the contention-aware network fabric — plugs in through the subsystem
protocol instead of inline event branches. ``docs/ARCHITECTURE.md`` is
the full tour: the kernel contract, the subsystem hooks, the per-stream
timing model (map read / shuffle / reduce formulas, the shuffle gate,
INT accounting), the elastic lease/failure/re-execution semantics, the
durability channels, and the fabric flow model.

The short version of the timing model (paper's three locality levels):

  map duration    = overhead + input/read_bw(locality) + input/map_rate
  shuffle read    = sum over mapper sources of bytes/read_bw(locality)
  reduce duration = overhead + shuffle read + reduce_input/reduce_rate

with reduces gated on all maps of the job (Hadoop's shuffle gate) and
INT counting every off-pod map read and cross-pod shuffle transfer.

Two transfer-timing modes share all scheduling/accounting code:

  * **per-stream** (default, ``SimConfig.fabric=None``) — every transfer
    is charged a fixed rate; bit-identical to the fabric-less simulator, held
    to the committed golden trajectories (``repro_torch.sim.golden``).
  * **fabric** (``SimConfig.fabric=FabricConfig(...)``) — transfers
    drain as flows through per-pod uplinks/downlinks and a shared WAN
    with max-min fair sharing (``repro_torch.sim.network``), so transfer
    completion times respond to load and saving INT bytes actually
    makes jobs faster — the paper's feedback loop.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.job import Job, MapTask, ReduceTask, TaskState
from repro_torch.core.topology import HostId, Locality, VirtualCluster
from repro_torch.sim.engine import EventKernel, Subsystem
from repro_torch.sim.network import FabricConfig, make_fabric


@dataclasses.dataclass
class SimConfig:
    """Rates in MB/s, times in seconds; defaults roughly calibrated to the
    paper's testbed (2-core VPS, SSD, LAN-within-datacenter, WAN across)."""

    disk_bw: float = 400.0      # host-local read
    pod_bw: float = 110.0       # intra-pod (LAN) per-stream
    dcn_bw: float = 35.0        # inter-pod (WAN) per-stream
    map_rate: float = 25.0      # map function processing rate
    reduce_rate: float = 50.0   # reduce function processing rate
    task_overhead: float = 1.0  # JVM/task start cost
    heartbeat: float = 3.0      # slot-offer interval (Hadoop heartbeat)
    fp_noise: float = 0.0       # relative noise on measured FP
    # straggler injection: host -> slowdown factor (>1 = slower)
    slow_hosts: Optional[Dict[HostId, float]] = None
    # speculative execution (framework feature; off for paper-faithful runs)
    speculative: bool = False
    spec_slack: float = 1.8     # relaunch when task exceeds slack * p50 runtime
    # seed-style dispatch: shuffle + poll every host on every event (kept
    # for old-vs-new benchmarking; the indexed dispatcher is the default)
    poll_all_hosts: bool = False
    # contention-aware fabric: None = per-stream mode (bit-identical
    # to the fabric-less simulator); a FabricConfig routes map reads, shuffle
    # fetches, checkpoint and repair traffic through shared links
    fabric: Optional[FabricConfig] = None
    # observability: a TelemetryConfig attaches the hook-only
    # TelemetrySubsystem (metric registry, trace exporter, scoreboard).
    # It owns no event kinds and consumes no RNG, so telemetry-on runs
    # are bit-identical to telemetry-off; None = zero overhead
    telemetry: Optional["TelemetryConfig"] = None
    # chaos layer: a ChaosConfig replays a deterministic fault
    # campaign (correlated pod outages, gray/disk episodes, link faults,
    # hung tasks); a ResponseConfig attaches the progress-timeout /
    # quarantine loop. Either None (or an empty campaign) executes the
    # exact pre-chaos code path — bit-identical to the 25 goldens
    chaos: Optional["ChaosConfig"] = None
    response: Optional["ResponseConfig"] = None

    def read_bw(self, loc: Locality) -> float:
        return {Locality.HOST: self.disk_bw, Locality.POD: self.pod_bw,
                Locality.OFF_POD: self.dcn_bw}[loc]


@dataclasses.dataclass
class TaskLog:
    job: Job
    task: object
    host: HostId
    start: float
    finish: float
    locality: Optional[Locality]  # None for reduce tasks
    bytes_local: float = 0.0
    bytes_pod: float = 0.0
    bytes_offpod: float = 0.0
    speculative: bool = False
    #: attempt restored from migrated state — resumed partway, so
    #: re-execution stats must not count it as a cold re-run
    migrated: bool = False


@dataclasses.dataclass
class SimResult:
    algorithm: str
    task_logs: List[TaskLog]
    job_submit: Dict[int, float]
    job_finish: Dict[int, float]
    int_bytes: float            # inter-pod traffic (MB)
    pod_bytes: float            # intra-pod traffic (MB)
    wtt: float
    jobs: List[Job]
    scheduler_decision_time: float = 0.0  # cumulative wall time in scheduler
    # -- elastic-cluster outputs (all zero for static runs) ------------------
    vps_hours: float = 0.0      # rented VPS-hours over the run
    cost_dollars: float = 0.0   # rental cost at the engine's price sheet
    work_lost_mb: float = 0.0   # completed map-output MB lost to churn
    n_reexec: int = 0           # task re-executions forced by churn
    n_host_adds: int = 0
    n_host_losses: int = 0
    elastic: object = None      # ElasticSummary when run with an engine
    # -- durability outputs (all zero without a durability config) -----
    n_rerep: int = 0            # shard replicas re-created after host loss
    rerep_mb: float = 0.0       # repair-pipeline traffic (not INT)
    ckpt_mb_written: float = 0.0  # map output persisted to pod stores
    ckpt_saved_mb: float = 0.0  # output MB the store saved from dead disks
    storage_dollars: float = 0.0  # object-store bill (also in cost_dollars)
    # -- fabric outputs (all zero/None in per-stream mode) -------------
    fabric: object = None       # FabricSummary when run with a fabric
    fabric_mb: float = 0.0      # MB drained through the fabric
    fabric_stall_s: float = 0.0  # transfer time lost to link contention
    wan_util: float = 0.0       # mean shared-WAN utilization over the run
    # -- migration outputs (all zero/None without the subsystem) -------
    migration: object = None    # MigrationSummary when run with migration
    n_migrated: int = 0         # tasks restored from shipped state
    migrate_mb: float = 0.0     # migration state traffic (MB)
    n_mig_aborted: int = 0      # migrations abandoned (races, lost hosts)
    # -- observability outputs (None without a telemetry config) -------
    telemetry: object = None    # TelemetrySubsystem (registry/trace/scoreboard)
    # -- chaos outputs (all zero/None without the chaos layer) --------
    chaos: object = None        # ChaosSummary when run with injection
    response: object = None     # ResponseSummary when run with the loop
    n_chaos_events: int = 0     # primary campaign injections applied
    n_hung: int = 0             # hung-task injections
    n_timeouts: int = 0         # attempts killed by progress timeout
    n_quarantined: int = 0      # hosts sent to quarantine
    n_surfaced: int = 0         # task pairs escalated to job-level failures

    def jtt(self, job: Job) -> float:
        return self.job_finish[job.job_id] - self.job_submit[job.job_id]


class Simulator:
    """Runs one workload under one algorithm. Deterministic given the seed
    (plus the elastic engine's churn seed, when one is attached)."""

    def __init__(self, cluster: VirtualCluster, algorithm, jobs: List[Job],
                 config: Optional[SimConfig] = None, seed: int = 0,
                 elastic=None, subsystems=()):
        self.cluster = cluster
        self.algo = algorithm
        self.jobs = jobs
        self.cfg = config or SimConfig()
        self.rng = np.random.RandomState(seed)
        self.elastic = elastic   # Optional[repro_torch.elastic.ElasticEngine]
        # extra observer subsystems appended after the built-ins:
        # hook-only plug-ins (no event kinds, no RNG) are guaranteed
        # trajectory-invariant — see tests/test_obs.py
        self.extra_subsystems = tuple(subsystems)

    def _make_kernel(self) -> EventKernel:
        """Kernel factory seam: benchmarks swap in ``ProfilingKernel``
        for per-event-kind timing without touching the run path."""
        return EventKernel()

    # ------------------------------------------------------------------ run --
    def run(self) -> SimResult:
        self.begin()
        end = self.kernel.run(post_step=self._dispatch_fn,
                              stop=self._drained)
        return self.finish(end)

    # -- resumable protocol (lockstep seam) ------------------------------
    # ``run()`` is exactly ``begin(); end = step(); finish(end)`` — the
    # split exists so a caller can interleave many simulators: pause each
    # at an event boundary (e.g. a deferred fabric fill), service the
    # batch, and resume. No state beyond the kernel's own heap/now is
    # held between calls, so a paused simulator is indistinguishable
    # from one mid-``run()``.
    def begin(self) -> None:
        """Build all run state and enqueue initial events; no event is
        processed yet."""
        kernel = self.kernel = self._make_kernel()
        subs = self._setup_state()
        kernel.register("submit", self._on_submit)
        kernel.register("hb", self._on_heartbeat, post_step=False)
        kernel.register("map_done", self._on_map_done)
        kernel.register("reduce_done", self._on_reduce_done)
        for s in subs:
            s.attach(self, kernel)
        self._bind_hooks(subs)
        for job in self.jobs:
            kernel.push(job.submit_time, "submit", job)
        for s in subs:
            s.start(0.0)
        dispatch = (self._naive_dispatch if self.cfg.poll_all_hosts
                    else self._dispatch)
        self._dispatch_fn = dispatch

    def step(self, pause=None) -> float:
        """Drain events until done, the heap empties, or ``pause()``
        returns true at an event boundary. Returns the last processed
        event time; call again to resume."""
        return self.kernel.run(post_step=self._dispatch_fn,
                               stop=self._drained, pause=pause)

    def finish(self, end: float) -> SimResult:
        return self._finalize(end)

    def _drained(self) -> bool:
        # all work done: the rest of the heap is heartbeats and
        # churn/autoscale ticks — nothing observable can happen, and
        # stopping here keeps lease accounting at makespan
        return self.unfinished == 0

    # ---------------------------------------------------------------- state --
    def _setup_state(self) -> List[Subsystem]:
        cfg = self.cfg
        elastic = self.elastic
        # durability: both flags gate every new branch below, so a
        # run without a manager executes exactly the durability-free code path
        self.dur = dur = elastic.durability if elastic is not None else None
        self.ckpt_on = dur is not None and dur.cfg.checkpoint
        self.rerep_on = dur is not None and dur.cfg.rereplicate
        self.departed = set()    # HostIds gone (ckpt store-read routing)
        # slot state
        self.map_free = {h.hid: h.map_slots for h in self.cluster.hosts()}
        self.red_free = {h.hid: h.reduce_slots for h in self.cluster.hosts()}
        # hosts with at least one free slot of each kind (incremental sets:
        # dispatch touches only eligible hosts instead of polling all)
        self.free_map_hosts = {h for h, n in self.map_free.items() if n > 0}
        self.free_red_hosts = {h for h, n in self.red_free.items() if n > 0}
        self.maps_left = {j.job_id: j.m for j in self.jobs}
        self.reds_left = {j.job_id: len(j.reduce_tasks) for j in self.jobs}
        # queued-but-unassigned reduces per job (for gate open/close sizing;
        # statically equals len(reduce_tasks) at the single gate opening)
        self.reds_unassigned = {j.job_id: len(j.reduce_tasks)
                                for j in self.jobs}
        self.job_by_id = {j.job_id: j for j in self.jobs}
        # mapper placements for shuffle accounting:
        # job -> [(host, out_bytes, map_index)]
        self.map_out: Dict[int, List[Tuple[HostId, float, int]]] = {
            j.job_id: [] for j in self.jobs}
        # reverse index: host -> jobs with map output on its disk, so a
        # host departure touches only the affected jobs instead of
        # scanning every job's full output list (churn-scale fix)
        self.host_outputs: Dict[HostId, set] = {}
        self.running: Dict[object, TaskLog] = {}
        self.task_logs: List[TaskLog] = []
        self.job_submit: Dict[int, float] = {}
        self.job_finish: Dict[int, float] = {}
        self.int_bytes = 0.0
        self.pod_bytes = 0.0
        self.submitted: set = set()
        # backlog counters: queued-but-unassigned maps and ready-but-
        # unassigned reduces; dispatch is a no-op while both are zero
        self.map_backlog = 0
        self.red_ready_backlog = 0
        self.notify_maps_done = getattr(self.algo, "job_maps_done", None)
        # elastic-cluster accounting
        self.work_lost_mb = 0.0
        self.n_reexec = 0
        self.n_host_adds = 0
        self.n_host_losses = 0
        # highest attempt number handed out per task (speculative twins and
        # churn re-executions share the sequence so tids stay unique)
        self.m_attempt: Dict[Tuple[int, int], int] = {}
        self.r_attempt: Dict[Tuple[int, int], int] = {}
        # speculative-execution bookkeeping (straggler mitigation)
        self.done_pairs: set = set()          # (job_id, map_index) finished
        self.backups: Dict[Tuple[int, int], int] = {}
        self.spec_tids: set = set()           # tids of backup shadows (the
        # attempt counter alone can't tell a backup from a churn re-run)
        self.map_durations: List[float] = []
        self.all_hosts = [h.hid for h in self.cluster.hosts()]
        self.host_rank = {hid: i for i, hid in enumerate(self.all_hosts)}
        self.n_hosts = len(self.all_hosts)
        # O(1) per-pod backlog flags: skip hosts whose pod
        # provably has no work. Exact — a skipped poll was guaranteed None.
        self.map_pod_ok = getattr(self.algo, "map_work_in_pod", None)
        self.red_pod_ok = getattr(self.algo, "reduce_work_in_pod", None)
        # total outstanding work, to know when the heartbeat chain may stop
        self.unfinished = sum(j.m + len(j.reduce_tasks) for j in self.jobs)
        self.hb_scheduled = False
        # speculative backups of checkpointed jobs read the pod object
        # store instead of a shard replica; empty unless
        # speculation AND checkpointing are both on
        self._store_read_maps: set = set()
        # fabric mode: in-flight flow per task tid (cancelled on kill)
        self._task_flows: Dict[object, int] = {}
        # migration: draining hosts keep their slot counters but
        # leave the free-offer sets, so dispatch stops feeding them
        self.draining: set = set()
        self.migration = None
        # chaos: dynamic fault overlays. Every consumer below
        # gates on truthiness, so with no campaign attached these stay
        # empty and the pre-chaos code path runs instruction-for-
        # instruction (bit-identity to the goldens)
        self.dyn_slow: Dict[HostId, float] = {}   # chaos slowdown overlay
        self.dyn_disk: Dict[HostId, float] = {}   # ckpt/rerep write stretch
        self.chaos_hung: Dict[object, float] = {}  # tid -> stall seconds
        self.quarantined: set = set()   # response-layer blacklist
        self.chaos = None           # ChaosSubsystem (set on attach)
        self.chaos_response = None  # ResponseSubsystem (set on attach)

        subs: List[Subsystem] = []
        if self.elastic is not None:
            from repro_torch.elastic.durability import DurabilitySubsystem
            from repro_torch.elastic.engine import ElasticSubsystem
            subs.append(ElasticSubsystem(self.elastic))
            if self.dur is not None:
                subs.append(DurabilitySubsystem(self.dur))
            mig_cfg = getattr(self.elastic, "migration_cfg", None)
            if mig_cfg is not None and mig_cfg.enabled:
                from repro_torch.elastic.migration import MigrationSubsystem
                self.migration = MigrationSubsystem(mig_cfg)
                subs.append(self.migration)
        # fast (class-aggregated) or reference allocator, per the config
        self.fabric = None
        if cfg.fabric is not None:
            self.fabric = make_fabric(self.cluster, cfg.fabric)
            subs.append(self.fabric)
        # chaos + response: injection attaches before response so
        # a same-instant injection is visible to that tick's deadline
        # scan, and both before telemetry so their notes are observable
        if cfg.chaos is not None and cfg.chaos.enabled:
            from repro_torch.chaos.inject import ChaosSubsystem
            subs.append(ChaosSubsystem(cfg.chaos))
        if cfg.response is not None and cfg.response.enabled:
            from repro_torch.chaos.response import ResponseSubsystem
            subs.append(ResponseSubsystem(cfg.response))
        # telemetry: attached last so its samples see the fabric;
        # hook-only (no event kinds, no RNG), so trajectories don't move
        self.telemetry = None
        if cfg.telemetry is not None:
            # local import: repro_torch.obs imports the engine module, so a
            # top-level import here would be circular
            from repro_torch.obs.telemetry import TelemetrySubsystem
            self.telemetry = TelemetrySubsystem(cfg.telemetry)
            subs.append(self.telemetry)
            if self.elastic is not None:
                attach = getattr(self.elastic.autoscaler,
                                 "attach_scoreboard", None)
                if attach is not None:
                    attach(self.telemetry.scoreboard)
        subs.extend(self.extra_subsystems)
        return subs

    def _bind_hooks(self, subs: List[Subsystem]) -> None:
        """Collect only the hooks a subsystem actually overrides, so the
        per-task/per-event hook fan-out costs nothing when unused."""
        def overridden(name):
            return [getattr(s, name) for s in subs
                    if getattr(type(s), name) is not getattr(Subsystem, name)]
        self._hooks_host_added = overridden("on_host_added")
        self._hooks_host_lost = overridden("on_host_lost")
        self._hooks_host_notice = overridden("on_host_notice")
        self._hooks_host_survived = overridden("on_host_survived")
        self._hooks_task_start = overridden("on_task_start")
        self._hooks_task_finish = overridden("on_task_finish")
        self._hooks_job_submit = overridden("on_job_submit")
        self._hooks_job_finish = overridden("on_job_finish")
        self._hooks_tick = overridden("on_tick")

    # ------------------------------------------------------------- helpers --
    def _ready_reduce(self, t: ReduceTask) -> bool:
        return (t.job_id in self.submitted and self.maps_left[t.job_id] == 0)

    def _host_slow(self, hid: HostId) -> float:
        s = (self.cfg.slow_hosts.get(hid, 1.0)
             if self.cfg.slow_hosts else 1.0)
        if self.dyn_slow:
            # chaos overlay: gray episodes / outage prodromes
            # multiply into the static straggler map
            s *= self.dyn_slow.get(hid, 1.0)
        return s

    # ------------------------------------------------ draining --
    def drain_host(self, hid: HostId) -> None:
        """Stop offering ``hid`` to dispatch (slot counters stay live, so
        running tasks finish normally and idleness is still observable)."""
        self.draining.add(hid)
        self.free_map_hosts.discard(hid)
        self.free_red_hosts.discard(hid)

    def undrain_host(self, hid: HostId) -> None:
        """Reopen a drained host (notice cancelled / nothing to move)."""
        self.draining.discard(hid)
        if self.cluster.has_host(hid) and hid not in self.quarantined:
            if self.map_free.get(hid, 0) > 0:
                self.free_map_hosts.add(hid)
            if self.red_free.get(hid, 0) > 0:
                self.free_red_hosts.add(hid)

    # ------------------------------------------- quarantine --
    def quarantine_host(self, hid: HostId) -> None:
        """Blacklist an unhealthy host: same mechanics as draining
        (slot counters stay live, running tasks finish or time out,
        nothing new is offered), but owned by the response layer."""
        self.quarantined.add(hid)
        self.free_map_hosts.discard(hid)
        self.free_red_hosts.discard(hid)

    def readmit_host(self, hid: HostId) -> None:
        """Probation over: re-enter the host in the offer sets (unless
        it is meanwhile draining toward an announced departure)."""
        self.quarantined.discard(hid)
        if self.cluster.has_host(hid) and hid not in self.draining:
            if self.map_free.get(hid, 0) > 0:
                self.free_map_hosts.add(hid)
            if self.red_free.get(hid, 0) > 0:
                self.free_red_hosts.add(hid)

    def kill_task(self, tid, now: float) -> Optional[TaskLog]:
        """Kill one running attempt (timeout response): free its
        slot, cancel its in-flight fabric flow, drop any pending hang,
        and leave re-dispatch to the caller. Returns the attempt's log,
        or None when it already finished (the timeout raced the done
        event inside one instant)."""
        log = self.running.pop(tid, None)
        if log is None:
            return None
        self.chaos_hung.pop(tid, None)
        if self.fabric is not None:
            fid = self._task_flows.pop(tid, None)
            if fid is not None:
                self.fabric.cancel(fid, now)
        t = log.task
        t.state = TaskState.FAILED
        self.algo.task_finished(t)
        hid = log.host
        offerable = (hid not in self.draining
                     and hid not in self.quarantined)
        if isinstance(t, MapTask):
            if hid in self.map_free:
                self.map_free[hid] += 1
                if offerable:
                    self.free_map_hosts.add(hid)
        elif hid in self.red_free:
            self.red_free[hid] += 1
            if offerable:
                self.free_red_hosts.add(hid)
        return log

    def requeue_failed_attempt(self, log: TaskLog, now: float) -> bool:
        """Queue a fresh attempt of a killed task (timeout
        response), mirroring ``lose_host``'s kill+requeue bookkeeping.
        Returns False when requeueing is moot: the pair finished in the
        meantime (a speculative twin) or another attempt is running."""
        t = log.task
        jid = t.job_id
        if jid in self.job_finish:
            return False
        if isinstance(t, MapTask):
            pair = (jid, t.index)
            if pair in self.done_pairs:
                return False
            if any(isinstance(ls.task, MapTask)
                   and (ls.task.job_id, ls.task.index) == pair
                   for ls in self.running.values()):
                return False
            requeue_map = getattr(self.algo, "requeue_map_task", None)
            if requeue_map is None:
                return False
            requeue_map(self._remake_map(jid, t.index))
            self.map_backlog += 1
            self.n_reexec += 1
            return True
        if self.job_by_id[jid].reduce_tasks[t.index].state is TaskState.DONE:
            return False
        if any(isinstance(ls.task, ReduceTask) and ls.task.job_id == jid
               and ls.task.index == t.index
               for ls in self.running.values()):
            return False
        requeue_red = getattr(self.algo, "requeue_reduce_task", None)
        if requeue_red is None:
            return False
        requeue_red(self._remake_reduce(jid, t.index))
        self.reds_unassigned[jid] += 1
        self.n_reexec += 1
        if self.maps_left[jid] == 0:
            self.red_ready_backlog += 1
            if self.notify_maps_done is not None:
                self.notify_maps_done(jid)
        return True

    def host_is_idle(self, hid: HostId) -> bool:
        """True iff the host is alive with every slot free (used to
        re-validate scale-in victims at apply time)."""
        if not self.cluster.has_host(hid):
            return False
        h = self.cluster.host(hid)
        return (self.map_free[hid] == h.map_slots
                and self.red_free[hid] == h.reduce_slots)

    # --------------------------------------------------------- task starts --
    def _start_map(self, t: MapTask, hid: HostId, now: float,
                   resume_frac: Optional[float] = None):
        """``resume_frac``: the attempt restores migrated state and
        only the remaining ``1 - resume_frac`` of input is read/computed
        (and of output persisted); None = a normal cold start."""
        cfg = self.cfg
        job = self.job_by_id[t.job_id]
        size = job.shard_bytes[t.index]
        rem = size if resume_frac is None else size * (1.0 - resume_frac)
        store_read = t.tid in self._store_read_maps
        src = None
        if store_read:
            # a speculative backup of a checkpointed job
            # fetches its own pod's object store (the store stages the
            # job's blocks on first read) instead of re-reading the
            # straggler's remote disk replica — pod traffic, not WAN
            loc = Locality.POD
        elif t.shard_id in self.cluster.shard_replicas:
            src, loc = self.cluster.nearest_replica(t.shard_id, hid)
        else:
            loc = Locality.OFF_POD
        if self.fabric is not None:
            return self._start_map_fabric(t, hid, now, job, rem, loc,
                                          src, store_read,
                                          migrated=resume_frac is not None)
        if store_read:
            read_t = rem / min(cfg.pod_bw, self.dur.cfg.ckpt_read_bw)
        else:
            read_t = rem / cfg.read_bw(loc)
        comp_t = rem / cfg.map_rate * job.cost_scale
        write_t = 0.0
        if self.ckpt_on and self.dur.checkpoints_job(job):
            # synchronous persist of the map output to the pod object
            # store before the task reports done (checkpointing)
            write_t = rem * job.true_fp / self.dur.cfg.ckpt_write_bw
            if self.dyn_disk:
                # disk-slow chaos episode stretches the persist
                write_t *= self.dyn_disk.get(hid, 1.0)
        dur_s = (cfg.task_overhead + read_t + comp_t + write_t) \
            * self._host_slow(hid)
        t.state = TaskState.RUNNING
        t.host, t.locality = hid, loc
        log = TaskLog(job, t, hid, now, now + dur_s, loc,
                      migrated=resume_frac is not None)
        self._account_map_bytes(log, loc, rem)
        self.running[t.tid] = log
        left = self.map_free[hid] - 1
        self.map_free[hid] = left
        if left == 0:
            self.free_map_hosts.discard(hid)
        self.algo.task_started(t)
        self.kernel.push(now + dur_s, "map_done", t)
        for h in self._hooks_task_start:
            h(log, now)

    def _account_map_bytes(self, log: TaskLog, loc: Locality, size: float):
        if loc is Locality.POD:
            log.bytes_pod = size
            self.pod_bytes += size
        elif loc is Locality.OFF_POD:
            log.bytes_offpod = size
            self.int_bytes += size
        else:
            log.bytes_local = size

    def _start_map_fabric(self, t: MapTask, hid: HostId, now: float,
                          job: Job, size: float, loc: Locality,
                          src: Optional[HostId], store_read: bool,
                          migrated: bool = False):
        """Fabric-mode map: overhead -> input transfer (flow, unless
        host-local) -> compute -> checkpoint write (flow) -> done. Fixed
        stages ride ``kernel.call_at``; transfers drain through the
        fabric. The host slowdown factor applies to local work (overhead,
        disk read, compute) — network time is the fabric's to decide.
        ``size`` is the bytes this attempt still has to process (already
        discounted for migrated restores)."""
        cfg = self.cfg
        slow = self._host_slow(hid)
        t.state = TaskState.RUNNING
        t.host, t.locality = hid, loc
        log = TaskLog(job, t, hid, now, 0.0, loc, migrated=migrated)
        self._account_map_bytes(log, loc, size)
        self.running[t.tid] = log
        left = self.map_free[hid] - 1
        self.map_free[hid] = left
        if left == 0:
            self.free_map_hosts.discard(hid)
        self.algo.task_started(t)
        for h in self._hooks_task_start:
            h(log, now)

        k = self.kernel
        tid = t.tid
        comp_t = size / cfg.map_rate * job.cost_scale * slow
        write_mb = 0.0
        if self.ckpt_on and self.dur.checkpoints_job(job):
            write_mb = size * job.true_fp

        def fin(tn):
            if tid in self.running:
                k.push(tn, "map_done", t)

        def wstage(tn):
            if tid not in self.running:
                return
            if write_mb > 0.0:
                # persist to the pod object store: pod-internal hop
                bw = self.dur.cfg.ckpt_write_bw
                if self.dyn_disk:
                    # disk-slow chaos episode caps the persist stream
                    bw /= self.dyn_disk.get(hid, 1.0)
                self._task_flow(tid, tn, write_mb, hid.pod, hid.pod,
                                bw, "ckpt_write", fin)
            else:
                fin(tn)

        def cstage(tn):
            if tid in self.running:
                k.call_at(tn + comp_t, wstage)

        pre = cfg.task_overhead * slow
        if loc is Locality.HOST:
            k.call_at(now + pre + size / cfg.disk_bw * slow + comp_t, wstage)
            return
        if store_read:
            src_pod, cap = hid.pod, min(cfg.pod_bw, self.dur.cfg.ckpt_read_bw)
        elif src is None:   # no surviving replica: external durable store
            src_pod, cap = None, cfg.dcn_bw
        else:
            src_pod = src.pod
            cap = cfg.pod_bw if loc is Locality.POD else cfg.dcn_bw

        def rstage(tn):
            if tid in self.running:
                self._task_flow(tid, tn, size, src_pod, hid.pod, cap,
                                "map_read", cstage)

        k.call_at(now + pre, rstage)

    def _task_flow(self, tid, now: float, mb: float, src_pod, dst_pod: int,
                   cap: float, kind: str, done) -> None:
        """Start a fabric flow owned by a running task; the ownership map
        lets a churn kill cancel the in-flight transfer."""
        def _done(tn):
            self._task_flows.pop(tid, None)
            done(tn)
        fid = self.fabric.start_flow(now, mb, src_pod, dst_pod, cap,
                                     kind, _done)
        if fid >= 0:
            self._task_flows[tid] = fid

    def _start_reduce(self, t: ReduceTask, hid: HostId, now: float,
                      resume_frac: Optional[float] = None):
        """``resume_frac``: restore from migrated state — only the
        remaining fraction of each shuffle fetch and of the compute runs,
        and the job's unassigned-reduce counter is left alone (the
        original attempt already claimed the assignment)."""
        cfg = self.cfg
        job = self.job_by_id[t.job_id]
        fp = job.true_fp
        r = len(job.reduce_tasks)
        scale = 1.0 if resume_frac is None else (1.0 - resume_frac)
        if self.fabric is not None:
            return self._start_reduce_fabric(t, hid, now, job, fp, r,
                                             resume_frac=resume_frac)
        log = TaskLog(job, t, hid, now, 0.0, None,
                      migrated=resume_frac is not None)
        read_t = 0.0
        for (src, out_bytes, _mi) in self.map_out[job.job_id]:
            share = out_bytes * fp / r * scale
            if self.ckpt_on and src in self.departed:
                # the mapper's disk is gone; its output survives only
                # in src's pod object store (checkpointing). A
                # store read is network traffic even within the pod,
                # and WAN-capped across pods.
                if src.pod == hid.pod:
                    log.bytes_pod += share
                    self.pod_bytes += share
                    read_t += share / min(cfg.pod_bw,
                                          self.dur.cfg.ckpt_read_bw)
                else:
                    log.bytes_offpod += share
                    self.int_bytes += share
                    read_t += share / min(cfg.dcn_bw,
                                          self.dur.cfg.ckpt_read_bw)
            elif src == hid:
                log.bytes_local += share
                read_t += share / cfg.disk_bw
            elif src.pod == hid.pod:
                log.bytes_pod += share
                self.pod_bytes += share
                read_t += share / cfg.pod_bw
            else:
                log.bytes_offpod += share
                self.int_bytes += share
                read_t += share / cfg.dcn_bw
        total_in = (log.bytes_local + log.bytes_pod + log.bytes_offpod)
        comp_t = total_in / cfg.reduce_rate * job.cost_scale
        dur_s = (cfg.task_overhead + read_t + comp_t) * self._host_slow(hid)
        t.state = TaskState.RUNNING
        t.host = hid
        log.finish = now + dur_s
        self.running[t.tid] = log
        if resume_frac is None:
            self.reds_unassigned[t.job_id] -= 1
        left = self.red_free[hid] - 1
        self.red_free[hid] = left
        if left == 0:
            self.free_red_hosts.discard(hid)
        self.algo.task_started(t)
        self.kernel.push(now + dur_s, "reduce_done", t)
        for h in self._hooks_task_start:
            h(log, now)

    def _start_reduce_fabric(self, t: ReduceTask, hid: HostId, now: float,
                             job: Job, fp: float, r: int,
                             resume_frac: Optional[float] = None):
        """Fabric-mode reduce: overhead -> sequential shuffle fetches
        (each remote source one flow; local sources read the disk) ->
        compute -> done. Byte counters are charged at start, exactly like
        per-stream mode (the traffic will physically happen)."""
        cfg = self.cfg
        slow = self._host_slow(hid)
        scale = 1.0 if resume_frac is None else (1.0 - resume_frac)
        log = TaskLog(job, t, hid, now, 0.0, None,
                      migrated=resume_frac is not None)
        # (mb, src_pod, per-flow cap, kind) per remote fetch; local
        # fetches contribute fixed disk time instead
        fetches: List[Tuple[float, Optional[int], float, str]] = []
        disk_t = 0.0
        for (src, out_bytes, _mi) in self.map_out[job.job_id]:
            share = out_bytes * fp / r * scale
            if self.ckpt_on and src in self.departed:
                if src.pod == hid.pod:
                    log.bytes_pod += share
                    self.pod_bytes += share
                    fetches.append((share, src.pod,
                                    min(cfg.pod_bw,
                                        self.dur.cfg.ckpt_read_bw),
                                    "ckpt_read"))
                else:
                    log.bytes_offpod += share
                    self.int_bytes += share
                    fetches.append((share, src.pod,
                                    min(cfg.dcn_bw,
                                        self.dur.cfg.ckpt_read_bw),
                                    "ckpt_read"))
            elif src == hid:
                log.bytes_local += share
                disk_t += share / cfg.disk_bw
            elif src.pod == hid.pod:
                log.bytes_pod += share
                self.pod_bytes += share
                fetches.append((share, src.pod, cfg.pod_bw, "shuffle"))
            else:
                log.bytes_offpod += share
                self.int_bytes += share
                fetches.append((share, src.pod, cfg.dcn_bw, "shuffle"))
        total_in = (log.bytes_local + log.bytes_pod + log.bytes_offpod)
        comp_t = total_in / cfg.reduce_rate * job.cost_scale * slow
        t.state = TaskState.RUNNING
        t.host = hid
        self.running[t.tid] = log
        if resume_frac is None:
            self.reds_unassigned[t.job_id] -= 1
        left = self.red_free[hid] - 1
        self.red_free[hid] = left
        if left == 0:
            self.free_red_hosts.discard(hid)
        self.algo.task_started(t)
        for h in self._hooks_task_start:
            h(log, now)

        k = self.kernel
        tid = t.tid
        it = iter(fetches)

        def next_fetch(tn):
            if tid not in self.running:
                return
            nxt = next(it, None)
            if nxt is None:
                k.call_at(tn + comp_t, done_stage)
                return
            mb, src_pod, cap, kind = nxt
            self._task_flow(tid, tn, mb, src_pod, hid.pod, cap, kind,
                            next_fetch)

        def done_stage(tn):
            if tid in self.running:
                k.push(tn, "reduce_done", t)

        k.call_at(now + (cfg.task_overhead + disk_t) * slow, next_fetch)

    # ----------------------------------------------------------- dispatch --
    def _launch_backups(self, now: float):
        """MapReduce speculative execution: duplicate a map task that
        exceeds spec_slack x the median duration onto a free host
        (another pod preferred) — first copy to finish wins. Backups of
        checkpointed jobs fetch the pod object store."""
        cfg = self.cfg
        map_durations = self.map_durations
        if len(map_durations) < 5:
            return
        threshold = cfg.spec_slack * float(np.median(map_durations))
        map_free = self.map_free
        for log in list(self.running.values()):
            t = log.task
            if not isinstance(t, MapTask):
                continue
            pair = (t.job_id, t.index)
            if (pair in self.done_pairs or self.backups.get(pair, 0) > 0
                    or now - log.start <= threshold):
                continue
            cands = [h for h in self.all_hosts
                     if map_free[h] > 0 and h != log.host
                     and h not in self.draining
                     and h not in self.quarantined]
            if not cands:
                continue
            cands.sort(key=lambda h: (h.pod == log.host.pod,
                                      h.pod, h.index))
            a = self.m_attempt[pair] = self.m_attempt.get(pair, 0) + 1
            shadow = MapTask(t.job_id, t.index, t.shard_id,
                             t.input_bytes, attempt=a)
            self.backups[pair] = self.backups.get(pair, 0) + 1
            self.spec_tids.add(shadow.tid)
            if self.ckpt_on and self.dur.checkpoints_job(
                    self.job_by_id[t.job_id]):
                self._store_read_maps.add(shadow.tid)
            self._start_map(shadow, cands[0], now)

    def _naive_dispatch(self, now: float):
        # seed dispatcher (kept for old-vs-new benchmarking): shuffle
        # and poll every host on every event
        order = list(self.all_hosts)
        self.rng.shuffle(order)
        algo = self.algo
        map_free = self.map_free
        red_free = self.red_free
        ready_reduce = self._ready_reduce
        progress = True
        while progress:
            progress = False
            for hid in order:
                if hid in self.draining or hid in self.quarantined:
                    continue
                while map_free[hid] > 0:
                    t = algo.next_map_task(hid)
                    if t is None:
                        break
                    self._start_map(t, hid, now)
                    progress = True
                while red_free[hid] > 0:
                    t = algo.next_reduce_task(hid, ready_reduce)
                    if t is None:
                        break
                    self._start_reduce(t, hid, now)
                    progress = True
        if self.cfg.speculative:
            self._launch_backups(now)

    def _dispatch(self, now: float):
        # incremental dispatcher: a no-op unless there is assignable
        # work AND a host with a free slot to offer; each pass touches
        # only eligible hosts. Heartbeat order is arbitrary in a real
        # cluster, so eligible hosts are still offered in shuffled
        # order (no algorithm benefits from host enumeration order).
        map_backlog = self.map_backlog
        red_ready_backlog = self.red_ready_backlog
        if map_backlog or red_ready_backlog:
            algo = self.algo
            free_map_hosts = self.free_map_hosts
            free_red_hosts = self.free_red_hosts
            map_free = self.map_free
            red_free = self.red_free
            all_hosts = self.all_hosts
            n_hosts = self.n_hosts
            host_rank = self.host_rank
            map_pod_ok = self.map_pod_ok
            red_pod_ok = self.red_pod_ok
            ready_reduce = self._ready_reduce
            start_map = self._start_map
            start_reduce = self._start_reduce
            while map_backlog or red_ready_backlog:
                elig = free_map_hosts if map_backlog else free_red_hosts
                if red_ready_backlog and map_backlog:
                    elig = free_map_hosts | free_red_hosts
                if not elig:
                    break
                if len(elig) * 8 > n_hosts:
                    order = [h for h in all_hosts if h in elig]
                else:
                    order = sorted(elig, key=host_rank.__getitem__)
                self.rng.shuffle(order)
                # per-pod work flags, memoized per pass (work can only
                # drain during a pass, so a cached True is merely a poll)
                mflags: Dict[int, bool] = {}
                rflags: Dict[int, bool] = {}
                progress = False
                for hid in order:
                    pod = hid.pod
                    if map_backlog:
                        ok = (mflags.get(pod) if map_pod_ok is not None
                              else True)
                        if ok is None:
                            ok = mflags[pod] = map_pod_ok(pod)
                        while ok and map_free[hid] > 0:
                            t = algo.next_map_task(hid)
                            if t is None:
                                break
                            map_backlog -= 1
                            start_map(t, hid, now)
                            progress = True
                    if red_ready_backlog:
                        ok = (rflags.get(pod) if red_pod_ok is not None
                              else True)
                        if ok is None:
                            ok = rflags[pod] = red_pod_ok(pod)
                        while ok and red_free[hid] > 0:
                            t = algo.next_reduce_task(hid, ready_reduce)
                            if t is None:
                                break
                            red_ready_backlog -= 1
                            start_reduce(t, hid, now)
                            progress = True
                if not progress:
                    break
            self.map_backlog = map_backlog
            self.red_ready_backlog = red_ready_backlog
        if self.cfg.speculative:
            self._launch_backups(now)

    # ---------------------------------------------- elastic mechanics --
    def _remake_map(self, jid: int, midx: int) -> MapTask:
        orig = self.job_by_id[jid].map_tasks[midx]
        a = self.m_attempt[(jid, midx)] = self.m_attempt.get((jid, midx),
                                                             0) + 1
        return MapTask(jid, midx, orig.shard_id, orig.input_bytes,
                       attempt=a)

    def _remake_reduce(self, jid: int, ridx: int) -> ReduceTask:
        a = self.r_attempt[(jid, ridx)] = self.r_attempt.get((jid, ridx),
                                                             0) + 1
        return ReduceTask(jid, ridx, attempt=a)

    def add_host(self, pod: int, kind: str, now: float) -> HostId:
        """Lease a fresh VPS into ``pod`` and enter it in every offer
        structure (called by the elastic subsystem)."""
        h = self.cluster.add_host(pod)
        hid = h.hid
        self.map_free[hid] = h.map_slots
        self.red_free[hid] = h.reduce_slots
        self.free_map_hosts.add(hid)
        self.free_red_hosts.add(hid)
        self.all_hosts.append(hid)
        self.host_rank[hid] = len(self.host_rank)  # ranks are never reused
        self.n_hosts += 1
        self.n_host_adds += 1
        hook = getattr(self.algo, "host_added", None)
        if hook is not None:
            hook(hid)
        for h2 in self._hooks_host_added:
            h2(hid, now)
        return hid

    def lose_host(self, hid: HostId, now: float):
        """Apply one host departure: kill+requeue its running tasks,
        re-run maps whose outputs died with its disk, re-close shuffle
        gates, and patch every index/offer structure."""
        dead = self.cluster.remove_host(hid)
        self.departed.add(hid)
        self.draining.discard(hid)
        self.quarantined.discard(hid)
        self.map_free.pop(hid, None)
        self.red_free.pop(hid, None)
        self.free_map_hosts.discard(hid)
        self.free_red_hosts.discard(hid)
        self.all_hosts.remove(hid)
        self.n_hosts -= 1
        self.n_host_losses += 1
        algo = self.algo
        hook = getattr(algo, "host_lost", None)
        if hook is not None:
            hook(hid)   # patches locality indexes; evacuates empty pods
        notify_undone = getattr(algo, "job_maps_undone", None)
        requeue_map = getattr(algo, "requeue_map_task", None)
        requeue_red = getattr(algo, "requeue_reduce_task", None)
        notify_maps_done = self.notify_maps_done
        # (a) completed map outputs on the dead disk are lost; if the
        # job still has reduce work ahead, those maps must re-run and
        # the shuffle gate re-closes until they land
        for jid in sorted(self.host_outputs.pop(hid, ())):
            if self.reds_left[jid] == 0:
                continue    # every reduce already consumed its shuffle
            entries = self.map_out[jid]
            lost = [e for e in entries if e[0] == hid]
            if not lost:    # pragma: no cover - index is add-only
                continue
            if self.ckpt_on and self.dur.checkpoints_job(self.job_by_id[jid]):
                # outputs persisted to the pod object store survive the
                # disk: no re-run, no gate re-close; reduces started
                # from here on read them via the store (``departed``)
                self.dur.note_ckpt_save(
                    sum(e[1] for e in lost) * self.job_by_id[jid].true_fp,
                    len(lost))
                continue
            self.map_out[jid] = [e for e in entries if e[0] != hid]
            job = self.job_by_id[jid]
            gate_was_open = self.maps_left[jid] == 0
            for (_h, out_b, midx) in lost:
                self.done_pairs.discard((jid, midx))
                job.map_tasks[midx].state = TaskState.FAILED
                self.maps_left[jid] += 1
                self.unfinished += 1
                self.work_lost_mb += out_b * job.true_fp
                # a still-running speculative twin will re-produce the
                # output — no fresh attempt needed (same backups-gated
                # O(1) guard as the killed-running path below)
                if self.backups.get((jid, midx), 0) and any(
                        isinstance(ls.task, MapTask)
                        and (ls.task.job_id, ls.task.index) == (jid, midx)
                        for ls in self.running.values()):
                    continue
                requeue_map(self._remake_map(jid, midx))
                self.map_backlog += 1
                self.n_reexec += 1
            if gate_was_open:
                self.red_ready_backlog -= self.reds_unassigned[jid]
                if notify_undone is not None:
                    notify_undone(jid)
        # (b) tasks running on the host are killed and re-executed
        for tid, log in list(self.running.items()):
            if log.host != hid:
                continue
            del self.running[tid]
            if self.fabric is not None:
                fid = self._task_flows.pop(tid, None)
                if fid is not None:
                    self.fabric.cancel(fid, now)
            t = log.task
            t.state = TaskState.FAILED
            algo.task_finished(t)   # the attempt ended (killed) — keeps
            # running_tasks honest for Fair/Capacity ordering
            jid = t.job_id
            if isinstance(t, MapTask):
                pair = (jid, t.index)
                if pair in self.done_pairs:
                    continue    # a speculative twin already finished it
                # a concurrent attempt can only exist if a backup was
                # launched for this pair, so the O(running) twin scan
                # is gated on the O(1) backups counter
                if self.backups.get(pair, 0) and any(
                        isinstance(ls.task, MapTask)
                        and (ls.task.job_id, ls.task.index) == pair
                        for ls in self.running.values()):
                    continue    # a twin is still running elsewhere
                requeue_map(self._remake_map(jid, t.index))
                self.map_backlog += 1
                self.n_reexec += 1
            else:
                requeue_red(self._remake_reduce(jid, t.index))
                self.reds_unassigned[jid] += 1
                self.n_reexec += 1
                if self.maps_left[jid] == 0:
                    self.red_ready_backlog += 1
                    if notify_maps_done is not None:
                        notify_maps_done(jid)   # re-mark the new bucket
        # (c) subsystem reactions (e.g. durability schedules re-replication
        # repairs for every shard the dead disk held)
        for h in self._hooks_host_lost:
            h(dead, now)

    def fleet_observation(self, now: float, full: bool = False):
        """The O(hosts) idle/busy fleet walk runs only for autoscale
        ticks (``full=True``) of policies that declared
        ``needs_idle_hosts`` — churn events (including lease-expiry
        renewals, which read only backlog/fleet-size/cost, all O(1))
        never pay it."""
        elastic = self.elastic
        idle: Tuple[HostId, ...] = ()
        light: Tuple[HostId, ...] = ()
        busy = 0
        scaler = elastic.autoscaler
        need_light = full and getattr(scaler, "needs_light_hosts", False)
        if full and (need_light
                     or getattr(scaler, "needs_idle_hosts", False)):
            cl = self.cluster
            idle_list = []
            light_list = []
            for hid in self.all_hosts:
                h = cl.host(hid)
                occ = ((h.map_slots - self.map_free[hid])
                       + (h.reduce_slots - self.red_free[hid]))
                if occ == 0:
                    idle_list.append(hid)
                else:
                    busy += 1
                    # compaction candidates: one straggling task
                    # pins the lease; skip hosts already being drained
                    if (need_light and occ == 1
                            and hid not in self.draining
                            and hid not in self.quarantined):
                        light_list.append(hid)
            idle = tuple(sorted(idle_list,
                                key=lambda h: (h.pod, h.index)))
            light = tuple(sorted(light_list,
                                 key=lambda h: (h.pod, h.index)))
        obs = elastic.observe(
            now, map_backlog=self.map_backlog,
            red_backlog=self.red_ready_backlog, busy_hosts=busy,
            idle_hosts=idle, light_hosts=light)
        tel = self.telemetry
        if tel is not None:
            # the scoreboard's fleet gauges are this observation's own
            # integers, so scoreboard-fed scaling decisions are
            # bit-identical to observation-fed ones
            tel.note_fleet(obs)
        return obs

    # ----------------------------------------------------- event handlers --
    def _on_heartbeat(self, now: float, _payload):
        # self-stepping (post_step=False): dispatch must run before the
        # heartbeat is re-armed so same-instant completions keep their
        # historical sequence numbers
        self.hb_scheduled = False
        for h in self._hooks_tick:
            h(now)
        self._dispatch_fn(now)
        if self.unfinished > 0:
            self.kernel.push(now + self.cfg.heartbeat, "hb", None)
            self.hb_scheduled = True

    def _on_submit(self, now: float, job: Job):
        self.job_submit[job.job_id] = now
        self.submitted.add(job.job_id)
        self.algo.submit(job)
        self.map_backlog += job.m
        if self.maps_left[job.job_id] == 0:  # map-less job: reduces ready
            self.red_ready_backlog += self.reds_unassigned[job.job_id]
            if self.notify_maps_done is not None:
                self.notify_maps_done(job.job_id)
        if not self.hb_scheduled:
            self.kernel.push(now + self.cfg.heartbeat, "hb", None)
            self.hb_scheduled = True
        for h in self._hooks_job_submit:
            h(job, now)

    def _on_map_done(self, now: float, t: MapTask):
        if self.chaos_hung:
            # hung-task injection: swallow the completion once
            # and re-fire it after the stall — no churn event, no freed
            # slot, nothing fail-stop detection could see
            stall = self.chaos_hung.pop(t.tid, None)
            if stall is not None and t.tid in self.running:
                self.kernel.push(now + stall, "map_done", t)
                return True
        log = self.running.pop(t.tid, None)
        if log is None:
            return True     # killed by churn: stale event, no dispatch
        pair = (t.job_id, t.index)
        if pair in self.done_pairs:
            # a speculative twin already finished this map task; the freed
            # slot waits for the next real event (returning True skips the
            # post-step, matching the old loop's ``continue``)
            self.map_free[log.host] += 1
            if (log.host not in self.draining
                    and log.host not in self.quarantined):
                self.free_map_hosts.add(log.host)
            self.algo.task_finished(t)
            return True
        self.done_pairs.add(pair)
        t.state = TaskState.DONE
        log.finish = now
        log.speculative = t.tid in self.spec_tids
        self.task_logs.append(log)
        self.map_durations.append(log.finish - log.start)
        job = self.job_by_id[t.job_id]
        canon = job.map_tasks[t.index]
        if canon is not t:   # re-execution/twin: sync canonical
            canon.state = TaskState.DONE
        self.map_out[job.job_id].append(
            (log.host, job.shard_bytes[t.index], t.index))
        outs = self.host_outputs.get(log.host)
        if outs is None:
            outs = self.host_outputs[log.host] = set()
        outs.add(t.job_id)
        left = self.maps_left[t.job_id] - 1
        self.maps_left[t.job_id] = left
        self.unfinished -= 1
        self.map_free[log.host] += 1
        if (log.host not in self.draining
                and log.host not in self.quarantined):
            self.free_map_hosts.add(log.host)
        self.algo.task_finished(t)
        for h in self._hooks_task_finish:
            h(log, now)
        if left == 0:
            # shuffle gate opens (again, after churn re-runs)
            self.red_ready_backlog += self.reds_unassigned[t.job_id]
            if self.notify_maps_done is not None:
                self.notify_maps_done(t.job_id)
            if (self.reds_left[t.job_id] == 0
                    and t.job_id not in self.job_finish):
                # churn only: every reduce finished before a lost
                # map output was re-run; the re-run completes the job
                self._finish_job(job, now)

    def _on_reduce_done(self, now: float, t: ReduceTask):
        if self.chaos_hung:
            stall = self.chaos_hung.pop(t.tid, None)
            if stall is not None and t.tid in self.running:
                self.kernel.push(now + stall, "reduce_done", t)
                return True
        log = self.running.pop(t.tid, None)
        if log is None:
            return True     # killed by churn: stale event, no dispatch
        t.state = TaskState.DONE
        log.finish = now
        self.task_logs.append(log)
        job = self.job_by_id[t.job_id]
        canon = job.reduce_tasks[t.index]
        if canon is not t:
            canon.state = TaskState.DONE
        self.reds_left[t.job_id] -= 1
        self.unfinished -= 1
        self.red_free[log.host] += 1
        if (log.host not in self.draining
                and log.host not in self.quarantined):
            self.free_red_hosts.add(log.host)
        self.algo.task_finished(t)
        for h in self._hooks_task_finish:
            h(log, now)
        if self.reds_left[t.job_id] == 0 and self.maps_left[t.job_id] == 0:
            self._finish_job(job, now)

    def _finish_job(self, job: Job, now: float):
        self.job_finish[job.job_id] = now
        fp = job.true_fp
        if self.cfg.fp_noise:
            fp *= float(1.0 + self.cfg.fp_noise
                        * self.rng.standard_normal())
        self.algo.record_completion(job, max(fp, 0.0))
        for h in self._hooks_job_finish:
            h(job, now)

    # ------------------------------------------------------------ finalize --
    def _finalize(self, end: float) -> SimResult:
        job_finish = self.job_finish
        wtt = (max(job_finish.values()) - min(self.job_submit.values())
               if job_finish else 0.0)
        res = SimResult(
            algorithm=getattr(self.algo, "name", type(self.algo).__name__),
            task_logs=self.task_logs, job_submit=self.job_submit,
            job_finish=job_finish, int_bytes=self.int_bytes,
            pod_bytes=self.pod_bytes, wtt=wtt, jobs=self.jobs,
            work_lost_mb=self.work_lost_mb, n_reexec=self.n_reexec,
            n_host_adds=self.n_host_adds, n_host_losses=self.n_host_losses)
        if self.elastic is not None:
            summary = self.elastic.finalize(end)
            res.elastic = summary
            res.vps_hours = summary.vps_hours
            res.cost_dollars = summary.cost
            if summary.durability is not None:
                ds = summary.durability
                res.n_rerep = ds.n_rerep
                res.rerep_mb = ds.rerep_mb
                res.ckpt_mb_written = ds.ckpt_mb_written
                res.ckpt_saved_mb = ds.ckpt_saved_mb
                res.storage_dollars = ds.storage_dollars
        if self.fabric is not None:
            fs = self.fabric.finalize(end)
            res.fabric = fs
            res.fabric_mb = fs.mb_total
            res.fabric_stall_s = fs.stall_s
            res.wan_util = fs.link_util.get("wan", 0.0)
        if self.migration is not None:
            ms = self.migration.finalize()
            res.migration = ms
            res.n_migrated = ms.n_migrated
            res.migrate_mb = ms.state_mb + ms.out_mb
            res.n_mig_aborted = ms.n_aborted
            if ms.storage_dollars:
                # state parked in the object store while in flight; when
                # the durability manager billed it already this is zero
                res.cost_dollars += ms.storage_dollars
                res.storage_dollars += ms.storage_dollars
        if self.telemetry is not None:
            res.telemetry = self.telemetry.finalize(end)
        if self.chaos is not None:
            cs = self.chaos.finalize()
            res.chaos = cs
            res.n_chaos_events = cs.n_injected
            res.n_hung = cs.n_hung
        if self.chaos_response is not None:
            rs = self.chaos_response.finalize()
            res.response = rs
            res.n_timeouts = rs.n_timeouts
            res.n_quarantined = rs.n_quarantined
            res.n_surfaced = rs.n_surfaced
        return res
