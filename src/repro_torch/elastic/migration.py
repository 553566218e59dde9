"""Graceful preemption: notice-window draining + live task migration.

Without this subsystem host departures are destructive: a preempted VPS
kills its running tasks cold and requeues them from byte zero. Real providers announce spot
reclaims 30-120 s ahead, and lease expiries are known in advance; this
subsystem exploits that window the way virtualization-based MapReduce
schedulers do — move the work, not lose it:

  notice -> drain -> checkpoint partial state -> ship -> restore

* **Drain** — on a ``notice`` churn event (or a proactive compaction
  drain from the autoscaler) the host leaves the free-offer sets, so
  dispatch stops feeding it while its tasks keep running. Draining also
  *evacuates* finished map outputs that pending reduces still need —
  decommissioning-style — so the disk's death destroys no shuffle
  inputs; outputs a task finishes during the window ship as they land.
* **Checkpoint + ship** — each running task's partial state (a fixed
  base image plus the fraction-complete share of its output/merge
  state) is written through the pod object store — billed at the
  durability prices — and shipped to the destination pod as a
  ``migrate`` fabric flow (contending with task traffic) or, in
  per-stream mode, at the migration bandwidth capped by the link class.
* **Restore** — on landing, the destination (chosen by the existing
  locality indexes: replica host > replica pod > anywhere for maps,
  source pod first for reduces) starts a fresh attempt that resumes
  from the checkpointed fraction (``resume_frac`` in the simulator's
  task starters) instead of re-executing.

Migration is *pre-copy*: the source attempt keeps running while state
ships, so every race degrades safely to today's behavior —

  * notice-then-finish: the source attempt completes first; the landing
    is stale (tid no longer running) and is abandoned.
  * notice-then-kill-anyway: the window was too short; ``lose_host``
    kills and requeues bit-identically to the no-migration path, and
    the in-flight transfer is dropped (``src_lost`` abort).
  * second failure: losing the *destination* cancels the transfer and
    leaves the source attempt untouched.

No RNG is ever consumed, so migration decisions are a deterministic
function of (workload seed, churn seed) — asserted by the
``migration-claims`` CI gate — and a disabled config (or zero notice
windows) leaves every golden trajectory untouched.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

from repro_torch.core.job import MapTask, TaskState
from repro_torch.core.topology import HostId, Locality
from repro_torch.elastic.leases import SPOT
from repro_torch.sim.engine import EventKernel, Subsystem


@dataclasses.dataclass(frozen=True)
class MigrationConfig:
    """Knobs for the migration subsystem (attach via
    ``ElasticEngine(migration=...)``)."""

    enabled: bool = True
    #: fixed per-task state overhead (runtime image, counters), MB
    state_base_mb: float = 4.0
    #: per-transfer migration bandwidth cap, MB/s (also capped by the
    #: pod/WAN link class in per-stream mode)
    mig_bw: float = 90.0
    #: never checkpoint beyond this completed fraction — a nearly-done
    #: task is cheaper to finish (or re-run) than to move
    max_frac: float = 0.95
    #: honor proactive compaction drains from the autoscaler
    compaction: bool = True
    #: evacuate finished map outputs off a draining disk (relocating
    #: their ``map_out`` entries on landing) — without this, draining
    #: only saves *running* work and the dead disk still destroys
    #: shuffle inputs that pending reduces need
    evac_outputs: bool = True
    #: migrate off-pod maps toward freshly re-replicated copies
    locality_repair: bool = True
    #: locality repair only pays off early in a task's life
    repair_max_frac: float = 0.5


@dataclasses.dataclass
class MigrationSummary:
    """Migration accounting for one run (merged into ``SimResult``)."""

    n_notices: int = 0      # drain requests honored (notices + compactions)
    n_started: int = 0      # state transfers begun
    n_migrated: int = 0     # tasks actually restored elsewhere
    n_aborted: int = 0      # transfers dropped (races, lost hosts)
    state_mb: float = 0.0   # total migration state shipped (MB)
    n_out_moved: int = 0    # finished map outputs relocated off drains
    out_mb: float = 0.0     # output bytes evacuated (MB)
    storage_dollars: float = 0.0   # store bill when no durability manager
    by_reason: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: flat (time, action, ...) trace of every decision — the per-seed
    #: determinism claim hashes this
    decision_log: List[Tuple] = dataclasses.field(default_factory=list)

    def signature(self) -> str:
        return hashlib.sha256(
            repr(self.decision_log).encode()).hexdigest()


@dataclasses.dataclass
class _Pending:
    """One in-flight state transfer (source attempt still running)."""

    tid: object
    src: HostId
    dst: HostId
    frac: float
    mb: float
    fid: int          # fabric flow id; -1 in per-stream mode
    reason: str       # "preempt" | "expire" | "compact" | "locality"
    is_map: bool


@dataclasses.dataclass
class _PendingOut:
    """One in-flight output evacuation: finished map outputs of one job
    shipping from a draining disk to a surviving one."""

    serial: int
    jid: int
    src: HostId
    dst: HostId
    midxs: frozenset  # map indexes whose entries relocate on landing
    mb: float
    fid: int          # fabric flow id; -1 in per-stream mode


class MigrationSubsystem(Subsystem):
    """Simulator plug-in: listens on ``on_host_notice`` /
    ``on_host_survived`` / ``on_host_lost``, owns no event kinds (state
    transfers ride fabric flows or ``call_at`` continuations)."""

    def __init__(self, cfg: MigrationConfig):
        self.cfg = cfg
        self.summary = MigrationSummary()
        self.pending: Dict[object, _Pending] = {}
        self.pending_out: Dict[int, _PendingOut] = {}
        self._out_keys: set = set()   # (jid, midx) already in flight
        self._out_serial = 0
        self._drains: Dict[HostId, Optional[float]] = {}  # hid -> deadline
        self._own_mb = 0.0   # state MB billed here when no durability mgr
        self._jidx: Optional[Dict[int, int]] = None

    def _jix(self, jid: int) -> int:
        """Job ids are globally counted across runs in one process; the
        decision log remaps them to submission order so two identical
        runs produce identical signatures (the determinism claim)."""
        m = self._jidx
        if m is None:
            self._jidx = m = {j.job_id: i
                              for i, j in enumerate(self.sim.jobs)}
        return m.get(jid, jid)

    def _tkey(self, tid) -> tuple:
        return (tid[0], self._jix(tid[1]), *tid[2:])

    def attach(self, sim, kernel: EventKernel) -> None:
        super().attach(sim, kernel)
        self.prices = sim.elastic.book.prices

    # -- hooks ---------------------------------------------------------------
    def on_host_notice(self, hid, deadline, reason: str,
                       now: float) -> None:
        sim = self.sim
        if not sim.cluster.has_host(hid):
            return
        if reason == "compact" and not self.cfg.compaction:
            return
        self.summary.n_notices += 1
        sim.drain_host(hid)
        self._drains[hid] = deadline
        moved = False
        for tid, log in list(sim.running.items()):
            if log.host != hid or tid in self.pending:
                continue
            if (deadline is not None
                    and self._projected_finish(log) <= deadline):
                continue    # finishes inside the window: let it run out
            if self._begin(tid, log, now, reason):
                moved = True
        if self._evacuate_outputs(hid, now):
            moved = True
        if (reason == "compact" and not moved
                and not any(p.src == hid for p in self.pending.values())
                and not any(p.src == hid
                            for p in self.pending_out.values())):
            # nothing to move (or nowhere to move it): keep the host in
            # service rather than starving it behind a drain forever
            sim.undrain_host(hid)
            self._drains.pop(hid, None)

    def on_host_survived(self, hid, now: float) -> None:
        sim = self.sim
        self._drains.pop(hid, None)
        if hid not in sim.draining:
            return
        sim.undrain_host(hid)
        for tid, p in list(self.pending.items()):
            if p.src == hid:
                del self.pending[tid]
                if p.fid >= 0:
                    sim.fabric.cancel(p.fid, now)
                self._free_slot(p.dst, p.is_map)
                self._abort(p, now, "survived")
        self._drop_outs(hid, now, "survived", dst_too=False)

    def on_host_lost(self, host, now: float) -> None:
        hid = host.hid
        self._drains.pop(hid, None)
        for tid, p in list(self.pending.items()):
            if p.src == hid:
                # the kill landed before the state finished shipping:
                # ``lose_host`` already killed+requeued bit-identically
                # to the no-migration path — just drop the transfer
                del self.pending[tid]
                if p.fid >= 0:
                    self.sim.fabric.cancel(p.fid, now)
                self._free_slot(p.dst, p.is_map)
                self._abort(p, now, "src_lost")
            elif p.dst == hid:
                # second failure cancels the in-flight flow; the source
                # attempt is untouched and keeps running
                del self.pending[tid]
                if p.fid >= 0:
                    self.sim.fabric.cancel(p.fid, now)
                self._abort(p, now, "dst_lost")
        self._drop_outs(hid, now, "host_lost", dst_too=True)

    def on_task_finish(self, log, now: float) -> None:
        """A map that ran out its notice window just parked fresh output
        on the doomed disk — ship that too, or the kill still destroys
        it (the loss channel draining alone cannot close)."""
        if isinstance(log.task, MapTask) and log.host in self._drains:
            self._evacuate_outputs(log.host, now)

    # -- locality repair (called by DurabilitySubsystem on rerep) ------------
    def replica_landed(self, shard_id, tgt: HostId, now: float) -> None:
        """Re-replication restored a copy of ``shard_id``: move young
        off-pod maps of that shard toward the new replica's locality."""
        if not self.cfg.locality_repair:
            return
        sim = self.sim
        for tid, log in list(sim.running.items()):
            t = log.task
            if (not isinstance(t, MapTask) or t.shard_id != shard_id
                    or tid in self.pending
                    or log.locality is not Locality.OFF_POD
                    or log.host in sim.draining
                    or log.host in sim.quarantined):
                continue
            if self._progress(log, now) > self.cfg.repair_max_frac:
                continue
            self._begin(tid, log, now, "locality", require_local=True)

    # -- output evacuation ---------------------------------------------------
    def _evacuate_outputs(self, hid, now: float) -> bool:
        """Ship finished map outputs still needed by pending reduces off
        the draining disk ``hid``, one transfer per job. On landing the
        ``map_out`` entries relocate to the destination, so the kill (or
        compaction scale-in) finds nothing to destroy: no ``work_lost``,
        no re-runs, no shuffle-gate re-close. Checkpointed jobs
        are skipped — the store already holds their outputs."""
        if not self.cfg.evac_outputs:
            return False
        sim = self.sim
        started = False
        for jid in sorted(sim.host_outputs.get(hid, ())):
            if sim.reds_left[jid] == 0:
                continue    # every reduce already consumed its shuffle
            job = sim.job_by_id[jid]
            if sim.ckpt_on and sim.dur.checkpoints_job(job):
                continue
            entries = [e for e in sim.map_out[jid]
                       if e[0] == hid and (jid, e[2]) not in self._out_keys]
            if not entries:
                continue
            dst = self._pick_out_dest(hid)
            if dst is None:
                continue    # nowhere safe to put them: accept the loss
            mb = sum(e[1] for e in entries) * job.true_fp
            midxs = frozenset(e[2] for e in entries)
            self._out_keys.update((jid, m) for m in midxs)
            self._out_serial += 1
            serial = self._out_serial
            fid = -1

            def land(tn, serial=serial):
                self._land_out(serial, tn)

            if sim.fabric is not None:
                fid = sim.fabric.start_flow(now, mb, hid.pod, dst.pod,
                                            self.cfg.mig_bw, "migrate",
                                            land)
            else:
                cap = (sim.cfg.pod_bw if hid.pod == dst.pod
                       else sim.cfg.dcn_bw)
                self.kernel.call_at(now + mb / min(cap, self.cfg.mig_bw),
                                    land)
            self.pending_out[serial] = _PendingOut(
                serial, jid, hid, dst, midxs, mb, fid)
            s = self.summary
            s.out_mb += mb
            s.decision_log.append((round(now, 6), "out_start", self._jix(jid),
                                   (hid.pod, hid.index),
                                   (dst.pod, dst.index), len(midxs),
                                   round(mb, 3)))
            started = True
        return started

    def _pick_out_dest(self, src) -> Optional[HostId]:
        """Outputs need a disk, not a slot: any surviving non-draining
        host qualifies — same pod preferred (keeps the relocated shuffle
        reads pod-local for the reduces that follow), and on-demand
        leases over spot within a pod, so a refuge is not itself one
        preemption away from re-shipping the same bytes."""
        sim = self.sim
        cands = [h for h in sim.all_hosts
                 if h != src and h not in sim.draining
                 and h not in sim.quarantined]
        if not cands:
            return None
        book = sim.elastic.book
        return min(cands, key=lambda h: (h.pod != src.pod,
                                         book.kind_of(h) == SPOT,
                                         h.pod, h.index))

    def _land_out(self, serial: int, now: float) -> None:
        p = self.pending_out.pop(serial, None)
        if p is None:
            return          # already cancelled (host lost / survived)
        self._out_keys.difference_update((p.jid, m) for m in p.midxs)
        sim = self.sim
        if (p.src in sim.departed or not sim.cluster.has_host(p.dst)
                or p.dst in sim.draining or p.dst in sim.quarantined
                or sim.reds_left[p.jid] == 0):
            self._abort_out(p, now, "stale")
            return
        moved = 0
        entries = sim.map_out[p.jid]
        for i, e in enumerate(entries):
            if e[0] == p.src and e[2] in p.midxs:
                entries[i] = (p.dst, e[1], e[2])
                moved += 1
        if not moved:       # pragma: no cover - entries are stable while
            return          # src is alive; defensive only
        if not any(e[0] == p.src for e in entries):
            outs = sim.host_outputs.get(p.src)
            if outs is not None:
                outs.discard(p.jid)
        sim.host_outputs.setdefault(p.dst, set()).add(p.jid)
        s = self.summary
        s.n_out_moved += moved
        s.decision_log.append((round(now, 6), "out_land", self._jix(p.jid), moved))

    def _drop_outs(self, hid, now: float, why: str, dst_too: bool) -> None:
        for serial, p in list(self.pending_out.items()):
            if p.src == hid or (dst_too and p.dst == hid):
                del self.pending_out[serial]
                self._out_keys.difference_update(
                    (p.jid, m) for m in p.midxs)
                if p.fid >= 0:
                    self.sim.fabric.cancel(p.fid, now)
                self._abort_out(p, now, why)

    def _abort_out(self, p: _PendingOut, now: float, why: str) -> None:
        s = self.summary
        s.n_aborted += 1
        s.decision_log.append((round(now, 6), "out_abort", self._jix(p.jid), why))

    # -- mechanics -----------------------------------------------------------
    def _nominal_duration(self, log) -> float:
        """Per-stream-style duration estimate (used in fabric mode, where
        ``log.finish`` is unknown until completion; progress under
        contention is approximated by the uncontended formula)."""
        sim = self.sim
        cfg = sim.cfg
        job = log.job
        t = log.task
        slow = sim._host_slow(log.host)
        if isinstance(t, MapTask):
            size = job.shard_bytes[t.index]
            read_t = size / cfg.read_bw(log.locality or Locality.OFF_POD)
            comp_t = size / cfg.map_rate * job.cost_scale
            return (cfg.task_overhead + read_t + comp_t) * slow
        total_in = log.bytes_local + log.bytes_pod + log.bytes_offpod
        read_t = total_in / cfg.pod_bw
        comp_t = total_in / cfg.reduce_rate * job.cost_scale
        return (cfg.task_overhead + read_t + comp_t) * slow

    def _projected_finish(self, log) -> float:
        if log.finish > log.start:   # per-stream mode: exact
            return log.finish
        return log.start + self._nominal_duration(log)

    def _progress(self, log, now: float) -> float:
        dur = (log.finish - log.start) if log.finish > log.start \
            else self._nominal_duration(log)
        if dur <= 0.0:
            return 0.0
        return min(max((now - log.start) / dur, 0.0), self.cfg.max_frac)

    def _state_mb(self, log, frac: float) -> float:
        job = log.job
        t = log.task
        if isinstance(t, MapTask):
            produced = job.shard_bytes[t.index] * job.true_fp * frac
        else:   # partial sort/merge state grows with consumed shuffle
            produced = (log.bytes_local + log.bytes_pod
                        + log.bytes_offpod) * frac
        return self.cfg.state_base_mb + produced

    def _pick_dest(self, log, require_local: bool = False
                   ) -> Optional[HostId]:
        """Destination by the existing locality preferences: replica
        host > replica pod > anywhere for maps (free map slots only);
        source pod first for reduces (their shuffle partly shipped
        already). Draining hosts are never candidates (they left the
        free sets)."""
        sim = self.sim
        src = log.host
        if isinstance(log.task, MapTask):
            cands = [h for h in sim.free_map_hosts if h != src]
            if not cands:
                return None
            cl = sim.cluster
            sid = log.task.shard_id
            reps = (cl.replica_hosts(sid)
                    if sid in cl.shard_replicas else frozenset())
            rep_pods = {h.pod for h in reps}
            if require_local:
                cands = [h for h in cands
                         if h in reps or h.pod in rep_pods]
                if not cands:
                    return None
            return min(cands, key=lambda h: (
                0 if h in reps else (1 if h.pod in rep_pods else 2),
                h.pod, h.index))
        cands = [h for h in sim.free_red_hosts if h != src]
        if not cands:
            return None
        return min(cands, key=lambda h: (h.pod != src.pod,
                                         h.pod, h.index))

    def _free_slot(self, hid: HostId, is_map: bool) -> None:
        sim = self.sim
        free = sim.map_free if is_map else sim.red_free
        if hid not in free:
            return          # host departed meanwhile
        free[hid] += 1
        if hid not in sim.draining and hid not in sim.quarantined:
            (sim.free_map_hosts if is_map
             else sim.free_red_hosts).add(hid)

    def _begin(self, tid, log, now: float, reason: str,
               require_local: bool = False) -> bool:
        sim = self.sim
        is_map = isinstance(log.task, MapTask)
        dst = self._pick_dest(log, require_local=require_local)
        if dst is None:
            return False    # no capacity: fall back to kill+requeue
        frac = self._progress(log, now)
        mb = self._state_mb(log, frac)
        # reserve the destination slot so a dispatch pass cannot race the
        # landing for it (released and immediately re-taken at takeover)
        free = sim.map_free if is_map else sim.red_free
        free[dst] -= 1
        if free[dst] == 0:
            (sim.free_map_hosts if is_map
             else sim.free_red_hosts).discard(dst)
        # the state write goes through the pod object store: bill it as
        # checkpoint traffic when the run has a durability manager,
        # otherwise tally it here and price it at finalize
        if sim.dur is not None:
            sim.dur.note_ckpt_write(mb)
        else:
            self._own_mb += mb
        src = log.host
        fid = -1

        def land(tn):
            self._land(tid, tn)

        if sim.fabric is not None:
            fid = sim.fabric.start_flow(now, mb, src.pod, dst.pod,
                                        self.cfg.mig_bw, "migrate", land)
        else:
            cap = (sim.cfg.pod_bw if src.pod == dst.pod
                   else sim.cfg.dcn_bw)
            self.kernel.call_at(now + mb / min(cap, self.cfg.mig_bw),
                                land)
        self.pending[tid] = _Pending(tid, src, dst, frac, mb, fid,
                                     reason, is_map)
        s = self.summary
        s.n_started += 1
        s.state_mb += mb
        s.by_reason[reason] = s.by_reason.get(reason, 0) + 1
        s.decision_log.append((round(now, 6), "start", self._tkey(tid),
                               (src.pod, src.index),
                               (dst.pod, dst.index),
                               round(frac, 6), reason))
        tel = getattr(sim, "telemetry", None)
        if tel is not None:
            tel.note_migration(now, "start", tid=tid, mb=mb,
                               reason=reason)
        return True

    def _land(self, tid, now: float) -> None:
        p = self.pending.pop(tid, None)
        if p is None:
            return          # already cancelled (host lost / survived)
        sim = self.sim
        log = sim.running.get(tid)
        valid = (log is not None and sim.cluster.has_host(p.dst)
                 and p.dst not in sim.draining
                 and p.dst not in sim.quarantined)
        if valid and p.is_map:
            t = log.task
            # a speculative twin may have finished the pair meanwhile
            valid = (t.job_id, t.index) not in sim.done_pairs
        if valid and not p.is_map:
            # a lost map output re-closed the shuffle gate: the shipped
            # merge state references inputs that must be re-fetched
            valid = sim.maps_left[log.task.job_id] == 0
        if not valid:
            self._free_slot(p.dst, p.is_map)
            self._abort(p, now, "stale")
            return
        self._takeover(p, log, now)

    def _takeover(self, p: _Pending, log, now: float) -> None:
        """The state landed and the source attempt is still running:
        kill it (its done event goes stale via the ``running`` pop, its
        in-flight transfer flow is cancelled) and restore a fresh
        attempt on the destination, resuming at the shipped fraction."""
        sim = self.sim
        del sim.running[p.tid]
        fid = sim._task_flows.pop(p.tid, None)
        if fid is not None:
            sim.fabric.cancel(fid, now)
        t = log.task
        t.state = TaskState.FAILED
        sim.algo.task_finished(t)   # the source attempt ended
        self._free_slot(p.src, p.is_map)   # source slot back
        self._free_slot(p.dst, p.is_map)   # reservation back; the start
        #                                    below re-takes it
        if p.is_map:
            nt = sim._remake_map(t.job_id, t.index)
            sim._start_map(nt, p.dst, now, resume_frac=p.frac)
        else:
            nt = sim._remake_reduce(t.job_id, t.index)
            sim._start_reduce(nt, p.dst, now, resume_frac=p.frac)
        s = self.summary
        s.n_migrated += 1
        s.decision_log.append((round(now, 6), "restore", self._tkey(nt.tid),
                               (p.dst.pod, p.dst.index),
                               round(p.frac, 6)))
        tel = getattr(sim, "telemetry", None)
        if tel is not None:
            tel.note_migration(now, "restore", tid=nt.tid,
                               frac=round(p.frac, 6))

    def _abort(self, p: _Pending, now: float, why: str) -> None:
        s = self.summary
        s.n_aborted += 1
        s.decision_log.append((round(now, 6), "abort", self._tkey(p.tid), why))
        tel = getattr(self.sim, "telemetry", None)
        if tel is not None:
            tel.note_migration(now, "abort", tid=p.tid, why=why)

    # -- accounting ----------------------------------------------------------
    def finalize(self) -> MigrationSummary:
        if self._own_mb:
            self.summary.storage_dollars = (
                self._own_mb / 1024.0 * self.prices.storage_per_gb)
        return self.summary
