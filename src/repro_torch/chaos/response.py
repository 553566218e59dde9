"""Adaptive fault response: timeout detection, backoff re-dispatch,
health-scored quarantine (scheduler side).

The injections of :mod:`repro_torch.chaos.inject` are chosen to be invisible
to fail-stop machinery: a gray host still heartbeats, a hung task never
frees its slot, a prodrome pod happily accepts work it will destroy.
This subsystem is the detection/response loop that survives them:

* **Progress-based task timeouts.** At task start the attempt gets a
  deadline: ``grace x nominal + slack`` seconds, where *nominal* is the
  analytic duration the timing model predicts from the bytes already
  charged to the attempt (read + compute, scaled by the host's *static*
  slowdown — dynamic chaos overlays are exactly what detection must not
  excuse). Every heartbeat tick scans the running set; an attempt past
  its deadline is killed (slot freed, flow cancelled) and re-dispatched
  after a capped exponential backoff. After ``max_attempts`` timeouts
  the (task, index) pair is *surfaced* — logged as a job-level failure,
  requeued immediately one last time, and no longer monitored.
* **Health-scored quarantine with probation.** Each timeout charges its
  host ``timeout_penalty`` health points; each clean finish refunds
  ``finish_credit``. At ``quarantine_at`` the host is quarantined: it
  leaves the free/dest/refuge offer sets exactly like migration's draining
  state (running tasks finish or time out; nothing new is offered),
  vetoed only when it would leave a single offerable host. After
  ``probation_s`` the host is re-admitted at ``probation_health`` — one
  more timeout sends it straight back.
* **Graceful degradation in JoSS.** When quarantine empties a pod's
  offerable set the algorithm's ``pod_degraded`` hook (when present)
  evacuates the pod's queues, re-bucketing queued work to healthy pods
  instead of letting it wait out the probation window.

Everything is deterministic: no RNG, decisions are pure functions of
the trajectory, and the full decision log is committed to a sha256
signature compared across runs and worker counts in CI. A response
subsystem that never fires (no chaos, generous thresholds) pushes no
events and is bit-identical to a run without it.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Set, Tuple

from repro_torch.core.job import MapTask
from repro_torch.sim.engine import EventKernel, Subsystem


@dataclasses.dataclass(frozen=True)
class ResponseConfig:
    """Detection/response knobs (see module docstring)."""

    enabled: bool = True
    # -- progress-based timeout detection -----------------------------------
    grace: float = 3.0           # kill past grace * nominal + slack
    slack_s: float = 10.0
    min_runtime_s: float = 5.0   # never kill younger than this
    max_attempts: int = 3        # timeouts per (task, index) before surfacing
    backoff_base_s: float = 5.0
    backoff_cap_s: float = 120.0
    # -- health score / quarantine ------------------------------------------
    timeout_penalty: float = 1.0
    finish_credit: float = 0.25
    quarantine_at: float = 1.0   # health threshold
    probation_s: float = 300.0   # quarantine length before re-admission
    probation_health: float = 0.5


@dataclasses.dataclass
class ResponseSummary:
    """Response-side accounting (merged into ``SimResult.response``)."""

    n_timeouts: int = 0
    n_requeued: int = 0        # backoff re-dispatches actually queued
    n_moot: int = 0            # re-dispatches obviated by a finished twin
    n_surfaced: int = 0        # pairs escalated to job-level failures
    n_quarantined: int = 0
    n_readmitted: int = 0
    n_vetoed: int = 0          # quarantines refused (last offerable host)
    n_pods_degraded: int = 0   # pod_degraded evacuations triggered
    #: full decision log: (time, action, details...) with job ids
    #: remapped to submission order and hosts as (pod, index) pairs
    log: List[Tuple] = dataclasses.field(default_factory=list)

    def signature(self) -> str:
        """sha256 of the decision log (per-seed determinism anchor)."""
        return hashlib.sha256(repr(self.log).encode()).hexdigest()


class ResponseSubsystem(Subsystem):
    """Timeout/quarantine loop on the kernel seam. Owns the ``respond``
    event kind (delayed re-dispatches, probation re-admissions)."""

    def __init__(self, cfg: ResponseConfig):
        self.cfg = cfg
        self.summary = ResponseSummary()
        self.deadlines: Dict[object, float] = {}   # tid -> kill instant
        self.attempts: Dict[Tuple, int] = {}       # (kind, jid, idx) -> n
        self.surfaced: Set[Tuple] = set()
        self.health: Dict[object, float] = {}      # hid -> score
        self.degraded: Set[int] = set()            # fully-quarantined pods

    # -- lifecycle ----------------------------------------------------------
    def attach(self, sim, kernel: EventKernel) -> None:
        super().attach(sim, kernel)
        kernel.register("respond", self._on_respond)
        sim.chaos_response = self
        self._jix: Dict[int, int] = {j.job_id: i
                                     for i, j in enumerate(sim.jobs)}

    # -- helpers ------------------------------------------------------------
    def _hkey(self, hid) -> Tuple[int, int]:
        return (hid.pod, hid.index)

    def _tkey(self, tid) -> Tuple:
        return (tid[0], self._jix[tid[1]], *tid[2:])

    def _pair(self, tid) -> Tuple:
        return (tid[0], tid[1], tid[2])   # attempt-independent identity

    def _log(self, now: float, action: str, *details) -> None:
        self.summary.log.append((round(now, 6), action, *details))
        tel = getattr(self.sim, "telemetry", None)
        if tel is not None:
            tel.note_chaos(now, action)

    def _nominal(self, log) -> float:
        """The timing model's analytic duration for this attempt, from
        the bytes charged at start (both transfer modes charge them
        there). The *static* slow factor is included — a declared
        straggler is expected to be slow; chaos overlays are not."""
        sim = self.sim
        cfg = sim.cfg
        read_t = (log.bytes_local / cfg.disk_bw
                  + log.bytes_pod / cfg.pod_bw
                  + log.bytes_offpod / cfg.dcn_bw)
        total = log.bytes_local + log.bytes_pod + log.bytes_offpod
        rate = (cfg.map_rate if isinstance(log.task, MapTask)
                else cfg.reduce_rate)
        comp_t = total / rate * log.job.cost_scale
        slow = (cfg.slow_hosts.get(log.host, 1.0)
                if cfg.slow_hosts else 1.0)
        return (cfg.task_overhead + read_t + comp_t) * slow

    # -- hooks ---------------------------------------------------------------
    def on_task_start(self, log, now: float) -> None:
        tid = log.task.tid
        if self._pair(tid) in self.surfaced:
            return   # escalated: the last attempt runs unmonitored
        horizon = max(self.cfg.min_runtime_s,
                      self.cfg.grace * self._nominal(log)
                      + self.cfg.slack_s)
        self.deadlines[tid] = now + horizon

    def on_task_finish(self, log, now: float) -> None:
        self.deadlines.pop(log.task.tid, None)
        h = self.health.get(log.host)
        if h:
            self.health[log.host] = max(0.0, h - self.cfg.finish_credit)

    def on_host_lost(self, host, now: float) -> None:
        self.health.pop(host.hid, None)

    def on_tick(self, now: float) -> None:
        if self.degraded:
            # keep a fully-quarantined pod's queues evacuated: work that
            # bucketed there since the last tick (new submissions, churn
            # requeues) would otherwise wait out the whole probation
            # window — or forever, when probation outlives the workload
            sim = self.sim
            degrade = getattr(sim.algo, "pod_degraded", None)
            for pod in sorted(self.degraded):
                live = [h for h in sim.all_hosts if h.pod == pod]
                if live and any(h not in sim.quarantined for h in live):
                    # an offerable host appeared (rejoin/scale-out):
                    # the pod can serve its own queues again
                    self.degraded.discard(pod)
                    self._log(now, "pod_restored", pod)
                elif degrade is not None:
                    degrade(pod)
        if not self.deadlines:
            return
        sim = self.sim
        for tid, deadline in sorted(self.deadlines.items()):
            log = sim.running.get(tid)
            if log is None:
                del self.deadlines[tid]   # finished/killed since armed
                continue
            if now >= deadline:
                del self.deadlines[tid]
                self._timeout(tid, log, now)

    # -- timeout path ---------------------------------------------------------
    def _timeout(self, tid, log, now: float) -> None:
        sim = self.sim
        hid = log.host
        pair = self._pair(tid)
        n = self.attempts[pair] = self.attempts.get(pair, 0) + 1
        self.summary.n_timeouts += 1
        self._log(now, "timeout", self._tkey(tid), self._hkey(hid), n)
        sim.kill_task(tid, now)
        self._charge_host(hid, now)
        if n >= self.cfg.max_attempts:
            # escalate: log the job-level failure, requeue one final
            # unmonitored attempt so the job can still finish
            self.surfaced.add(pair)
            self.summary.n_surfaced += 1
            self._log(now, "surface", self._tkey(tid),
                      self._jix[log.job.job_id])
            if sim.requeue_failed_attempt(log, now):
                self.summary.n_requeued += 1
            else:
                self.summary.n_moot += 1
            return
        delay = min(self.cfg.backoff_cap_s,
                    self.cfg.backoff_base_s * (2.0 ** (n - 1)))
        self.kernel.push(now + delay, "respond", ("requeue", log))

    def _charge_host(self, hid, now: float) -> None:
        sim = self.sim
        cfg = self.cfg
        h = self.health[hid] = self.health.get(hid, 0.0) \
            + cfg.timeout_penalty
        if (h < cfg.quarantine_at or hid in sim.quarantined
                or not sim.cluster.has_host(hid)):
            return
        if len(sim.all_hosts) - len(sim.quarantined) <= 1:
            # never quarantine the last offerable host — same veto
            # discipline as the elastic engine's last-host rule
            self.summary.n_vetoed += 1
            self._log(now, "quarantine_veto", self._hkey(hid))
            return
        sim.quarantine_host(hid)
        self.summary.n_quarantined += 1
        self._log(now, "quarantine", self._hkey(hid), round(h, 6))
        self.kernel.push(now + cfg.probation_s, "respond",
                         ("probation", hid))
        pod_live = [h2 for h2 in sim.all_hosts if h2.pod == hid.pod]
        if pod_live and all(h2 in sim.quarantined for h2 in pod_live):
            degrade = getattr(sim.algo, "pod_degraded", None)
            if degrade is not None:
                degrade(hid.pod)
                self.degraded.add(hid.pod)
                self.summary.n_pods_degraded += 1
                self._log(now, "pod_degraded", hid.pod)

    # -- event handler ---------------------------------------------------------
    def _on_respond(self, now: float, payload: Tuple) -> None:
        op = payload[0]
        sim = self.sim
        if op == "requeue":
            log = payload[1]
            if sim.requeue_failed_attempt(log, now):
                self.summary.n_requeued += 1
                self._log(now, "requeue", self._tkey(log.task.tid))
            else:
                self.summary.n_moot += 1
                self._log(now, "requeue_moot", self._tkey(log.task.tid))
            return
        # probation re-admission
        hid = payload[1]
        if hid in sim.quarantined and sim.cluster.has_host(hid):
            sim.readmit_host(hid)
            self.health[hid] = self.cfg.probation_health
            self.summary.n_readmitted += 1
            self._log(now, "readmit", self._hkey(hid))
            if hid.pod in self.degraded:
                # the pod has an offerable host again: stop evacuating
                self.degraded.discard(hid.pod)
                self._log(now, "pod_restored", hid.pod)

    # -- finalize ---------------------------------------------------------------
    def finalize(self) -> ResponseSummary:
        return self.summary
