"""Chaos injection subsystem.

``ChaosSubsystem`` replays a pre-sampled :mod:`~repro_torch.chaos.campaign`
through the event kernel's subsystem seam. It owns one event kind
(``chaos``) whose payloads are plain op tuples: the campaign's primary
injections plus the follow-up steps they schedule (gray ramp steps, outage kills and
rejoins, link restores). All randomness lives in the campaign's own
RNG, consumed at construction — at run time the subsystem is a pure
function of (campaign, trajectory), so the injection log is
deterministic per seed and sha-stable across runs and worker counts.

Injection mechanics, by fault class:

* **Pod outage** — the prodrome writes ``sim.dyn_slow`` for every live
  host of the target pod; the kill step calls ``Simulator.lose_host``
  per host (closing leases through ``ElasticEngine.applied_loss`` when
  an engine is attached, reason ``"chaos"``), vetoing the last live
  host like the elastic engine does; the rejoin step re-leases the same
  number of hosts into the pod. Chaos-rejoined hosts draw no personal
  churn events — the campaign, not the churn model, owns their fate.
* **Gray / disk episodes** — scheduled edits of ``sim.dyn_slow`` /
  ``sim.dyn_disk``, the dynamic overlays the simulator multiplies into
  ``_host_slow`` / checkpoint-write times. Episodes affect *newly
  started* work (durations are fixed at task start, like the static
  ``slow_hosts`` map).
* **Link faults** — ``fabric.set_derate(key, factor, now)``: the
  settle-then-recapacitate discipline of ``ElasticLinks`` capacity
  refreshes, factor 0.0 being a full partition (flows park on the
  starved class until restore). Logged-and-skipped in per-stream mode.
* **Hung tasks** — an entry in ``sim.chaos_hung``: the completion
  handler intercepts the task's done event once and re-pushes it
  ``hang_s`` later. No churn event fires, no slot frees — the failure
  is invisible to everything except progress-based detection.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

from repro_torch.chaos.campaign import ChaosConfig, ChaosEvent, build_campaign
from repro_torch.sim.engine import EventKernel, Subsystem


@dataclasses.dataclass
class ChaosSummary:
    """Injection-side accounting (merged into ``SimResult.chaos``)."""

    n_injected: int = 0        # primary campaign events applied
    n_outages: int = 0
    n_gray: int = 0
    n_disk: int = 0
    n_link: int = 0
    n_partition: int = 0
    n_hung: int = 0
    n_killed_hosts: int = 0    # hosts destroyed by outage kills
    n_skipped: int = 0         # no eligible target / no fabric / veto
    #: full injection log: (time, action, details...) with job ids
    #: remapped to submission order and hosts as (pod, index) pairs
    log: List[Tuple] = dataclasses.field(default_factory=list)

    def signature(self) -> str:
        """sha256 of the injection log — the per-seed determinism
        anchor (compared across runs and worker counts in CI)."""
        return hashlib.sha256(repr(self.log).encode()).hexdigest()


class ChaosSubsystem(Subsystem):
    """Replays one deterministic fault campaign into a simulation."""

    def __init__(self, cfg: ChaosConfig,
                 campaign: Optional[List[ChaosEvent]] = None):
        self.cfg = cfg
        #: tests may hand in an explicit schedule (e.g. to collide an
        #: injection with a churn event at the exact same instant)
        self.campaign = (build_campaign(cfg) if campaign is None
                         else list(campaign))
        self.summary = ChaosSummary()

    # -- lifecycle ----------------------------------------------------------
    def attach(self, sim, kernel: EventKernel) -> None:
        super().attach(sim, kernel)
        kernel.register("chaos", self._on_chaos)
        sim.chaos = self
        self._jix: Dict[int, int] = {j.job_id: i
                                     for i, j in enumerate(sim.jobs)}

    def start(self, now: float) -> None:
        for ev in self.campaign:
            self.kernel.push(ev.time, "chaos", (ev.op, ev.rank, ev.draw))

    # -- helpers ------------------------------------------------------------
    def _hkey(self, hid) -> Tuple[int, int]:
        return (hid.pod, hid.index)

    def _tkey(self, tid) -> Tuple:
        return (tid[0], self._jix[tid[1]], *tid[2:])

    def _log(self, now: float, action: str, *details) -> None:
        self.summary.log.append((round(now, 6), action, *details))
        tel = getattr(self.sim, "telemetry", None)
        if tel is not None:
            tel.note_chaos(now, action)

    # -- event handler ------------------------------------------------------
    def _on_chaos(self, now: float, payload: Tuple) -> None:
        op = payload[0]
        getattr(self, "_op_" + op)(now, *payload[1:])

    # -- correlated pod outages ---------------------------------------------
    def _op_outage(self, now: float, rank: int, draw: int) -> None:
        sim = self.sim
        pods = sorted({h.pod for h in sim.all_hosts})
        if not pods:
            self.summary.n_skipped += 1
            self._log(now, "outage_skip", draw)
            return
        pod = pods[rank % len(pods)]
        victims = sorted((h for h in sim.all_hosts if h.pod == pod),
                         key=lambda h: (h.pod, h.index))
        for hid in victims:
            sim.dyn_slow[hid] = self.cfg.outage_gray_factor
        self.summary.n_injected += 1
        self.summary.n_outages += 1
        self._log(now, "outage_begin", draw, pod, len(victims))
        nxt = "outage_kill" if self.cfg.outage_kill else "outage_clear"
        self.kernel.push(now + self.cfg.outage_gray_s, "chaos", (nxt, pod))

    def _op_outage_clear(self, now: float, pod: int) -> None:
        sim = self.sim
        for hid in sorted((h for h in sim.all_hosts if h.pod == pod),
                          key=lambda h: (h.pod, h.index)):
            sim.dyn_slow.pop(hid, None)
        self._log(now, "outage_clear", pod)

    def _op_outage_kill(self, now: float, pod: int) -> None:
        sim = self.sim
        engine = sim.elastic
        book = engine.book if engine is not None else None
        kinds: List[str] = []
        for hid in sorted((h for h in sim.all_hosts if h.pod == pod),
                          key=lambda h: (h.pod, h.index)):
            if len(sim.all_hosts) <= 1:
                # same last-host veto as the elastic engine: the tenant
                # always keeps one VPS or queued work never drains
                self.summary.n_skipped += 1
                self._log(now, "outage_veto", self._hkey(hid))
                continue
            kind = book.kind_of(hid) if book is not None else "ondemand"
            sim.dyn_slow.pop(hid, None)
            sim.dyn_disk.pop(hid, None)
            sim.lose_host(hid, now)
            if engine is not None:
                engine.applied_loss(hid, now, "chaos")
            kinds.append(kind)
            self.summary.n_killed_hosts += 1
            self._log(now, "outage_kill", self._hkey(hid))
        if kinds:
            self.kernel.push(now + self.cfg.outage_down_s, "chaos",
                             ("outage_rejoin", pod, tuple(kinds)))

    def _op_outage_rejoin(self, now: float, pod: int,
                          kinds: Tuple[str, ...]) -> None:
        sim = self.sim
        engine = sim.elastic
        for kind in kinds:
            hid = sim.add_host(pod, kind, now)
            if engine is not None:
                # open the lease; the personal churn draws are discarded
                # — the campaign owns chaos-rejoined hosts' fate
                engine.applied_add(hid, kind, now)
            self._log(now, "outage_rejoin", self._hkey(hid))

    # -- gray host episodes --------------------------------------------------
    def _op_gray(self, now: float, rank: int, draw: int) -> None:
        sim = self.sim
        hosts = sorted(sim.all_hosts, key=lambda h: (h.pod, h.index))
        if not hosts:
            self.summary.n_skipped += 1
            self._log(now, "gray_skip", draw)
            return
        hid = hosts[rank % len(hosts)]
        f = self.cfg.gray_factor
        sim.dyn_slow[hid] = f
        self.summary.n_injected += 1
        self.summary.n_gray += 1
        self._log(now, "gray_begin", draw, self._hkey(hid), f)
        half = self.cfg.gray_s * 0.5
        self.kernel.push(now + half, "chaos",
                         ("gray_step", hid, (1.0 + f) * 0.5))
        self.kernel.push(now + self.cfg.gray_s, "chaos",
                         ("gray_clear", hid))

    def _op_gray_step(self, now: float, hid, factor: float) -> None:
        sim = self.sim
        if hid in sim.dyn_slow:   # episode still live (not killed/cleared)
            sim.dyn_slow[hid] = factor
            self._log(now, "gray_step", self._hkey(hid), factor)

    def _op_gray_clear(self, now: float, hid) -> None:
        if self.sim.dyn_slow.pop(hid, None) is not None:
            self._log(now, "gray_clear", self._hkey(hid))

    # -- disk-slow episodes --------------------------------------------------
    def _op_disk(self, now: float, rank: int, draw: int) -> None:
        sim = self.sim
        hosts = sorted(sim.all_hosts, key=lambda h: (h.pod, h.index))
        if not hosts:
            self.summary.n_skipped += 1
            self._log(now, "disk_skip", draw)
            return
        hid = hosts[rank % len(hosts)]
        sim.dyn_disk[hid] = self.cfg.disk_factor
        self.summary.n_injected += 1
        self.summary.n_disk += 1
        self._log(now, "disk_begin", draw, self._hkey(hid),
                  self.cfg.disk_factor)
        self.kernel.push(now + self.cfg.disk_s, "chaos",
                         ("disk_clear", hid))

    def _op_disk_clear(self, now: float, hid) -> None:
        if self.sim.dyn_disk.pop(hid, None) is not None:
            self._log(now, "disk_clear", self._hkey(hid))

    # -- link faults ----------------------------------------------------------
    def _derate(self, now: float, rank: int, draw: int, factor: float,
                dur: float, tag: str) -> None:
        fab = self.sim.fabric
        if fab is None:
            self.summary.n_skipped += 1
            self._log(now, tag + "_skip", draw)
            return
        keys = sorted(fab._caps)
        key = keys[rank % len(keys)]
        fab.set_derate(key, factor, now)
        self.summary.n_injected += 1
        if tag == "link":
            self.summary.n_link += 1
        else:
            self.summary.n_partition += 1
        self._log(now, tag + "_begin", draw, key, factor)
        self.kernel.push(now + dur, "chaos", ("link_restore", key, tag))

    def _op_link(self, now: float, rank: int, draw: int) -> None:
        self._derate(now, rank, draw, self.cfg.link_factor,
                     self.cfg.link_s, "link")

    def _op_partition(self, now: float, rank: int, draw: int) -> None:
        self._derate(now, rank, draw, 0.0, self.cfg.partition_s,
                     "partition")

    def _op_link_restore(self, now: float, key, tag: str) -> None:
        fab = self.sim.fabric
        if fab is not None:
            fab.set_derate(key, 1.0, now)
            self._log(now, tag + "_end", key)

    # -- hung tasks ------------------------------------------------------------
    def _op_hang(self, now: float, rank: int, draw: int) -> None:
        sim = self.sim
        tids = sorted(t for t in sim.running if t not in sim.chaos_hung)
        if not tids:
            self.summary.n_skipped += 1
            self._log(now, "hang_skip", draw)
            return
        tid = tids[rank % len(tids)]
        sim.chaos_hung[tid] = self.cfg.hang_s
        self.summary.n_injected += 1
        self.summary.n_hung += 1
        self._log(now, "hang", draw, self._tkey(tid), self.cfg.hang_s)

    # -- finalize ---------------------------------------------------------------
    def finalize(self) -> ChaosSummary:
        return self.summary
