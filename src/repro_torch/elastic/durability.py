"""Data durability for elastic virtual clusters.

An elastic fleet is mutable, and it pays for that in durability: a departing
host takes its shard replicas and its finished map outputs with it, so
re-executed maps degrade to off-pod reads forever and jobs re-open their
shuffle gates. This module restores both halves of the paper's locality
assumption (§1, §4 — map inputs stay replicated, map outputs survive
until shuffle) the way production stacks do:

  * **Delayed HDFS-style re-replication.** When ``remove_host`` orphans
    replicas, every shard the dead disk held enters a re-replication
    queue. After a detection/trigger delay (``rerep_delay``, NameNode
    timeout analog) the copies drain *serially* through a bandwidth
    budget (``rerep_bandwidth``): copy i completes at
    ``max(loss + delay, pipeline_free) + size / bandwidth``. Each
    completion re-creates the replica on a surviving host — preferring
    the pod that lost it, then the host with the fewest replicas — and
    the caller patches the queue locality indexes so still-queued and
    re-executed maps regain node/pod locality instead of staying
    off-pod for the rest of the run.
  * **Off-host shuffle checkpointing.** Finished map outputs are
    persisted to the *pod object store* as part of the map task
    (synchronous write at ``ckpt_write_bw``, extending the map
    duration). A host departure then no longer destroys them: no map
    re-execution, no ``mark_job_unready`` gate re-close, zero
    ``work_lost_mb`` for checkpointed jobs. The price is the write time
    plus remote shuffle reads — a reduce fetching a departed mapper's
    output reads the pod store at ``ckpt_read_bw`` (WAN-capped across
    pods) instead of the mapper's local disk, and the store bills
    ``PriceSheet.storage_per_gb`` per GB written.

Everything here is deterministic — no RNG is consumed — so a durability
run is reproducible per (workload seed, churn seed) and a *disabled*
durability config is bit-identical to the durability-free elastic
simulator (the JAX package's ``benchmarks/bench_elastic.py`` asserts both;
the port is held to the same golden trajectories by
``tests/test_torch_elastic.py``).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.job import MapTask
from repro_torch.core.topology import Host, HostId, VirtualCluster
from repro_torch.sim.engine import EventKernel, Subsystem

from repro_torch.elastic.leases import PriceSheet


@dataclasses.dataclass(frozen=True)
class DurabilityConfig:
    """Knobs for the two durability channels. Both default off, so an
    attached-but-default config changes nothing (bit-identity)."""

    # -- delayed re-replication (HDFS under-replication repair) --------------
    rereplicate: bool = False
    rerep_delay: float = 30.0      # loss-detection delay before copying (s)
    rerep_bandwidth: float = 80.0  # MB/s budget of the one-copy-at-a-time
    #                                re-replication pipeline
    # -- off-host shuffle checkpointing (pod object store) -------------------
    checkpoint: bool = False
    ckpt_write_bw: float = 90.0    # MB/s map-output persist (extends map)
    ckpt_read_bw: float = 90.0     # MB/s shuffle read from the pod store
    ckpt_min_job_mb: float = 0.0   # only jobs with >= this much input
    #                                checkpoint (0 = every job)

    @property
    def enabled(self) -> bool:
        return self.rereplicate or self.checkpoint


@dataclasses.dataclass(frozen=True)
class RerepEvent:
    """One scheduled replica re-creation (fires in the sim event loop)."""

    time: float      # copy completion instant (delay + bandwidth queue)
    shard_id: object
    pod: int         # pod that lost the replica (preferred restore target)
    mb: float        # shard size (for traffic accounting)


@dataclasses.dataclass
class DurabilitySummary:
    """Durability-side accounting for one run (merged into ``SimResult``)."""

    n_rerep_scheduled: int = 0
    n_rerep: int = 0               # replicas actually re-created
    n_rerep_skipped: int = 0       # fired with no eligible target host
    rerep_mb: float = 0.0          # bytes copied by the repair pipeline
    ckpt_mb_written: float = 0.0   # map output persisted to pod stores
    ckpt_saved_mb: float = 0.0     # output MB a host loss would have
    #                                destroyed but the store preserved
    n_ckpt_saves: int = 0          # map outputs saved from a dead disk
    storage_dollars: float = 0.0   # object-store bill (filled at finalize)


class DurabilityManager:
    """Run-scoped durability state (one per ``ElasticEngine``).

    The simulator owns the event loop; the manager owns the policy: which
    shards to repair, when each copy completes under the bandwidth budget,
    where the new replica lands, and what checkpointing costs. All clocks
    advance on the engine's event times, never on an RNG.
    """

    def __init__(self, cfg: DurabilityConfig, cluster: VirtualCluster,
                 prices: Optional[PriceSheet] = None):
        self.cfg = cfg
        self.cluster = cluster
        self.prices = prices or PriceSheet()
        self.summary = DurabilitySummary()
        self._pipeline_free = 0.0   # repair pipeline busy-until clock
        self._ckpt_cache: Dict[int, bool] = {}   # job_id -> checkpointed?

    # -- re-replication ------------------------------------------------------
    def host_lost(self, dead: Host, now: float,
                  size_of: Callable[[object], Optional[float]]
                  ) -> List[RerepEvent]:
        """Schedule repair copies for every shard the dead disk held.

        Shards are visited in sorted-id order (deterministic per seed) and
        drain serially through the bandwidth budget. Shards whose size the
        caller cannot resolve (not part of the simulated workload, e.g.
        profiling-prelude placements) are skipped — no simulated task can
        ever read them, so repairing them would only burn budget.
        """
        if not self.cfg.rereplicate:
            return []
        events: List[RerepEvent] = []
        ready_at = now + self.cfg.rerep_delay
        for sid in sorted(dead.local_shards, key=str):
            size = size_of(sid)
            if size is None:
                continue
            start = max(ready_at, self._pipeline_free)
            done = start + size / self.cfg.rerep_bandwidth
            self._pipeline_free = done
            events.append(RerepEvent(done, sid, dead.hid.pod, float(size)))
            self.summary.n_rerep_scheduled += 1
        return events

    def apply(self, ev: RerepEvent) -> Optional[Tuple[HostId, bool]]:
        """A repair copy finished: pick the target and patch the cluster.

        Target choice is deterministic: a live host not already holding the
        shard, preferring the pod that lost the replica (restores pod
        locality), then the fewest-replica host, then (pod, index). Returns
        ``(target, pod_was_covered)`` — the flag tells queue re-indexing
        whether the shard already had pod-level coverage there — or None
        when every live host already holds the shard (nothing to repair).
        """
        cl = self.cluster
        holders = cl.replica_hosts(ev.shard_id)
        cands = [h for h in cl.hosts() if h.hid not in holders]
        if not cands:
            self.summary.n_rerep_skipped += 1
            return None
        target = min(cands, key=lambda h: (h.hid.pod != ev.pod,
                                           len(h.local_shards),
                                           h.hid.pod, h.hid.index))
        pod_covered = target.hid.pod in cl.replica_pods(ev.shard_id)
        cl.add_replica(ev.shard_id, target.hid)
        self.summary.n_rerep += 1
        self.summary.rerep_mb += ev.mb
        return target.hid, pod_covered

    # -- shuffle checkpointing -----------------------------------------------
    def checkpoints_job(self, job) -> bool:
        """Does ``job`` persist its map outputs to the pod object store?"""
        if not self.cfg.checkpoint:
            return False
        hit = self._ckpt_cache.get(job.job_id)
        if hit is None:
            hit = sum(job.shard_bytes) >= self.cfg.ckpt_min_job_mb
            self._ckpt_cache[job.job_id] = hit
        return hit

    def note_ckpt_write(self, mb: float) -> None:
        self.summary.ckpt_mb_written += mb

    def note_ckpt_save(self, mb: float, n_outputs: int) -> None:
        self.summary.ckpt_saved_mb += mb
        self.summary.n_ckpt_saves += n_outputs

    # -- accounting ----------------------------------------------------------
    def storage_cost(self) -> float:
        return self.summary.ckpt_mb_written / 1024.0 \
            * self.prices.storage_per_gb

    def finalize(self) -> DurabilitySummary:
        self.summary.storage_dollars = self.storage_cost()
        return self.summary


class DurabilitySubsystem(Subsystem):
    """Simulator plug-in: owns the ``rerep`` event kind, schedules
    repairs on the ``on_host_lost`` hook, and notes checkpoint writes on
    ``on_task_finish`` — the arms that used to be inlined into
    ``Simulator.run``.

    Repair traffic has two transports:

      * **per-stream mode** — the manager's serialized bandwidth-budget
        clock decides each copy's completion (bit-identical to the
        inlined arms).
      * **fabric mode** — each copy is a fabric *flow* (kind ``rerep``)
        at the repair bandwidth, still strictly serial and still delayed
        by the detection timeout, but now contending with task traffic
        on the pod links and the WAN. The flow targets the pod that lost
        the replica (where ``DurabilityManager.apply`` prefers to
        restore); its source is the first surviving replica's pod, or
        the external store (WAN ingress) when none survives.
    """

    def __init__(self, manager: DurabilityManager):
        self.mgr = manager

    def attach(self, sim, kernel: EventKernel) -> None:
        super().attach(sim, kernel)
        kernel.register("rerep", self._on_rerep)
        self.shard_size: Dict[object, float] = {}
        if self.mgr.cfg.rereplicate:
            for j in sim.jobs:
                for sid, b in zip(j.shard_ids, j.shard_bytes):
                    self.shard_size[sid] = float(b)
        # fabric-mode repair pipeline: FIFO of (shard, pod, mb, eligible_t)
        self._repairs = collections.deque()
        self._copying = False

    # -- hooks -----------------------------------------------------------------
    def on_host_lost(self, host: Host, now: float) -> None:
        if not self.mgr.cfg.rereplicate:
            return
        if self.sim.fabric is None:
            # completions computed by the manager's own pipeline clock
            for rev in self.mgr.host_lost(host, now, self.shard_size.get):
                self.kernel.push(rev.time, "rerep", rev)
            return
        eligible = now + self.mgr.cfg.rerep_delay
        for sid in sorted(host.local_shards, key=str):
            size = self.shard_size.get(sid)
            if size is None:
                continue   # not part of the simulated workload
            self._repairs.append((sid, host.hid.pod, float(size), eligible))
            self.mgr.summary.n_rerep_scheduled += 1
        self._pump(now)

    def on_task_finish(self, log, now: float) -> None:
        job = log.job
        if (self.mgr.cfg.checkpoint and isinstance(log.task, MapTask)
                and self.mgr.checkpoints_job(job)):
            # a finished map's synchronous store write (paid inside the
            # task duration) lands with its completion
            self.mgr.note_ckpt_write(
                job.shard_bytes[log.task.index] * job.true_fp)

    # -- event handlers ----------------------------------------------------------
    def _on_rerep(self, now: float, ev: RerepEvent) -> None:
        # a repair copy completed: patch the replica map and give
        # queued/re-executed maps their locality index entries back
        restored = self.mgr.apply(ev)
        tel = getattr(self.sim, "telemetry", None)
        if tel is not None:
            tel.note_rerep(now, ev)
        if restored is not None:
            tgt, pod_covered = restored
            hook = getattr(self.sim.algo, "replica_restored", None)
            if hook is not None:
                hook(ev.shard_id, tgt, pod_covered)
            # locality repair: a fresh copy may make a running
            # off-pod map worth migrating toward it
            mig = getattr(self.sim, "migration", None)
            if mig is not None:
                mig.replica_landed(ev.shard_id, tgt, now)

    # -- fabric-mode repair pipeline ----------------------------------------------
    def _pump(self, now: float) -> None:
        if self._copying or not self._repairs:
            return
        self._copying = True
        eligible = self._repairs[0][3]
        if now < eligible:
            self.kernel.call_at(eligible, self._launch)
        else:
            self._launch(now)

    def _launch(self, now: float) -> None:
        sid, pod, mb, _eligible = self._repairs.popleft()
        reps = self.sim.cluster.shard_replicas.get(sid) or ()
        src_pod = reps[0].pod if reps else None

        def copied(tn):
            self.kernel.push(tn, "rerep", RerepEvent(tn, sid, pod, mb))
            self._copying = False
            self._pump(tn)

        bw = self.mgr.cfg.rerep_bandwidth
        dyn = self.sim.dyn_disk
        if dyn:
            # disk-slow chaos episode: the repair writes at the
            # worst degraded disk of the destination pod. Per-stream
            # rerep completions are precomputed at loss time (the target
            # is not chosen yet), so only fabric mode models this.
            pf = max((f for h, f in dyn.items() if h.pod == pod),
                     default=1.0)
            bw /= pf
        self.sim.fabric.start_flow(now, mb, src_pod, pod, bw, "rerep",
                                   copied)
