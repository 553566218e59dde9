"""Baseline schedulers the paper compares against (§3, §6): Hadoop FIFO [1],
Fair [19], and Capacity [20].

All three keep a *global* job list (no pod-level placement — they were built
for single-LAN clusters) and differ only in which job serves an idle slot:

  * FIFO     — strict submission order.
  * Fair     — job with the fewest currently-running tasks (equal share).
  * Capacity — multiple queues with capacity fractions; pick the least-used
    queue, FIFO within it.

Map picks prefer host-local (node-local) replicas *within the chosen job*;
beyond that they are BLIND to the pod boundary: Hadoop's second locality
tier is rack-locality, and a tenant's virtual cluster exposes no rack
topology (paper §1/§3 — stock Hadoop "might be unable to provide a high
map-data locality" there), so every non-node-local task looks equally
'rack-local' and the first pending one is taken. Reduce picks take the
first ready reduce task on whatever slot frees first — no reduce
placement, exactly the behaviour the paper measures.

The seed rebuilt the pending-task list of every job on every slot offer
(O(total tasks) per offer). This version keeps per-job pending deques in
task-index order plus per-(job, host) replica deques, both purged lazily as
task states flip, so a map pick is amortized O(active jobs) with O(1) work
per job, and drained jobs are compacted out of the scheduling order. The
scan-based seed service is retained in ``repro_torch.core.reference`` and covered
by equivalence tests.
"""
from __future__ import annotations

import bisect
import collections
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.core.job import Job, MapTask, ReduceTask, TaskState
from repro_torch.core.topology import HostId, Locality, VirtualCluster

# node-local first; pod == off-pod (flat-rack blindness of stock Hadoop
# in a virtual cluster, paper §1/§3)
_LOC_RANK = {Locality.HOST: 0, Locality.POD: 1, Locality.OFF_POD: 1}

_PENDING = TaskState.PENDING


def _purge_peek(dq: Optional[Deque]):
    """First still-PENDING task of a deque; tasks never return to PENDING,
    so popped heads are gone for good (lazy tombstones by state)."""
    if dq is None:
        return None
    while dq:
        t = dq[0]
        if t.state is _PENDING:
            return t
        dq.popleft()
    return None


class GlobalScheduler:
    """Common machinery for the three Hadoop baselines."""

    name = "global"

    def __init__(self, cluster: VirtualCluster):
        self.cluster = cluster
        self.jobs: List[Job] = []
        self.running_tasks: Dict[int, int] = {}  # job_id -> running count
        # indexed pending structures (amortized O(1) per job per offer)
        self._pending_maps: Dict[int, Deque] = {}
        self._pending_reds: Dict[int, Deque] = {}
        self._host_maps: Dict[Tuple[int, HostId], Deque] = {}
        self._ready: set = set()        # job_ids whose maps all finished
        self._sched: List[Job] = []     # submission order, drained pruned
        self._in_sched: set = set()     # job_ids currently in _sched
        self._drained: set = set()
        self._job_by_id: Dict[int, Job] = {}

    # -- scheduling (submission) ------------------------------------------------
    def submit(self, job: Job) -> None:
        self.jobs.append(job)
        self._sched.append(job)
        self._in_sched.add(job.job_id)
        self._job_by_id[job.job_id] = job
        self.running_tasks.setdefault(job.job_id, 0)
        jid = job.job_id
        self._pending_maps[jid] = collections.deque(job.map_tasks)
        self._pending_reds[jid] = collections.deque(job.reduce_tasks)
        replicas = self.cluster.shard_replicas
        host_maps = self._host_maps
        for t in job.map_tasks:
            for hid in replicas.get(t.shard_id, ()):
                k = (jid, hid)
                dq = host_maps.get(k)
                if dq is None:
                    dq = host_maps[k] = collections.deque()
                dq.append(t)

    def record_completion(self, job: Job, measured_fp: float) -> None:
        """Baselines learn nothing from FP; kept for interface parity."""

    def job_maps_done(self, job_id: int) -> None:
        """Simulator notification: every map of ``job_id`` finished, so its
        reduce tasks are ready (bypasses the per-task predicate)."""
        self._ready.add(job_id)

    def job_maps_undone(self, job_id: int) -> None:
        """Elastic only: a departed host lost finished map outputs of
        ``job_id``; its reduces are no longer ready until the re-runs land."""
        self._ready.discard(job_id)

    # -- elastic-cluster interface ----------------------------------------
    def host_added(self, hid: HostId) -> None:
        """A fresh VPS joined with an empty disk: nothing to index."""

    def host_lost(self, hid: HostId) -> None:
        """Purge the departed host's node-local replica index entries."""
        host_maps = self._host_maps
        for k in [k for k in host_maps if k[1] == hid]:
            del host_maps[k]

    def replica_restored(self, shard_id, hid: HostId,
                         pod_covered: bool) -> None:
        """Re-replication: a repair copy of ``shard_id`` landed on
        ``hid`` — pending maps of the shard become node-local candidates
        there. The baselines are pod-blind (flat-rack), so ``pod_covered``
        is irrelevant to them. Scan over pending work, same rarity argument
        as ``host_lost``."""
        host_maps = self._host_maps
        for jid, dq in self._pending_maps.items():
            for t in dq:
                if (t.state is _PENDING
                        and getattr(t, "shard_id", None) == shard_id):
                    k = (jid, hid)
                    hq = host_maps.get(k)
                    if hq is None:
                        hq = host_maps[k] = collections.deque()
                    hq.append(t)

    def _resurrect(self, job: Job) -> None:
        """Undo drain bookkeeping for a job that got work back (churn).

        A job pruned from ``_sched`` by drain compaction re-enters at its
        submission-order position, so FIFO (and Capacity's within-queue
        FIFO) keep strict submission order across churn."""
        jid = job.job_id
        self._drained.discard(jid)
        if jid not in self._in_sched:
            pos = bisect.bisect_right(
                self._sched, (job.submit_time, jid),
                key=lambda j: (j.submit_time, j.job_id))
            self._sched.insert(pos, job)
            self._in_sched.add(jid)

    def requeue_map_task(self, task: MapTask) -> None:
        """Re-execution of a map lost to churn: failed tasks retry first
        (appendleft), indexed against the shard's surviving replicas."""
        jid = task.job_id
        self._resurrect(self._job_by_id[jid])
        dq = self._pending_maps.get(jid)
        if dq is None:
            dq = self._pending_maps[jid] = collections.deque()
        dq.appendleft(task)
        host_maps = self._host_maps
        for hid in self.cluster.shard_replicas.get(task.shard_id, ()):
            k = (jid, hid)
            hq = host_maps.get(k)
            if hq is None:
                hq = host_maps[k] = collections.deque()
            hq.append(task)

    def requeue_reduce_task(self, task: ReduceTask) -> None:
        jid = task.job_id
        self._resurrect(self._job_by_id[jid])
        dq = self._pending_reds.get(jid)
        if dq is None:
            dq = self._pending_reds[jid] = collections.deque()
        dq.appendleft(task)

    # -- bookkeeping hooks used by the simulator ---------------------------------
    def task_started(self, task) -> None:
        self.running_tasks[task.job_id] = self.running_tasks.get(
            task.job_id, 0) + 1

    def task_finished(self, task) -> None:
        self.running_tasks[task.job_id] -= 1

    # -- job ordering: the only thing the three baselines disagree on ------------
    def job_order(self) -> List[Job]:
        raise NotImplementedError

    def _mark_drained(self, job: Job) -> None:
        jid = job.job_id
        self._drained.add(jid)
        self._pending_maps.pop(jid, None)
        self._pending_reds.pop(jid, None)
        if len(self._drained) > 32 and len(self._drained) * 4 > len(
                self._sched):
            drained = self._drained
            self._sched = [j for j in self._sched
                           if j.job_id not in drained]
            self._in_sched = {j.job_id for j in self._sched}
            host_maps = self._host_maps
            for k in [k for k in host_maps if k[0] in drained]:
                del host_maps[k]
            self._drained = set()

    def _job_pending_map(self, job: Job) -> Optional[MapTask]:
        head = _purge_peek(self._pending_maps.get(job.job_id))
        if head is None and _purge_peek(
                self._pending_reds.get(job.job_id)) is None:
            self._mark_drained(job)
        return head

    # -- slot service -------------------------------------------------------------
    def next_map_task(self, host: HostId) -> Optional[MapTask]:
        for job in self.job_order():
            head = self._job_pending_map(job)
            if head is None:
                continue
            # node-local pick within the chosen job, else first pending
            local = _purge_peek(self._host_maps.get((job.job_id, host)))
            return local if local is not None else head
        return None

    def next_reduce_task(self, host: HostId,
                         ready: Callable[[ReduceTask], bool]
                         ) -> Optional[ReduceTask]:
        ready_jobs = self._ready
        for job in self.job_order():
            dq = self._pending_reds.get(job.job_id)
            head = _purge_peek(dq)
            if head is None:
                continue
            if job.job_id in ready_jobs or ready(head):
                return head
            # per-task fallback for non-job-uniform predicates
            for t in dq:
                if t.state is _PENDING and ready(t):
                    return t
        return None


class FifoScheduler(GlobalScheduler):
    """Hadoop MRv1 default: strict job submission order [1]."""

    name = "fifo"

    def job_order(self) -> List[Job]:
        return self._sched


class FairScheduler(GlobalScheduler):
    """Facebook fair scheduler [19]: equal share over time; we order jobs by
    fewest running tasks (deficit first), then submission order.

    The seed re-sorted every job on every slot offer (O(a log a) per offer).
    This version keeps an activity-keyed priority structure instead: one
    bucket per running-task count, each bucket a (submit_time, job_id)-sorted
    list with lazy tombstones. A task start/finish moves exactly one job
    between adjacent buckets (amortized O(log b) + a memmove), and
    ``job_order`` reads the order off in O(active jobs) with no sort. The
    ordering is bit-identical to the seed's sort key — the equivalence tests
    against ``repro_torch.core.reference.ReferenceFair`` (which retains the
    sorting implementation) prove it.
    """

    name = "fair"

    def __init__(self, cluster: VirtualCluster):
        super().__init__(cluster)
        # running-count -> sorted [(submit_time, job_id, serial)]
        self._buckets: Dict[int, List[Tuple[float, int, int]]] = {}
        self._bucket_dead: Dict[int, int] = {}   # count -> tombstones
        self._entry: Dict[int, Tuple[int, int]] = {}  # jid -> (count, serial)
        self._eserial = 0

    # -- activity-keyed structure maintenance ---------------------------------
    def _entry_add(self, job: Job, count: int) -> None:
        self._eserial += 1
        rec = (job.submit_time, job.job_id, self._eserial)
        self._entry[job.job_id] = (count, self._eserial)
        b = self._buckets.get(count)
        if b is None:
            self._buckets[count] = [rec]
        else:
            bisect.insort(b, rec)

    def _entry_kill(self, jid: int) -> None:
        ent = self._entry.pop(jid, None)
        if ent is None:
            return
        count = ent[0]
        dead = self._bucket_dead.get(count, 0) + 1
        bucket = self._buckets.get(count)
        if bucket is not None and dead >= len(bucket):
            del self._buckets[count]         # fully tombstoned
            self._bucket_dead.pop(count, None)
        elif bucket is not None and dead > 16 and dead * 2 > len(bucket):
            entry = self._entry
            self._buckets[count] = [
                r for r in bucket
                if entry.get(r[1], (None, None))[1] == r[2]]
            self._bucket_dead.pop(count, None)
        else:
            self._bucket_dead[count] = dead

    def _entry_move(self, jid: int, new_count: int) -> None:
        job = self._job_by_id.get(jid)
        if job is None or jid not in self._entry:
            return
        self._entry_kill(jid)
        self._entry_add(job, new_count)

    def _job_dead(self, jid: int) -> bool:
        """A job leaves the structure when it has drained (its pending
        deques were reaped by ``_mark_drained``, and churn has not requeued
        work for it) and its last running task finished."""
        return (jid not in self._pending_maps
                and jid not in self._pending_reds
                and self.running_tasks.get(jid, 0) == 0)

    # -- GlobalScheduler hooks ------------------------------------------------
    def submit(self, job: Job) -> None:
        super().submit(job)
        self._entry_add(job, self.running_tasks.get(job.job_id, 0))

    def task_started(self, task) -> None:
        super().task_started(task)
        self._entry_move(task.job_id, self.running_tasks[task.job_id])

    def task_finished(self, task) -> None:
        super().task_finished(task)
        jid = task.job_id
        if self._job_dead(jid):
            self._entry_kill(jid)
        else:
            self._entry_move(jid, self.running_tasks[jid])

    def _mark_drained(self, job: Job) -> None:
        super()._mark_drained(job)
        if self._job_dead(job.job_id):
            self._entry_kill(job.job_id)

    def _resurrect(self, job: Job) -> None:
        super()._resurrect(job)
        if job.job_id not in self._entry:
            self._entry_add(job, self.running_tasks.get(job.job_id, 0))

    def job_order(self) -> List[Job]:
        out: List[Job] = []
        entry = self._entry
        jobs = self._job_by_id
        for count in sorted(self._buckets):
            for (_, jid, ser) in self._buckets[count]:
                if entry.get(jid, (None, None))[1] == ser:
                    out.append(jobs[jid])
        return out


class CapacityScheduler(GlobalScheduler):
    """Yahoo! capacity scheduler [20]: n_queues queues with equal capacity;
    jobs land in queues round-robin; serve the queue with the lowest
    used-fraction, FIFO within the queue."""

    name = "capacity"

    def __init__(self, cluster: VirtualCluster, n_queues: int = 3):
        super().__init__(cluster)
        self.n_queues = n_queues
        self._job_queue: Dict[int, int] = {}
        self._next_q = 0

    def submit(self, job: Job) -> None:
        super().submit(job)
        self._job_queue[job.job_id] = self._next_q
        self._next_q = (self._next_q + 1) % self.n_queues

    def job_order(self) -> List[Job]:
        used = {q: 0 for q in range(self.n_queues)}
        # running tasks of every job ever submitted count against its queue
        for jid, q in self._job_queue.items():
            used[q] += self.running_tasks.get(jid, 0)
        q_order = sorted(range(self.n_queues), key=lambda q: (used[q], q))
        out: List[Job] = []
        for q in q_order:
            out.extend(j for j in self._sched
                       if self._job_queue[j.job_id] == q)
        return out
