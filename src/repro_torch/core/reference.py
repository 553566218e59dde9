"""Naive scan-based reference implementations of the TTA/JTA picks and the
Hadoop-baseline slot service, retained verbatim from the pre-indexed seed.

These exist so the O(1) indexed fast path in ``assigners``/``queues``/
``baselines`` can be proven behaviour-identical: the equivalence tests run
the same workload under both stacks and assert identical assignment
sequences and ``SimResult`` metrics, and ``chip_smoke.py`` times them as the
"old" side of its old-vs-new assign-rate comparison. A copy of
``repro/core/reference.py``.

They operate on the indexed ``TaskQueue`` through its sequence interface
(iteration in enqueue order, ``peek``/``remove``/``popleft``), which is
exactly the contract the seed's plain deques offered.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.core.assigners import BaseAssigner
from repro_torch.core.baselines import (CapacityScheduler, FairScheduler,
                                        FifoScheduler, _LOC_RANK)
from repro_torch.core.job import MapTask, ReduceTask, TaskState
from repro_torch.core.joss import Joss
from repro_torch.core.queues import TaskQueue
from repro_torch.core.topology import HostId, Locality, VirtualCluster


def reference_fifo_pick_map(queue: TaskQueue, host: HostId,
                            cluster: VirtualCluster) -> Optional[MapTask]:
    """Seed Hadoop-FIFO map pick: O(m) scan over the head job's tasks."""
    head = queue.peek()
    if head is None:
        return None
    job_id = head.job_id
    best, best_rank = None, 3
    for t in queue:
        if t.job_id != job_id:
            break  # strict FIFO job order
        loc = cluster.locality_of(t.shard_id, host) \
            if t.shard_id in cluster.shard_replicas else Locality.OFF_POD
        rank = {Locality.HOST: 0, Locality.POD: 1, Locality.OFF_POD: 2}[loc]
        if rank < best_rank:
            best, best_rank = t, rank
            if rank == 0:
                break
    if best is None:
        best = head
    queue.remove(best)
    return best


def reference_head_pick_map(queue: TaskQueue, host: HostId,
                            cluster: VirtualCluster) -> Optional[MapTask]:
    """Seed TTA map pick: plain head-of-queue."""
    if not queue:
        return None
    return queue.popleft()


def reference_pick_ready_reduce(queue: TaskQueue,
                                ready: Callable[[ReduceTask], bool],
                                trust_marks: bool = False
                                ) -> Optional[ReduceTask]:
    """Seed reduce pick: O(n) predicate scan for the first ready task."""
    for t in queue:
        if ready(t):
            queue.remove(t)
            return t
    return None


class ReferenceTTA(BaseAssigner):
    """Seed TTA: head pick + scan-based FIFO/reduce service."""

    map_pick = staticmethod(reference_head_pick_map)
    fifo_pick = staticmethod(reference_fifo_pick_map)
    reduce_pick = staticmethod(reference_pick_ready_reduce)
    name = "tta"


class ReferenceJTA(BaseAssigner):
    """Seed JTA: scan-based locality pick with the same defer bookkeeping."""

    fifo_pick = staticmethod(reference_fifo_pick_map)
    reduce_pick = staticmethod(reference_pick_ready_reduce)
    name = "jta"
    max_defer = 1

    def __init__(self, cluster: VirtualCluster, queues):
        super().__init__(cluster, queues)
        self._defers: Dict[object, int] = {}

    def map_pick(self, queue: TaskQueue, host: HostId,
                 cluster: VirtualCluster) -> Optional[MapTask]:
        head = queue.peek()
        if head is None:
            return None
        job_id = head.job_id
        best, best_rank = None, 99
        for t in queue:
            if t.job_id != job_id:
                break
            loc = cluster.locality_of(t.shard_id, host) \
                if t.shard_id in cluster.shard_replicas else Locality.OFF_POD
            rank = {Locality.HOST: 0, Locality.POD: 1,
                    Locality.OFF_POD: 2}[loc]
            if rank < best_rank:
                best, best_rank = t, rank
                if rank == 0:
                    break
        if best is None:
            return None
        if best_rank > 0 and self.max_defer > 0:
            key = (host, best.tid)
            n = self._defers.get(key, 0)
            if n < self.max_defer:
                self._defers[key] = n + 1
                return None  # wait a heartbeat for a local host to claim it
        queue.remove(best)
        self._defers.pop((host, best.tid), None)
        return best


class ReferenceJossT(Joss):
    name = "joss-t"
    assigner_cls = ReferenceTTA


class ReferenceJossJ(Joss):
    name = "joss-j"
    assigner_cls = ReferenceJTA


class _ReferenceSlotService:
    """Seed GlobalScheduler slot service: full pending-list scans."""

    def next_map_task(self, host: HostId) -> Optional[MapTask]:
        for job in self.job_order():
            pending = [t for t in job.map_tasks
                       if t.state == TaskState.PENDING]
            if not pending:
                continue
            best, best_rank = None, 99
            for t in pending:
                if t.shard_id in self.cluster.shard_replicas:
                    loc = self.cluster.locality_of(t.shard_id, host)
                else:
                    loc = Locality.OFF_POD
                r = _LOC_RANK[loc]
                if r < best_rank:
                    best, best_rank = t, r
                    if r == 0:
                        break
            return best
        return None

    def next_reduce_task(self, host: HostId,
                         ready: Callable[[ReduceTask], bool]
                         ) -> Optional[ReduceTask]:
        for job in self.job_order():
            for t in job.reduce_tasks:
                if t.state == TaskState.PENDING and ready(t):
                    return t
        return None


class ReferenceFifo(_ReferenceSlotService, FifoScheduler):
    pass


class ReferenceFair(_ReferenceSlotService, FairScheduler):
    """Seed Fair: re-sorts every job on every slot offer (O(a log a)).

    Kept verbatim so the activity-keyed bucket structure in
    ``FairScheduler`` can be equivalence-tested against the original
    ordering (same sort key: running tasks, then submit time, then id).
    """

    def job_order(self):
        return sorted(self._sched,
                      key=lambda j: (self.running_tasks.get(j.job_id, 0),
                                     j.submit_time, j.job_id))


class ReferenceCapacity(_ReferenceSlotService, CapacityScheduler):
    pass


def make_reference_algorithm(name: str, cluster: VirtualCluster, **kw):
    """Factory mirroring ``make_algorithm`` with the naive reference stack."""
    table = {
        "joss-t": ReferenceJossT,
        "joss-j": ReferenceJossJ,
        "fifo": ReferenceFifo,
        "fair": ReferenceFair,
        "capacity": ReferenceCapacity,
    }
    if name not in table:
        raise ValueError(f"unknown algorithm {name!r}; "
                         f"choose from {sorted(table)}")
    return table[name](cluster, **kw)
