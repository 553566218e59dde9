"""Task assigners: TTA (Fig. 5) and JTA (Fig. 6) — indexed fast path.

Both pull tasks for an idle slot of host VPS_{c,l}:
  * map slot:  MQ_FIFO first (Hadoop-FIFO semantics to profile new jobs),
    else round-robin over cen_c's map queues. TTA takes the *head* task of
    the chosen queue (fast assignment); JTA applies Hadoop-FIFO inside the
    chosen queue (strict job order + locality preference -> VPS-locality).
  * reduce slot: RQ_FIFO first, else round-robin over cen_c's reduce queues;
    both assigners take the first *ready* reduce task.

``ready`` for a reduce task is delegated to a predicate (the simulator wires
it to "all map tasks of the job finished", Hadoop's shuffle gate simplified).
The predicate must be job-uniform: all reduce tasks of one job flip ready at
the same instant.

The seed implementation scanned the head job's tasks per pick (O(m) with an
O(n) ``deque.remove``) and scanned every queued reduce task per ready check.
Here every pick consults the ``TaskQueue`` locality/job indexes, so the
Hadoop-FIFO map pick and the ready-reduce pick are amortized O(1); cluster
and per-pod backlog counters let a no-work slot offer return in O(1) without
touching any queue. The scan-based originals are retained verbatim in
``repro_torch.core.reference`` and the equivalence tests assert both produce
identical assignment sequences and simulation metrics.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.core.job import MapTask, ReduceTask
from repro_torch.core.queues import ClusterQueues, TaskQueue
from repro_torch.core.topology import HostId, VirtualCluster


def fifo_pick_map(queue: TaskQueue, host: HostId,
                  cluster: VirtualCluster) -> Optional[MapTask]:
    """Hadoop-FIFO map pick: strict job order, locality-preferring.

    Considers only the earliest job present in the queue and among its tasks
    prefers host-local, then pod-local, then the head task — each an O(1)
    index lookup instead of a scan over the head job's tasks.
    """
    jid = queue.head_job()
    if jid is None:
        return None
    t = queue.pick_local(jid, host)
    if t is not None:
        return t
    t = queue.pick_pod(jid, host.pod)
    if t is not None:
        return t
    return queue.pick_job_head(jid)


def head_pick_map(queue: TaskQueue, host: HostId,
                  cluster: VirtualCluster) -> Optional[MapTask]:
    """TTA map pick: plain head-of-queue (fast task assignment)."""
    if queue._len:
        return queue.popleft()
    return None


def pick_ready_reduce(queue: TaskQueue,
                      ready: Callable[[ReduceTask], bool],
                      trust_marks: bool = False) -> Optional[ReduceTask]:
    """First ready reduce task in queue order (see TaskQueue.pick_ready)."""
    return queue.pick_ready(ready, trust_marks)


class BaseAssigner:
    """Shared round-robin machinery of TTA/JTA (Figs. 5 and 6 differ only in
    line 11: how a map task is picked from the chosen queue)."""

    #: how this assigner picks from a non-FIFO map queue
    map_pick = staticmethod(head_pick_map)
    #: how it serves MQ_FIFO (reference subclasses swap in the scan version)
    fifo_pick = staticmethod(fifo_pick_map)
    #: how it picks a ready reduce task
    reduce_pick = staticmethod(pick_ready_reduce)
    #: whether this assigner's map pick consults the per-task job/locality
    #: indexes of pod map queues (False -> queues may run in light mode)
    needs_task_index = True
    name = "base"

    __slots__ = ("cluster", "queues", "_i_map", "_i_red", "_map_backlog",
                 "_red_backlog", "_mq_fifo", "_rq_fifo", "_pods")

    def __init__(self, cluster: VirtualCluster, queues: ClusterQueues):
        self.cluster = cluster
        self.queues = queues
        # per-pod persistent round-robin indices I_map / I_red
        self._i_map: Dict[int, int] = {}
        self._i_red: Dict[int, int] = {}
        # stable hot-path references (these objects are never replaced)
        self._map_backlog = queues.map_backlog
        self._red_backlog = queues.red_backlog
        self._mq_fifo = queues.mq_fifo
        self._rq_fifo = queues.rq_fifo
        self._pods = queues.pods

    # -- map slot --------------------------------------------------------------
    def next_map_task(self, host: HostId) -> Optional[MapTask]:
        if self._map_backlog.n == 0:    # O(1) no-work fast path
            return None
        # lines 6-8: MQ_FIFO first, with Hadoop-FIFO locality semantics
        if self._mq_fifo._len:
            task = self.fifo_pick(self._mq_fifo, host, self.cluster)
            if task is not None:
                return task
        # lines 9-13: round-robin over this pod's map queues
        pod_q = self._pods[host.pod]
        if pod_q.map_load.n == 0:
            return None
        n = len(pod_q.map_queues)
        if n == 1:  # single queue: round-robin state stays untouched
            return self.map_pick(pod_q.map_queues[0], host, self.cluster)
        i = self._i_map.get(host.pod, 0)
        for step in range(n):
            q = pod_q.map_queues[(i + step) % n]
            task = self.map_pick(q, host, self.cluster)
            if task is not None:
                self._i_map[host.pod] = (i + step + 1) % n
                return task
        self._i_map[host.pod] = i % n
        return None

    # -- elasticity -------------------------------------------------------
    def host_lost(self, hid: HostId) -> None:
        """A host departed; assigners keep no per-host state by default."""

    # -- reduce slot -------------------------------------------------------------
    def next_reduce_task(self, host: HostId,
                         ready: Callable[[ReduceTask], bool]
                         ) -> Optional[ReduceTask]:
        if self._red_backlog.n == 0:    # O(1) no-work fast path
            return None
        trust = self.queues.notified
        # lines 15-17: RQ_FIFO first
        if self._rq_fifo._len:
            task = self.reduce_pick(self._rq_fifo, ready, trust)
            if task is not None:
                return task
        # lines 18-22: round-robin over this pod's reduce queues
        pod_q = self._pods[host.pod]
        if pod_q.red_load.n == 0:
            return None
        n = len(pod_q.reduce_queues)
        i = self._i_red.get(host.pod, 0)
        for step in range(n):
            q = pod_q.reduce_queues[(i + step) % n]
            task = self.reduce_pick(q, ready, trust)
            if task is not None:
                self._i_red[host.pod] = (i + step + 1) % n
                return task
        self._i_red[host.pod] = i % n
        return None


class TTA(BaseAssigner):
    """Task-driven Task Assigner (Fig. 5): fastest possible assignment.

    TTA's pick is always head-of-queue, so pod map queues run in light mode
    (no per-task indexes) and the whole pick — backlog gate, round-robin
    queue choice, tombstone-skipping pop, counter updates — is inlined into
    one frame. This is the per-slot hot path of the 4096-host operating
    point; the generic path above stays the readable specification.
    """

    map_pick = staticmethod(head_pick_map)
    needs_task_index = False
    name = "tta"
    __slots__ = ()

    def next_map_task(self, host: HostId) -> Optional[MapTask]:
        if self._map_backlog.n == 0:    # O(1) no-work fast path
            return None
        fifo = self._mq_fifo
        if fifo._len:
            task = self.fifo_pick(fifo, host, self.cluster)
            if task is not None:
                return task
        pod = host.pod
        pod_q = self._pods[pod]
        if pod_q.map_load.n == 0:
            return None
        mqs = pod_q.map_queues
        n = len(mqs)
        if n == 1:
            i = step = 0
            q = mqs[0]
        else:
            i = self._i_map.get(pod, 0)
            for step in range(n):
                q = mqs[(i + step) % n]
                if q._len:
                    break
            else:                       # pragma: no cover - load>0 => a pick
                self._i_map[pod] = i % n
                return None
        if q._indexed:                  # not taken in light mode
            t = q.popleft()
        else:
            dq, live = q._q, q._live
            while True:                 # _len > 0 guarantees a live head
                t = dq.popleft()
                try:                    # tombstones are rare in light mode
                    live.remove(id(t))
                    break
                except KeyError:
                    continue
            q._len -= 1
            for c in q._counters:
                c.n -= 1
        if n > 1:                       # single queue: RR state untouched
            self._i_map[pod] = (i + step + 1) % n
        return t


class JTA(BaseAssigner):
    """Job-driven Task Assigner (Fig. 6): Hadoop-FIFO within each queue to
    further improve VPS-locality, at an assignment-latency cost.

    The paper observes (Table 8, Fig. 7) that JTA both raises VPS-locality
    and *delays* map execution. We model the mechanism explicitly: when the
    chosen queue's head job has no host-local task for the requesting host,
    JTA defers that host's assignment for up to ``max_defer`` heartbeats,
    giving the holding host a chance to claim it (cf. delay scheduling [17],
    which the paper's JTA approximates via Hadoop-FIFO locality preference).
    After the defer budget is spent the task is assigned non-locally.
    """

    name = "jta"
    max_defer = 1
    __slots__ = ("_defers",)

    def __init__(self, cluster: VirtualCluster, queues: ClusterQueues):
        super().__init__(cluster, queues)
        self._defers: Dict[object, int] = {}

    def host_lost(self, hid: HostId) -> None:
        """Drop defer bookkeeping keyed by the departed host (it will never
        be offered a slot again, so the entries are pure leak)."""
        self._defers = {k: v for k, v in self._defers.items() if k[0] != hid}

    def map_pick(self, queue: TaskQueue, host: HostId,
                 cluster: VirtualCluster) -> Optional[MapTask]:
        jid = queue.head_job()
        if jid is None:
            return None
        best = queue.pick_local(jid, host)      # rank 0: assign immediately
        if best is not None:
            self._defers.pop((host, best.tid), None)
            return best
        best = queue.peek_pod(jid, host.pod)    # rank 1: pod-local
        if best is None:
            best = queue.peek_job_head(jid)     # rank 2: head task
        if best is None:                        # pragma: no cover
            return None
        if self.max_defer > 0:
            key = (host, best.tid)
            n = self._defers.get(key, 0)
            if n < self.max_defer:
                self._defers[key] = n + 1
                return None  # wait a heartbeat for a local host to claim it
        queue.remove(best)
        self._defers.pop((host, best.tid), None)
        return best
