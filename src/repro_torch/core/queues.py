"""Per-pod task queues (paper §4) — indexed O(1) fast-path edition.

Each pod c owns permanent queues MQ_{c,0} / RQ_{c,0} (small jobs only) plus
dynamically created per-large-job queues MQ_{c,p}/RQ_{c,q} (policy C), and the
cluster owns global MQ_FIFO / RQ_FIFO for unprofiled jobs (Fig. 4 lines 4-6).

The seed implementation stored plain deques, so the assigners paid O(n) per
slot offer (scanning the head job's tasks for locality, ``deque.remove``,
predicate scans for ready reduces) and ``least_loaded_pod``/``unprocessed``
re-summed every queue per job submission. This version keeps the same FIFO
semantics but adds, per ``TaskQueue``:

  * per-job buckets in enqueue order (jobs are always enqueued contiguously:
    the scheduler extends a queue once per job), so the Hadoop-FIFO "head
    job" is an O(1) lookup instead of a scan;
  * per-(job, host) and per-(job, pod) locality indexes built from the
    cluster's shard-replica map at append time, so a locality-preferring
    pick is amortized O(1);
  * lazy tombstone removal: ``remove``/``popleft`` mark a task dead in O(1)
    and every secondary index purges dead entries only when it touches them;
  * cached live-length plus chained load counters, so ``unprocessed()`` and
    ``least_loaded_pod`` never re-sum;
  * a ready-job transition for reduce queues: ``mark_job_ready`` moves a
    job's pending reduce bucket into a ready heap exactly once (keyed by
    enqueue order), replacing the per-task predicate scan.

Tasks are tracked by ``id()`` so arbitrary payload objects (tests enqueue
plain sentinels for load accounting) remain supported.
"""
from __future__ import annotations

import collections
import heapq
from typing import Deque, Dict, List, Optional, Tuple


class LoadCounter:
    """A shared mutable task counter (pod load / cluster backlog)."""

    __slots__ = ("n",)

    def __init__(self) -> None:
        self.n = 0


class TaskQueue:
    """FIFO queue of tasks with O(1) append/popleft/removal and indexed
    locality/ready picks. Iteration yields live tasks in enqueue order."""

    __slots__ = ("name", "_q", "_live", "_len", "_jobs", "_job_tasks",
                 "_job_keys", "_job_serial", "_serial", "_ready", "_rheap",
                 "_cluster", "_counters", "_hidx", "_pidx", "_indexed")

    def __init__(self, name: str, cluster=None,
                 counters: Tuple[LoadCounter, ...] = (),
                 index_tasks: bool = True):
        self.name = name
        #: False = "light mode": plain FIFO with counters only, for queues
        #: that are only ever served head-first (TTA pod map queues); the
        #: job/locality indexes are neither built nor maintained.
        self._indexed = index_tasks
        self._q: Deque = collections.deque()    # live + tombstoned tasks
        self._live: set = set()                 # id(task) of live tasks
        self._len = 0
        # job_id -> live count, in first-enqueue order (dicts are ordered);
        # a queue receives each job's tasks in one contiguous extend, so
        # insertion order == queue order of the job's first task.
        self._jobs: Dict[object, int] = {}
        self._job_tasks: Dict[object, Deque] = {}
        self._job_keys: Dict[object, List] = {}   # index keys for cleanup
        self._job_serial: Dict[object, int] = {}
        self._serial = 0
        self._ready: set = set()                  # job_ids marked ready
        self._rheap: List[Tuple[int, object]] = []  # (enqueue serial, job)
        self._cluster = cluster
        self._counters = tuple(counters)
        self._hidx: Dict = {}   # (job_id, HostId) -> deque (host-local)
        self._pidx: Dict = {}   # (job_id, pod)    -> deque (pod-local)

    # -- mutation -------------------------------------------------------------
    def append(self, task) -> None:
        self._q.append(task)
        self._live.add(id(task))
        self._len += 1
        for c in self._counters:
            c.n += 1
        if not self._indexed:
            return
        jid = getattr(task, "job_id", None)
        if jid is None:
            return
        jobs = self._jobs
        if jid in jobs:
            jobs[jid] += 1
        else:
            jobs[jid] = 1
            self._job_tasks[jid] = collections.deque()
            self._job_keys[jid] = []
            self._job_serial[jid] = self._serial
            self._serial += 1
        self._job_tasks[jid].append(task)
        sid = getattr(task, "shard_id", None)
        cl = self._cluster
        if sid is not None and cl is not None:
            reps = cl.shard_replicas.get(sid)
            if reps:
                keys = self._job_keys[jid]
                hidx, pidx = self._hidx, self._pidx
                seen_pods = set()
                for hid in reps:
                    k = (jid, hid)
                    dq = hidx.get(k)
                    if dq is None:
                        dq = hidx[k] = collections.deque()
                        keys.append(("h", k))
                    dq.append(task)
                    if hid.pod not in seen_pods:
                        seen_pods.add(hid.pod)
                        pk = (jid, hid.pod)
                        pq = pidx.get(pk)
                        if pq is None:
                            pq = pidx[pk] = collections.deque()
                            keys.append(("p", pk))
                        pq.append(task)

    def extend(self, tasks) -> None:
        for t in tasks:
            self.append(t)

    def _discard(self, task) -> None:
        """O(1) tombstone removal; secondary indexes purge lazily."""
        self._live.discard(id(task))
        self._len -= 1
        for c in self._counters:
            c.n -= 1
        # amortized compaction: indexed picks never pop _q, so without this
        # a long-lived permanent queue would retain every task ever seen
        dead = len(self._q) - self._len
        if dead > 64 and dead > self._len:
            live = self._live
            self._q = collections.deque(
                t for t in self._q if id(t) in live)
        if not self._indexed:
            return
        jid = getattr(task, "job_id", None)
        if jid is None:
            return
        n = self._jobs[jid] - 1
        if n:
            self._jobs[jid] = n
        else:
            del self._jobs[jid]
            del self._job_tasks[jid]
            for kind, k in self._job_keys.pop(jid, ()):
                (self._hidx if kind == "h" else self._pidx).pop(k, None)
            self._ready.discard(jid)
            self._job_serial.pop(jid, None)

    def popleft(self):
        q, live = self._q, self._live
        while q:
            t = q.popleft()
            if id(t) in live:
                self._discard(t)
                return t
        raise IndexError("pop from an empty TaskQueue")

    def peek(self):
        q, live = self._q, self._live
        while q:
            t = q[0]
            if id(t) in live:
                return t
            q.popleft()
        return None

    def remove(self, task) -> None:
        if id(task) not in self._live:
            raise ValueError("task not in queue")
        self._discard(task)

    # -- introspection --------------------------------------------------------
    def __len__(self) -> int:
        return self._len

    def __iter__(self):
        live = self._live
        return (t for t in self._q if id(t) in live)

    def __bool__(self) -> bool:
        return self._len > 0

    def head_job(self):
        """job_id of the earliest-enqueued job with live tasks (O(1))."""
        for jid in self._jobs:
            return jid
        return None

    def _peek_live(self, dq):
        """First live task of an index deque, purging tombstones."""
        live = self._live
        while dq:
            t = dq[0]
            if id(t) in live:
                return t
            dq.popleft()
        return None

    # -- indexed map picks ----------------------------------------------------
    def peek_local(self, jid, hid):
        dq = self._hidx.get((jid, hid))
        return None if dq is None else self._peek_live(dq)

    def peek_pod(self, jid, pod: int):
        dq = self._pidx.get((jid, pod))
        return None if dq is None else self._peek_live(dq)

    def peek_job_head(self, jid):
        dq = self._job_tasks.get(jid)
        return None if dq is None else self._peek_live(dq)

    def pick_local(self, jid, hid):
        t = self.peek_local(jid, hid)
        if t is not None:
            self._discard(t)
        return t

    def pick_pod(self, jid, pod: int):
        t = self.peek_pod(jid, pod)
        if t is not None:
            self._discard(t)
        return t

    def pick_job_head(self, jid):
        t = self.peek_job_head(jid)
        if t is not None:
            self._discard(t)
        return t

    # -- elasticity ----------------------------------------------------
    def drop_host(self, hid) -> None:
        """A host departed: purge its per-(job, host) locality entries.

        The pod-level index is left untouched — it is a *preference* index
        (which task to offer first), and a stale pod entry only means one
        pick is offered as pod-local when the replica is gone; the executor
        computes true locality from the cluster at start time. Departed
        hosts receive no slot offers, so host-keyed entries are pure leak.

        This is a scan over the queue's live index keys, deliberately: a
        host-keyed reverse index would make departures O(affected) but tax
        every ``append`` on the static hot path (the per-slot
        dispatch envelope), while departures are per-host-hour rare and the scan is
        bounded by currently *queued* work, not history.
        """
        hidx = self._hidx
        for k in [k for k in hidx if k[1] == hid]:
            del hidx[k]

    def reindex_shard(self, shard_id, hid, pod_covered: bool) -> None:
        """A replica of ``shard_id`` was re-created on ``hid`` (re-replication): give queued tasks of that shard their host-local
        index entry back, and a pod entry when the pod had lost coverage
        (``pod_covered`` is the pre-patch truth from the cluster).

        Scan-based over the queue's live tasks for the same reason
        ``drop_host`` scans keys: repairs are per-host-loss rare, while a
        shard-keyed reverse index would tax every ``append`` on the static
        hot path. Tasks enqueued *after* the repair index themselves against
        the patched replica map, so this never runs twice for one task.
        """
        if not self._indexed:
            return
        live = self._live
        hidx, pidx = self._hidx, self._pidx
        pod = hid.pod
        for t in self._q:
            if id(t) not in live or getattr(t, "shard_id", None) != shard_id:
                continue
            jid = getattr(t, "job_id", None)
            keys = self._job_keys.get(jid)
            if keys is None:    # pragma: no cover - untracked sentinel task
                continue
            k = (jid, hid)
            dq = hidx.get(k)
            if dq is None:
                dq = hidx[k] = collections.deque()
                keys.append(("h", k))
            dq.append(t)
            if not pod_covered:
                pk = (jid, pod)
                pq = pidx.get(pk)
                if pq is None:
                    pq = pidx[pk] = collections.deque()
                    keys.append(("p", pk))
                pq.append(t)

    # -- ready-reduce transition ----------------------------------------------
    def mark_job_ready(self, jid) -> None:
        """Move job ``jid``'s pending reduce bucket to the ready heap (once).

        Readiness is monotone (all maps of the job finished), so a marked
        job never reverts; drained jobs are purged from the heap lazily.
        """
        if jid in self._jobs and jid not in self._ready:
            self._ready.add(jid)
            heapq.heappush(self._rheap, (self._job_serial[jid], jid))

    def mark_job_unready(self, jid) -> None:
        """Re-close job ``jid``'s shuffle gate (elastic clusters only: a
        departed host lost completed map outputs, so the job's maps are no
        longer all finished). Stale heap entries purge lazily; a later
        ``mark_job_ready`` re-inserts the job."""
        self._ready.discard(jid)

    def pick_ready(self, ready, trust_marks: bool = False):
        """First ready reduce task in queue order.

        ``ready`` must be job-uniform (all reduce tasks of a job flip ready
        together — Hadoop's shuffle gate). With ``trust_marks`` the caller
        guarantees ``ready(t) == (t.job_id marked via mark_job_ready)`` and
        the pick is O(log jobs); otherwise jobs are scanned in enqueue order
        with one predicate call per job.
        """
        heap, rset = self._rheap, self._ready
        while heap and heap[0][1] not in rset:
            heapq.heappop(heap)
        if trust_marks:
            if not heap:
                return None
            jid = heap[0][1]
            t = self._peek_live(self._job_tasks[jid])
            self._discard(t)
            return t
        for jid in self._jobs:
            t = self._peek_live(self._job_tasks[jid])
            if t is None:       # pragma: no cover - _jobs implies live tasks
                continue
            if jid in rset or ready(t):
                self._discard(t)
                return t
        return None


class PodQueues:
    """All map/reduce queues of one pod.

    Index 0 is the permanent queue; indices >= 1 are per-large-job queues
    created by policy C and garbage-collected when drained. Load is kept in
    cached counters (``map_load``/``red_load``) updated on every queue
    mutation, so ``unprocessed()`` is O(1).
    """

    def __init__(self, pod: int, cluster=None,
                 map_backlog: Optional[LoadCounter] = None,
                 red_backlog: Optional[LoadCounter] = None):
        self.pod = pod
        self._cluster = cluster
        self.index_map_tasks = True   # False once a head-only assigner owns us
        self.map_load = LoadCounter()
        self.red_load = LoadCounter()
        self._map_counters = tuple(
            c for c in (self.map_load, map_backlog) if c is not None)
        self._red_counters = tuple(
            c for c in (self.red_load, red_backlog) if c is not None)
        self.map_queues: List[TaskQueue] = [
            TaskQueue(f"MQ[{pod},0]", cluster, self._map_counters)]
        self.reduce_queues: List[TaskQueue] = [
            TaskQueue(f"RQ[{pod},0]", cluster, self._red_counters)]

    # -- permanent queues ----------------------------------------------------
    @property
    def mq0(self) -> TaskQueue:
        return self.map_queues[0]

    @property
    def rq0(self) -> TaskQueue:
        return self.reduce_queues[0]

    # -- policy C dynamic queues ---------------------------------------------
    def new_map_queue(self) -> TaskQueue:
        q = TaskQueue(f"MQ[{self.pod},{len(self.map_queues)}]",
                      self._cluster, self._map_counters,
                      index_tasks=self.index_map_tasks)
        self.map_queues.append(q)
        return q

    def new_reduce_queue(self) -> TaskQueue:
        q = TaskQueue(f"RQ[{self.pod},{len(self.reduce_queues)}]",
                      self._cluster, self._red_counters)
        self.reduce_queues.append(q)
        return q

    def gc(self) -> None:
        """Drop drained dynamic queues (keep index 0 forever)."""
        if len(self.map_queues) > 1 and not all(self.map_queues[1:]):
            self.map_queues = [self.map_queues[0]] + [
                q for q in self.map_queues[1:] if q]
        if len(self.reduce_queues) > 1 and not all(self.reduce_queues[1:]):
            self.reduce_queues = [self.reduce_queues[0]] + [
                q for q in self.reduce_queues[1:] if q]

    # -- load ----------------------------------------------------------------
    def unprocessed(self) -> int:
        """Amount of unprocessed tasks queued at this pod (policy A input)."""
        return self.map_load.n + self.red_load.n


class ClusterQueues:
    """Queue state for the whole cluster: per-pod queues + global FIFO.

    Accepts either a pod count (legacy callers: policy unit tests, the data
    pipeline) or a ``VirtualCluster``; only the latter enables the per-host
    locality indexes inside the queues. Cluster-wide map/reduce backlog
    counters make "is there any assignable work?" an O(1) question for the
    assigners and the simulator's dispatch loop.
    """

    def __init__(self, k):
        cluster = None if isinstance(k, int) else k
        n_pods = k if cluster is None else cluster.k
        self.cluster = cluster
        self.map_backlog = LoadCounter()
        self.red_backlog = LoadCounter()
        self.pods: Dict[int, PodQueues] = {
            c: PodQueues(c, cluster, self.map_backlog, self.red_backlog)
            for c in range(n_pods)}
        self.mq_fifo = TaskQueue("MQ_FIFO", cluster, (self.map_backlog,))
        self.rq_fifo = TaskQueue("RQ_FIFO", cluster, (self.red_backlog,))
        # job_id -> the queue(s) holding its reduce tasks (ready
        # notifications). Statically a job's reduces live in exactly one
        # queue; churn re-executions may split a job across its original
        # queue and RQ_FIFO, so this maps to a small list. Pruned of
        # drained jobs every so often (amortized O(1) per submit).
        self._reduce_queue_of: Dict[int, List[TaskQueue]] = {}
        self._reduce_prune_at = 128
        #: True once a simulator delivers maps-done notifications; assigners
        #: then use the O(log) ready heap instead of the predicate scan.
        self.notified = False

    def set_map_task_indexing(self, enabled: bool) -> None:
        """Disable ("light mode") or enable per-task indexing of the pod map
        queues. Head-only assigners (TTA) never consult the job/locality
        indexes of pod map queues, so skipping their maintenance roughly
        halves the per-assignment cost. MQ_FIFO (Hadoop-FIFO locality pick)
        and all reduce queues stay indexed. Only callable while empty."""
        for p in self.pods.values():
            p.index_map_tasks = enabled
            for q in p.map_queues:
                if len(q):      # pragma: no cover - misuse guard
                    raise RuntimeError("cannot re-index a non-empty queue")
                q._indexed = enabled

    def register_reduce_queue(self, job_id: int, q: TaskQueue) -> None:
        qs = self._reduce_queue_of.get(job_id)
        if qs is None:
            self._reduce_queue_of[job_id] = [q]
        elif q not in qs:
            qs.append(q)
        if len(self._reduce_queue_of) >= self._reduce_prune_at:
            # drop jobs whose reduce buckets have drained (they can never be
            # marked ready again), so the map stays O(in-flight jobs) and
            # gc'd policy-C queues are not pinned forever
            pruned = {}
            for j, rqs in self._reduce_queue_of.items():
                live = [rq for rq in rqs if j in rq._jobs]
                if live:
                    pruned[j] = live
            self._reduce_queue_of = pruned
            self._reduce_prune_at = max(
                128, 2 * len(self._reduce_queue_of) + 64)

    def mark_job_ready(self, job_id: int) -> None:
        """All maps of ``job_id`` finished: its reduces become assignable."""
        self.notified = True
        for q in self._reduce_queue_of.get(job_id, ()):
            q.mark_job_ready(job_id)

    def mark_job_unready(self, job_id: int) -> None:
        """Elastic only: a departed host lost map outputs of ``job_id``, so
        its shuffle gate re-closes until the re-executed maps finish."""
        for q in self._reduce_queue_of.get(job_id, ()):
            q.mark_job_unready(job_id)

    def replica_restored(self, shard_id, hid, pod_covered: bool) -> None:
        """Re-replication: a replica of ``shard_id`` came back on
        ``hid`` — re-patch the map-queue locality indexes so queued and
        re-executed maps of the shard regain node/pod locality. Reduce
        queues never index shards (reduce tasks carry no shard), so only
        map queues are touched."""
        for p in self.pods.values():
            for q in p.map_queues:
                q.reindex_shard(shard_id, hid, pod_covered)
        self.mq_fifo.reindex_shard(shard_id, hid, pod_covered)

    # -- elasticity ----------------------------------------------------
    def host_lost(self, hid) -> None:
        """Purge the departed host's locality-index entries everywhere."""
        for p in self.pods.values():
            for q in p.map_queues:
                q.drop_host(hid)
            for q in p.reduce_queues:
                q.drop_host(hid)
        self.mq_fifo.drop_host(hid)
        self.rq_fifo.drop_host(hid)

    def evacuate_pod(self, c: int) -> Tuple[int, int]:
        """Move every queued task of a now-hostless pod to the global FIFO
        queues (only a pod's own hosts serve its queues, so work stranded
        in an empty pod would never run). Ready marks follow the moved
        reduce buckets. Returns (maps moved, reduces moved)."""
        p = self.pods[c]
        n_maps = n_reds = 0
        for q in p.map_queues:
            for t in list(q):
                q.remove(t)
                self.mq_fifo.append(t)
                n_maps += 1
        for q in p.reduce_queues:
            ready = set(q._ready)
            moved_jobs = []
            for t in list(q):
                q.remove(t)
                self.rq_fifo.append(t)
                moved_jobs.append(t.job_id)
                n_reds += 1
            for jid in moved_jobs:
                self.register_reduce_queue(jid, self.rq_fifo)
            for jid in ready:
                self.rq_fifo.mark_job_ready(jid)
        p.gc()
        return n_maps, n_reds

    def rebalance_to_pod(self, dst: int, n: int) -> int:
        """Scale-out re-planning: pull up to ``n`` queued
        map tasks from the most-backlogged *other* pod into ``dst``'s
        permanent map queue, so a freshly-leased host in a previously
        empty pod attracts work before new jobs arrive. Tasks move from
        the donor's queue tails (its own hosts keep draining the heads,
        so FIFO fairness at the donor is preserved); appending re-indexes
        them against the current replica map, restoring whatever locality
        ``dst`` offers. Returns the number of maps moved."""
        if n <= 0:
            return 0
        donors = [c for c, p in self.pods.items()
                  if c != dst and p.map_load.n > 0]
        if not donors:
            return 0
        donor = self.pods[max(donors,
                              key=lambda c: (self.pods[c].map_load.n, -c))]
        dq = self.pods[dst].mq0
        moved = 0
        for q in reversed(donor.map_queues):
            if moved >= n:
                break
            tasks = list(q)
            take = tasks[max(0, len(tasks) - (n - moved)):]
            for t in take:
                q.remove(t)
                dq.append(t)
                moved += 1
        donor.gc()
        return moved

    def least_loaded_pod(self) -> int:
        """cen_w: least unprocessed tasks (Fig. 4 line 9); ties -> lowest id.

        Hostless pods (elastic clusters) are skipped — work placed there
        could never be served, since assigners only pull for a pod's own
        hosts. With a static cluster every pod qualifies (seed behaviour).
        """
        pods = self.pods
        cl = self.cluster
        if cl is not None:
            cands = [c for c in pods if cl.pods[c].hosts] or list(pods)
        else:
            cands = list(pods)
        return min(cands, key=lambda c: (pods[c].unprocessed(), c))

    def total_pending(self) -> int:
        return self.map_backlog.n + self.red_backlog.n

    def gc(self) -> None:
        for p in self.pods.values():
            p.gc()
