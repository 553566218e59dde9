"""JoSS facade: JoSS-T (scheduler + TTA) and JoSS-J (scheduler + JTA).

Presents the same pull interface as the Hadoop baselines so the simulator,
the data pipeline, and the launcher can drive any of the five algorithms
interchangeably (paper §6 evaluates exactly this set).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.core.assigners import JTA, TTA, BaseAssigner
from repro_torch.core.classifier import FpRegistry
from repro_torch.core.job import Job, MapTask, ReduceTask
from repro_torch.core.scheduler import JossScheduler
from repro_torch.core.topology import HostId, VirtualCluster


class Joss:
    """One JoSS variant = Fig. 4 scheduler + one of the Fig. 5/6 assigners."""

    name = "joss"
    assigner_cls = TTA

    def __init__(self, cluster: VirtualCluster,
                 registry: Optional[FpRegistry] = None,
                 td: Optional[float] = None,
                 replan_on_scaleout: bool = False):
        self.cluster = cluster
        #: opt-in scale-out re-planning — pull queued maps
        #: toward a freshly-joined host's pod so new capacity attracts
        #: work. Off by default: rejoin joins fire ``host_added`` in the
        #: golden churn variants, whose trajectories must stay unchanged.
        self.replan_on_scaleout = replan_on_scaleout
        self.scheduler = JossScheduler(cluster, registry=registry, td=td)
        self.assigner: BaseAssigner = self.assigner_cls(
            cluster, self.scheduler.queues)
        if not self.assigner_cls.needs_task_index:
            # head-only pick (TTA): pod map queues skip per-task indexing
            self.scheduler.queues.set_map_task_indexing(False)
        self.running_tasks: Dict[int, int] = {}
        # bind the hot slot-service entry points directly to the assigner:
        # one Python frame less per slot offer (significant at 4096 hosts)
        self.next_map_task = self.assigner.next_map_task
        self.next_reduce_task = self.assigner.next_reduce_task

    # -- interface shared with baselines ----------------------------------------
    def submit(self, job: Job) -> None:
        self.scheduler.submit(job)
        self.running_tasks.setdefault(job.job_id, 0)

    def record_completion(self, job: Job, measured_fp: float) -> None:
        self.scheduler.record_completion(job, measured_fp)

    def task_started(self, task) -> None:
        self.running_tasks[task.job_id] = self.running_tasks.get(
            task.job_id, 0) + 1

    def task_finished(self, task) -> None:
        self.running_tasks[task.job_id] -= 1
        self.scheduler.gc()

    def job_maps_done(self, job_id: int) -> None:
        """All maps of ``job_id`` finished: unlock its reduce bucket (the
        ready-reduce transition happens exactly once per job)."""
        self.scheduler.queues.mark_job_ready(job_id)

    def job_maps_undone(self, job_id: int) -> None:
        """Elastic only: a departed host lost finished map outputs of
        ``job_id``; its shuffle gate re-closes until the re-runs finish."""
        self.scheduler.queues.mark_job_unready(job_id)

    # -- elastic-cluster interface ----------------------------------------
    def host_added(self, hid: HostId) -> None:
        """A fresh VPS joined. It starts with an empty local disk (no shard
        replicas), so no locality index needs patching. With
        ``replan_on_scaleout`` the join also pulls queued maps from the
        most-backlogged other pod into this pod's queue when this pod has
        none — otherwise the new host idles until a new job happens to be
        scheduled here."""
        if not self.replan_on_scaleout:
            return
        queues = self.scheduler.queues
        if queues.pods[hid.pod].map_load.n > 0:
            return      # the pod already has work for the newcomer
        host = self.cluster.host(hid)
        queues.rebalance_to_pod(hid.pod, 2 * host.map_slots)

    def host_lost(self, hid: HostId) -> None:
        """A VPS departed: patch the locality indexes incrementally and, if
        its pod is now hostless, evacuate the pod's queues to the global
        FIFO queues (only a pod's own hosts serve its queues)."""
        queues = self.scheduler.queues
        queues.host_lost(hid)
        self.assigner.host_lost(hid)
        if not self.cluster.pods[hid.pod].hosts:
            queues.evacuate_pod(hid.pod)

    def pod_degraded(self, pod: int) -> None:
        """Graceful degradation: quarantine emptied ``pod``'s
        offerable set. Its hosts are still leased (so ``host_lost`` never
        fired), but nothing will serve the pod's queues until probation
        ends — evacuate them to the global FIFO queues now, the same
        re-bucketing an emptied pod gets, so queued work re-acquires
        whatever locality healthy pods can still offer."""
        self.scheduler.queues.evacuate_pod(pod)

    def replica_restored(self, shard_id, hid: HostId,
                         pod_covered: bool) -> None:
        """Re-replication: a repair copy landed on ``hid`` — re-patch
        the queue locality indexes so queued work regains locality."""
        self.scheduler.queues.replica_restored(shard_id, hid, pod_covered)

    def requeue_map_task(self, task: MapTask) -> None:
        """Re-execution of a map lost to churn. Routed through MQ_FIFO,
        which every assigner serves first — Hadoop's failed-task-first
        retry priority. The queue indexes the task against the shard's
        *surviving* replicas, so the re-run still prefers locality."""
        self.scheduler.queues.mq_fifo.append(task)

    def requeue_reduce_task(self, task: ReduceTask) -> None:
        """Re-execution of a reduce lost to churn, via RQ_FIFO (served
        first). The job's ready-mark set is extended to RQ_FIFO so gate
        notifications reach both the original bucket and the retry."""
        queues = self.scheduler.queues
        queues.rq_fifo.append(task)
        queues.register_reduce_queue(task.job_id, queues.rq_fifo)

    def map_work_in_pod(self, pod: int) -> bool:
        """O(1): could ``next_map_task`` yield work for a host of ``pod``?
        (Exactly the early-return gates of the assigner, so a False means
        every host of the pod would poll to None.)"""
        q = self.scheduler.queues
        return len(q.mq_fifo) > 0 or q.pods[pod].map_load.n > 0

    def reduce_work_in_pod(self, pod: int) -> bool:
        """O(1) per-pod reduce-backlog gate (readiness is still checked by
        the assigner; this only bounds no-op polling)."""
        q = self.scheduler.queues
        return len(q.rq_fifo) > 0 or q.pods[pod].red_load.n > 0

    def has_map_work(self) -> bool:
        """O(1): any queued-but-unassigned map task anywhere?"""
        return self.scheduler.queues.map_backlog.n > 0

    def has_ready_reduce(self) -> bool:
        """O(1): any queued reduce task at all? (readiness gating is the
        assigner's job; this bounds the simulator's polling)"""
        return self.scheduler.queues.red_backlog.n > 0

    def next_map_task(self, host: HostId) -> Optional[MapTask]:
        return self.assigner.next_map_task(host)

    def next_reduce_task(self, host: HostId,
                         ready: Callable[[ReduceTask], bool]
                         ) -> Optional[ReduceTask]:
        return self.assigner.next_reduce_task(host, ready)

    # -- introspection ------------------------------------------------------------
    @property
    def registry(self) -> FpRegistry:
        return self.scheduler.registry

    def plan_of(self, job: Job):
        rec = self.scheduler.records.get(job.job_id)
        return None if rec is None else rec.plan


class JossT(Joss):
    """JoSS-T: fast task assignment (TTA). Best JTT on small workloads."""

    name = "joss-t"
    assigner_cls = TTA


class JossJ(Joss):
    """JoSS-J: locality-maximizing assignment (JTA). Best WTT on mixed."""

    name = "joss-j"
    assigner_cls = JTA


def make_algorithm(name: str, cluster: VirtualCluster, **kw):
    """Factory covering the paper's five evaluated algorithms."""
    from repro_torch.core.baselines import (CapacityScheduler, FairScheduler,
                                      FifoScheduler)
    table = {
        "joss-t": JossT,
        "joss-j": JossJ,
        "fifo": FifoScheduler,
        "fair": FairScheduler,
        "capacity": CapacityScheduler,
    }
    if name not in table:
        raise ValueError(f"unknown algorithm {name!r}; "
                         f"choose from {sorted(table)}")
    return table[name](cluster, **kw)
