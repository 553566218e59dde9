"""The JoSS task scheduler (paper Fig. 4).

Receives submitted jobs, classifies them (unknown FP -> FIFO queues; else
policies A/B/C), and enqueues their tasks into the cluster queue structure.
The task *assigner* (TTA/JTA, assigners.py) later pulls tasks for idle slots.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.classifier import FpRegistry, JobClassifier
from repro_torch.core.job import Job, JobKind
from repro_torch.core.policies import (PlacementPlan, policy_a, policy_b, policy_c)
from repro_torch.core.queues import ClusterQueues, TaskQueue
from repro_torch.core.topology import VirtualCluster


@dataclasses.dataclass
class ScheduleRecord:
    """What the scheduler decided for one job (for metrics/tests)."""

    job: Job
    kind: JobKind
    plan: Optional[PlacementPlan]  # None for UNKNOWN (FIFO path)


class JossScheduler:
    """Implements Fig. 4: classify then enqueue.

    For UNKNOWN jobs (hash not in H), all tasks go to MQ_FIFO/RQ_FIFO and the
    assigner runs them under plain Hadoop-FIFO semantics; on completion the
    executor must call ``record_completion`` so FP is memoized.
    """

    def __init__(self, cluster: VirtualCluster,
                 registry: Optional[FpRegistry] = None,
                 td: Optional[float] = None):
        self.cluster = cluster
        self.registry = registry if registry is not None else FpRegistry()
        self.classifier = JobClassifier(cluster, self.registry, td=td)
        # the cluster handle enables the queues' per-host locality indexes
        self.queues = ClusterQueues(cluster)
        self.records: Dict[int, ScheduleRecord] = {}
        # task -> pod the scheduler planned it for (reduce placement etc.)
        self.planned_pod: Dict[object, int] = {}

    # -- Fig. 4 --------------------------------------------------------------
    def submit(self, job: Job) -> ScheduleRecord:
        kind = self.classifier.classify(job)
        if kind is JobKind.UNKNOWN:
            # lines 4-6: profile via FIFO queues
            self.queues.mq_fifo.extend(job.map_tasks)
            self.queues.rq_fifo.extend(job.reduce_tasks)
            self.queues.register_reduce_queue(job.job_id, self.queues.rq_fifo)
            rec = ScheduleRecord(job, kind, None)
        else:
            plan = self._plan(job, kind)
            self._enqueue(job, plan)
            rec = ScheduleRecord(job, kind, plan)
        self.records[job.job_id] = rec
        return rec

    def _plan(self, job: Job, kind: JobKind) -> PlacementPlan:
        if kind is JobKind.SMALL_RH:
            return policy_a(job, self.cluster, self.queues)
        if kind is JobKind.SMALL_MH:
            return policy_b(job, self.cluster, self.queues)
        return policy_c(job, self.cluster, self.queues)

    def _enqueue(self, job: Job, plan: PlacementPlan) -> None:
        by_pod: Dict[int, List] = {}
        for task, pod in zip(job.map_tasks, plan.map_assignment):
            by_pod.setdefault(pod, []).append(task)
            self.planned_pod[task.tid] = pod
        if plan.new_queues:  # policy C: fresh queues per (job, pod)
            for pod, tasks in by_pod.items():
                q = self.queues.pods[pod].new_map_queue()
                q.extend(tasks)
            rq = self.queues.pods[plan.reduce_pod].new_reduce_queue()
            rq.extend(job.reduce_tasks)
        else:  # policies A/B: permanent queues
            for pod, tasks in by_pod.items():
                self.queues.pods[pod].mq0.extend(tasks)
            rq = self.queues.pods[plan.reduce_pod].rq0
            rq.extend(job.reduce_tasks)
        self.queues.register_reduce_queue(job.job_id, rq)
        for t in job.reduce_tasks:
            self.planned_pod[t.tid] = plan.reduce_pod

    # -- FP feedback loop (Fig. 4 epilogue, §4.3) ------------------------------
    def record_completion(self, job: Job, measured_fp: float) -> None:
        """Memoize the measured average FP for this (code, input-type)."""
        self.registry.record(job, measured_fp)

    def gc(self) -> None:
        self.queues.gc()
