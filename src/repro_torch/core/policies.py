"""JoSS scheduling policies A, B, C (paper §4.2) and the task scheduler's
placement computation (Fig. 4 lines 14-31).

Placement is expressed as a pure function cluster-state -> plan so the same
code drives both the discrete-event simulator and the real data pipeline
(shard->pod assignment for the training batches).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.job import Job
from repro_torch.core.queues import ClusterQueues
from repro_torch.core.topology import VirtualCluster


@dataclasses.dataclass
class PlacementPlan:
    """Result of scheduling one job: pod assignment for every task.

    map_assignment[i] = pod that will run map task i (and, where possible, the
    shard replica it should read — the assigner refines host-level choice).
    reduce_pod = pod that runs every reduce task of the job.
    new_queues = True iff policy C (fresh queues; avoids starving small jobs).
    """

    policy: str
    map_assignment: List[int]
    reduce_pod: int
    new_queues: bool

    def pods_used(self) -> List[int]:
        return sorted(set(self.map_assignment) | {self.reduce_pod})


def policy_a(job: Job, cluster: VirtualCluster,
             queues: ClusterQueues) -> PlacementPlan:
    """Policy A (small RH): everything to the least-loaded pod cen_w.

    Reducers then shuffle entirely inside one pod: reduce-data locality = 1.
    """
    w = queues.least_loaded_pod()
    return PlacementPlan("A", [w] * job.m, w, new_queues=False)


def _greedy_cover(job: Job, cluster: VirtualCluster
                  ) -> Tuple[List[int], int]:
    """Greedy max-unique-shard cover (Fig. 4 lines 14-29, the Fig. 3 example).

    Repeatedly pick the pod holding the largest set of still-unscheduled
    unique shards of the job; assign those map tasks there. Map tasks whose
    shard has no replica anywhere (possible in a degraded cluster) fall back
    to the pod with most of the job's shards.

    Returns (per-map-task pod assignment, reduce pod = pod holding the most
    unique shards overall, Fig. 4 line 30).
    """
    # L_c: unique shards of the job held by pod c
    remaining: Dict[int, set] = {c: set() for c in range(cluster.k)}
    known = set(cluster.shard_replicas)
    for s in set(job.shard_ids):
        if s in known:
            for c in cluster.replica_pods(s):
                remaining[c].add(s)

    # reduce pod: holds the max unique shards of J *before* deletion.
    # Candidates are restricted to pods that still have hosts (elastic
    # clusters): a replica can only live on a live host, so the greedy
    # loop below never picks a hostless pod, but the reduce pod and the
    # replica-less fallback would otherwise strand tasks in an empty pod
    # forever when the job's shards lost every replica to churn.
    active = [c for c in remaining if cluster.pods[c].hosts] \
        or list(remaining)
    reduce_pod = max(active, key=lambda c: (len(remaining[c]), -c))

    shard_to_pod: Dict[object, int] = {}
    unassigned = set(job.shard_ids)
    while any(remaining.values()):
        # first largest set L_d (ties -> lowest pod id, 'first' in the paper)
        d = max(remaining, key=lambda c: (len(remaining[c]), -c))
        for s in remaining[d]:
            shard_to_pod[s] = d
            unassigned.discard(s)
        taken = remaining[d]
        remaining = {c: (v - taken if c != d else set())
                     for c, v in remaining.items()}

    # replica-less shards: send to the reduce pod (best proximity to peers)
    for s in unassigned:
        shard_to_pod[s] = reduce_pod

    assignment = [shard_to_pod[t.shard_id] for t in job.map_tasks]
    return assignment, reduce_pod


def policy_b(job: Job, cluster: VirtualCluster,
             queues: Optional[ClusterQueues] = None) -> PlacementPlan:
    """Policy B (small MH): map tasks follow their shards; reducers follow
    the pod with the most unique shards. Policy B reads no queue, so the
    data pipeline calls it without one."""
    assignment, reduce_pod = _greedy_cover(job, cluster)
    return PlacementPlan("B", assignment, reduce_pod, new_queues=False)


def policy_c(job: Job, cluster: VirtualCluster,
             queues: ClusterQueues) -> PlacementPlan:
    """Policy C (large): same placement as B, but into fresh queues so the
    round-robin assigner interleaves large jobs with small ones."""
    assignment, reduce_pod = _greedy_cover(job, cluster)
    return PlacementPlan("C", assignment, reduce_pod, new_queues=True)
