"""JoSS placement policy B (paper §4.2, Fig. 4 lines 14-31), a copy of the
part of ``repro/core/policies.py`` the data pipeline runs: map tasks
follow their shards by the greedy unique-shard cover, reducers go to the
pod holding the most unique shards.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core.job import Job
from repro_torch.core.topology import VirtualCluster


@dataclasses.dataclass
class PlacementPlan:
    """Result of scheduling one job: pod assignment for every task.

    map_assignment[i] = pod that will run map task i.
    reduce_pod = pod that runs every reduce task of the job.
    new_queues = True iff policy C (fresh queues; avoids starving small jobs).
    """

    policy: str
    map_assignment: List[int]
    reduce_pod: int
    new_queues: bool

    def pods_used(self) -> List[int]:
        return sorted(set(self.map_assignment) | {self.reduce_pod})


def _greedy_cover(job: Job, cluster: VirtualCluster
                  ) -> Tuple[List[int], int]:
    """Greedy max-unique-shard cover (Fig. 4 lines 14-29, the Fig. 3 example).

    Repeatedly pick the pod holding the largest set of still-unscheduled
    unique shards of the job; assign those map tasks there. Map tasks whose
    shard has no replica anywhere go to the reduce pod.

    Returns (per-map-task pod assignment, reduce pod = pod holding the most
    unique shards overall, Fig. 4 line 30; only pods with hosts qualify).
    """
    remaining: Dict[int, set] = {c: set() for c in range(cluster.k)}
    known = set(cluster.shard_replicas)
    for s in set(job.shard_ids):
        if s in known:
            for c in cluster.replica_pods(s):
                remaining[c].add(s)

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

    for s in unassigned:
        shard_to_pod[s] = reduce_pod

    assignment = [shard_to_pod[t.shard_id] for t in job.map_tasks]
    return assignment, reduce_pod


def policy_b(job: Job, cluster: VirtualCluster) -> PlacementPlan:
    """Policy B (small MH): map tasks follow their shards; reducers follow
    the pod with the most unique shards. (The JAX signature also takes the
    cluster's queues, which policy B does not read.)"""
    assignment, reduce_pod = _greedy_cover(job, cluster)
    return PlacementPlan("B", assignment, reduce_pod, new_queues=False)
