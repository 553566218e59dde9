"""Elastic re-meshing: when pods join or leave, recompute the mesh and the
JoSS shard placement, and reshard the checkpointed state.

The policy follows the paper's job classification logic: the cluster's
N_avg_VPS changes with pod membership, so job classes (small vs large,
Eq. 4) and the td threshold (= k/(k-1), Eq. 8) are re-derived; all queued
placement plans are recomputed against the new topology. For training
state, resharding is checkpoint-mediated (restore with new shardings),
which is the production-safe path — no peer-to-peer state surgery.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.classifier import best_threshold
from repro_torch.core.topology import VirtualCluster


@dataclasses.dataclass
class ElasticPlan:
    """What changes when the pod set changes."""

    old_pods: Tuple[int, ...]
    new_pods: Tuple[int, ...]
    new_td: float
    new_n_avg: float
    mesh_shape: Tuple[int, ...]
    # data shards whose home pod disappeared -> new pod assignment
    orphan_reassignment: Dict[object, int]
    # whether global batch must shrink (lost data parallelism)
    batch_scale: float


def plan_elastic_remesh(cluster: VirtualCluster,
                        surviving_pods: Sequence[int],
                        shard_home: Dict[object, int],
                        *, model_parallel: int = 16) -> ElasticPlan:
    """Plan the transition to ``surviving_pods``.

    shard_home: data-shard id -> current home pod. Orphans (home pod dead)
    are reassigned round-robin over survivors, least-loaded first —
    exactly policy A's least-loaded choice applied to data placement.
    """
    old = tuple(p.index for p in cluster.pods)
    new = tuple(sorted(surviving_pods))
    if not new:
        raise ValueError("no surviving pods")
    k = len(new)
    # per-pod shard load among survivors
    load = {c: 0 for c in new}
    for s, home in shard_home.items():
        if home in load:
            load[home] += 1
    orphan: Dict[object, int] = {}
    for s, home in sorted(shard_home.items(), key=lambda kv: str(kv[0])):
        if home not in load:
            target = min(load, key=lambda c: (load[c], c))
            orphan[s] = target
            load[target] += 1
    hosts = sum(cluster.pods[c].n_hosts for c in new)
    data_parallel = max(1, hosts // model_parallel)
    return ElasticPlan(
        old_pods=old, new_pods=new,
        new_td=best_threshold(k) if k > 1 else float("inf"),
        new_n_avg=hosts / k,
        mesh_shape=(k, data_parallel // k if k and data_parallel >= k
                    else 1, model_parallel),
        orphan_reassignment=orphan,
        batch_scale=len(new) / max(len(old), 1))
