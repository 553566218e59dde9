"""Virtual-cluster topology, from the tenant's perspective (paper §1, §4),
trimmed to what the serving router and the data pipeline read.

A copy of part of ``repro/core/topology.py``: k pods (the paper's k
datacenters), each with its hosts (VPSs), and shard (block) replicas on
specific hosts, as HDFS places them. Locality levels:

    VPS-locality  -> host-local shard (no network)
    Cen-locality  -> inside the pod
    off-Cen       -> between pods

Elasticity, re-replication and the fabric's link capacities stay with the
scheduler's port.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterator, List, Optional, Sequence, Tuple


class Locality(enum.Enum):
    """Data-locality levels visible to a tenant (paper §1)."""

    HOST = "host"        # paper: VPS-locality
    POD = "pod"          # paper: Cen-locality
    OFF_POD = "off_pod"  # paper: off-Cen


@dataclasses.dataclass(frozen=True)
class HostId:
    """Identifies one executor (paper: VPS_{c,l})."""

    pod: int    # datacenter index c
    index: int  # VPS index l within the datacenter


@dataclasses.dataclass
class Host:
    """One VPS; ``local_shards`` are the shards with a replica on its disk."""

    hid: HostId
    local_shards: set = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class Pod:
    """One datacenter cen_c of the virtual cluster."""

    index: int
    hosts: List[Host]

    @property
    def n_hosts(self) -> int:
        return len(self.hosts)


class VirtualCluster:
    """A virtual MapReduce cluster of k pods (paper: k datacenters), with
    each shard's replica hosts."""

    def __init__(self, hosts_per_pod: Sequence[int]):
        if len(hosts_per_pod) < 1:
            raise ValueError("need at least one pod")
        self.pods: List[Pod] = []
        self._host_by_id: Dict[HostId, Host] = {}
        for c, n in enumerate(hosts_per_pod):
            if n < 1:
                raise ValueError(f"pod {c} must have >= 1 host")
            hosts = [Host(HostId(c, i)) for i in range(n)]
            self.pods.append(Pod(c, hosts))
            for h in hosts:
                self._host_by_id[h.hid] = h
        # shard id -> list of HostId replicas, and the pods holding one
        self.shard_replicas: Dict[object, List[HostId]] = {}
        self._replica_pods: Dict[object, Tuple[int, ...]] = {}

    @property
    def k(self) -> int:
        """Number of pods (paper: k datacenters)."""
        return len(self.pods)

    @property
    def n_hosts(self) -> int:
        return sum(p.n_hosts for p in self.pods)

    def hosts(self) -> Iterator[Host]:
        for p in self.pods:
            yield from p.hosts

    def host(self, hid: HostId) -> Host:
        return self._host_by_id[hid]

    def place_shard(self, shard_id, replicas: Sequence[HostId]) -> None:
        """Register a shard's replica locations (HDFS block placement)."""
        if not replicas:
            raise ValueError("a shard needs at least one replica")
        reps = list(replicas)
        self.shard_replicas[shard_id] = reps
        self._replica_pods[shard_id] = tuple(sorted({h.pod for h in reps}))
        for hid in reps:
            self.host(hid).local_shards.add(shard_id)

    def replica_pods(self, shard_id) -> List[int]:
        """Pods holding at least one replica of shard_id."""
        return list(self._replica_pods[shard_id])

    def nearest_replica(self, shard_id, hid: HostId
                        ) -> Tuple[Optional[HostId], Locality]:
        """Closest replica of shard_id as seen from host hid; a shard with
        no replica reads as ``(None, OFF_POD)`` (the external store)."""
        best, best_loc = None, None
        order = {Locality.HOST: 0, Locality.POD: 1, Locality.OFF_POD: 2}
        for r in self.shard_replicas[shard_id]:
            if r == hid:
                loc = Locality.HOST
            elif r.pod == hid.pod:
                loc = Locality.POD
            else:
                loc = Locality.OFF_POD
            if best is None or order[loc] < order[best_loc]:
                best, best_loc = r, loc
        return best, best_loc or Locality.OFF_POD
