"""Virtual-cluster topology, from the tenant's perspective (paper §1, §4).

The paper's tenant sees only (VPS, datacenter). The adaptation sees only
(host/chip, pod): physical rack/switch layout inside a pod is opaque, exactly
as physical machines are opaque to the paper's tenant. Locality levels map as

    VPS-locality  -> host-local shard (no network)
    Cen-locality  -> intra-pod ICI
    off-Cen       -> inter-pod DCN

Elastic clusters: the tenant *rents* VPSs, so the fleet is mutable.
``add_host`` leases a fresh VPS into a pod (always under a brand-new index,
so a ``HostId`` is a permanent identity: once removed it never comes back)
and ``remove_host`` returns a leased VPS, dropping every shard replica that
lived on its local disk from the replica maps. A shard whose last replica
departs stays registered with an empty replica set — reads of it fall back
to off-pod (re-fetch from the durable external store), which is exactly how
HDFS under-replication degrades. A pod may become empty (zero hosts); it
stays in the pod list so pod indices remain stable, and placement helpers
(``active_pods``) let schedulers avoid routing work to hostless pods.
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

    @property
    def paper_name(self) -> str:
        return {"host": "VPS-locality", "pod": "Cen-locality",
                "off_pod": "off-Cen"}[self.value]


@dataclasses.dataclass(frozen=True)
class LinkCapacities:
    """Aggregate fabric capacities (MB/s) of the virtual cluster.

    The tenant-visible network is modelled as one uplink and one downlink
    per pod (everything its hosts send into / receive from the fabric,
    including pod-object-store traffic) plus a single shared WAN link that
    every inter-pod byte crosses. ``sim.network.NetworkFabric`` drains
    flows through these with max-min fair sharing; the per-stream rates of
    ``SimConfig`` (``pod_bw``/``dcn_bw``) remain the *per-flow* caps, so an
    uncontended fabric reproduces per-stream timing and contention only
    ever slows transfers down. Defaults approximate the paper's 15-VPS
    pods with a moderately oversubscribed WAN; benchmarks override them
    explicitly (``repro_torch.sim.workloads.fabric_links``).
    """

    pod_up: float = 1650.0    # per-pod aggregate uplink (15 x pod_bw)
    pod_down: float = 1650.0  # per-pod aggregate downlink
    wan: float = 525.0        # shared inter-pod capacity (15 x dcn_bw)

    def __post_init__(self):
        if min(self.pod_up, self.pod_down, self.wan) <= 0:
            raise ValueError("link capacities must be positive")


@dataclasses.dataclass(frozen=True)
class ElasticLinks:
    """Per-host NIC contributions for *elastic* fabric capacities.

    ``LinkCapacities`` is a fixed provisioning; on an elastic fleet every
    leased VPS physically brings its own NIC, so pod aggregate capacity
    should track the live host count. With ``FabricConfig.elastic`` set,
    the fabric derives ``pod_up/pod_down = host_up/host_down x live
    hosts`` at attach time and re-derives them in its ``on_host_added``/
    ``on_host_lost`` hooks, so scale-in/scale-out reshapes the fabric.
    ``wan_per_host > 0`` additionally scales the shared WAN with the
    *total* fleet size (tenant egress commitments often do); the default
    0 keeps ``LinkCapacities.wan`` fixed.

    Defaults match ``workloads.fabric_links``'s provisioning of two
    concurrent intra-pod streams per host (the 1+1 slot shape). A pod
    that loses its last host has capacity 0.0 — flows into it starve
    (rate 0, no completion armed) until a host joins again.
    """

    host_up: float = 220.0    # MB/s each live VPS adds to its pod uplink
    host_down: float = 220.0  # MB/s each live VPS adds to its pod downlink
    wan_per_host: float = 0.0  # 0 = keep LinkCapacities.wan fixed

    def __post_init__(self):
        if min(self.host_up, self.host_down) <= 0:
            raise ValueError("per-host link capacities must be positive")
        if self.wan_per_host < 0:
            raise ValueError("wan_per_host must be >= 0")


@dataclasses.dataclass(frozen=True)
class HostId:
    """Identifies one executor (paper: VPS_{c,l})."""

    pod: int    # datacenter index c
    index: int  # VPS index l within the datacenter

    def __post_init__(self):
        # HostIds key every hot dict/set in the dispatcher; the cached
        # value equals the generated dataclass hash (hash of the field
        # tuple), so set/dict behaviour is unchanged — it only skips
        # re-hashing a fresh tuple on each of the millions of lookups
        object.__setattr__(self, "_hash", hash((self.pod, self.index)))

    def __hash__(self) -> int:
        return self._hash

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"host[{self.pod},{self.index}]"


@dataclasses.dataclass
class Host:
    """One VPS: bounded concurrent map/reduce slots (paper §4 assumes 1+1)."""

    hid: HostId
    map_slots: int = 1
    reduce_slots: int = 1
    # shard ids whose replica lives on this host's local disk
    local_shards: set = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class Pod:
    """One datacenter cen_c of the virtual cluster.

    ``hosts`` holds the *live* hosts only; after removals, list position no
    longer equals ``HostId.index`` — look hosts up through the cluster.
    ``next_index`` is the lease counter: new hosts always get fresh indices.
    """

    index: int
    hosts: List[Host]
    next_index: int = 0

    @property
    def n_hosts(self) -> int:
        return len(self.hosts)


class VirtualCluster:
    """A virtual MapReduce cluster of k pods (paper: k datacenters, k > 1).

    Also models shard (block) placement: each shard has replicas on specific
    hosts, mirroring HDFS block replicas (paper §2).
    """

    def __init__(self, hosts_per_pod: Sequence[int], *, map_slots: int = 1,
                 reduce_slots: int = 1,
                 links: Optional[LinkCapacities] = None):
        if len(hosts_per_pod) < 1:
            raise ValueError("need at least one pod")
        # fabric capacities: per-pod uplink/downlink + shared WAN.
        # Only consulted when a run enables the contention-aware fabric
        # (``SimConfig.fabric``); per-stream runs never read them.
        self.links = links or LinkCapacities()
        self.pods: List[Pod] = []
        self._host_by_id: Dict[HostId, Host] = {}
        # construction-time slot shape: the default for leased hosts, so an
        # elastic fleet keeps uniform capacity as it churns
        self.default_map_slots = map_slots
        self.default_reduce_slots = reduce_slots
        for c, n in enumerate(hosts_per_pod):
            if n < 1:
                raise ValueError(f"pod {c} must have >= 1 host")
            hosts = [Host(HostId(c, l), map_slots, reduce_slots)
                     for l in range(n)]
            self.pods.append(Pod(c, hosts, next_index=n))
            for h in hosts:
                self._host_by_id[h.hid] = h
        # shard id -> list of HostId replicas
        self.shard_replicas: Dict[object, List[HostId]] = {}
        # precomputed shard -> replica-host set / replica-pod tuple indexes,
        # maintained by place_shard, so locality_of and the queue locality
        # indexes are O(1) lookups instead of list scans per judgement
        self._replica_host_set: Dict[object, frozenset] = {}
        self._replica_pods: Dict[object, Tuple[int, ...]] = {}

    # -- basic shape ---------------------------------------------------------
    @property
    def k(self) -> int:
        """Number of pods (paper: k datacenters)."""
        return len(self.pods)

    @property
    def n_hosts(self) -> int:
        return sum(p.n_hosts for p in self.pods)

    @property
    def n_avg_hosts(self) -> float:
        """N_avg_VPS = (sum_c N_VPS,c) / k (paper §4.1)."""
        return self.n_hosts / self.k

    def hosts(self) -> Iterator[Host]:
        for p in self.pods:
            yield from p.hosts

    def host(self, hid: HostId) -> Host:
        return self._host_by_id[hid]

    def has_host(self, hid: HostId) -> bool:
        return hid in self._host_by_id

    def active_pods(self) -> List[int]:
        """Pod indices that currently have at least one host."""
        return [p.index for p in self.pods if p.hosts]

    # -- elasticity: the fleet is rented, not fixed -------------------
    def add_host(self, pod: int, *, map_slots: Optional[int] = None,
                 reduce_slots: Optional[int] = None) -> Host:
        """Lease a fresh VPS into pod ``pod`` under a brand-new index.

        Indices are never reused, so a ``HostId`` seen once identifies the
        same VPS forever (departed hosts stay departed). Slot counts
        default to the cluster's construction-time shape, so churned-in
        replacements match the fleet's capacity.
        """
        p = self.pods[pod]
        h = Host(HostId(pod, p.next_index),
                 self.default_map_slots if map_slots is None else map_slots,
                 self.default_reduce_slots if reduce_slots is None
                 else reduce_slots)
        p.next_index += 1
        p.hosts.append(h)
        self._host_by_id[h.hid] = h
        return h

    def remove_host(self, hid: HostId) -> Host:
        """Return a leased VPS: drop it and every replica on its disk.

        Shards that lose their last replica remain registered with an empty
        replica set; reads of them degrade to off-pod (external re-fetch).
        The pod may end up empty — it stays in the pod list.
        """
        h = self._host_by_id.pop(hid)
        self.pods[hid.pod].hosts.remove(h)
        for sid in h.local_shards:
            reps = [r for r in self.shard_replicas[sid] if r != hid]
            self.shard_replicas[sid] = reps
            self._replica_host_set[sid] = frozenset(reps)
            self._replica_pods[sid] = tuple(sorted({r.pod for r in reps}))
        return h

    def add_replica(self, shard_id, hid: HostId) -> None:
        """Re-replication: register one more replica of a known shard
        on a live host, undoing the degradation ``remove_host`` caused.

        No-op if the host already holds the shard. The shard must have been
        placed before (its registration survives even total replica loss).
        """
        if hid in self._replica_host_set[shard_id]:
            return
        reps = self.shard_replicas[shard_id]
        reps.append(hid)
        self._replica_host_set[shard_id] = frozenset(reps)
        self._replica_pods[shard_id] = tuple(sorted({r.pod for r in reps}))
        self.host(hid).local_shards.add(shard_id)

    # -- shard placement -----------------------------------------------------
    def place_shard(self, shard_id, replicas: Sequence[HostId]) -> None:
        """Register a shard's replica locations (HDFS block placement)."""
        if not replicas:
            raise ValueError("a shard needs at least one replica")
        reps = list(replicas)
        self.shard_replicas[shard_id] = reps
        self._replica_host_set[shard_id] = frozenset(reps)
        self._replica_pods[shard_id] = tuple(sorted({h.pod for h in reps}))
        for hid in reps:
            self.host(hid).local_shards.add(shard_id)

    def replica_pods(self, shard_id) -> List[int]:
        """Pods holding at least one replica of shard_id."""
        return list(self._replica_pods[shard_id])

    def replica_hosts(self, shard_id) -> frozenset:
        """Replica host set of shard_id (empty for unknown shards)."""
        return self._replica_host_set.get(shard_id, frozenset())

    def pods_holding(self, shard_ids: Sequence) -> Dict[int, set]:
        """pod -> set of unique shards (paper: L_c, Fig. 4 line 14)."""
        out: Dict[int, set] = {p.index: set() for p in self.pods}
        for s in shard_ids:
            for c in self.replica_pods(s):
                out[c].add(s)
        return out

    # -- locality judgement --------------------------------------------------
    def locality_of(self, shard_id, hid: HostId) -> Locality:
        """Locality level of reading `shard_id` from host `hid` (paper §1)."""
        if hid in self._replica_host_set[shard_id]:
            return Locality.HOST
        if hid.pod in self._replica_pods[shard_id]:
            return Locality.POD
        return Locality.OFF_POD

    def nearest_replica(self, shard_id, hid: HostId) -> Tuple[HostId, Locality]:
        """Closest replica of shard_id as seen from host hid.

        A shard with no surviving replica (all holders departed) reads as
        ``(None, OFF_POD)``: the bytes must come from the external store.
        """
        if not self.shard_replicas[shard_id]:
            return None, Locality.OFF_POD
        best = None
        best_loc = None
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
        return best, best_loc
