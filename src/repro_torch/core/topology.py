"""Virtual-cluster topology, trimmed to what the serving router reads.

A copy of the shape half of ``repro/core/topology.py::VirtualCluster``: k
pods (the paper's k datacenters), each with its hosts (VPSs). Shard
placement, elasticity and the fabric stay with the scheduler's port.
"""
from __future__ import annotations

from typing import List, Sequence


class VirtualCluster:
    """A virtual MapReduce cluster of k pods (paper: k datacenters)."""

    def __init__(self, hosts_per_pod: Sequence[int]):
        if len(hosts_per_pod) < 1:
            raise ValueError("need at least one pod")
        for c, n in enumerate(hosts_per_pod):
            if n < 1:
                raise ValueError(f"pod {c} must have >= 1 host")
        self.hosts_per_pod: List[int] = list(hosts_per_pod)

    @property
    def k(self) -> int:
        """Number of pods (paper: k datacenters)."""
        return len(self.hosts_per_pod)

    @property
    def n_hosts(self) -> int:
        return sum(self.hosts_per_pod)
