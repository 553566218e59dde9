"""Cluster model pieces the serving router and the data pipeline need:
the virtual cluster with shard placement, the job model and JoSS policy
B."""
from repro_torch.core.job import Job, MapTask
from repro_torch.core.policies import PlacementPlan, policy_b
from repro_torch.core.topology import (Host, HostId, Locality, Pod,
                                       VirtualCluster)

__all__ = ["Job", "MapTask", "PlacementPlan", "policy_b", "Host", "HostId",
           "Locality", "Pod", "VirtualCluster"]
