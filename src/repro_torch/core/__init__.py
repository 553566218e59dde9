"""JoSS core: the paper's contribution as a composable library.

Public API:
  * VirtualCluster / Locality         - tenant-visible topology (pods, hosts)
  * Job / MapTask / ReduceTask        - job model
  * best_threshold, JobClassifier     - Eq. (3)/(4)/(8)
  * policy_a / policy_b / policy_c    - §4.2 placement policies
  * JossScheduler                     - Fig. 4
  * TTA / JTA                         - Figs. 5/6
  * JossT / JossJ / make_algorithm    - evaluated algorithm set (§6)
"""
from repro_torch.core.assigners import JTA, TTA
from repro_torch.core.baselines import (CapacityScheduler, FairScheduler,
                                  FifoScheduler)
from repro_torch.core.classifier import (FpRegistry, JobClassifier, best_threshold,
                                   classify_input_type,
                                   worst_case_traffic_mh,
                                   worst_case_traffic_rh)
from repro_torch.core.job import Job, JobKind, MapTask, ReduceTask, TaskState
from repro_torch.core.joss import Joss, JossJ, JossT, make_algorithm
from repro_torch.core.policies import PlacementPlan, policy_a, policy_b, policy_c
from repro_torch.core.queues import ClusterQueues
from repro_torch.core.scheduler import JossScheduler
from repro_torch.core.topology import Host, HostId, Locality, Pod, VirtualCluster

__all__ = [
    "JTA", "TTA", "CapacityScheduler", "FairScheduler", "FifoScheduler",
    "FpRegistry", "JobClassifier", "best_threshold", "classify_input_type",
    "worst_case_traffic_mh", "worst_case_traffic_rh", "Job", "JobKind",
    "MapTask", "ReduceTask", "TaskState", "Joss", "JossJ", "JossT",
    "make_algorithm", "PlacementPlan", "policy_a", "policy_b", "policy_c",
    "ClusterQueues", "JossScheduler", "Host", "HostId", "Locality", "Pod",
    "VirtualCluster",
]
