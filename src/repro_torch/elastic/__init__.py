"""Elastic virtual-cluster subsystem.

The paper's tenant *rents* VPSs to form the virtual MapReduce cluster —
this package makes the fleet mutable: leases and rental-cost accounting
(``leases``), a deterministic churn event model for failures / spot
preemptions / lease expiries (``churn``), autoscaler policies driven by
the scheduler's O(1) backlog counters (``autoscaler``), and the engine that
glues them to the discrete-event simulator (``engine``).

(The training-side re-meshing planner, the JAX package's
``runtime/elastic.py``, is not part of this package; this package is the
scheduling/simulation side.)
"""
from repro_torch.elastic.autoscaler import (Autoscaler, BacklogThresholdScaler,
                                            CompactingScaler,
                                            CostCappedSpotScaler, FixedFleet,
                                            FleetObservation, ScaleDecision)
from repro_torch.elastic.churn import ChurnConfig, ChurnEvent, ChurnModel
from repro_torch.elastic.durability import (DurabilityConfig, DurabilityManager,
                                            DurabilitySubsystem,
                                            DurabilitySummary, RerepEvent)
from repro_torch.elastic.engine import (ElasticActions, ElasticEngine,
                                        ElasticSubsystem, ElasticSummary)
from repro_torch.elastic.leases import (ON_DEMAND, SPOT, Lease, LeaseBook,
                                        PriceSheet)
from repro_torch.elastic.migration import (MigrationConfig, MigrationSubsystem,
                                           MigrationSummary)

__all__ = [
    "Autoscaler", "BacklogThresholdScaler", "CompactingScaler",
    "CostCappedSpotScaler", "FixedFleet", "FleetObservation",
    "ScaleDecision",
    "ChurnConfig", "ChurnEvent", "ChurnModel",
    "DurabilityConfig", "DurabilityManager", "DurabilitySubsystem",
    "DurabilitySummary", "RerepEvent",
    "ElasticActions", "ElasticEngine", "ElasticSubsystem",
    "ElasticSummary",
    "MigrationConfig", "MigrationSubsystem", "MigrationSummary",
    "ON_DEMAND", "SPOT", "Lease", "LeaseBook", "PriceSheet",
]
