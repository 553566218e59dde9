"""Cluster runtime: heartbeats, failure detection, straggler mitigation,
elastic re-meshing. The control-plane twin of the JoSS scheduler (a copy
of ``repro/runtime/``: host code, no kernel)."""
from repro_torch.runtime.health import (HealthTracker, HostState,
                                        SpeculativeLauncher)
from repro_torch.runtime.elastic import ElasticPlan, plan_elastic_remesh

__all__ = ["HealthTracker", "HostState", "SpeculativeLauncher",
           "ElasticPlan", "plan_elastic_remesh"]
