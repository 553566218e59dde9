"""Discrete-event simulator of a virtual MapReduce cluster (paper §6).

Validates the JoSS claims (map/reduce locality, INT, JTT/WTT, load balance)
against FIFO/Fair/Capacity at the paper's scale and beyond (k pods, many
hosts), without real VPSs. The same JoSS control-plane code that places
the training data pipeline's shards is exercised here.
"""
from repro_torch.sim.cluster_sim import SimConfig, SimResult, Simulator
from repro_torch.sim.engine import EventKernel, Subsystem
from repro_torch.sim.network import (FabricConfig, FabricSummary, NetworkFabric,
                               make_fabric)
from repro_torch.sim.workloads import (PAPER_BENCHMARKS, fabric_links,
                                 fabric_scenarios, make_cluster,
                                 mixed_workload, replication_scenarios,
                                 small_workload)
from repro_torch.sim.metrics import summarize

__all__ = ["SimConfig", "SimResult", "Simulator", "EventKernel",
           "Subsystem", "FabricConfig", "FabricSummary", "NetworkFabric",
           "make_fabric", "PAPER_BENCHMARKS", "fabric_links",
           "fabric_scenarios", "make_cluster", "mixed_workload",
           "replication_scenarios", "small_workload", "summarize"]
