"""Paper workloads (§6, Tables 5-7) and cluster/topology builders.

Five benchmarks with the measured average filtering percentages of Table 5;
the small workload (300 x ~1 GB jobs, SWIM-like heavy-tailed arrivals with
mean 27.70 s / std 36.52 s) and the mixed workload (100 jobs of 1/5/12 GB,
Poisson arrivals with mean 42.26 s). Block size 128 MB, one replica per block
(paper §6), blocks placed uniformly at random over all hosts.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.job import Job
from repro_torch.core.topology import HostId, LinkCapacities, VirtualCluster

MB = 1.0  # all byte quantities in the sim are in MB
BLOCK_MB = 128.0


@dataclasses.dataclass(frozen=True)
class Benchmark:
    name: str
    fp: float          # Table 5 average filtering percentage
    input_type: str    # input-data classifier verdict


# paper Table 5
PAPER_BENCHMARKS: Dict[str, Benchmark] = {
    "WC": Benchmark("WC", 1.039, "web"),
    "SC": Benchmark("SC", 0.569, "web"),
    "II": Benchmark("II", 1.166, "web"),
    "Grep": Benchmark("Grep", 0.10, "web"),
    "Permu": Benchmark("Permu", 3.0, "non-web"),
}


def make_cluster(hosts_per_pod: Sequence[int] = (15, 15), *,
                 map_slots: int = 1, reduce_slots: int = 1,
                 links: Optional[LinkCapacities] = None) -> VirtualCluster:
    """Paper testbed: 2 datacenters (Dallas/Atlanta) x 15 VPS, 1+1 slots.
    ``links`` sets the fabric capacities for contention-aware runs."""
    return VirtualCluster(hosts_per_pod, map_slots=map_slots,
                          reduce_slots=reduce_slots, links=links)


def fabric_links(hosts_per_pod: Sequence[int], *, wan_oversub: float = 1.0,
                 pod_bw: float = 110.0, dcn_bw: float = 35.0
                 ) -> LinkCapacities:
    """Fabric capacities for an oversubscription sweep.

    Pod uplinks/downlinks are provisioned for every host of the largest
    pod running a map read AND a shuffle fetch at the intra-pod rate
    simultaneously (2 streams/host — the 1+1 slot shape — so pod links
    are never the experiment's bottleneck), while the shared WAN carries
    the fleet's peak inter-pod demand divided by ``wan_oversub``:

      * ``wan_oversub=1`` — congestion-free: every concurrent off-pod
        stream can run at ``dcn_bw``, reproducing per-stream timing;
      * ``wan_oversub=k`` — the WAN serves only 1/k of peak inter-pod
        demand, the classic oversubscribed-core datacenter shape. The
        more INT bytes an algorithm pushes, the more its transfers queue.
    """
    n = max(hosts_per_pod)
    total = sum(hosts_per_pod)
    return LinkCapacities(pod_up=2 * n * pod_bw, pod_down=2 * n * pod_bw,
                          wan=2 * total * dcn_bw / wan_oversub)


def fabric_scenarios(hosts_per_pod: Sequence[int]
                     ) -> Dict[str, LinkCapacities]:
    """Named WAN-oversubscription levels for fabric runs: the sweep the
    ``bench_fabric`` claim checks run over (JoSS's WTT margin over the
    baselines must *widen* as the shared WAN gets scarcer)."""
    return {
        "uncontended": fabric_links(hosts_per_pod, wan_oversub=1.0),
        "oversub8": fabric_links(hosts_per_pod, wan_oversub=8.0),
        "oversub24": fabric_links(hosts_per_pod, wan_oversub=24.0),
    }


def _place_blocks(cluster: VirtualCluster, job_tag: str, n_blocks: int,
                  rng: np.random.RandomState, replication: int = 1
                  ) -> List[str]:
    """Uniform random block placement (HDFS with the paper's 1 replica)."""
    all_hosts = [h.hid for h in cluster.hosts()]
    ids = []
    for b in range(n_blocks):
        sid = f"{job_tag}/B{b}"
        picks = rng.choice(len(all_hosts), size=min(replication,
                                                    len(all_hosts)),
                           replace=False)
        cluster.place_shard(sid, [all_hosts[int(p)] for p in picks])
        ids.append(sid)
    return ids


def _mk_job(cluster: VirtualCluster, bench: Benchmark, size_mb: float,
            submit_time: float, rng: np.random.RandomState,
            tag: str, replication: int = 1) -> Job:
    n_blocks = max(1, int(np.ceil(size_mb / BLOCK_MB)))
    ids = _place_blocks(cluster, tag, n_blocks, rng, replication)
    sizes = [BLOCK_MB] * n_blocks
    sizes[-1] = size_mb - BLOCK_MB * (n_blocks - 1)
    return Job(name=bench.name, code_key=bench.name,
               input_type=bench.input_type, shard_ids=ids,
               shard_bytes=[float(s) for s in sizes], n_reducers=1,
               true_fp=bench.fp, submit_time=submit_time)


def _swim_arrivals(n: int, mean: float, std: float,
                   rng: np.random.RandomState) -> np.ndarray:
    """SWIM-like heavy-tailed inter-arrival times matched to (mean, std)
    via a gamma distribution (Table 6: 27.70 s / 36.52 s)."""
    theta = std ** 2 / mean
    k = mean / theta
    return rng.gamma(k, theta, size=n)


def small_workload(cluster: VirtualCluster, seed: int = 7,
                   n_jobs: int = 300, replication: int = 1) -> List[Job]:
    """Table 6: 300 x ~1 GB jobs (60 WC / 59 SC / 59 II / 61 Grep / 61 Permu),
    each 8 map tasks, SWIM-like arrivals."""
    rng = np.random.RandomState(seed)
    counts = {"WC": 60, "SC": 59, "II": 59, "Grep": 61, "Permu": 61}
    scale = n_jobs / 300.0
    names: List[str] = []
    for b, c in counts.items():
        names += [b] * max(1, int(round(c * scale)))
    names = names[:n_jobs] if len(names) >= n_jobs else names + \
        ["WC"] * (n_jobs - len(names))
    rng.shuffle(names)
    gaps = _swim_arrivals(len(names), 27.70, 36.52, rng)
    t = np.cumsum(gaps)
    jobs = []
    for i, (name, ti) in enumerate(zip(names, t)):
        jobs.append(_mk_job(cluster, PAPER_BENCHMARKS[name], 1024.0,
                            float(ti), rng, tag=f"small{i}",
                            replication=replication))
    return jobs


def mixed_workload(cluster: VirtualCluster, seed: int = 11,
                   replication: int = 1) -> List[Job]:
    """Table 7: 64 x 1 GB (26 WC, 20 II, 10 SC, 5 Grep, 3 Permu),
    19 x 5 GB Permu, 17 x 12 GB (6 WC, 11 II); Poisson arrivals mean 42.26 s."""
    rng = np.random.RandomState(seed)
    spec = ([("WC", 1)] * 26 + [("II", 1)] * 20 + [("SC", 1)] * 10
            + [("Grep", 1)] * 5 + [("Permu", 1)] * 3
            + [("Permu", 5)] * 19
            + [("WC", 12)] * 6 + [("II", 12)] * 11)
    rng.shuffle(spec)
    gaps = rng.exponential(42.26, size=len(spec))
    t = np.cumsum(gaps)
    jobs = []
    for i, ((name, gb), ti) in enumerate(zip(spec, t)):
        jobs.append(_mk_job(cluster, PAPER_BENCHMARKS[name], gb * 1024.0,
                            float(ti), rng, tag=f"mixed{i}",
                            replication=replication))
    return jobs


def churn_scenarios() -> Dict[str, dict]:
    """Named churn scenarios for elastic-cluster runs: kwargs for
    ``repro_torch.elastic.ChurnConfig`` (minus the seed, which callers supply so
    scenario and replica seeds stay independent).

      * ``stable``  — no churn at all: the paper's static testbed. With a
        fixed fleet this must be bit-identical to the static simulator.
      * ``flaky``   — permanent VPS failures at 1/host-hour with 2-minute
        replacement provisioning (provider-maintained fleet size).
      * ``spot``    — 40% of the fleet on spot leases, preempted at
        1.5/spot-host-hour, never replaced (the tenant rides it out).
      * ``lease``   — 20-minute lease terms; expiry is a renewal decision
        point for the autoscaler (rolling rentals, staggered start).
    """
    return {
        "stable": dict(),
        "flaky": dict(fail_rate=1.0, rejoin_delay=120.0),
        "spot": dict(spot_fraction=0.4, spot_preempt_rate=1.5),
        "lease": dict(lease_term=1200.0),
    }


def durability_scenarios() -> Dict[str, Optional[dict]]:
    """Named durability modes for elastic-cluster runs: kwargs for
    ``repro_torch.elastic.DurabilityConfig`` (None = no config attached at all).

      * ``off``   — churn-only behaviour: departed replicas stay gone, lost map
        outputs force re-execution with shuffle-gate re-close.
      * ``rerep`` — delayed HDFS-style re-replication: orphaned shards are
        re-created on surviving hosts after a short detection delay,
        draining through a bandwidth budget, so re-executed and queued
        maps regain node/pod locality.
      * ``ckpt``  — off-host shuffle checkpointing: map outputs persist to
        the pod object store (synchronous write), so host loss destroys
        no finished work — at a write-time + store-read-bandwidth price.
      * ``full``  — both channels.
    """
    rerep = dict(rereplicate=True, rerep_delay=20.0, rerep_bandwidth=100.0)
    ckpt = dict(checkpoint=True)
    return {
        "off": None,
        "rerep": dict(rerep),
        "ckpt": dict(ckpt),
        "full": dict(**rerep, **ckpt),
    }


def migration_scenarios() -> Dict[str, dict]:
    """Chaos sweep for the migration subsystem: spot-heavy churn
    kwargs for ``repro_torch.elastic.ChurnConfig``, crossing the provider's
    notice window (0 s = today's kill-cold behaviour, 30 s = typical
    spot reclaim warning, 120 s = lease-style advance notice) with the
    preemption rate (low = occasional reclaim, high = hostile market).
    The robustness envelope — how much work survives as warning shrinks
    and pressure grows — is a first-class benchmark axis."""
    out: Dict[str, dict] = {}
    for wname, window in (("notice0", 0.0), ("notice30", 30.0),
                          ("notice120", 120.0)):
        for rname, rate in (("low", 3.0), ("high", 8.0)):
            out[f"{wname}_{rname}"] = dict(
                spot_fraction=0.4, spot_preempt_rate=rate,
                preempt_notice=window, expire_notice=window)
    return out


def chaos_scenarios() -> Dict[str, dict]:
    """Named fault campaigns for the chaos layer: kwargs for
    ``repro_torch.chaos.ChaosConfig`` (minus the seed, which callers supply so
    campaign and workload seeds stay independent).

      * ``calm``     — no injections at all: an attached-but-empty chaos
        subsystem, which must be bit-identical to running without one.
      * ``gray``     — partial failures only: slowdown ramps, disk-slow
        episodes and one hung task; nothing fail-stop ever fires.
      * ``outages``  — two correlated pod-scoped outages (gray prodrome,
        whole-pod kill, later rejoin) — the co-tenant/rack failure mode
        independent per-host churn cannot express.
      * ``hostile``  — the bench_chaos gate campaign: outages plus gray/
        disk episodes and hung tasks, the mix the timeout+quarantine
        response loop is claimed to beat detection-off under.
      * ``partition``— fabric faults: link derating and a full pod
        partition (per-stream runs log-and-skip these).
    """
    return {
        "calm": dict(),
        "gray": dict(n_gray=2, gray_factor=6.0, n_disk=1, n_hung=1,
                     horizon=1200.0),
        "outages": dict(n_outages=2, outage_gray_s=240.0,
                        outage_gray_factor=6.0, horizon=1200.0),
        "hostile": dict(n_outages=2, outage_gray_s=240.0,
                        outage_gray_factor=6.0, n_gray=1, gray_factor=6.0,
                        n_disk=1, n_hung=2, horizon=1200.0),
        "partition": dict(n_link=2, link_factor=0.25, link_s=120.0,
                          n_partition=1, partition_s=45.0, horizon=1200.0),
    }


def replication_scenarios() -> Dict[str, int]:
    """Replication factors for the durability-vs-storage sweep. The paper runs 1 replica per block; HDFS defaults to 3.
    More replicas mean fewer shards orphaned per departing disk (less
    repair traffic on the fabric, better retry locality) at the price of
    replicated storage — ``bench_elastic`` sweeps these against the
    re-replication pipeline."""
    return {"r1": 1, "r2": 2, "r3": 3}


def profiling_prelude(cluster: VirtualCluster, seed: int = 3) -> List[Job]:
    """One tiny job per (benchmark, input-type) submitted ahead of a workload
    so JoSS's FP registry is warm (the paper's steady state, where H already
    contains the hash of every recurring job)."""
    rng = np.random.RandomState(seed)
    jobs = []
    for i, bench in enumerate(PAPER_BENCHMARKS.values()):
        jobs.append(_mk_job(cluster, bench, 2 * BLOCK_MB, float(i),
                            rng, tag=f"prelude{i}"))
    return jobs
