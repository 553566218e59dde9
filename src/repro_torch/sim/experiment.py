"""End-to-end experiment harness: rebuilds identical cluster + workload per
algorithm (fixed seeds -> identical block placement and submission order,
the paper's fair-comparison methodology in §6) and runs the simulator.

Run the paper's §6 comparison (reduced by default; ``--full`` for the
exact 300/100-job workloads), three tables: the small workload on 2x15
VPS, the mixed workload, and the small workload on 4 pods x 64 hosts::

    PYTHONPATH=src python -m repro_torch.sim.experiment [--full]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.joss import make_algorithm
from repro_torch.sim.cluster_sim import SimConfig, SimResult, Simulator
from repro_torch.sim.metrics import Summary, summarize
from repro_torch.sim.workloads import (make_cluster, mixed_workload,
                                       profiling_prelude, small_workload)

ALGOS = ("joss-t", "joss-j", "fifo", "fair", "capacity")


def run_one(algo_name: str, workload: str = "small", *,
            hosts_per_pod: Sequence[int] = (15, 15), seed: int = 7,
            n_jobs: Optional[int] = None, config: Optional[SimConfig] = None,
            warm_registry: bool = True, replication: int = 1) -> SimResult:
    cluster = make_cluster(hosts_per_pod)
    if workload == "small":
        jobs = small_workload(cluster, seed=seed,
                              n_jobs=n_jobs or 300, replication=replication)
    elif workload == "mixed":
        jobs = mixed_workload(cluster, seed=seed, replication=replication)
    else:
        raise ValueError(f"unknown workload {workload!r}")
    algo = make_algorithm(algo_name, cluster)
    if warm_registry and hasattr(algo, "registry"):
        # steady state: H already holds each recurring job's hash (Fig. 4);
        # equivalently run `profiling_prelude` through the FIFO path first.
        for j in profiling_prelude(cluster):
            algo.registry.record(j, j.true_fp)
    t0 = time.perf_counter()
    res = Simulator(cluster, algo, jobs, config=config, seed=seed).run()
    res.scheduler_decision_time = time.perf_counter() - t0
    return res


def run_comparison(workload: str = "small", *,
                   algos: Sequence[str] = ALGOS,
                   hosts_per_pod: Sequence[int] = (15, 15), seed: int = 7,
                   n_jobs: Optional[int] = None,
                   config: Optional[SimConfig] = None,
                   replication: int = 1) -> Dict[str, Summary]:
    out: Dict[str, Summary] = {}
    for name in algos:
        res = run_one(name, workload, hosts_per_pod=hosts_per_pod, seed=seed,
                      n_jobs=n_jobs, config=config, replication=replication)
        out[name] = summarize(res)
    return out


def paper_tables(full: bool = False
                 ) -> List[Tuple[str, Dict[str, Summary]]]:
    """The three comparisons of the paper-experiment CLI, titled."""
    n_small = 300 if full else 60
    return [
        (f"small workload ({n_small} x 1GB jobs, 2x15 VPS; paper §6.1)",
         run_comparison("small", n_jobs=n_small)),
        ("mixed workload (100 jobs 1-12GB; paper §6.2)",
         run_comparison("mixed")),
        # beyond paper: a 4-pod, 256-host virtual cluster
        ("beyond-paper scale: 4 pods x 64 hosts",
         run_comparison("small", n_jobs=n_small,
                        hosts_per_pod=(64, 64, 64, 64))),
    ]


def table_row(s: Summary) -> Dict[str, float]:
    """One algorithm's row: INT GB, WTT, mean VPS- and off-centre map
    locality over the benchmarks, mean reduce locality, VPS load std."""
    ml = [s.map_locality[b] for b in s.map_locality]
    return {"int_gb": s.int_mb / 1024, "wtt": s.wtt,
            "vps_loc": float(np.mean([m.vps for m in ml])),
            "off_cen": float(np.mean([m.off_cen for m in ml])),
            "reduce_loc": float(np.mean(list(s.reduce_locality.values()))),
            "load_std": s.vps_load_std}


def format_table(title: str, res: Dict[str, Summary]) -> str:
    lines = [f"\n=== {title} ===",
             f"{'algo':10s} {'INT GB':>8s} {'WTT s':>8s} {'VPS-loc':>8s} "
             f"{'off-Cen':>8s} {'reduce-loc':>10s} {'load std':>9s}"]
    for a in res:
        r = table_row(res[a])
        lines.append(f"{a:10s} {r['int_gb']:8.1f} {r['wtt']:8.0f} "
                     f"{r['vps_loc']:8.2f} {r['off_cen']:8.2f} "
                     f"{r['reduce_loc']:10.2f} {r['load_std']:9.2f}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="exact paper workloads (300 + 100 jobs)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    for title, res in paper_tables(args.full):
        print(format_table(title, res))
    print(f"\n[wall {time.perf_counter() - t0:.2f} s]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
