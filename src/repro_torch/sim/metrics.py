"""Metrics of paper §6.1/§6.2: map-data locality (Eqs. 9-11), reduce-data
locality, INT, JTT (+ normalized, Table 8), WTT, VPS load (Tables 9-10),
cumulative completion (Fig. 15). Elastic runs additionally report
the tenant's rental economics: VPS-hours, dollar cost, churn-lost work
(MB of finished map output destroyed with departed disks) and the task
re-execution count."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.job import MapTask
from repro_torch.core.topology import Locality
from repro_torch.sim.cluster_sim import SimResult


@dataclasses.dataclass
class LocalityRates:
    vps: float      # Eq. (9)
    cen: float      # Eq. (10)
    off_cen: float  # Eq. (11)


@dataclasses.dataclass
class Summary:
    algorithm: str
    map_locality: Dict[str, LocalityRates]          # per benchmark
    reduce_locality: Dict[str, float]               # per benchmark
    int_mb: float
    avg_jtt: Dict[str, float]                       # per benchmark
    wtt: float
    vps_load_mean: float
    vps_load_std: float
    completion_curve: List[Tuple[float, float]]     # (time, fraction done)
    # -- elastic-cluster outputs (zero for static runs) ----------------------
    vps_hours: float = 0.0
    cost_dollars: float = 0.0
    work_lost_mb: float = 0.0
    n_reexec: int = 0
    n_host_adds: int = 0
    n_host_losses: int = 0
    # -- durability outputs (zero without a durability config) ---------
    n_rerep: int = 0
    rerep_mb: float = 0.0
    ckpt_mb_written: float = 0.0
    ckpt_saved_mb: float = 0.0
    storage_dollars: float = 0.0
    #: locality of re-executed maps (churn retries; excludes speculative
    #: twins) — the rate re-replication exists to raise. None when the run
    #: had no re-executed maps.
    reexec_map_locality: Optional[float] = None
    # -- fabric outputs (zero for per-stream runs) ---------------------
    fabric_mb: float = 0.0        # MB drained through the shared fabric
    fabric_stall_s: float = 0.0   # transfer time lost to link contention
    wan_util: float = 0.0         # mean shared-WAN utilization
    #: per-traffic-kind fabric breakdown: kind -> (n_flows, mb, stall_s),
    #: straight from ``FabricSummary.by_kind``. Empty without a
    #: fabric.
    fabric_by_kind: Dict[str, Tuple[int, float, float]] = \
        dataclasses.field(default_factory=dict)
    # -- migration outputs (zero without the subsystem) ----------------
    n_migrated: int = 0           # tasks restored from shipped state
    migrate_mb: float = 0.0       # migration state traffic (MB)
    n_mig_aborted: int = 0        # transfers abandoned (races, lost hosts)
    # -- chaos outputs (zero without the chaos layer) -----------------
    n_chaos_events: int = 0       # primary campaign injections applied
    n_hung: int = 0               # hung-task injections
    n_timeouts: int = 0           # attempts killed by progress timeout
    n_quarantined: int = 0        # hosts sent to quarantine
    n_surfaced: int = 0           # pairs escalated to job-level failures


def _bench_of(log) -> str:
    return log.job.name


def reexec_map_stats(res: SimResult) -> Tuple[int, int]:
    """(re-executed maps, of which node/pod local) for a run.

    Churn retries only: speculative twins share the attempt counter, so
    ``attempt > 0`` alone would overcount — the ``speculative`` log flag
    excludes them, and so does ``migrated`` (a restored attempt
    resumed partway, it did not re-execute). The single source of truth
    for this predicate (the elastic bench and
    ``Summary.reexec_map_locality`` both use it)."""
    n = loc = 0
    for log in res.task_logs:
        t = log.task
        if (not isinstance(t, MapTask) or t.attempt == 0
                or log.speculative or log.migrated):
            continue
        n += 1
        if log.locality is not Locality.OFF_POD:
            loc += 1
    return n, loc


def summarize(res: SimResult, *, benchmarks: Optional[List[str]] = None
              ) -> Summary:
    maps = [l for l in res.task_logs if isinstance(l.task, MapTask)]
    reds = [l for l in res.task_logs if not isinstance(l.task, MapTask)]
    names = benchmarks or sorted({_bench_of(l) for l in res.task_logs})

    map_loc: Dict[str, LocalityRates] = {}
    for b in names:
        ls = [l for l in maps if _bench_of(l) == b]
        if not ls:
            # no maps ran for this benchmark (zero finished jobs / empty
            # logs): all-zero rates, not a phantom 100% off-pod share
            map_loc[b] = LocalityRates(0.0, 0.0, 0.0)
            continue
        n = len(ls)
        v = sum(1 for l in ls if l.locality is Locality.HOST) / n
        c = sum(1 for l in ls if l.locality is Locality.POD) / n
        map_loc[b] = LocalityRates(v, c, max(0.0, 1.0 - v - c))

    red_loc: Dict[str, float] = {}
    for b in names:
        ls = [l for l in reds if _bench_of(l) == b]
        tot = sum(l.bytes_local + l.bytes_pod + l.bytes_offpod for l in ls)
        loc = sum(l.bytes_local + l.bytes_pod for l in ls)
        red_loc[b] = loc / tot if tot > 0 else 1.0

    jtt: Dict[str, float] = {}
    for b in names:
        js = [j for j in res.jobs if j.name == b
              and j.job_id in res.job_finish]
        jtt[b] = (float(np.mean([res.jtt(j) for j in js])) if js else 0.0)

    per_host: Dict[object, int] = {}
    for l in maps:
        per_host[l.host] = per_host.get(l.host, 0) + 1
    loads = np.array(list(per_host.values()), dtype=float)

    finishes = sorted(res.job_finish.values())
    n_jobs = max(1, len(res.job_finish))
    curve = [(t, (i + 1) / n_jobs) for i, t in enumerate(finishes)]

    n_re, n_re_loc = reexec_map_stats(res)
    reexec_loc = n_re_loc / n_re if n_re else None

    return Summary(
        algorithm=res.algorithm, map_locality=map_loc,
        reduce_locality=red_loc, int_mb=res.int_bytes, avg_jtt=jtt,
        wtt=res.wtt,
        vps_load_mean=float(loads.mean()) if loads.size else 0.0,
        vps_load_std=float(loads.std(ddof=0)) if loads.size else 0.0,
        completion_curve=curve,
        vps_hours=res.vps_hours, cost_dollars=res.cost_dollars,
        work_lost_mb=res.work_lost_mb, n_reexec=res.n_reexec,
        n_host_adds=res.n_host_adds, n_host_losses=res.n_host_losses,
        n_rerep=res.n_rerep, rerep_mb=res.rerep_mb,
        ckpt_mb_written=res.ckpt_mb_written,
        ckpt_saved_mb=res.ckpt_saved_mb,
        storage_dollars=res.storage_dollars,
        reexec_map_locality=reexec_loc,
        fabric_mb=res.fabric_mb, fabric_stall_s=res.fabric_stall_s,
        wan_util=res.wan_util,
        fabric_by_kind={k: (int(v[0]), float(v[1]), float(v[2]))
                        for k, v in getattr(res.fabric, "by_kind", {}).items()}
        if res.fabric is not None else {},
        n_migrated=res.n_migrated, migrate_mb=res.migrate_mb,
        n_mig_aborted=res.n_mig_aborted,
        n_chaos_events=res.n_chaos_events, n_hung=res.n_hung,
        n_timeouts=res.n_timeouts, n_quarantined=res.n_quarantined,
        n_surfaced=res.n_surfaced)


def normalized_jtt(summaries: List[Summary], reference: str = "joss-t"
                   ) -> Dict[str, Dict[str, float]]:
    """Table 8: JTT of each algorithm normalized to the reference.

    Degenerate inputs are well-defined rather than fatal: an empty
    summary list returns ``{}``; a missing reference algorithm falls back
    to the first summary; a reference benchmark whose JTT is zero (no
    finished jobs under the reference) yields a 0.0 ratio."""
    ref = next((s for s in summaries if s.algorithm == reference), None)
    if ref is None:
        if not summaries:
            return {}
        ref = summaries[0]
    out: Dict[str, Dict[str, float]] = {}
    for s in summaries:
        out[s.algorithm] = {
            b: (s.avg_jtt[b] / ref.avg_jtt[b] if ref.avg_jtt.get(b) else 0.0)
            for b in s.avg_jtt}
    return out
