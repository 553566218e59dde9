"""Golden-trajectory anchor for simulator refactors.

The repo's discipline is that structural rework of the simulator must be
*bit-identical* in behaviour: the indexed dispatcher was proven against
the naive reference, and churn/durability-disabled runs against the
static simulator. Moving the whole event loop into the ``sim/engine.py``
kernel and adding the network fabric was anchored by a set of
**committed trajectory hashes** generated from the inline simulator
*before* that refactor (the JAX package's
``scripts/gen_golden_trajectories.py``). This module reads the same
committed file, so the port is held to the very same hashes.
A fabric-disabled run of the refactored engine must reproduce every one
of them exactly — every task placement, start/finish instant and byte
counter — across all five algorithms with churn and durability both off
and on.

The case matrix is deliberately small (a (4, 4) fleet, 12 jobs) so the
equivalence suite stays cheap enough for tier-1, while still driving
every subsystem seam: churn kill/requeue, shuffle-gate re-close,
re-replication events, checkpoint write/read routing, and speculative
backups.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

GOLDEN_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "tests", "golden",
    "sim_trajectories.json")

ALGOS = ("joss-t", "joss-j", "fifo", "fair", "capacity")

#: variant -> (churn on?, durability kwargs or None, sim-config kwargs)
VARIANTS: Dict[str, Tuple[bool, Optional[dict], dict]] = {
    # the paper's static testbed (no elastic engine at all)
    "static": (False, None, {}),
    # churny fleet: failures with replacement provisioning
    "churn": (True, None, {}),
    # durability with zero churn: checkpoint writes still reshape
    # every map duration, so this pins the ckpt arithmetic
    "durability": (False, dict(rereplicate=True, rerep_delay=20.0,
                               rerep_bandwidth=100.0, checkpoint=True), {}),
    # both channels live under churn: rerep events, store reads, gate math
    "churn+durability": (True, dict(rereplicate=True, rerep_delay=20.0,
                                    rerep_bandwidth=100.0,
                                    checkpoint=True), {}),
    # speculative execution against an injected straggler (static fleet)
    "speculative": (False, None, dict(speculative=True, slow_hosts="auto")),
}


def golden_cases() -> List[Tuple[str, str]]:
    return [(a, v) for v in VARIANTS for a in ALGOS]


def run_case(algo: str, variant: str, *, hosts_per_pod=(4, 4),
             n_jobs: int = 12, seed: int = 11, telemetry=None,
             subsystems=()):
    """One anchored run. Everything here must stay deterministic: the
    fleet, workload, churn seed and config shape are part of the anchor.

    Deliberately self-contained (no sharing with the bench harnesses):
    the committed hashes are only meaningful if this function never
    changes behind their back, so it must not inherit refactors of the
    bench setup code.

    ``telemetry``/``subsystems`` let observability tests attach a
    ``TelemetryConfig`` or extra hook-only subsystems to the *same*
    anchored run; both default off, so the committed hashes are what they
    always were — and a run with them on must hash identically (that is
    the claim being tested)."""
    from repro_torch.core.joss import make_algorithm
    from repro_torch.core.topology import HostId
    from repro_torch.elastic import (ChurnConfig, DurabilityConfig, ElasticEngine,
                                     FixedFleet)
    from repro_torch.sim.cluster_sim import SimConfig, Simulator
    from repro_torch.sim.workloads import (make_cluster, profiling_prelude,
                                           small_workload)

    churn_on, dur_kw, cfg_kw = VARIANTS[variant]
    cluster = make_cluster(hosts_per_pod)
    jobs = small_workload(cluster, seed=seed, n_jobs=n_jobs)
    a = make_algorithm(algo, cluster)
    if hasattr(a, "registry"):
        for j in profiling_prelude(cluster):
            a.registry.record(j, j.true_fp)
    cfg_kw = dict(cfg_kw)
    if cfg_kw.get("slow_hosts") == "auto":
        cfg_kw["slow_hosts"] = {HostId(0, 0): 4.0}
    if telemetry is not None:
        cfg_kw["telemetry"] = telemetry
    cfg = SimConfig(**cfg_kw)
    elastic = None
    if churn_on or dur_kw is not None:
        elastic = ElasticEngine(
            cluster,
            churn=(ChurnConfig(seed=seed + 1, fail_rate=1.0,
                               rejoin_delay=120.0) if churn_on else None),
            autoscaler=FixedFleet(),
            durability=(DurabilityConfig(**dur_kw)
                        if dur_kw is not None else None))
    return Simulator(cluster, a, jobs, config=cfg, seed=seed,
                     elastic=elastic, subsystems=subsystems).run()


def full_signature(res) -> tuple:
    """Every observable of a run: aggregates plus the complete task
    trajectory (placement, timing, per-log byte counters). Job ids are
    globally counted across runs, so they are remapped to submission
    order to make signatures comparable between processes."""
    idx = {j.job_id: i for i, j in enumerate(res.jobs)}
    return (
        res.wtt, res.int_bytes, res.pod_bytes,
        tuple(sorted((idx[j], t) for j, t in res.job_finish.items())),
        res.n_reexec, res.work_lost_mb, res.n_rerep, res.rerep_mb,
        res.ckpt_mb_written, res.ckpt_saved_mb,
        tuple(((log.task.tid[0], idx[log.task.tid[1]], *log.task.tid[2:]),
               (log.host.pod, log.host.index), log.start, log.finish,
               (log.locality.value if log.locality is not None else None),
               log.bytes_local, log.bytes_pod, log.bytes_offpod,
               log.speculative)
              for log in res.task_logs))


def signature_hash(res) -> str:
    """Stable digest of ``full_signature`` (float repr is exact, so two
    bit-identical runs hash equal and any drift flips the digest)."""
    return hashlib.sha256(repr(full_signature(res)).encode()).hexdigest()


def load_golden(path: str = GOLDEN_PATH) -> Dict[str, str]:
    with open(path) as f:
        return json.load(f)["hashes"]


def case_key(algo: str, variant: str) -> str:
    return f"{variant}/{algo}"
