"""Sweep cells: one (algorithm x scenario x seed) simulation point.

A :class:`CellSpec` is a pure value — picklable, JSON-canonical, and the
*only* input a cell needs. Everything random about a cell is re-derived
from the spec itself: ``sim_seed`` is a sha256 of the canonical cell key,
so the trajectory a cell produces is a function of the spec and nothing
else — not the worker pool's inherited RNG state, not the submission
order, not the process or the lane of the lockstep gang it runs in. Keys
and seeds are those of the JAX package's cells, so the same spec names
the same simulation in both. (The engine's workers additionally *poison*
their global RNGs at start so any accidental dependence on inherited
streams would show up as a determinism failure, not a silent bias.)

Families registered here:

  * ``fabric_contention`` — the bench_fabric contention matrix: burst
    small workload through the contention-aware fabric at a named WAN
    oversubscription level;
  * ``elastic_churn`` — the bench_elastic sweep cell: an elastic fleet
    under a named churn scenario with its autoscaler;
  * ``chaos`` — the bench_chaos A/B cell: a named fault campaign with the
    detection/response loop on or off;
  * ``selftest`` — engine-robustness probes that crash or hang the
    worker process on purpose. Built in (not test-local) because spawned
    workers import this module fresh and must be able to resolve the
    family without conftest side effects.

A cell returns a flat ``{metric: value}`` dict — every scalar field of
``repro_torch.sim.metrics.Summary`` plus bookkeeping — which is what the
content-addressed store persists and the aggregation layer consumes.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, Sequence, Tuple

from repro_torch.sweep.stats import stable_hash

#: named WAN-oversubscription levels of the fabric contention matrix
#: (mirrors ``repro_torch.sim.workloads.fabric_scenarios``)
WAN_OVERSUB = {"uncontended": 1.0, "oversub8": 8.0, "oversub24": 24.0}


def _canon(value: Any) -> Any:
    """JSON-canonical form of a param value (tuples become lists)."""
    if isinstance(value, (tuple, list)):
        return [_canon(v) for v in value]
    return value


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One sweep cell. ``seed`` is the *replica index* within the
    matrix; the simulation seed is derived from the whole key (see
    :meth:`sim_seed`), so replica 3 of one scenario shares nothing with
    replica 3 of another."""

    family: str
    algo: str
    scenario: str
    seed: int
    params: Tuple[Tuple[str, Any], ...] = ()

    def key(self) -> str:
        """Canonical JSON cell key — the cache/content address and the
        root of every RNG stream the cell uses."""
        return json.dumps(
            {"family": self.family, "algo": self.algo,
             "scenario": self.scenario, "seed": self.seed,
             "params": {k: _canon(v) for k, v in self.params}},
            sort_keys=True, separators=(",", ":"))

    def sim_seed(self) -> int:
        """Simulation seed, re-derived from the cell key (sha256) —
        never from pool or global RNG state."""
        return stable_hash(self.key()) % (2 ** 31 - 1)

    def param(self, name: str, default: Any = None) -> Any:
        for k, v in self.params:
            if k == name:
                return v
        return default

    @staticmethod
    def from_key(key: str) -> "CellSpec":
        d = json.loads(key)
        params = tuple(sorted(
            (k, tuple(v) if isinstance(v, list) else v)
            for k, v in d["params"].items()))
        return CellSpec(d["family"], d["algo"], d["scenario"],
                        d["seed"], params)


def make_params(**kw: Any) -> Tuple[Tuple[str, Any], ...]:
    """Sorted param tuple for a :class:`CellSpec` (dict order never
    leaks into the cell key)."""
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in kw.items()))


def matrix(family: str, algos: Sequence[str], scenarios: Sequence[str],
           n_seeds: int, **params: Any) -> list:
    """The full (algorithm x scenario x seed) cell list of a sweep."""
    p = make_params(**params)
    return [CellSpec(family, a, s, i, p)
            for a in algos for s in scenarios for i in range(n_seeds)]


def summary_metrics(res) -> Dict[str, float]:
    """Flatten a run into the metric dict a cell returns: every scalar
    (int/float) field of ``repro_torch.sim.metrics.Summary``, skipping the
    per-benchmark breakdowns and ``None`` optionals."""
    from repro_torch.sim.metrics import Summary, summarize
    s = summarize(res)
    out: Dict[str, float] = {}
    for f in dataclasses.fields(Summary):
        v = getattr(s, f.name)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        out[f.name] = float(v)
    out["n_jobs_finished"] = float(len(res.job_finish))
    if res.fabric is not None:
        out["n_flows"] = float(res.fabric.n_flows)
    return out


def _warm_registry(algo, cluster) -> None:
    from repro_torch.sim.workloads import profiling_prelude
    if hasattr(algo, "registry"):
        for j in profiling_prelude(cluster):
            algo.registry.record(j, j.true_fp)


def build_fabric_contention(spec: CellSpec):
    """Construct the ``fabric_contention`` cell without running it:
    returns ``(sim, finish)`` where ``sim`` is the ready-to-run
    :class:`Simulator` and ``finish(res)`` turns its result into the
    cell's metric dict. ``_fabric_contention_cell`` is exactly
    ``build(...)`` + ``sim.run()`` + ``finish(...)``; the lockstep
    executor uses the same builder but drives ``sim`` through
    the resumable ``begin/step/finish`` protocol instead."""
    from repro_torch.core.joss import make_algorithm
    from repro_torch.sim.cluster_sim import SimConfig, Simulator
    from repro_torch.sim.network import FabricConfig
    from repro_torch.sim.workloads import (fabric_links, make_cluster,
                                     small_workload)
    hosts_per_pod = tuple(spec.param("hosts_per_pod", (8, 8)))
    n_jobs = int(spec.param("n_jobs", 12))
    oversub = float(spec.param("wan_oversub",
                               WAN_OVERSUB.get(spec.scenario, 1.0)))
    seed = spec.sim_seed()
    links = fabric_links(hosts_per_pod, wan_oversub=oversub)
    cluster = make_cluster(hosts_per_pod, links=links)
    jobs = small_workload(cluster, seed=seed, n_jobs=n_jobs)
    if spec.param("burst", True):
        for j in jobs:
            j.submit_time = 0.0
    algo = make_algorithm(spec.algo, cluster)
    _warm_registry(algo, cluster)
    cfg = SimConfig(fabric=FabricConfig(completion_log=False))
    sim = Simulator(cluster, algo, jobs, config=cfg, seed=seed)

    def finish(res) -> Dict[str, float]:
        assert len(res.job_finish) == n_jobs, \
            f"{spec.algo}/{spec.scenario}#{spec.seed}: " \
            f"{len(res.job_finish)}/{n_jobs} jobs finished"
        return summary_metrics(res)

    return sim, finish


def _fabric_contention_cell(spec: CellSpec) -> Dict[str, float]:
    """Burst small workload through the contention-aware fabric at the
    scenario's WAN-oversubscription level (the bench_fabric contention
    cell, parameterized by seed)."""
    sim, finish = build_fabric_contention(spec)
    return finish(sim.run())


def _elastic_churn_cell(spec: CellSpec) -> Dict[str, float]:
    """Elastic fleet under a named churn scenario with the
    scenario-appropriate autoscaler (the bench_elastic sweep cell,
    parameterized by seed)."""
    from repro_torch.core.joss import make_algorithm
    from repro_torch.elastic import (BacklogThresholdScaler, ChurnConfig,
                                     CostCappedSpotScaler, ElasticEngine,
                                     FixedFleet)
    from repro_torch.sim.cluster_sim import Simulator
    from repro_torch.sim.workloads import (churn_scenarios, make_cluster,
                                           small_workload)
    hosts_per_pod = tuple(spec.param("fleet", (8, 8)))
    n_jobs = int(spec.param("n_jobs", 40))
    seed = spec.sim_seed()
    cfg_kw = churn_scenarios()[spec.scenario]
    cluster = make_cluster(hosts_per_pod)
    jobs = small_workload(cluster, seed=seed, n_jobs=n_jobs)
    algo = make_algorithm(spec.algo, cluster)
    _warm_registry(algo, cluster)
    n_hosts = sum(hosts_per_pod)
    if spec.scenario == "lease":
        scaler = BacklogThresholdScaler(min_hosts=max(2, n_hosts // 2),
                                        max_hosts=2 * n_hosts)
    elif spec.scenario == "spot":
        scaler = CostCappedSpotScaler(budget=0.25 * n_hosts,
                                      min_hosts=max(2, n_hosts // 2),
                                      max_hosts=2 * n_hosts)
    else:
        scaler = FixedFleet()
    churn = ChurnConfig(seed=seed + 1, **cfg_kw) if cfg_kw else None
    elastic = ElasticEngine(cluster, churn=churn, autoscaler=scaler)
    res = Simulator(cluster, algo, jobs, seed=seed,
                    elastic=elastic).run()
    assert len(res.job_finish) == n_jobs, \
        f"{spec.algo}/{spec.scenario}#{spec.seed}: " \
        f"{len(res.job_finish)}/{n_jobs} jobs finished"
    return summary_metrics(res)


def _chaos_cell(spec: CellSpec) -> Dict[str, float]:
    """A named fault campaign from ``chaos_scenarios`` against one
    algorithm, with the detection/response loop toggled by the
    ``detect`` param (the bench_chaos A/B cell, parameterized by seed).
    The campaign seed is derived from the cell key too, so replica *i*
    of ``detect=True`` and ``detect=False`` cells see *different*
    campaigns — A/B pairs that must share a campaign pin it with an
    explicit ``chaos_seed`` param instead."""
    from repro_torch.chaos import ChaosConfig, ResponseConfig
    from repro_torch.core.joss import make_algorithm
    from repro_torch.sim.cluster_sim import SimConfig, Simulator
    from repro_torch.sim.workloads import (chaos_scenarios, make_cluster,
                                           small_workload)
    hosts_per_pod = tuple(spec.param("hosts_per_pod", (5, 5)))
    n_jobs = int(spec.param("n_jobs", 20))
    seed = spec.sim_seed()
    camp_kw = chaos_scenarios()[spec.scenario]
    cluster = make_cluster(hosts_per_pod)
    jobs = small_workload(cluster, seed=seed, n_jobs=n_jobs)
    algo = make_algorithm(spec.algo, cluster)
    _warm_registry(algo, cluster)
    chaos = ChaosConfig(seed=int(spec.param("chaos_seed", seed + 1)),
                        **camp_kw)
    response = None
    if spec.param("detect", True):
        response = ResponseConfig(
            grace=float(spec.param("grace", 2.0)),
            quarantine_at=float(spec.param("quarantine_at", 1.0)))
    cfg = SimConfig(chaos=chaos, response=response)
    res = Simulator(cluster, algo, jobs, config=cfg, seed=seed).run()
    assert len(res.job_finish) == n_jobs, \
        f"{spec.algo}/{spec.scenario}#{spec.seed}: " \
        f"{len(res.job_finish)}/{n_jobs} jobs finished"
    return summary_metrics(res)


def _selftest_cell(spec: CellSpec) -> Dict[str, float]:
    """Engine-robustness probe. Scenarios:

      * ``ok``           — return a tiny metric dict immediately;
      * ``crash_once``   — hard-kill the worker (``os._exit``) on the
        first attempt, succeed on the retry;
      * ``hang_once``    — sleep past any sane cell timeout on the
        first attempt, succeed on the retry;
      * ``crash_always`` — hard-kill the worker on every attempt (the
        poisoned-cell path).

    "First attempt" is tracked with a flag file under the required
    ``flag_dir`` param — worker processes share no memory, so the
    filesystem is the only attempt counter a retried cell can see."""
    import os
    import time
    metrics = {"ok": 1.0, "seed": float(spec.seed)}
    if spec.scenario == "ok":
        return metrics
    if spec.scenario == "crash_always":
        os._exit(17)
    if spec.scenario not in ("crash_once", "hang_once"):
        raise ValueError(f"unknown selftest scenario {spec.scenario!r}")
    flag_dir = spec.param("flag_dir")
    if flag_dir is None:
        raise ValueError("selftest crash_once/hang_once cells need a "
                         "flag_dir param")
    flag = os.path.join(str(flag_dir),
                        f"{stable_hash(spec.key()):x}.attempted")
    if not os.path.exists(flag):
        with open(flag, "w") as f:
            f.write(spec.key())
        if spec.scenario == "crash_once":
            os._exit(17)
        time.sleep(float(spec.param("hang_s", 600.0)))
    return metrics


CELL_FAMILIES: Dict[str, Callable[[CellSpec], Dict[str, float]]] = {
    "fabric_contention": _fabric_contention_cell,
    "elastic_churn": _elastic_churn_cell,
    "chaos": _chaos_cell,
    "selftest": _selftest_cell,
}

#: families the lockstep executor can drive: builder(spec) -> (sim,
#: finish). Families absent here (e.g. elastic_churn, which has no
#: fabric and therefore no fill problems to batch) fall back to the
#: scalar ``run_cell`` path inside the lockstep backend.
LOCKSTEP_BUILDERS: Dict[str, Callable] = {
    "fabric_contention": build_fabric_contention,
}


def run_cell(spec: CellSpec) -> Dict[str, float]:
    """Execute one cell (in whatever process this is called from)."""
    try:
        runner = CELL_FAMILIES[spec.family]
    except KeyError:
        raise ValueError(f"unknown cell family {spec.family!r}") from None
    return runner(spec)
