"""The port's chaos layer (``repro_torch.chaos``: campaigns, injection and
the timeout/quarantine response loop) against the JAX package on the CPU:
every ``chaos_scenarios`` campaign, per stream and through the fabric, the
committed gate of ``BENCH_chaos.json`` (its per-algorithm rows and its
injection and decision signatures, through ``chip_smoke.py``'s
``sched_chaos_probe``), ``chaos`` sweep cells, and the
attached-but-calm layer on the 25 golden trajectories. Exact equality
throughout."""
import dataclasses
import enum
import importlib
import json
import pathlib
import types

import pytest

pytest.importorskip("torch")

import chip_smoke as cs  # noqa: E402
from benchmarks import bench_chaos as jax_chaos  # noqa: E402
from repro.chaos import build_campaign as jax_build_campaign  # noqa: E402
from repro.chaos import ChaosConfig as JaxChaosConfig  # noqa: E402
from repro.sim import golden as jax_golden  # noqa: E402
from repro.sweep import matrix as jax_matrix  # noqa: E402
from repro.sweep import run_cell as jax_run_cell  # noqa: E402
from repro_torch.chaos import (ChaosConfig, ChaosSubsystem,  # noqa: E402
                               ResponseConfig, ResponseSubsystem,
                               build_campaign)
from repro_torch.sim import golden  # noqa: E402
from repro_torch.sim.workloads import chaos_scenarios  # noqa: E402
from repro_torch.sweep import matrix, run_cell  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ALGOS = golden.ALGOS
SCENARIOS = tuple(chaos_scenarios())
SKIP = {"task_logs", "jobs", "job_submit", "job_finish", "telemetry",
        "scheduler_decision_time"}


def plain(x):
    """Package-neutral form of a result value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return plain(x.value)
    if isinstance(x, tuple):
        return tuple(plain(v) for v in x)
    if isinstance(x, list):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    return x


def result_fields(res):
    return {f.name: plain(getattr(res, f.name))
            for f in dataclasses.fields(res) if f.name not in SKIP}


def _pkg(name):
    imp = importlib.import_module
    return types.SimpleNamespace(
        joss=imp(f"{name}.core.joss"), sim=imp(f"{name}.sim.cluster_sim"),
        wl=imp(f"{name}.sim.workloads"), net=imp(f"{name}.sim.network"),
        chaos=imp(f"{name}.chaos"))


PORT, JAX = _pkg("repro_torch"), _pkg("repro")


def scenario_run(p, algo_name, scenario, *, fabric, n_jobs=12, seed=11):
    """bench_chaos's campaign run (response loop on) on a 4 + 4 fleet, per
    stream or through the contended fabric, built from package ``p``."""
    hpp = (4, 4)
    chaos = p.chaos.ChaosConfig(seed=seed + 1,
                                **p.wl.chaos_scenarios()[scenario])
    links = p.wl.fabric_links(hpp, wan_oversub=8.0) if fabric else None
    cluster = p.wl.make_cluster(hpp, links=links)
    jobs = p.wl.small_workload(cluster, seed=seed, n_jobs=n_jobs)
    algo = p.joss.make_algorithm(algo_name, cluster)
    if hasattr(algo, "registry"):
        for j in p.wl.profiling_prelude(cluster):
            algo.registry.record(j, j.true_fp)
    cfg = p.sim.SimConfig(
        chaos=chaos, response=p.chaos.ResponseConfig(),
        fabric=p.net.FabricConfig() if fabric else None)
    res = p.sim.Simulator(cluster, algo, jobs, config=cfg, seed=seed).run()
    assert len(res.job_finish) == n_jobs
    return res


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_campaign_equals_jax(scenario):
    kw = chaos_scenarios()[scenario]
    for seed in (0, 5, 12):
        ours = build_campaign(ChaosConfig(seed=seed, **kw))
        theirs = jax_build_campaign(JaxChaosConfig(seed=seed, **kw))
        assert [plain(e) for e in ours] == [plain(e) for e in theirs]
        assert len(ours) == ChaosConfig(seed=seed, **kw).n_events


@pytest.mark.parametrize("fabric", [False, True], ids=["stream", "fabric"])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_run_equals_jax(scenario, fabric):
    for algo in ALGOS:
        ours = scenario_run(PORT, algo, scenario, fabric=fabric)
        theirs = scenario_run(JAX, algo, scenario, fabric=fabric)
        assert ours.chaos.signature() == theirs.chaos.signature()
        assert ours.response.signature() == theirs.response.signature()
        assert golden.full_signature(ours) == \
            jax_golden.full_signature(theirs)
        assert result_fields(ours) == result_fields(theirs)
        if scenario == "calm":
            assert ours.n_chaos_events == ours.n_timeouts == 0
        if scenario == "partition" and fabric:
            assert ours.chaos.n_link + ours.chaos.n_partition > 0


@pytest.mark.parametrize("algo", ALGOS)
def test_gate_rows_equal_committed_and_jax(algo):
    stored = json.loads((ROOT / "BENCH_chaos.json").read_text())
    point = stored["gate"]
    assert dict(point, hosts_per_pod=tuple(point["hosts_per_pod"])) == \
        jax_chaos.GATE
    off = cs.sched_chaos_probe(algo, False, point)
    on = cs.sched_chaos_probe(algo, True, point)
    assert dict(off_wtt=off.wtt, off_reexec=off.n_reexec, wtt=on.wtt,
                reexec=on.n_reexec, n_timeouts=on.n_timeouts,
                n_quarantined=on.n_quarantined,
                n_surfaced=on.n_surfaced) == stored["algos"][algo]
    theirs = jax_chaos.chaos_probe(algo, detect=True)
    assert golden.full_signature(on) == jax_golden.full_signature(theirs)
    assert result_fields(on) == result_fields(theirs)
    if algo == "joss-t":
        assert on.chaos.signature() == stored["chaos_signature"]
        assert on.response.signature() == stored["response_signature"]


@pytest.mark.parametrize("detect", [True, False])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_chaos_cell_equals_jax(scenario, detect):
    kw = dict(hosts_per_pod=(4, 4), n_jobs=10, detect=detect)
    specs = matrix("chaos", ALGOS, (scenario,), 1, **kw)
    jspecs = jax_matrix("chaos", ALGOS, (scenario,), 1, **kw)
    for spec, jspec in zip(specs, jspecs):
        assert spec.key() == jspec.key()
        assert run_cell(spec) == jax_run_cell(jspec), spec.key()


def test_calm_layer_keeps_every_golden_trajectory():
    """An attached-but-inert chaos layer (empty campaign, a detector whose
    grace never trips) moves no event of any committed trajectory."""
    want = golden.load_golden()
    for algo, variant in golden.golden_cases():
        calm = (ChaosSubsystem(ChaosConfig(seed=0)),
                ResponseSubsystem(ResponseConfig(grace=1e18,
                                                 quarantine_at=1e18)))
        res = golden.run_case(algo, variant, subsystems=calm)
        assert golden.signature_hash(res) == \
            want[golden.case_key(algo, variant)], (algo, variant)
