"""The port's elastic fleet (``repro_torch.elastic``) against the JAX package
on the CPU: the 25 committed golden trajectories (5 algorithms x static /
churn / durability / churn+durability / speculative), the bench_migration
probe at a 0 s and a 30 s notice (the port's side built by
``chip_smoke.py``'s ``sched_migration_probe``), the committed migration
gate row of ``BENCH_elastic.json``, fleet compaction, and ``elastic_churn`` sweep cells.
Exact equality throughout: both sides run the same float64 Python
arithmetic and draw from the same numpy ``RandomState`` streams."""
import dataclasses
import enum
import importlib
import json
import pathlib
import types

import pytest

pytest.importorskip("torch")

import chip_smoke as cs  # noqa: E402
from benchmarks import bench_migration as jax_mig  # noqa: E402
from repro.sim import golden as jax_golden  # noqa: E402
from repro.sweep import matrix as jax_matrix  # noqa: E402
from repro.sweep import run_cell as jax_run_cell  # noqa: E402
from repro_torch.elastic import (DurabilityConfig, ElasticEngine,  # noqa: E402
                                 FixedFleet)
from repro_torch.sim import golden  # noqa: E402
from repro_torch.sim.workloads import make_cluster  # noqa: E402
from repro_torch.sweep import matrix, run_cell  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ALGOS = golden.ALGOS
#: SimResult fields held elsewhere (full_signature remaps the job ids) or
#: not part of the trajectory (wall time, the telemetry object)
SKIP = {"task_logs", "jobs", "job_submit", "job_finish", "telemetry",
        "scheduler_decision_time"}


def plain(x):
    """Package-neutral form of a result value: dataclasses become dicts,
    enums their values, named tuples tuples."""
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


def test_golden_path_is_the_committed_file():
    assert pathlib.Path(golden.GOLDEN_PATH) == (
        ROOT / "tests" / "golden" / "sim_trajectories.json")
    assert golden.load_golden() == jax_golden.load_golden()
    assert golden.golden_cases() == jax_golden.golden_cases()


@pytest.mark.parametrize("algo,variant", golden.golden_cases(),
                         ids=[golden.case_key(*c) for c in
                              golden.golden_cases()])
def test_golden_case_equals_jax_and_committed(algo, variant):
    ours = golden.run_case(algo, variant)
    theirs = jax_golden.run_case(algo, variant)
    assert golden.full_signature(ours) == jax_golden.full_signature(theirs)
    assert result_fields(ours) == result_fields(theirs)
    assert golden.signature_hash(ours) == \
        golden.load_golden()[golden.case_key(algo, variant)]


@pytest.mark.parametrize("notice", [0.0, 30.0])
@pytest.mark.parametrize("algo", ALGOS)
def test_migration_probe_equals_jax(algo, notice):
    point = dict(jax_mig.GATE, notice=notice)
    ours = cs.sched_migration_probe(algo, True, point)
    theirs = jax_mig.migration_probe(algo, True, notice)
    assert golden.full_signature(ours) == jax_golden.full_signature(theirs)
    assert result_fields(ours) == result_fields(theirs)
    assert ours.migration.signature() == theirs.migration.signature()
    if notice == 0.0:
        # no warning, nothing to drain: migration is inert
        base = cs.sched_migration_probe(algo, False, point)
        assert golden.full_signature(base) == golden.full_signature(ours)


@pytest.mark.parametrize("algo", ALGOS)
def test_migration_gate_row_equals_committed(algo):
    stored = json.loads((ROOT / "BENCH_elastic.json").read_text())
    gate = stored["migration"]
    base = cs.sched_migration_probe(algo, False, gate["probe"])
    mig = cs.sched_migration_probe(algo, True, gate["probe"])
    assert dict(base_lost=base.work_lost_mb, base_reexec=base.n_reexec,
                lost=mig.work_lost_mb, reexec=mig.n_reexec,
                n_migrated=mig.n_migrated) == gate["algos"][algo]
    if algo == "joss-t":
        assert mig.migration.signature() == gate["signature"]


def _pkg(name):
    imp = importlib.import_module
    return types.SimpleNamespace(
        joss=imp(f"{name}.core.joss"), topo=imp(f"{name}.core.topology"),
        sim=imp(f"{name}.sim.cluster_sim"), wl=imp(f"{name}.sim.workloads"),
        el=imp(f"{name}.elastic"))


def compaction_run(p, compact):
    """bench_migration's compaction probe: a one-burst workload with
    straggler hosts under the compacting (or the plain backlog) scaler."""
    cluster = p.wl.make_cluster((6, 6))
    jobs = p.wl.small_workload(cluster, seed=11, n_jobs=16)
    for j in jobs:
        j.submit_time = 0.0
    algo = p.joss.make_algorithm("joss-j", cluster)
    for j in p.wl.profiling_prelude(cluster):
        algo.registry.record(j, j.true_fp)
    kw = dict(interval=30.0, hi=4.0, step=4, min_hosts=2)
    scaler = (p.el.CompactingScaler(**kw) if compact
              else p.el.BacklogThresholdScaler(**kw))
    eng = p.el.ElasticEngine(
        cluster, churn=None, autoscaler=scaler,
        durability=p.el.DurabilityConfig(checkpoint=True),
        migration=p.el.MigrationConfig())
    hid = p.topo.HostId
    slow = {hid(0, 1): 8.0, hid(0, 3): 8.0, hid(1, 2): 8.0}
    res = p.sim.Simulator(cluster, algo, jobs,
                          config=p.sim.SimConfig(slow_hosts=slow),
                          seed=11, elastic=eng).run()
    assert len(res.job_finish) == 16
    return res


@pytest.mark.parametrize("compact", [True, False])
def test_compaction_run_equals_jax(compact):
    ours = compaction_run(_pkg("repro_torch"), compact)
    theirs = compaction_run(_pkg("repro"), compact)
    assert golden.full_signature(ours) == jax_golden.full_signature(theirs)
    assert result_fields(ours) == result_fields(theirs)
    if compact:
        assert ours.n_migrated > 0


ELASTIC_SMALL = dict(fleet=(4, 4), n_jobs=12)


@pytest.mark.parametrize("scenario", ["stable", "flaky", "spot", "lease"])
def test_elastic_churn_cell_equals_jax(scenario):
    specs = matrix("elastic_churn", ALGOS, (scenario,), 1, **ELASTIC_SMALL)
    jspecs = jax_matrix("elastic_churn", ALGOS, (scenario,), 1,
                        **ELASTIC_SMALL)
    assert [s.key() for s in specs] == [s.key() for s in jspecs]
    for spec, jspec in zip(specs, jspecs):
        assert run_cell(spec) == jax_run_cell(jspec), spec.key()


def test_engine_rejects_a_reused_autoscaler():
    cluster = make_cluster((2, 2))
    scaler = FixedFleet()
    ElasticEngine(cluster, autoscaler=scaler)
    with pytest.raises(ValueError, match="single-run"):
        ElasticEngine(cluster, autoscaler=scaler)


def test_durability_run_saves_checkpointed_output():
    """Churn with checkpointing on: the store saves finished outputs and
    the ElasticSummary carries the durability accounting."""
    res = golden.run_case("joss-t", "churn+durability")
    assert res.n_host_losses > 0 and res.ckpt_mb_written > 0
    assert res.elastic.durability is not None
    assert res.elastic.durability.ckpt_mb_written == res.ckpt_mb_written
    assert DurabilityConfig(checkpoint=True).enabled
