"""The port's telemetry (``repro_torch.obs``: registry, scoreboard, trace
export, the hook-only subsystem) against the JAX package on the CPU:
telemetry-on runs of the 25 golden cases keep the committed hashes and
write the JAX package's trace byte for byte; the ``BENCH_obs.json`` trace
probe (a churny elastic fleet on a contended fabric, 32 jobs, seed 7) has
the committed sha256 and event count; a scoreboard-fed autoscaler decides
as the observation-fed one does; a capped trace counts its drops. Exact
equality throughout."""
import importlib
import json
import pathlib
import types

import pytest

pytest.importorskip("torch")

from repro.obs import TelemetryConfig as JaxTelemetryConfig  # noqa: E402
from repro.sim import golden as jax_golden  # noqa: E402
from repro_torch.obs import (Counter, Gauge, MetricRegistry,  # noqa: E402
                             TelemetryConfig, TraceExporter, WindowSeries)
from repro_torch.sim import golden  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROBE = json.loads((ROOT / "BENCH_obs.json").read_text())["probe"]


def _pkg(name):
    imp = importlib.import_module
    return types.SimpleNamespace(
        joss=imp(f"{name}.core.joss"), sim=imp(f"{name}.sim.cluster_sim"),
        wl=imp(f"{name}.sim.workloads"), el=imp(f"{name}.elastic"),
        obs=imp(f"{name}.obs"), golden=imp(f"{name}.sim.golden"))


PORT, JAX = _pkg("repro_torch"), _pkg("repro")


def elastic_run(p, telemetry, *, n_jobs=PROBE["n_jobs"], seed=PROBE["seed"]):
    """bench_obs's trace probe: a churny elastic run with a backlog-threshold
    autoscaler on a contended fabric, built from package ``p``."""
    hpp = (8, 8)
    cluster = p.wl.make_cluster(hpp, map_slots=2)
    jobs = p.wl.small_workload(cluster, seed=seed, n_jobs=n_jobs)
    algo = p.joss.make_algorithm("joss-t", cluster)
    cfg = p.sim.SimConfig(fabric=p.sim.FabricConfig(
        links=p.wl.fabric_links(hpp)), telemetry=telemetry)
    eng = p.el.ElasticEngine(
        cluster,
        churn=p.el.ChurnConfig(seed=5, fail_rate=0.5, rejoin_delay=90.0),
        autoscaler=p.el.BacklogThresholdScaler(min_hosts=4))
    return p.sim.Simulator(cluster, algo, jobs, config=cfg, seed=seed,
                           elastic=eng).run()


@pytest.mark.parametrize("algo,variant", golden.golden_cases(),
                         ids=[golden.case_key(*c) for c in
                              golden.golden_cases()])
def test_telemetry_on_golden_equals_committed_and_jax(algo, variant):
    ours = golden.run_case(algo, variant, telemetry=TelemetryConfig())
    theirs = jax_golden.run_case(algo, variant,
                                 telemetry=JaxTelemetryConfig())
    assert golden.signature_hash(ours) == \
        golden.load_golden()[golden.case_key(algo, variant)]
    assert golden.full_signature(ours) == jax_golden.full_signature(theirs)
    assert ours.telemetry.trace.jsonl() == theirs.telemetry.trace.jsonl()


@pytest.fixture(scope="module")
def probe_runs():
    return (elastic_run(PORT, TelemetryConfig()),
            elastic_run(JAX, JaxTelemetryConfig()))


def test_trace_probe_equals_committed(probe_runs):
    ours, _ = probe_runs
    tr = ours.telemetry.trace
    assert (tr.sha256(), len(tr)) == (PROBE["sha256"], PROBE["n_events"])
    again = elastic_run(PORT, TelemetryConfig())
    assert again.telemetry.trace.jsonl() == tr.jsonl()


def test_trace_probe_equals_jax(probe_runs):
    ours, theirs = probe_runs
    assert ours.telemetry.trace.jsonl() == theirs.telemetry.trace.jsonl()
    assert ours.telemetry.trace.chrome_trace() == \
        theirs.telemetry.trace.chrome_trace()
    assert ours.telemetry.registry.snapshot() == \
        theirs.telemetry.registry.snapshot()


def test_scoreboard_series_equal_jax(probe_runs):
    ours, theirs = probe_runs
    sb, jsb = ours.telemetry.scoreboard, theirs.telemetry.scoreboard
    horizon = ours.wtt + 2 * sb.window
    assert sb.window == jsb.window
    assert sb.link_names() == jsb.link_names()
    assert sorted(sb.link_names()) == ["down0", "down1", "up0", "up1", "wan"]
    for ln in sb.link_names():
        series = sb.link_util_series(ln, horizon)
        assert series and series == jsb.link_util_series(ln, horizon)
        assert sb.series_values(f"link.{ln}.mb", horizon) == \
            jsb.series_values(f"link.{ln}.mb", horizon)


def test_scoreboard_fed_autoscaler_is_bit_identical(probe_runs):
    """With telemetry on, the BacklogThresholdScaler reads its backlog off
    the scoreboard; its decisions equal the observation-fed run's."""
    ours, _ = probe_runs
    off = elastic_run(PORT, None)
    assert off.telemetry is None
    assert golden.full_signature(off) == golden.full_signature(ours)


def test_trace_limit_counts_drops(probe_runs):
    ours, _ = probe_runs
    capped = elastic_run(PORT, TelemetryConfig(trace_limit=100))
    jcapped = elastic_run(JAX, JaxTelemetryConfig(trace_limit=100))
    tr = capped.telemetry.trace
    assert len(tr) == 100 and tr.dropped > 0
    assert tr.dropped == jcapped.telemetry.trace.dropped
    assert tr.jsonl() == jcapped.telemetry.trace.jsonl()
    assert golden.full_signature(capped) == golden.full_signature(ours)


def test_registry_and_exporter_primitives():
    reg = MetricRegistry(window=10.0)
    c, g = reg.counter("tasks"), reg.gauge("hosts")
    assert isinstance(c, Counter) and isinstance(g, Gauge)
    assert reg.counter("tasks") is c
    c.inc()
    c.inc(2.0)
    g.set(7)
    s = reg.get_series("util")
    assert isinstance(s, WindowSeries)
    s.add(3.0, 1.5)
    s.add_range(5.0, 25.0, 4.0)
    # 1.5 + a quarter of 4.0 in [0, 10); half in [10, 20); a quarter after
    assert s.closed_values(30.0) == [2.5, 2.0, 1.0]
    snap = reg.snapshot()
    assert snap["counters"]["tasks"] == 3.0
    assert snap["gauges"]["hosts"] == 7
    ex = TraceExporter(limit=2)
    ex.instant("sim", "fleet", "add", 1.0)
    ex.complete("host", "h0", "map", 0.0, 2.0)
    ex.instant("sim", "fleet", "loss", 3.0)
    assert len(ex) == 2 and ex.dropped == 1
    assert len(ex.jsonl().splitlines()) == 2
