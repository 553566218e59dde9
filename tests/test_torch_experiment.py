"""The port's paper-experiment entry point (``repro_torch.sim.experiment``)
against the JAX package on the CPU: ``run_comparison`` of the small
workload (12 jobs, 2x15 VPS) and of the mixed workload gives ``Summary``
fields equal to JAX's for every algorithm, its tables print as
``examples/cluster_sim.py`` prints them, and ``main`` prints the three
tables. Exact equality throughout."""
import dataclasses
import pathlib
import runpy

import pytest

pytest.importorskip("torch")

from repro.sim import experiment as jax_experiment  # noqa: E402
from repro_torch.sim import experiment  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def plain(x):
    """Package-neutral form of a Summary value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


CASES = [("small", dict(n_jobs=12)), ("mixed", {})]


@pytest.mark.parametrize("algo", experiment.ALGOS)
@pytest.mark.parametrize("workload,kw", CASES, ids=[c[0] for c in CASES])
def test_run_comparison_equals_jax(workload, kw, algo):
    ours = experiment.run_comparison(workload, algos=(algo,), **kw)[algo]
    theirs = jax_experiment.run_comparison(workload, algos=(algo,),
                                           **kw)[algo]
    assert plain(ours) == plain(theirs)
    assert ours.int_mb > 0 and ours.wtt > 0


def test_tables_print_as_the_example_does(capsys):
    ours = experiment.run_comparison("small", n_jobs=12)
    theirs = jax_experiment.run_comparison("small", n_jobs=12)
    example = runpy.run_path(str(ROOT / "examples" / "cluster_sim.py"))
    example["show"](theirs, "small")
    assert experiment.format_table("small", ours) + "\n" == \
        capsys.readouterr().out


def test_main_prints_three_tables(monkeypatch, capsys):
    calls = []
    run_comparison = experiment.run_comparison

    def small_comparison(workload, **kw):
        calls.append((workload, kw))
        return run_comparison(
            workload, n_jobs=6, hosts_per_pod=kw.get("hosts_per_pod",
                                                     (4, 4)))

    monkeypatch.setattr(experiment, "run_comparison", small_comparison)
    assert experiment.main(["--full"]) == 0
    out = capsys.readouterr().out
    assert [c[0] for c in calls] == ["small", "mixed", "small"]
    assert calls[0][1]["n_jobs"] == 300
    assert calls[2][1]["hosts_per_pod"] == (64, 64, 64, 64)
    assert out.count("=== ") == 3 and "paper §6.1" in out
    assert "[wall " in out
    rows = experiment.table_row(run_comparison(
        "small", n_jobs=6, algos=("fifo",))["fifo"])
    assert sorted(rows) == ["int_gb", "load_std", "off_cen", "reduce_loc",
                            "vps_loc", "wtt"]
