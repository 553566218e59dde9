"""The port's scheduler simulator and its lockstep sweep against the JAX
package, on the CPU: ``fabric_contention`` cells give metric dicts equal to
``repro.sweep.cells.run_cell`` (every algorithm and scenario), and the
lockstep executor, batched through the fill kernel's plain version
(``device="cpu"``) and on its scalar deferred path, gives results equal to
JAX's ``run_cell``, the epoch and problem counts of JAX's
``LockstepExecutor(use_jax=False)``, and a byte-equal ``aggregate_json``."""
import pytest

torch = pytest.importorskip("torch")

from repro.sweep import LockstepExecutor as JaxExecutor  # noqa: E402
from repro.sweep import aggregate_json as jax_aggregate_json  # noqa: E402
from repro.sweep import matrix as jax_matrix  # noqa: E402
from repro.sweep import run_cell as jax_run_cell  # noqa: E402
from repro_torch.sim.network import FabricConfig, make_fabric  # noqa: E402
from repro_torch.sim.workloads import make_cluster  # noqa: E402
from repro_torch.sweep import (CellSpec, LockstepExecutor,  # noqa: E402
                               SweepEngine, aggregate_json, matrix,
                               run_cell, run_serial)
from repro_torch.sweep import lockstep as ls  # noqa: E402

ALGOS = ("joss-t", "joss-j", "fifo", "fair", "capacity")
SCENARIOS = ("uncontended", "oversub8", "oversub24")
SMALL = dict(hosts_per_pod=(4, 4), n_jobs=6)
#: the JAX lockstep tests' gate point: fills wide enough to pass INLINE_C
GATE = dict(hosts_per_pod=(8,) * 8, n_jobs=24)


def _gate_specs(mod):
    return mod("fabric_contention", ("joss-t", "fifo"), SCENARIOS, 2, **GATE)


@pytest.fixture(scope="module")
def jax_gate():
    specs = _gate_specs(jax_matrix)
    results = {s.key(): jax_run_cell(s) for s in specs}
    ex = JaxExecutor(use_jax=False)
    assert ex.run(specs) == results
    return results, ex.stats


def test_cell_keys_and_seeds_match_jax():
    ours = matrix("fabric_contention", ALGOS, SCENARIOS, 3, **GATE)
    theirs = jax_matrix("fabric_contention", ALGOS, SCENARIOS, 3, **GATE)
    assert [s.key() for s in ours] == [s.key() for s in theirs]
    assert [s.sim_seed() for s in ours] == [s.sim_seed() for s in theirs]
    assert CellSpec.from_key(ours[7].key()) == ours[7]


@pytest.mark.parametrize("algo", ALGOS)
def test_run_cell_equals_jax(algo):
    for spec in matrix("fabric_contention", (algo,), SCENARIOS, 1, **SMALL):
        jspec = jax_matrix("fabric_contention", (algo,), (spec.scenario,),
                           1, **SMALL)[0]
        assert run_cell(spec) == jax_run_cell(jspec), spec.key()


@pytest.mark.parametrize("use_batched", [True, False],
                         ids=["batched", "scalar"])
def test_lockstep_equals_jax(jax_gate, use_batched):
    want, jst = jax_gate
    specs = _gate_specs(matrix)
    ex = LockstepExecutor(use_batched=use_batched, device="cpu")
    got = ex.run(specs)
    assert got == want
    st = ex.stats
    assert (st.epochs, st.problems, st.n_cells) == (jst.epochs, jst.problems,
                                                    jst.n_cells)
    assert aggregate_json(got, metrics=ls.CLAIM_METRICS) == \
        jax_aggregate_json(want, metrics=ls.CLAIM_METRICS)
    assert aggregate_json(got) == jax_aggregate_json(want)
    if use_batched:
        # the kernel path engaged: problems past INLINE_C went batched
        assert st.used_batched and st.batches > 0
        assert st.inline_small < st.problems
        assert st.solver["solve_s"] > 0.0
    else:
        assert not st.used_batched and st.batches == 0


def test_gang_size_never_changes_results(jax_gate):
    want, _ = jax_gate
    specs = _gate_specs(matrix)[:4]
    got = LockstepExecutor(gang_size=3, device="cpu").run(specs)
    assert got == {s.key(): want[s.key()] for s in specs}


def test_gate_entry_point_small(capsys, monkeypatch):
    r = ls.run_gate(1, device="cpu")
    assert r["cells"] == 15 and r["cells_equal"] and r["aggregate_equal"]
    assert r["deferred_equal"] and r["cells_differing"] == 0
    assert r["aggregate_sha256"] == r["scalar_aggregate_sha256"]
    assert r["batched"]["problems"] > r["batched"]["inline_small"]
    calls = []
    monkeypatch.setattr(ls, "run_gate",
                        lambda n, device: calls.append((n, device)) or r)
    assert ls.main(["--seeds", "1", "--device", "cpu"]) == 0
    assert calls == [(1, "cpu")]
    out = capsys.readouterr().out
    assert "lockstep (batched, cpu)" in out and r["aggregate_sha256"] in out
    monkeypatch.setattr(ls, "run_gate",
                        lambda n, device: dict(r, cells_equal=False))
    assert ls.main([]) == 1


def test_sweep_engine_backends_agree():
    specs = matrix("fabric_contention", ("joss-j",), ("oversub8",), 2,
                   **SMALL)
    inline, st = SweepEngine().run(specs)
    lock, _ = SweepEngine(backend="lockstep", device="cpu").run(specs)
    assert inline == lock == run_serial(specs)
    assert st.n_cells == st.n_executed == 2


def test_unported_parts_raise(tmp_path):
    """What the engine still refuses: an unknown backend, and the lockstep
    executor without a card. The process pool, the result store and the
    ``selftest`` family, once refused here, are ported: they construct,
    and a selftest cell gives JAX's metrics."""
    from repro_torch.sweep import ResultStore
    eng = SweepEngine(workers=2, store=ResultStore(str(tmp_path)))
    assert eng.workers == 2 and eng.store is not None
    spec = CellSpec("selftest", "joss-t", "ok", 0)
    assert run_cell(spec) == jax_run_cell(
        jax_matrix("selftest", ("joss-t",), ("ok",), 1)[0])
    with pytest.raises(ValueError, match="unknown sweep backend"):
        SweepEngine(backend="bogus")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LockstepExecutor()


@pytest.mark.parametrize("family,scenario", [("elastic_churn", "flaky"),
                                             ("chaos", "hostile")])
def test_ported_families_run_and_equal_jax(family, scenario):
    """The elastic_churn and chaos families, once refused here, run and
    give JAX's metric dicts."""
    kw = (dict(fleet=(4, 4), n_jobs=8) if family == "elastic_churn"
          else dict(hosts_per_pod=(4, 4), n_jobs=8))
    spec = matrix(family, ("joss-t",), (scenario,), 1, **kw)[0]
    jspec = jax_matrix(family, ("joss-t",), (scenario,), 1, **kw)[0]
    assert run_cell(spec) == jax_run_cell(jspec)


def test_reference_allocator_is_built():
    from repro_torch.sim.network_reference import ReferenceNetworkFabric
    fab = make_fabric(make_cluster((2, 2)),
                      FabricConfig(allocator="reference"))
    assert isinstance(fab, ReferenceNetworkFabric)


def test_lockstep_mixed_matrix_falls_back_for_elastic_and_chaos():
    """A matrix mixing batched fabric cells with elastic and chaos cells:
    the latter run on the scalar fallback, every cell equals run_cell."""
    specs = (matrix("fabric_contention", ("joss-t",), ("oversub8",), 1,
                    **GATE)
             + matrix("elastic_churn", ("fifo",), ("flaky", "spot"), 1,
                      fleet=(4, 4), n_jobs=8)
             + matrix("chaos", ("joss-j",), ("gray",), 1,
                      hosts_per_pod=(4, 4), n_jobs=8))
    eng = SweepEngine(backend="lockstep", device="cpu")
    got, st = eng.run(specs)
    assert got == run_serial(specs)
    assert st.n_cells == 4
    assert eng.lockstep_stats.n_fallback == 3
    assert eng.lockstep_stats.batches > 0
