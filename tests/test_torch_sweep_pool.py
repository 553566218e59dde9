"""The port's sweep process pool, result store and ``selftest`` family
against the JAX package, on the CPU.

The pool spawns fresh worker interpreters, so each engine here that runs
with ``workers >= 2`` costs a few seconds of worker start-up; the tests
keep such engines few. The sabotage of the ``selftest`` cells (a hard
``os._exit`` or a long sleep) always lands in a spawned pool worker,
never in the pytest process.
"""
import os
import shutil

import pytest

pytest.importorskip("torch")

from repro.sweep import ResultStore as JaxResultStore  # noqa: E402
from repro.sweep import SweepEngine as JaxSweepEngine  # noqa: E402
from repro.sweep import aggregate_json as jax_aggregate_json  # noqa: E402
from repro.sweep import code_fingerprint as jax_fingerprint  # noqa: E402
from repro.sweep import matrix as jax_matrix  # noqa: E402
from repro_torch.sweep import (CellSpec, ResultStore,  # noqa: E402
                               SweepEngine, aggregate_json,
                               code_fingerprint, make_params, matrix,
                               run_cell)
from repro_torch.sweep import cache  # noqa: E402

#: the JAX sweep tests' tiny-but-real matrix: 2 algorithms x 2 scenarios x
#: 2 seeds of the fabric contention family
TINY = dict(family="fabric_contention", algos=["fifo", "joss-t"],
            scenarios=["uncontended", "oversub8"], n_seeds=2,
            hosts_per_pod=(4, 4), n_jobs=6)
METRICS = ("wtt", "int_mb")
FAST = dict(retry_backoff_s=0.05, retry_backoff_cap_s=0.2)
PORT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    cache.__file__)))


def _tiny(mod):
    t = dict(TINY)
    return mod(t.pop("family"), t.pop("algos"), t.pop("scenarios"),
               t.pop("n_seeds"), **t)


def _ok_cells(n=4):
    return [CellSpec("selftest", "a", "ok", i) for i in range(n)]


@pytest.fixture(scope="module")
def inline_results():
    results, stats = SweepEngine(workers=1).run(_tiny(matrix))
    assert stats.n_executed == len(results) == 8
    return results


# ------------------------------------------------------------- the pool --
def test_pool_matches_inline_and_jax(inline_results):
    """A pool of 2 spawned workers, the port's inline engine and JAX's
    inline engine give per-cell equal results and byte-identical
    aggregates; no worker initialises CUDA."""
    pooled, stats = SweepEngine(workers=2).run(_tiny(matrix))
    jax_res, _ = JaxSweepEngine(workers=1).run(_tiny(jax_matrix))
    assert stats.workers == 2 and stats.n_executed == 8
    assert pooled == inline_results == jax_res
    agg = aggregate_json(pooled, metrics=METRICS)
    assert agg == aggregate_json(inline_results, metrics=METRICS)
    assert agg == jax_aggregate_json(jax_res, metrics=METRICS)
    assert stats.worker_cuda and not any(stats.worker_cuda.values())
    assert all(r["status"] == "ok" and r["attempts"] == 1
               for r in stats.cell_report.values())


# ------------------------------------------------------------ the store --
def test_store_warm_run_executes_nothing(tmp_path, inline_results):
    store = ResultStore(directory=str(tmp_path))
    engine = SweepEngine(workers=1, store=store)
    cold, s1 = engine.run(_tiny(matrix))
    assert (s1.n_executed, s1.n_cached) == (8, 0)
    warm, s2 = engine.run(list(reversed(_tiny(matrix))))
    assert (s2.n_executed, s2.n_cached) == (0, 8)
    assert cold == warm == inline_results
    # the pool backend reads the same store before it spawns anything
    pooled, s3 = SweepEngine(workers=2, store=store).run(_tiny(matrix))
    assert (s3.n_executed, s3.n_cached) == (0, 8)
    assert pooled == inline_results and s3.worker_cuda == {}


def test_store_shares_a_directory_with_jax_without_collisions(tmp_path):
    """Both packages' stores in one directory: each serves its own
    entries only, since their fingerprints differ."""
    ours = ResultStore(directory=str(tmp_path))
    theirs = JaxResultStore(directory=str(tmp_path))
    assert ours.fingerprint == code_fingerprint() != theirs.fingerprint
    key = _tiny(matrix)[0].key()
    theirs.put(key, {"wtt": 1.0})
    assert ours.get(key) is None
    ours.put(key, {"wtt": 2.0})
    assert theirs.get(key) == {"wtt": 1.0} and ours.get(key) == {"wtt": 2.0}


def test_store_treats_corruption_as_miss(tmp_path):
    store = ResultStore(directory=str(tmp_path), fingerprint="c" * 64)
    store.put("cell", {"wtt": 1.0})
    with open(store._path("cell"), "w") as f:
        f.write("{not json")
    assert store.get("cell") is None
    store.put("cell", {"wtt": 2.0})
    assert store.get("cell") == {"wtt": 2.0}


def test_fingerprint_digests_the_port_only(tmp_path):
    """The default root is ``src/repro_torch``: a copy of the tree digests
    the same; an edit to a copy of the JAX package beside it changes
    nothing; an edit to one of the port's sources changes the digest."""
    assert code_fingerprint() == code_fingerprint(PORT_ROOT)
    assert code_fingerprint() != jax_fingerprint()
    src = tmp_path / "src"
    shutil.copytree(PORT_ROOT, src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(os.path.join(os.path.dirname(PORT_ROOT), "repro"),
                    src / "repro",
                    ignore=shutil.ignore_patterns("__pycache__"))
    copy_root = str(src / "repro_torch")
    assert cache.code_fingerprint(copy_root) == code_fingerprint()
    with open(src / "repro" / "sweep" / "cells.py", "a") as f:
        f.write("\n# an edit to the JAX package\n")
    cache._fingerprint_cache.pop(copy_root)
    assert cache.code_fingerprint(copy_root) == code_fingerprint()
    with open(src / "repro_torch" / "sweep" / "cells.py", "a") as f:
        f.write("\n# an edit to the port\n")
    cache._fingerprint_cache.pop(copy_root)
    edited = cache.code_fingerprint(copy_root)
    assert len(edited) == 64 and edited != code_fingerprint()


# --------------------------------------------------- the selftest family --
def test_worker_crash_is_retried_and_aggregates_stay_identical(tmp_path):
    """A hard worker crash: the pool is rebuilt, the cell retried, every
    cell delivers, and the unaffected cells' aggregate is byte-identical
    to a crash-free run's."""
    crash = [CellSpec("selftest", "a", "crash_once", 0,
                      make_params(flag_dir=str(tmp_path)))]
    noisy, stats = SweepEngine(workers=2, **FAST).run(_ok_cells() + crash)
    assert len(noisy) == 5
    assert stats.n_pool_rebuilds >= 1 and stats.n_retried >= 1
    assert stats.n_poisoned == 0
    row = stats.cell_report[crash[0].key()]
    assert row["status"] == "ok" and row["crashes"] >= 1
    clean, _ = SweepEngine(workers=1).run(_ok_cells())
    unaffected = {k: v for k, v in noisy.items() if k in clean}
    assert aggregate_json(unaffected, metrics=("ok",)) \
        == aggregate_json(clean, metrics=("ok",))


def test_hung_cell_times_out_and_retries(tmp_path):
    """A cell that outlives ``cell_timeout`` is charged a timeout, the pool
    rebuilt, and the cell retried to completion. The timeout also counts
    a spawned worker's start-up, which under a loaded test run takes
    seconds: 30 s leaves room for it."""
    hang = [CellSpec("selftest", "a", "hang_once", 0,
                     make_params(flag_dir=str(tmp_path), hang_s=600.0))]
    eng = SweepEngine(workers=2, cell_timeout=30.0, **FAST)
    res, stats = eng.run(_ok_cells() + hang)
    assert len(res) == 5
    assert stats.n_timeouts == 1 and stats.n_poisoned == 0
    row = stats.cell_report[hang[0].key()]
    assert row["status"] == "ok" and row["timeouts"] == 1


def test_always_crashing_cell_is_poisoned_not_fatal():
    poison = [CellSpec("selftest", "a", "crash_always", 0)]
    res, stats = SweepEngine(workers=2, max_attempts=2, **FAST).run(poison)
    assert res == {}
    assert stats.n_poisoned == 1 and stats.n_pool_rebuilds == 2
    assert stats.cell_report[poison[0].key()] == {
        "attempts": 2, "crashes": 2, "timeouts": 0, "status": "poisoned"}


def test_selftest_cells_run_inline_as_in_jax(tmp_path):
    """The ``ok`` cells, and the argument checks, in this process."""
    from repro.sweep import run_cell as jax_run_cell
    from repro.sweep.cells import CellSpec as JaxCellSpec
    for i in range(3):
        assert run_cell(CellSpec("selftest", "a", "ok", i)) \
            == jax_run_cell(JaxCellSpec("selftest", "a", "ok", i))
    with pytest.raises(ValueError, match="flag_dir"):
        run_cell(CellSpec("selftest", "a", "hang_once", 0))
    with pytest.raises(ValueError, match="scenario"):
        run_cell(CellSpec("selftest", "a", "nonsense", 0))
    res, stats = SweepEngine(workers=1).run(_ok_cells())
    assert len(res) == 4 and stats.n_retried == stats.n_poisoned \
        == stats.n_timeouts == stats.n_pool_rebuilds == 0
