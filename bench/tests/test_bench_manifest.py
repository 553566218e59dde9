"""BENCHMARK.json against the benchmark's contract, and every entry against
the files it names; a cell, a traffic mix and a metric added as files and
entries alone are found."""
from __future__ import annotations

import importlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench import cell as cells
from bench import roofline

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|^(d_model|d_ff|head_dim|n_heads|"
                    r"n_kv_heads|decay_lora|moe_topk|hidden|intermediate)")
M = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in M["workloads"]]


def test_manifest_shape():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"][0] == "python3" and len(M["command"]) <= 32
    assert all(Path(p).parts[0] in M["paths"] for p in M["command"][1:])
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in M[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for x in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for x in M["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    assert any(x["name"] == "setup_s" for x in M["end_to_end"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == \
        len(M["workloads"])
    e2e = {x["name"] for x in M["end_to_end"]}
    for x in M["per_layer"]:
        assert set(x) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert x["moves"] in e2e and set(x["workloads"]) <= set(CELLS)
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("conf", M["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    f = json.loads((ROOT / conf["file"]).read_text())
    assert Path(conf["file"]).parts[0] in M["paths"]
    assert f["name"] == conf["name"] and f["source"] == conf["source"]
    assert f["reduced"] == conf["reduced"]
    assert not [k for k in conf["reduced"] if WIDTHS.search(k)]
    assert any(w["config"] == conf["name"] for w in M["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    c = cells.load(ROOT, name)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer and set(c.limits)
    drv = c.driver()
    for fn in ("setup", "unit", "close", "end_to_end", "window_record",
               "attempted", "traced", "release", "check"):
        assert callable(getattr(drv, fn))
    for m in c.per_layer:
        assert callable(cells.metric_reader(m["name"]).read)
        assert m["moves"] in reported


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    """metrics/<name>.py, or the reader its quantity shares across the
    kinds of cell, metrics/<name up to its first dot>.py."""
    have = {p.name[:-3] for p in (ROOT / "bench" / "metrics").glob("*.py")}
    name = metric["name"]
    assert name in have or name.split(".")[0] in have


ADDED = '''
import json, sys, time
sys.path[:0] = [".", {src!r}]
import torch
from bench.cell import load, metric_reader
from bench.run import run_cell
c = load(__import__("pathlib").Path("."), {cell!r})
from types import SimpleNamespace
v = metric_reader("batches.short_docs").read(
    SimpleNamespace(window={{"batches": 2}}))
mfu = metric_reader("step_mfu.prefill").read(SimpleNamespace(
    config=c.config, window={{"prefills": [[2, 8, 0.5]]}}))
out = run_cell(c, 7, 0.2, False, torch.device("cpu"), time.perf_counter())
print(json.dumps({{"v": v, "mfu": mfu,
                  "per_layer": [m["name"] for m in c.per_layer],
                  "metrics": sorted(out["metrics"]),
                  "correct": out["correct"]}}))
'''
FAMILIES = Path(__file__).resolve().parent / "families"
#: a second family added as files: the program's ``moe`` at a tiny size,
#: where its capacity (at least 128 rows an expert) drops no pair, so the
#: dropless reference of ``families/moe_reference.py`` must agree
TINY = {"dense": {},
        "moe": {"family": "moe", "n_experts": 4, "moe_topk": 2}}


@pytest.mark.parametrize("family", sorted(TINY))
def test_added_by_files_alone(tmp_path, family):
    """A configuration, a traffic mix, a cell's limits and a metric added
    to a copy as new files and new manifest entries run without an edit to
    any file the benchmark has; a family other than dense adds its
    reference and its operation count as files too."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp_path / "bench"
    before = {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}
    if family != "dense":
        shutil.copy(FAMILIES / f"{family}_reference.py",
                    b / "reference" / f"{family}.py")
        shutil.copy(FAMILIES / f"{family}_count.py",
                    b / "counts" / f"{family}.py")
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "bench/configs/granite-3-2b.json").read_text())
    name, cell = f"tiny-{family}", f"tiny-{family}.short_docs"
    conf.update(name=name, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                head_dim=16, d_ff=128, vocab=250, **TINY[family])
    (b / f"configs/{name}.json").write_text(json.dumps(conf))
    traffic = json.loads((b / "traffic/docqa_b16.json").read_text())
    traffic.update(batch=2, prompt_lens=[8, 24], length_weights=[3, 1],
                   gen_len=3, rate=40.0, check_requests=2)
    (b / "traffic/short_docs.json").write_text(json.dumps(traffic))
    (b / f"limits/{cell}.json").write_text(
        json.dumps({"logit_gap": {"limit": 0.05}}))
    (b / "metrics/batches.short_docs.py").write_text(
        "def read(run):\n    return float(run.window['batches'])\n")
    m["configs"].append({"name": name, "source": "a test",
                         "file": f"bench/configs/{name}.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": cell, "config": name,
                           "traffic": "short_docs", "chips": 1,
                           "why": "a test"})
    m["end_to_end"].append({"name": "ttft_p50_ms", "unit": "ms",
                            "better": "lower", "bound": 0.25,
                            "source": "host_clock", "workloads": [cell]})
    for x in m["per_layer"]:
        if x["name"] == "step_mfu.prefill":
            x["workloads"].append(cell)
    m["per_layer"].append({"name": "batches.short_docs", "unit": "1",
                           "better": "higher", "source": "host_clock",
                           "layer": "serving flow",
                           "moves": "ttft_p50_ms", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    out = subprocess.run([sys.executable, "-c",
                          ADDED.format(src=str(ROOT / "src"), cell=cell)],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert all(p.read_bytes() == data for p, data in before.items())
    got = json.loads(out.stdout.strip().splitlines()[-1])
    count = cells.family_module("counts", "dense") if family == "dense" \
        else importlib.import_module(f"bench.tests.families.{family}_count")
    flops = count.layers_flops(conf, 2, 8) + 2.0 * 64 * 250 * 2
    assert got == {"v": 2.0, "mfu": 100.0 * flops / 0.5 / roofline.PEAK_FLOPS,
                   "per_layer": ["step_mfu.prefill", "batches.short_docs"],
                   "metrics": ["setup_s", "ttft_p50_ms"], "correct": True}
