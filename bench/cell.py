"""A cell of ``BENCHMARK.json``, found by name: its entry, its configuration
file, its traffic file (``traffic/<traffic>.json``), its limits
(``limits/<cell>.json``), and the metrics it reports. Adding a cell, a
configuration, a traffic mix or a metric adds files and entries; nothing
here names one."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict               # the configuration file, as it is run
    traffic: dict              # the traffic file
    limits: Dict[str, float]   # number compared -> its limit
    end_to_end: List[dict]     # the manifest's metrics this cell reports
    per_layer: List[dict]

    def driver(self) -> ModuleType:
        return importlib.import_module(
            f"bench.drivers.{self.traffic['driver']}")


def manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str, e2e: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e if "moves" in metric else True


def load(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json."""
    m = manifest(root)
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in m['workloads']]}")
    conf = next(c for c in m["configs"] if c["name"] == entry["config"])
    e2e = [x for x in m["end_to_end"] if _reports(x, name, [])]
    names = [x["name"] for x in e2e]
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
    return Cell(name=name, chips=entry["chips"],
                config=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads((BENCH / "traffic" /
                                    f"{entry['traffic']}.json").read_text()),
                limits={k: v["limit"] for k, v in limits.items()},
                end_to_end=e2e,
                per_layer=[x for x in m["per_layer"]
                           if _reports(x, name, names)])


def family_module(kind: str, family: str) -> ModuleType:
    """``<kind>/<family>.py`` of a configuration's ``family``: its reference
    (``reference``) or its operation count (``counts``), so a family is
    added as files."""
    if not (BENCH / kind / f"{family}.py").is_file():
        raise ValueError(f"no {kind} for family {family!r}")
    return importlib.import_module(f"bench.{kind}.{family}")


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py``, or else ``metrics/<name up to its first
    dot>.py``, the reader that one quantity shares across the kinds of
    cell: its ``read(run)`` gives the metric's value, or None where the run
    holds nothing for it to read."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        path = BENCH / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
