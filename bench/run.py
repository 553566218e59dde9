"""Run one cell of BENCHMARK.json once, on the card this process is given.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (from process start: the program's model built from the cell's
configuration file and loaded with weights made on the card from the seed,
every shape the traffic uses warmed up), then a window of ``--seconds`` in
which the cell's driver (``drivers/<driver>.py``, named by its traffic
file) drives the program, then, with ``--trace 1``, a short traced window
reduced to the cell's per-layer metrics (``metrics/<metric>.py``). Once
the windows are closed and the peak memory read, the program is freed and
the plain reference (``reference/``) checks what the timed path produced;
each number compared is printed beside its limit (``limits/<cell>.json``)
as the last lines on standard error and under ``check`` in the result.
The last line of standard output is the result, one JSON object.

For measuring the limits: ``--control fp8`` puts the reference one
precision down in the program's place, and ``--fault half_batch`` (training)
a reference that takes the loss over half of each batch.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Iterable, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: modules that may not be loaded in a run, by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden(modules: Iterable[str]) -> List[str]:
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def fail(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"


def window(drv, state, seconds: float, device) -> float:
    """Drive units of work until ``seconds`` have passed; the elapsed time
    to the end of the last unit, synchronised."""
    from bench.harness import sync
    sync(device)
    t0 = time.perf_counter()
    while True:
        drv.unit(state)
        if time.perf_counter() - t0 >= seconds:
            break
    drv.close(state)
    return time.perf_counter() - t0


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: Optional[str] = None,
             fault: Optional[str] = None) -> dict:
    """One run of ``cell`` on ``device``; the result's fields (``device``
    without the card's name) and ``check``."""
    import torch
    from bench.cell import metric_reader
    from bench.harness import Context, free, sync

    drv = cell.driver()
    ctx = Context(cell, seed, device, control, fault)
    cuda = device.type == "cuda"
    if cuda:
        torch.empty(0, device=device)          # the context, then the stats
        torch.cuda.reset_peak_memory_stats(device)
    state = drv.setup(ctx)
    sync(device)
    setup_s = time.perf_counter() - t_start
    stand_in = getattr(drv, "STANDS_IN", False) and bool(control or fault)
    elapsed = 0.0 if stand_in else window(drv, state, seconds, device)
    e2e = drv.end_to_end(state, elapsed) if elapsed else {}
    e2e["setup_s"] = setup_s
    run = SimpleNamespace(config=cell.config, traffic=cell.traffic,
                          window=drv.window_record(state, elapsed),
                          trace=None, traced={}, peak_bytes=0)
    if trace and not stand_in:
        from bench import trace as tr
        run.traced, run.trace = tr.capture(lambda: drv.traced(state),
                                            device)
    run.peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    layer = {}
    if trace:
        for m in cell.per_layer:
            v = None if run.trace is None else \
                metric_reader(m["name"]).read(run)
            if v is not None:
                layer[m["name"]] = {"value": v, "unit": m["unit"]}
    want = layer if trace else {
        m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
        for m in cell.end_to_end if m["name"] in e2e}
    attempted = drv.attempted(state)
    evidence = drv.release(state)
    del state
    free(device)
    numbers = drv.check(ctx, evidence)
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in cell.limits.items()}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": attempted, "failed": 0, "metrics": want,
           "device": {"platform": "gpu" if cuda else device.type,
                      "count": 1, "memory_peak_bytes": run.peak_bytes},
           "info": {k: v for k, v in numbers.items() if k not in checks}}
    out["info"]["end_to_end"] = e2e
    if run.trace is not None:
        out["device"].update(busy_s=run.trace.busy_s,
                             window_s=run.trace.window_s)
        out["info"]["traced_host_s"] = run.trace.host_window_s
        out["breakdown"] = run.trace.breakdown()
    out["check"] = checks
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8",), default=None)
    ap.add_argument("--fault", choices=("half_batch",), default=None)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("the program (src/repro_torch) is not in this checkout")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    import torch
    torch.set_num_threads(4)
    from bench.cell import load
    cell = load(ROOT, args.workload)
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} found")
    card = power_limit()
    device = torch.device("cuda", 0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   T_START, args.control, args.fault)
    bad = forbidden(sys.modules)
    if bad:
        fail(f"loaded in this run: {bad}")
    print(json.dumps(result_line(out, torch.cuda.get_device_name(device),
                                 card)), flush=True)


def result_line(out: dict, kind: str, card: str) -> dict:
    """The run's result with the card's name and power limit beside the
    peaks, ``check`` last; prints the numbers compared, each beside its
    limit, as the last lines of standard error."""
    from bench import roofline
    out = dict(out)
    checks = out.pop("check")
    out["device"] = dict(out["device"], kind=kind)
    out["card"] = card
    out["peaks"] = {"bf16_flops_s": roofline.PEAK_FLOPS,
                    "hbm_bytes_s": roofline.PEAK_BYTES}
    out["check"] = checks
    for k, v in out["info"].items():
        print(f"info {k} {v!r}", file=sys.stderr)
    print(f"card {card}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return out


if __name__ == "__main__":
    main()
