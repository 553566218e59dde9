"""How the device time of each program span (``repro_torch.spans``) reads
in one traced window of a benchmark cell, counted three ways from the
same profiler events.

    python3 scripts/span_mirror.py --workload <cell> --seed <n>
                                   [--device cuda|cpu]

The cell is set up as ``bench/run.py`` sets it up, and its traced work
(the driver's ``traced``) runs under ``torch.profiler`` as in
``bench.trace.capture``. For each range that starts in the window it
prints: ``device_time_total_ms``, the torch tree's sum, which
``bench/trace.py::reduce`` reads as the span's device time;
``kernels_ms``, the kernels attached to the range and to the operations
beneath it, leaving out the profiler's "Command Buffer Full" events (a
host wait on a full launch queue, which shares the waiting operation's
correlation id and gets kernels attached too); ``mirror_ms``, the range's
device-side mirror, from its first kernel's start to its last one's end;
``busy_ms``, the union of the device's intervals inside the mirror (the
mirror without its idle); and ``full_waits``, the "Command Buffer Full"
events beneath it. Then the window's busy time (``bench.trace``'s union
of device intervals) and each reading's share of it, and, where the
traced work prefilled, the prefills' model operations over each reading
of ``serve.prefill`` as a share of the bf16 peak.

A serving cell adds the host clock of a prefill and of a decode step at
the replay's shortest and longest prompt, the median of five calls:
without a profiler, under the benchmark's profiler (host and device
activities), and on the card under a profiler of the device's activity
alone. Prints one JSON object.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import (ProfilerActivity, profile,  # noqa: E402
                            record_function)

from bench import roofline, trace  # noqa: E402
from bench.cell import load  # noqa: E402
from bench.harness import Context, sync  # noqa: E402
from repro_torch.spans import PREFIX  # noqa: E402

FULL = "Command Buffer Full"
READINGS = ("device_time_total", "kernels", "mirror", "busy")
CALLS = 5


def ranges(events, lo: float, hi: float) -> Dict[str, dict]:
    """The program's ranges that start in [lo, hi), by name, each read
    three ways."""
    rows: Dict[str, dict] = {}
    for e in events:
        if e.device_type == DeviceType.CUDA or \
                not e.name.startswith(PREFIX) or \
                not lo <= e.time_range.start < hi:
            continue
        r = rows.setdefault(e.name, dict(
            {f"{k}_ms": 0.0 for k in READINGS}, n=0, full_waits=0))
        r["n"] += 1
        r["device_time_total_ms"] += e.device_time_total / 1e3
        todo = [e]                  # e and the CPU events beneath it
        while todo:
            x = todo.pop()
            if x.name == FULL:
                r["full_waits"] += 1
                continue
            r["kernels_ms"] += sum(k.duration for k in x.kernels) / 1e3
            todo.extend(x.cpu_children)
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    iv = sorted((e.time_range.start, e.time_range.end) for e in dev
                if not e.name.startswith((PREFIX, "Command Buffer",
                                          "ProfilerStep", trace.WINDOW)))
    starts = [a for a, _ in iv]
    longest = max((b - a for a, b in iv), default=0.0)
    inside: Dict[str, list] = {}
    for e in dev:
        if e.name in rows and e.time_range.start >= lo:
            a, b = e.time_range.start, e.time_range.end
            rows[e.name]["mirror_ms"] += (b - a) / 1e3
            i, j = (bisect.bisect_left(starts, a - longest),
                    bisect.bisect_left(starts, b))
            inside.setdefault(e.name, []).extend(
                (max(x, a), min(y, b)) for x, y in iv[i:j]
                if min(y, b) > max(x, a))
    for name, got in inside.items():
        rows[name]["busy_ms"] = sum(
            b - a for a, b in trace._union(got)) / 1e3
    return rows


def traced_window(drv, st, device) -> dict:
    """The driver's traced work under the benchmark's profiler (warm-up
    call, then the window), read as ``bench.trace`` reads it and per
    range three ways."""
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts) as prof:
        drv.traced(st)
        sync(device)
        with record_function(trace.WINDOW):
            t0 = time.perf_counter()
            traced = drv.traced(st)
            sync(device)
            host_s = time.perf_counter() - t0
    events = prof.events()
    t = trace.reduce(events, host_s)
    win = next(e for e in events if e.name == trace.WINDOW and
               e.device_type != DeviceType.CUDA)
    rows = ranges(events, win.time_range.start, win.time_range.end)
    busy_ms = t.busy_s * 1e3
    for r in rows.values():
        for k in READINGS:
            r[f"{k}_share"] = 100.0 * r[f"{k}_ms"] / busy_ms \
                if busy_ms else None
    out = {"busy_ms": busy_ms, "window_ms": t.window_s * 1e3,
           "traced_host_s": host_s, "ranges": rows,
           "idle_gaps": t.breakdown()["idle_gaps"], "traced": traced}
    pf, pre = traced.get("prefills"), rows.get(PREFIX + "serve.prefill")
    if pf and pre:
        flops = sum(roofline.prefill_flops(st.ctx.config, B, P)
                    for B, P, _ in pf)
        out["prefill_mfu"] = {
            k: 100.0 * flops / (pre[f"{k}_ms"] / 1e3) / roofline.PEAK_FLOPS
            for k in READINGS if pre[f"{k}_ms"] > 0}
    return out


def host_clock(st, device) -> dict:
    """A serving cell's prefill and decode-step host time at its shortest
    and longest prompt, without a profiler, under the host and device
    profiler, and on the card under the device's alone; each the median
    of ``CALLS`` calls after one outside the count."""
    t = st.ctx.traffic
    B, G = t["batch"], t["gen_len"]
    modes = {"plain": None,
             "cpu_and_cuda": [ProfilerActivity.CPU, ProfilerActivity.CUDA]}
    if device.type == "cuda":
        modes["cuda_only"] = [ProfilerActivity.CUDA]
    out = {}
    for P in (min(st.prefill), max(st.prefill)):
        def one():
            sync(device)
            t0 = time.perf_counter()
            nxt, cache = st.prefill[P](
                {"tokens": st.ctx.tokens((B, P), "span_mirror", P)})
            sync(device)
            t1 = time.perf_counter()
            for j in range(G - 1):
                nxt, _, cache = st.decode(cache, nxt, P + j)
            sync(device)
            return {"prefill_s": t1 - t0,
                    "decode_step_ms": 1e3 * (time.perf_counter() - t1)
                    / (G - 1)}
        row = {}
        for mode, acts in modes.items():
            with profile(activities=acts) if acts else nullcontext():
                one()
                calls = [one() for _ in range(CALLS)]
            row[mode] = {k: statistics.median(c[k] for c in calls)
                         for k in calls[0]}
        out[f"P{P}"] = row
    return out


def measure(cell, seed: int, device: torch.device) -> dict:
    drv = cell.driver()
    st = drv.setup(Context(cell, seed, device))
    sync(device)
    out = {"workload": cell.name, "seed": seed,
           "device": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu"}
    out.update(traced_window(drv, st, device))
    if hasattr(st, "decode"):
        out["host_clock"] = host_clock(st, device)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps(measure(load(ROOT, args.workload), args.seed,
                             torch.device(args.device))))


if __name__ == "__main__":
    main()
