"""A traced window under ``torch.profiler``, reduced to what the per-layer
metrics read: the device's busy time as the union of its kernel, copy and
set intervals inside the window, over the window's span on the device's
own timeline, from its first interval's start to its last one's end (not a
sum of records over a host wall time that the profiler lengthens); each
kernel's count and device time; the device time inside each of the
program's profiler ranges (its spans) in the window; and the device's idle
gaps by what the host was doing meanwhile.

The traced work runs twice under the profiler: once as its warm-up, outside
the window's range, so that the profiler's start-up falls outside it, and
once inside the range, which alone is read."""
from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench::window"
TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float                            # the device's span
    busy_s: float                              # union of device intervals
    kernels: Dict[str, Tuple[int, float]]      # name -> (count, seconds)
    spans: Dict[str, float]                    # range name -> device s
    gaps: List[Tuple[str, float]]              # host activity, idle s
    host_window_s: float = 0.0                 # host clock, synchronised

    def kernel_s(self, part: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds
        ``part``."""
        hits = [v for k, v in self.kernels.items() if part in k]
        return sum(n for n, _ in hits), sum(s for _, s in hits)

    def idle_share(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
        return {"device_ops": [[k, s] for k, (_, s) in ops],
                "idle_gaps": [[k, s] for k, s in self.gaps[:TOP]]}


def _device_time_us(e) -> float:
    t = getattr(e, "device_time_total", None)
    return t if t is not None else e.cuda_time_total


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def capture(fn: Callable[[], object], device: torch.device
            ) -> Tuple[object, Trace]:
    """Run fn twice under the profiler (the host's and the device's
    activities), the second time inside the window's range, synchronised
    at both ends; returns (the second call's result, its Trace)."""
    from bench.harness import sync
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts) as prof:
        fn()
        sync(device)
        with record_function(WINDOW):
            t0 = time.perf_counter()
            out = fn()
            sync(device)
            host_s = time.perf_counter() - t0
    return out, reduce(prof.events(), host_s)


def reduce(events, host_window_s: float) -> Trace:
    cpu = [e for e in events if e.device_type != DeviceType.CUDA]
    ranges = {e.name for e in cpu if getattr(e, "is_user_annotation", False)
              or e.name == WINDOW or e.name.startswith("repro_torch::")}
    win = next(e for e in cpu if e.name == WINDOW)
    lo, hi = win.time_range.start, win.time_range.end
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    iv = []
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in ranges or \
                e.name.startswith(("Command Buffer", "ProfilerStep")):
            continue
        a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if b <= a:
            continue
        iv.append((a, b))
        rec = kernels[e.name]
        rec[0] += 1
        rec[1] += (b - a) / 1e6
    merged = _union(iv)
    busy = sum(b - a for a, b in merged) / 1e6
    first, last = (merged[0][0], merged[-1][1]) if merged else (lo, lo)
    spans: Dict[str, float] = defaultdict(float)
    for e in cpu:
        if e.name in ranges and e.name != WINDOW and \
                lo <= e.time_range.start < hi:
            spans[e.name] += _device_time_us(e) / 1e6
    return Trace(window_s=(last - first) / 1e6, busy_s=busy,
                 kernels={k: (n, s) for k, (n, s) in kernels.items()},
                 spans=dict(spans),
                 gaps=_gaps(cpu, win, merged, first, last),
                 host_window_s=host_window_s)


def _gaps(cpu, win, merged, lo: float, hi: float
          ) -> List[Tuple[str, float]]:
    """Idle device time between the window's first and last device
    intervals, summed by the outermost host operation running at each
    gap's middle (beneath the window's range), largest first."""
    outer = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in cpu if e is not win and
                   (e.cpu_parent is None or e.cpu_parent is win))
    starts = [s for s, _, _ in outer]
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    by: Dict[str, float] = defaultdict(float)
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid, name = (a + b) / 2, "host outside any operation"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 8, -1), -1):   # a few threads overlap
            if outer[j][1] >= mid:
                name = outer[j][2]
                break
        by[name] += (b - a) / 1e6
    return sorted(by.items(), key=lambda kv: -kv[1])
