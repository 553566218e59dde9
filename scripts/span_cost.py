"""What a program span (``repro_torch.spans``) costs the host, and whether
its check holds on the autograd engine's threads.

    PYTHONPATH=src python3 scripts/span_cost.py [--device cuda|cpu]

Prints one JSON object: the microseconds a call of the check
(``torch._C._autograd._profiler_enabled``), of a span entered and left with
no profiler running, and of a bare ``torch.profiler.record_function`` with
no profiler running; then, for one backward under a profiler and one
without, whether it ran on the calling thread and what the check and the
process-wide flag ``torch.autograd.profiler._is_profiler_enabled`` read
there.
"""
from __future__ import annotations

import argparse
import json
import threading
import timeit

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.spans import span


def per_call_us(fn, n: int) -> float:
    """The least of 5 timings of n calls, a call."""
    return min(timeit.repeat(fn, number=n, repeat=5)) / n * 1e6


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)

    def off():
        with span("train.forward"):
            pass

    def bare():
        with torch.profiler.record_function("repro_torch::train.forward"):
            pass

    out = {"device": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu",
           "check_us": per_call_us(torch._C._autograd._profiler_enabled,
                                   200_000),
           "span_off_us": per_call_us(off, 200_000),
           "record_function_us": per_call_us(bare, 20_000)}
    caller, seen = threading.get_ident(), []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            seen.append({
                "calling_thread": threading.get_ident() == caller,
                "check": torch._C._autograd._profiler_enabled(),
                "process_flag": torch.autograd.profiler._is_profiler_enabled})
            return g * 2

    x = torch.ones(8, device=dev, requires_grad=True)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        Probe.apply(x).sum().backward()
    Probe.apply(x).sum().backward()
    out["backward_profiled"], out["backward_plain"] = seen
    print(json.dumps(out))


if __name__ == "__main__":
    main()
