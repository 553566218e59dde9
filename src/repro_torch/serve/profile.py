"""Profile the serving path on the card: a warm prefill and a few greedy
decode steps under ``torch.profiler``, at full width and depth.

Run:  PYTHONPATH=src python -m repro_torch.serve.profile [--arch ARCH]
                  [--prompt-len P] [--n-layers L] [--frames F]

The configuration is one of chip_smoke.py's serving runs: 8 requests of
``--prompt-len`` tokens (512 by default; chip_smoke.py gives hymba-1.5b
2048, whisper-medium 224 beside 3000 frames) of ``--arch`` (qwen3-4b by
default, or any other arch; ``--n-layers`` cuts the depth, as
chip_smoke.py runs dbrx-132b at 8 layers and arctic-480b at 2), with 4
profiled decode steps. Encdec's frames and vlm's patches are
``models.side_inputs``'s, and vlm's positions count its patch prefix.

Prints one JSON line: host-clock prefill seconds and decode ms per step
(without the profiler, after a warm-up; the median of 11 runs of each, and
the runs), then, under the profiler, the
device's busy share of each window (kernel time over the window's wall
time, which the profiler lengthens) and the kernels that take the most
device time.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model, prefix_len, side_inputs
from repro_torch.train import make_prefill_step, make_serve_step

REQUESTS, STEPS, TOP, REPEATS = 8, 4, 12, 11


def _window(fn):
    """Run fn under the profiler; (wall s, busy share, top kernels). Busy
    time sums the device's kernel and memcpy records only (not the aten
    ops that launched them, which would count the same time twice)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: Dict[str, List[float]] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or \
                e.name.startswith("Command Buffer"):
            continue
        rec = by_name.setdefault(e.name[:90], [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.elapsed_us()
    busy_us = sum(us for _, us in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    kernels = [{"name": n, "count": c, "device_ms": us / 1e3}
               for n, (c, us) in ranked]
    return wall, busy_us / 1e6 / wall, kernels


@torch.no_grad()
def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None,
                    help="encdec: audio frames a request (default: the "
                         "prompt length)")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    cfg = get_config(args.arch)
    if args.n_layers:
        cfg = cfg.scaled(n_layers=args.n_layers)
    B, P, G = REQUESTS, args.prompt_len, STEPS + 1
    model = build_model(cfg, device=dev)
    model.init_params(torch.Generator(device=dev).manual_seed(0))
    batch = {"tokens": torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab, (B, P)), dtype=torch.int32, device=dev)}
    for name, x in side_inputs(cfg, B, seed=1,
                               n_frames=args.frames or P).items():
        batch[name] = torch.as_tensor(x, device=dev).to(cfg.tdtype)
    P += prefix_len(cfg)
    prefill = make_prefill_step(model, cache_len=P + G)
    decode = make_serve_step(model)
    nxt, cache = prefill(batch)                        # warm-up
    decode(cache, nxt, P)
    state = {}

    def run_prefill():
        state["nxt"], state["cache"] = prefill(batch)

    def run_decode():
        nxt = state["nxt"]
        for i in range(STEPS):
            nxt, _, _ = decode(state["cache"], nxt, P + i)

    def host_clock(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # in turns, as the host's clock varies from one moment to the next
    runs = [(host_clock(run_prefill), host_clock(run_decode))
            for _ in range(REPEATS)]
    pf_runs = [pf for pf, _ in runs]
    dec_runs = [dec / STEPS * 1e3 for _, dec in runs]
    pf_prof_s, pf_busy, pf_top = _window(run_prefill)
    dec_prof_s, dec_busy, dec_top = _window(run_decode)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "arch": cfg.name,
        "n_layers": cfg.n_layers, "requests": B,
        "prompt_len": P,                    # vlm: with its patch prefix
        "decode_steps": STEPS,
        "prefill_s": float(np.median(pf_runs)), "prefill_s_runs": pf_runs,
        "decode_ms_per_step": float(np.median(dec_runs)),
        "decode_ms_per_step_runs": dec_runs,
        "profiled_prefill_s": pf_prof_s, "prefill_device_busy": pf_busy,
        "profiled_decode_ms_per_step": dec_prof_s / STEPS * 1e3,
        "decode_device_busy": dec_busy,
        "prefill_top": pf_top, "decode_top": dec_top}), flush=True)


if __name__ == "__main__":
    main()
