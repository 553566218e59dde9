"""The readers of the program's spans on synthetic traces: their values, and
None where their span did not run in the window (a renamed span reads
null, not 0); the trace reduction credits an idle gap inside the decode
step's range to that range, not to the operation beneath it."""
from __future__ import annotations

import importlib.util
from pathlib import Path
from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

from bench import roofline, trace
from bench.cell import metric_reader

ROOT = Path(__file__).resolve().parents[2]
CONFIG = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
          "head_dim": 16, "d_ff": 128, "vocab": 250}
OPT = "repro_torch::train.optimizer"
HEAD = "repro_torch::model.unembed"
DECODE = "repro_torch::serve.decode_step"
PREFILL = "repro_torch::serve.prefill"


def tr(spans, gaps=(), busy=2.0, window=4.0):
    return trace.Trace(window_s=window, busy_s=busy, kernels={},
                       spans=dict(spans), gaps=list(gaps))


def run(t, prefills=()):
    return NS(trace=t, config=CONFIG, traced={"prefills": list(prefills)})


PFS = [[16, 512, 0.1], [16, 4092, 0.9]]
FLOPS = sum(roofline.prefill_flops(CONFIG, B, P) for B, P, _ in PFS)
CASES = {
    # metric -> (trace with its span, value; trace without it)
    "optimizer_share.train": (tr({OPT: 0.5}), 25.0,
                              tr({"repro_torch::train.forward": 1.0})),
    "unembed_share.prefill": (tr({HEAD: 0.1, PREFILL: 1.5}), 5.0,
                              tr({PREFILL: 1.5})),
    "decode_idle_share.prefill": (
        tr({DECODE: 0.2}, [(DECODE, 0.3), ("aten::mm", 0.1)]), 7.5,
        tr({}, [("aten::mm", 0.1)])),
    "prefill_mfu.prefill": (
        tr({PREFILL: 2.0}), 100.0 * FLOPS / 2.0 / roofline.PEAK_FLOPS,
        tr({"repro_torch::serve.route": 0.01})),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_value(name):
    t, want, _ = CASES[name]
    assert metric_reader(name).read(run(t, PFS)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_none_without_its_span(name):
    _, _, t = CASES[name]
    assert metric_reader(name).read(run(t, PFS)) is None


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_none_on_an_empty_trace(name):
    """The parent commit's program records none of these ranges."""
    assert metric_reader(name).read(run(tr({}, busy=0.0, window=0.0))) \
        is None


def test_decode_step_without_idle_reads_zero():
    """The span ran and the device never waited under it: 0, not None."""
    t = tr({DECODE: 0.2}, [("aten::mm", 0.1)])
    assert metric_reader("decode_idle_share.prefill").read(run(t)) == 0.0


def test_prefill_mfu_none_without_traced_prefills():
    assert metric_reader("prefill_mfu.prefill").read(
        run(tr({PREFILL: 2.0}))) is None


def ev(name, a, b, device=False, parent=None, dev_us=0.0, note=False):
    return NS(name=name, time_range=NS(start=a, end=b),
              device_type=DeviceType.CUDA if device else DeviceType.CPU,
              cpu_parent=parent, device_time_total=dev_us,
              is_user_annotation=note)


def test_idle_gap_is_credited_to_the_decode_step():
    """Inside the window: a prefill range, then a decode step's range that
    holds an aten op; the device idles while the host is in the op. The
    gap goes to the outermost range, the decode step."""
    win = ev(trace.WINDOW, 0, 1000, note=True)
    pre = ev(PREFILL, 10, 300, parent=win, dev_us=250, note=True)
    head = ev(HEAD, 200, 290, parent=pre, dev_us=40, note=True)
    dec = ev(DECODE, 400, 900, parent=win, dev_us=100, note=True)
    mm = ev("aten::matmul", 420, 880, parent=dec)
    events = [win, pre, head, dec, mm,
              ev("nvjet_gemm", 20, 270, device=True),
              ev("nvjet_gemm", 270, 310, device=True),
              ev("attn_decode_split", 850, 950, device=True),
              ev(PREFILL, 20, 310, device=True),     # the device's mirror
              ev(DECODE, 850, 950, device=True)]
    t = trace.reduce(events, host_window_s=0.001)
    assert t.spans == {PREFILL: pytest.approx(250e-6),
                       HEAD: pytest.approx(40e-6),
                       DECODE: pytest.approx(100e-6)}
    assert t.busy_s == pytest.approx(390e-6)
    gaps = dict(t.gaps)
    # idle 310-850, mid 580: inside the aten op, inside the decode step
    assert gaps == {DECODE: pytest.approx(540e-6)}
    assert "aten::matmul" not in gaps
    got = metric_reader("decode_idle_share.prefill").read(run(t))
    assert got == pytest.approx(100 * 540 / (950 - 20))
    assert metric_reader("unembed_share.prefill").read(run(t)) == \
        pytest.approx(100 * 40 / 390)


def _span_mirror():
    spec = importlib.util.spec_from_file_location(
        "span_mirror", ROOT / "scripts" / "span_mirror.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("driver", ["train", "prefill"])
def test_span_mirror_script_on_a_tiny_cell(driver):
    """scripts/span_mirror.py reads every program range of a traced window
    three ways; on the CPU the device readings are 0, the counts hold."""
    import torch
    from bench.cell import Cell
    from bench.tests.test_bench_run import DENSE, PREFILL, TRAIN
    traffic = dict(TRAIN if driver == "train" else PREFILL)
    c = Cell("tiny", 1, DENSE, traffic, {}, [], [])
    out = _span_mirror().measure(c, 2 ** 31 + 7, torch.device("cpu"))
    got = {k: r["n"] for k, r in out["ranges"].items()}
    if driver == "train":
        assert got == {"repro_torch::train.forward": 1,
                       "repro_torch::model.unembed": 1,
                       "repro_torch::train.optimizer": 1,
                       "repro_torch::flash_attention_backward": 2}
        assert "host_clock" not in out
    else:
        n, G = traffic["traced_batches"], traffic["gen_len"]
        assert got == {"repro_torch::serve.route": n,
                       "repro_torch::serve.prefill": n,
                       "repro_torch::serve.decode_step": n * (G - 1),
                       "repro_torch::model.unembed": n * G}
        assert set(out["host_clock"]) == {"P16", "P32"}
    for r in out["ranges"].values():
        assert r["mirror_ms"] == r["busy_ms"] == r["full_waits"] == 0
        assert r["kernels_ms"] == r["device_time_total_ms"] == 0


def test_span_mirror_reads_a_range_four_ways():
    """A range whose operation waited on a full launch queue: the torch
    tree counts the kernels again under the wait, the kernels without the
    wait miss one attached to the wait alone, the mirror spans the idle
    between the kernels, and the busy time inside the mirror has neither
    fault."""
    def cpu(name, a, b, children=(), kernels=(), dev_us=0.0):
        return NS(name=name, device_type=DeviceType.CPU,
                  time_range=NS(start=a, end=b), cpu_children=list(children),
                  kernels=[NS(duration=d) for d in kernels],
                  device_time_total=dev_us)

    wait = cpu("Command Buffer Full", 150, 160, kernels=[50, 30],
               dev_us=80)
    op = cpu("aten::mm", 120, 180, [wait], kernels=[50], dev_us=130)
    rng = cpu(DECODE, 100, 500, [op], dev_us=130)
    gpu = [NS(name=n, device_type=DeviceType.CUDA,
              time_range=NS(start=a, end=b)) for n, a, b in
           [("nvjet_gemm", 200, 250), ("argmax", 300, 330),
            (DECODE, 200, 330), ("Command Buffer Full", 150, 160)]]
    rows = _span_mirror().ranges([rng, op, wait] + gpu, 0, 1000)
    assert rows == {DECODE: {
        "n": 1, "full_waits": 1, "device_time_total_ms": 0.13,
        "kernels_ms": 0.05, "mirror_ms": 0.13,
        "busy_ms": pytest.approx(0.08)}}
