"""The trace reduction on synthetic profiler events: busy time as a union
of intervals clipped to the window, kernel times, span device time, idle
gaps by the host operation running meanwhile."""
from __future__ import annotations

from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

from bench import trace


def ev(name, a, b, device=False, parent=None, dev_us=0.0, note=False):
    return NS(name=name, time_range=NS(start=a, end=b),
              device_type=DeviceType.CUDA if device else DeviceType.CPU,
              cpu_parent=parent, device_time_total=dev_us,
              is_user_annotation=note)


def test_reduce():
    win = ev(trace.WINDOW, 0, 1000, note=True)
    step = ev("aten::mm", 10, 400, parent=win)
    back = ev("repro_torch::flash_attention_backward", 500, 900, dev_us=150,
              note=True)
    warm = ev("repro_torch::flash_attention_backward", -400, -100,
              dev_us=70, note=True)           # the warm-up, before the range
    events = [win, step, back, warm,
              ev("attn_fwd_tc<64>", -300, -200, device=True),  # warm-up
              ev("attn_fwd_tc<64>", 100, 200, device=True),
              ev("nvjet_gemm", 150, 300, device=True),        # overlaps
              ev("attn_fwd_tc<64>", 600, 700, device=True),
              ev("Memcpy HtoD", 950, 1100, device=True),      # clipped
              ev("repro_torch::flash_attention_backward", 600, 700,
                 device=True),                                # its range
              ev("Command Buffer Full", 0, 50, device=True)]
    t = trace.reduce(events, host_window_s=0.0012)
    assert t.busy_s == pytest.approx((200 + 100 + 50) / 1e6)
    # the device's span: its first interval's start to its last one's end
    assert t.window_s == pytest.approx((1000 - 100) / 1e6)
    assert t.host_window_s == 0.0012
    assert t.kernel_s("attn_fwd_tc") == (2, pytest.approx(200 / 1e6))
    assert t.spans == {"repro_torch::flash_attention_backward":
                       pytest.approx(150 / 1e6)}
    assert t.idle_share() == pytest.approx(100 * (1 - 350 / 900))
    gaps = dict(t.gaps)
    # idle 300-600 (mid 450, between the two host operations), 700-950
    # (mid 825, under the backward's range); nothing before the first
    # interval counts
    assert gaps == {"host outside any operation": pytest.approx(300 / 1e6),
                    "repro_torch::flash_attention_backward":
                    pytest.approx(250 / 1e6)}
    b = t.breakdown()
    assert b["device_ops"][0] == ["attn_fwd_tc<64>", pytest.approx(2e-4)]
    assert len(b["device_ops"]) <= trace.TOP >= len(b["idle_gaps"])


def test_capture_reads_the_second_call():
    """The traced work runs once as the profiler's warm-up and once inside
    the window; the second call's result comes back."""
    import torch
    calls = []

    def work():
        calls.append(len(calls))
        return torch.ones(64, 64) @ torch.ones(64, 64), len(calls)

    (x, n), t = trace.capture(work, torch.device("cpu"))
    assert n == 2 and calls == [0, 1]
    assert t.host_window_s > 0 and t.busy_s == 0 and t.window_s == 0


def test_metric_readers_of_the_device_layer():
    from types import SimpleNamespace as R
    from bench.cell import metric_reader
    t = trace.Trace(window_s=2.0, busy_s=1.5, kernels={}, spans={},
                    gaps=[])
    idle = metric_reader("idle_share.train")
    assert idle.read(R(trace=t)) == pytest.approx(25.0)
    assert idle.read(R(trace=trace.Trace(0.0, 0.0, {}, {}, []))) is None
    peak = metric_reader("peak_mem_gib.prefill")
    assert peak.read(R(peak_bytes=3 * 2 ** 30)) == 3.0
