"""flash_bwd_roofline.train against counts made by hand, on synthetic
traces."""
from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace as NS

import pytest

from bench.cell import metric_reader
from bench.trace import Trace

GRANITE = json.loads((Path(__file__).resolve().parents[1] / "configs" /
                      "granite-3-2b.json").read_text())
READER = metric_reader("flash_bwd_roofline.train")
# granite-3-2b at B 4 x S 1024 (H 32, G 8, D 64), by hand: the causal
# forward 4 B H D S (S + 1) / 2 = 1.7196646e10 operations, the backward
# 2.5 times that, 4.299161600e10, over 989e12/s = 43.4698 us; bytes
# 2 x 4 x 1024 x 64 x (4 x 32 + 4 x 8) + 2 x 4 x 4 x 1024 x 32 =
# 84934656 over 3.35e12/s = 25.35 us: bound by operations
LEAST_S = 4.299161600e10 / 989e12


def _run(kernels, steps=2):
    trace = Trace(window_s=1.0, busy_s=1.0, kernels=kernels, spans={},
                  gaps=[])
    return NS(config=GRANITE, trace=trace, traced={"steps": steps},
              window={"batch": 4, "seq_len": 1024})


def test_least_time_at_granites_training_shape():
    assert READER.least_s(4, 1024, 32, 8, 64) == pytest.approx(LEAST_S,
                                                               rel=1e-12)
    assert LEAST_S * 3.35e12 > 84934656


@pytest.mark.parametrize("per_call", [1, 2])
def test_reading_over_the_kernels_time(per_call):
    """Two kernels a call (dq, dk and dv) or one: 40 layers x 2 steps."""
    n = 80 * per_call
    kernels = {"void attn_bwd_dq<64>(...)": (80, 0.010),
               "void attn_fwd_tc<64, true>(...)": (160, 0.5)}
    if per_call == 2:
        kernels["void attn_bwd_dkv<64>(...)"] = (80, 0.010)
    secs = 0.010 * per_call
    got = READER.read(_run(kernels))
    assert sum(c for k, (c, _) in kernels.items() if "attn_bwd" in k) == n
    assert got == pytest.approx(100.0 * 80 * LEAST_S / secs)


@pytest.mark.parametrize("kernels", [
    {},                                              # the parent: none
    {"attn_bwd_dq<64>": (79, 0.01)},                 # not a multiple
    {"attn_bwd_dq<64>": (80, 0.01), "attn_bwd_dkv<64>": (41, 0.01)},
    {"attn_fwd_tc<64, true>": (160, 0.5)}])
def test_none_unless_a_whole_number_of_launches_a_call(kernels):
    assert READER.read(_run(kernels)) is None


def test_none_without_traced_steps():
    assert READER.read(_run({"attn_bwd_dq<64>": (80, 0.01)}, steps=0)) \
        is None


def test_a_kernel_at_its_bound_reads_under_100():
    """Kernel time at the least time reads 100%; any time above it less."""
    at = 80 * LEAST_S
    kernels = {"attn_bwd_dq<64>": (80, at / 2), "attn_bwd_dkv<64>": (80,
                                                                      at / 2)}
    assert READER.read(_run(kernels)) == pytest.approx(100.0)
    kernels["attn_bwd_dkv<64>"] = (80, at)
    assert READER.read(_run(kernels)) < 100.0
