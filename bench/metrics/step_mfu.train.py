"""The traced training steps' model operations (the benchmark's own count:
forward and backward, no recompute) over their span on the device's
timeline, as a share of the card's bf16 peak."""
from bench import roofline


def read(run):
    steps = run.traced.get("steps")
    if not steps or run.trace.window_s <= 0:
        return None
    w = run.window
    flops = roofline.train_flops(run.config, w["batch"], w["seq_len"])
    return 100.0 * flops * steps / run.trace.window_s / roofline.PEAK_FLOPS
