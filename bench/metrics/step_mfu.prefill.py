"""The prefills' model operations (every layer over the prompt, the last
position's logits) over the prefills' time, as a share of the bf16 peak."""
from bench import roofline


def read(run):
    pf = run.window.get("prefills")
    if not pf:
        return None
    flops = sum(roofline.prefill_flops(run.config, B, P) for B, P, _ in pf)
    secs = sum(s for _, _, s in pf)
    return 100.0 * flops / secs / roofline.PEAK_FLOPS
