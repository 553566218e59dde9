"""The traced prefills' model operations (every layer over the prompt, the
last position's logits) over the device time inside the program's prefill
range, as a share of the bf16 peak."""
from bench import roofline

SPAN = "repro_torch::serve.prefill"


def read(run):
    secs = run.trace.spans.get(SPAN)
    pf = run.traced.get("prefills")
    if not secs or not pf:
        return None
    flops = sum(roofline.prefill_flops(run.config, B, P) for B, P, _ in pf)
    return 100.0 * flops / secs / roofline.PEAK_FLOPS
