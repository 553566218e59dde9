"""Device time inside the program's attention backward range over the
traced window's device time."""
SPAN = "repro_torch::flash_attention_backward"


def read(run):
    s = run.trace.spans.get(SPAN)
    return 100.0 * s / run.trace.busy_s if s else None
