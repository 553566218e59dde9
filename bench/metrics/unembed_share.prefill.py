"""Device time inside the program's head range (final norm, head matmul,
padding mask; at prefill and at each decode step) over the traced window's
busy time."""
SPAN = "repro_torch::model.unembed"


def read(run):
    t = run.trace
    s = t.spans.get(SPAN)
    return None if s is None or t.busy_s <= 0 else 100.0 * s / t.busy_s
