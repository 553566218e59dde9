"""Device time inside the program's optimizer range (AdamW: the global norm
and every leaf) over the traced window's busy time."""
SPAN = "repro_torch::train.optimizer"


def read(run):
    t = run.trace
    s = t.spans.get(SPAN)
    return None if s is None or t.busy_s <= 0 else 100.0 * s / t.busy_s
