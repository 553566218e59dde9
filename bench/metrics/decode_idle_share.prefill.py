"""Idle device time while the host was inside the program's decode-step
range (the outermost range at the gap) over the traced window's span on
the device's timeline."""
SPAN = "repro_torch::serve.decode_step"


def read(run):
    t = run.trace
    if SPAN not in t.spans or t.window_s <= 0:
        return None
    return 100.0 * dict(t.gaps).get(SPAN, 0.0) / t.window_s
