"""The traced window's share in which the device ran nothing: 1 - the union
of its kernel and copy intervals over the window's span on the device's
timeline."""


def read(run):
    return run.trace.idle_share() if run.trace.window_s > 0 else None
