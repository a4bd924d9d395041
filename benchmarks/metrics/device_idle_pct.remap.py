"""device_idle_pct.remap: the share of the traced window in which the
card ran no kernel, copy or set, in %."""

from yardstick.readers import traced


def read(run):
    if run.op != "remap" or not traced(run):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
