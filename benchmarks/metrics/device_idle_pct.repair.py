"""device_idle_pct.repair: the share of the traced window in which the
card ran no kernel, copy or set, in %."""

from yardstick.readers import ec, traced


def read(run):
    if not (ec(run, "decode") and traced(run)):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
