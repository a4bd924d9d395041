"""degraded_read_gbps: data bytes of every stripe whose lost chunks were
rebuilt inside the window, over the window's seconds, in 1e9 bytes per
second."""

from yardstick.readers import ec


def read(run):
    return run.rate() / 1e9 if ec(run, "decode") else None
