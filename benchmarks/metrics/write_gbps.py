"""write_gbps: data bytes (k chunks a stripe) of every full-stripe write
whose parity completed inside the window, over the window's seconds,
in 1e9 bytes per second."""

from yardstick.readers import ec


def read(run):
    return run.rate() / 1e9 if ec(run, "encode") else None
