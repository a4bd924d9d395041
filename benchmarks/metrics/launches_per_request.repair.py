"""launches_per_request.repair: kernel launches the program's wrappers
counted over the window (ops/launches.py), per repair."""

from yardstick.readers import ec


def read(run):
    return run.launches / run.requests if ec(run, "decode") else None
