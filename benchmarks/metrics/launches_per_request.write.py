"""launches_per_request.write: kernel launches the program's wrappers
counted over the window (ops/launches.py), per request."""

from yardstick.readers import ec


def read(run):
    return run.launches / run.requests if ec(run, "encode") else None
