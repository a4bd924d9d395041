"""crush_device_ms.remap: device milliseconds per epoch, every op of the
traced window (the bulk evaluator's)."""

from yardstick.readers import traced


def read(run):
    if run.op != "remap" or not traced(run):
        return None
    return 1e3 * run.trace.device_s() / run.requests
