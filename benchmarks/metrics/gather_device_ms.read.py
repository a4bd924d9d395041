"""gather_device_ms.read: device milliseconds per degraded read of every
device op other than the program's GF kernels (the survivor selection
and copies around the apply)."""

from yardstick.readers import ec, is_gf_kernel, traced


def read(run):
    if not (ec(run, "decode") and traced(run)):
        return None
    other = run.trace.device_s(lambda n: not is_gf_kernel(n))
    return 1e3 * other / run.requests
