"""gf_kernels_roofline.repair: the least device time of the window's
repairs (the reference's repair composite of each loss, its frozen
byte and INT32 counts in yardstick/costs.py at the H100's 3.35 TB/s and
16.7 Tops/s, whichever is larger), over the device time of the
program's GF kernels (names gf*_) in the trace, in %."""

from yardstick.readers import ec, is_gf_kernel, traced


def read(run):
    if not (ec(run, "decode") and traced(run)):
        return None
    kernel_s = run.trace.device_s(is_gf_kernel)
    if kernel_s <= 0:
        return None
    return 100.0 * run.bound_s * run.requests / kernel_s
