"""incremental_ms.remap: host milliseconds per epoch inside the
program's apply_incremental."""


def read(run):
    if run.op != "remap" or not run.requests:
        return None
    return float(run.span_s("incremental").mean()) * 1e3
