"""dispatch_ms.read: host milliseconds per request inside the program's span
engine.dispatch (telemetry/spans.py, armed by the traced window's
profiler): the engine's choice, record_dispatch, the supervisor seam, the
kernel's wrapper and its launch."""


def read(run):
    from ceph_tpu_torch.telemetry.spans import global_tracer
    totals = getattr(global_tracer(), "totals", None)
    if run.op != "decode" or run.trace is None or totals is None \
            or not run.requests:
        return None
    span = totals().get("engine.dispatch")
    return None if span is None else 1e3 * span["seconds"] / run.requests
