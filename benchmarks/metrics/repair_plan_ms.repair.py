"""repair_plan_ms.repair: host milliseconds per repair inside the
program's span clay.repair_plan (telemetry/spans.py, armed by the traced
window's profiler): the repair's checks of the loss, the helpers and the
shape, and the lookup of its composite matrix."""


def read(run):
    from ceph_tpu_torch.telemetry.spans import global_tracer
    totals = getattr(global_tracer(), "totals", None)
    if run.op != "decode" or run.trace is None or totals is None \
            or not run.requests:
        return None
    span = totals().get("clay.repair_plan")
    return None if span is None else 1e3 * span["seconds"] / run.requests
