"""osdmap_overlay_ms.remap: host milliseconds per epoch inside the program's
osdmap.overlay spans (telemetry/spans.py, armed by the traced window's
profiler): the pps seeds, the upmap overrides and the up-set overlay of
pg_to_up_bulk."""


def read(run):
    from ceph_tpu_torch.telemetry.spans import global_tracer
    totals = getattr(global_tracer(), "totals", None)
    if run.op != "remap" or run.trace is None or totals is None \
            or not run.requests:
        return None
    span = totals().get("osdmap.overlay")
    return None if span is None else 1e3 * span["seconds"] / run.requests
