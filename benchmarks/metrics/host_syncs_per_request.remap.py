"""host_syncs_per_request.remap: host syncs the bulk evaluator noted
under the program's osdmap.pg_to_up_bulk spans (telemetry/spans.py, armed
by the traced window's profiler): lane-mask indices, readbacks and
blocking copies of host data, per epoch."""


def read(run):
    from ceph_tpu_torch.telemetry.spans import global_tracer
    totals = getattr(global_tracer(), "totals", None)
    if run.op != "remap" or run.trace is None or totals is None \
            or not run.requests:
        return None
    span = totals().get("osdmap.pg_to_up_bulk")
    if span is None:
        return None
    return span["counts"].get("host_syncs", 0) / run.requests
