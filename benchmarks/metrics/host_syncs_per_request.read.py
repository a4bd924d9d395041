"""host_syncs_per_request.read: host syncs the program noted under its
codec.decode spans (telemetry/spans.py, armed by the traced window's
profiler), per request."""


def read(run):
    from ceph_tpu_torch.telemetry.spans import global_tracer
    totals = getattr(global_tracer(), "totals", None)
    if run.op != "decode" or run.trace is None or totals is None \
            or not run.requests:
        return None
    span = totals().get("codec.decode")
    if span is None:
        return None
    return span["counts"].get("host_syncs", 0) / run.requests
