"""codec_self_ms.read: host milliseconds per request of the self time of
the program's own span codec.decode (telemetry/spans.py, armed by the
traced window's profiler): the call less its engine.dispatch child, that
is the views, the decode matrix or plan lookup and shec's survivor gather
issue."""


def read(run):
    from ceph_tpu_torch.telemetry.spans import global_tracer
    totals = getattr(global_tracer(), "totals", None)
    if run.op != "decode" or run.trace is None or totals is None \
            or not run.requests:
        return None
    span = totals().get("codec.decode")
    return None if span is None else 1e3 * span["self_seconds"] / run.requests
