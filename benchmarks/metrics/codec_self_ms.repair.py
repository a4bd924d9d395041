"""codec_self_ms.repair: host milliseconds per repair of the self time of
the program's span codec.decode (telemetry/spans.py, armed by the traced
window's profiler): the call less its clay.repair_plan and
engine.dispatch children, that is the device check, the views and the
read count."""


def read(run):
    from ceph_tpu_torch.telemetry.spans import global_tracer
    totals = getattr(global_tracer(), "totals", None)
    if run.op != "decode" or run.trace is None or totals is None \
            or not run.requests:
        return None
    span = totals().get("codec.decode")
    return None if span is None else 1e3 * span["self_seconds"] / run.requests
