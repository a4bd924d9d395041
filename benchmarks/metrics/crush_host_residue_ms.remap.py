"""crush_host_residue_ms.remap: host milliseconds per epoch inside the
program's crush.host_residue span (telemetry/spans.py, armed by the
traced window's profiler): the host mapper over the lanes no rung
placed."""


def read(run):
    from ceph_tpu_torch.telemetry.spans import global_tracer
    totals = getattr(global_tracer(), "totals", None)
    if run.op != "remap" or run.trace is None or totals is None \
            or not run.requests:
        return None
    span = totals().get("crush.host_residue")
    return None if span is None else 1e3 * span["seconds"] / run.requests
