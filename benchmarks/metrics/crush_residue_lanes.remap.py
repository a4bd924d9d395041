"""crush_residue_lanes.remap: lanes per epoch that the program's
crush.host_residue span noted (telemetry/spans.py, armed by the traced
window's profiler): placement groups no rung of the bulk evaluator placed,
mapped on the host."""


def read(run):
    from ceph_tpu_torch.telemetry.spans import global_tracer
    totals = getattr(global_tracer(), "totals", None)
    if run.op != "remap" or run.trace is None or totals is None \
            or not run.requests:
        return None
    span = totals().get("crush.host_residue")
    if span is None:
        return None
    return span["counts"].get("residue_lanes", 0) / run.requests
