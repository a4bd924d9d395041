"""crush_issue_ms.remap: host milliseconds per epoch of the self time of the
program's crush.rung spans (telemetry/spans.py, armed by the traced
window's profiler): the rungs of the bulk evaluator less their host syncs,
the host's issue of the evaluator's kernels."""


def read(run):
    from ceph_tpu_torch.telemetry.spans import global_tracer
    totals = getattr(global_tracer(), "totals", None)
    if run.op != "remap" or run.trace is None or totals is None \
            or not run.requests:
        return None
    span = totals().get("crush.rung")
    return None if span is None else 1e3 * span["self_seconds"] / run.requests
