"""crush_sync_wait_ms.remap: host milliseconds per epoch inside the program's
crush.sync spans (telemetry/spans.py, armed by the traced window's
profiler): every host sync of the bulk evaluator, the wait for the card
included."""


def read(run):
    from ceph_tpu_torch.telemetry.spans import global_tracer
    totals = getattr(global_tracer(), "totals", None)
    if run.op != "remap" or run.trace is None or totals is None \
            or not run.requests:
        return None
    span = totals().get("crush.sync")
    return None if span is None else 1e3 * span["seconds"] / run.requests
