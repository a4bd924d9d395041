"""repair_read_bytes_per_stripe.repair: the helper bytes the program
noted its repair apply reads (count repair_read_bytes under the span
codec.decode, telemetry/spans.py, armed by the traced window's
profiler), per stripe repaired."""


def read(run):
    from ceph_tpu_torch.telemetry.spans import global_tracer
    totals = getattr(global_tracer(), "totals", None)
    stripes = getattr(run, "stripes", 0)
    if run.op != "decode" or run.trace is None or totals is None \
            or not run.requests or not stripes:
        return None
    span = totals().get("codec.decode")
    if span is None or "repair_read_bytes" not in span["counts"]:
        return None
    return span["counts"]["repair_read_bytes"] / (run.requests * stripes)
