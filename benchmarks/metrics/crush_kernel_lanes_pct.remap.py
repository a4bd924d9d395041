"""crush_kernel_lanes_pct.remap: the share of the window's placement groups
that the bulk evaluator's CUDA rule kernel placed, %: the count
kernel_lanes noted under the program's crush.rung spans
(telemetry/spans.py, armed by the traced window's profiler) over the
epochs' placement groups.  None where nothing noted it: a program without
the kernel, or one that did not take it."""


def read(run):
    from ceph_tpu_torch.telemetry.spans import global_tracer
    totals = getattr(global_tracer(), "totals", None)
    if run.op != "remap" or run.trace is None or totals is None \
            or not run.requests or not run.work:
        return None
    span = totals().get("crush.rung")
    if span is None or "kernel_lanes" not in span["counts"]:
        return None
    return 100.0 * span["counts"]["kernel_lanes"] / (run.requests * run.work)
