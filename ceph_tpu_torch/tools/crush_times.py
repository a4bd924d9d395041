"""Times of the bulk CRUSH evaluator's first rung at the remap cell's
shape, on the card: the rule kernel against the eager tier.

    python -m ceph_tpu_torch.tools.crush_times [--seed N] [--iters N]

The shape: 100 hosts of 12 OSDs (straw2, jewel tunables), the EC rule
(set_chooseleaf_tries 5, set_choose_tries 100, chooseleaf_indep 0 type
host) 11 wide, the 16384 pps seeds of a pool of 16384 PGs, 8 OSDs down
and 40 reweighted in [0.5, 1.0] (from ``--seed``).  One JSON line:

- ``kernel_ms``: the rule kernel's own device time per sweep
  (``crush_rule_kernel`` in a ``torch.profiler`` trace of ``--iters``
  sweeps through ``crush_rule_cuda``), ``kernel_event_ms`` the same
  sweeps between CUDA events;
- ``bound_ms``: the least time the card could take for the draws these
  inputs need when nothing collides (11 replicas x (100 + 12) straw2
  draws a lane at ``STRAW2_DRAW_OPS`` INT32 operations, 16.7 Tops/s):
  a lower bound, since a collision or a rejected OSD adds draws;
- ``kernel_sweep_ms`` / ``eager_sweep_ms``: ``bulk_do_rule`` from host
  x to host arrays on the host's clock, through the kernel and with it
  off (the eager rungs), and ``eager_device_ms`` the eager sweep's
  device time; each the median of ``--iters`` sweeps;
- ``equal``: the two sweeps' mappings and counts are equal.

No card: the run fails.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np


def cell_map():
    """(CrushMap, rule id, result_max): the remap cell's cluster."""
    from ceph_tpu_torch.crush.builder import CrushBuilder
    from ceph_tpu_torch.crush.types import (
        step_chooseleaf_indep, step_emit, step_set_choose_tries,
        step_set_chooseleaf_tries, step_take)
    b = CrushBuilder()
    root = b.build_two_level(100, 12)
    b.add_rule(1, [step_set_chooseleaf_tries(5), step_set_choose_tries(100),
                   step_take(root), step_chooseleaf_indep(0, 1),
                   step_emit()])
    return b.map, 1, 11


def cell_inputs(seed: int, n_osds: int):
    """(pps seeds of a 16384-PG pool, reweight vector)."""
    from ceph_tpu_torch.crush.osdmap import PGPool
    xs = np.asarray(PGPool(1, 16384, size=11, erasure=True).pps_all(),
                    np.int64)
    rng = np.random.default_rng(seed)
    w = [0x10000] * n_osds
    picks = rng.choice(n_osds, 48, replace=False)
    for o in picks[:8]:
        w[o] = 0
    for o in picks[8:]:
        w[o] = int(rng.integers(0x8000, 0x10001))
    return xs, w


def _profiled_ms(fn, name: str, iters: int):
    """Device ms per call of the CUDA events whose names hold ``name``
    (every event where ``name`` is empty) over ``iters`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time_total for e in prof.events()
          if e.device_type == DeviceType.CUDA and name in e.name]
    return sum(us) / 1e3 / iters if us else None


def measure(seed: int = 1, iters: int = 20) -> dict:
    import torch
    from ceph_tpu_torch.crush import bulk
    from ceph_tpu_torch.ops import crush_kernels
    from ceph_tpu_torch.telemetry.profiler import (CARD_INT32_OPS_PER_S,
                                                   H100, STRAW2_DRAW_OPS)
    cmap, rule, nrep = cell_map()
    xs, w = cell_inputs(seed, cmap.max_devices)
    cm = bulk.CompiledCrushMap(cmap, device="cuda")
    kr = crush_kernels.kernel_rule(cm, rule, nrep)
    if kr is None:
        raise SystemExit("the cell's rule is outside the kernel's scope")
    tabs = cm.kernel_tables()
    xs_d = torch.as_tensor(xs, device="cuda")
    w_d = torch.as_tensor(np.asarray(w, np.int64), device="cuda")

    def launch():
        return crush_kernels.crush_rule_cuda(tabs, kr, xs_d, w_d)

    launch()
    torch.cuda.synchronize()
    kernel_ms = _profiled_ms(launch, "crush_rule_kernel", iters)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        launch()
    end.record()
    end.synchronize()
    event_ms = start.elapsed_time(end) / iters

    def sweep():
        return bulk.bulk_do_rule(cm, rule, xs, nrep, weight=w)

    def timed(fn):
        fn()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(times)

    (k_out, k_cnt), kernel_sweep = timed(sweep)
    real = bulk._rule_kernel
    bulk._rule_kernel = lambda *a: None
    try:
        (e_out, e_cnt), eager_sweep = timed(sweep)
        eager_dev = _profiled_ms(sweep, "", 3)
    finally:
        bulk._rule_kernel = real
    draws = len(xs) * nrep * (100 + 12)
    bound = draws * STRAW2_DRAW_OPS / CARD_INT32_OPS_PER_S[H100] * 1e3
    return {"device": torch.cuda.get_device_name(0), "lanes": len(xs),
            "kernel_ms": kernel_ms, "kernel_event_ms": event_ms,
            "bound_ms": bound, "draws": draws,
            "draw_ops": STRAW2_DRAW_OPS,
            "kernel_sweep_ms": kernel_sweep, "eager_sweep_ms": eager_sweep,
            "eager_device_ms": eager_dev,
            "equal": bool(np.array_equal(k_out, e_out)
                          and np.array_equal(k_cnt, e_cnt))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.seed, args.iters)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
