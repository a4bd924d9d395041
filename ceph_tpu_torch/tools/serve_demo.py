"""serve_demo — the serving front end end to end on one seeded scenario:
the counterpart of the reference's ``tools/serve_demo.py``.

A mixed rs/shec/clay encode+decode stream with a chaos-injected
degraded slice: every repair request's survivors are read back from a
ShardStore that the seeded ShardErasure injector actually damaged, so
the repair path is exercised as a degraded READ.  The stream runs
through the admission queue → continuous batcher → SLO ledger on a
FakeClock with a deterministic service model — every run replays
byte-identically from --seed — and each served result is verified
against the encode ground truth.

    python -m ceph_tpu_torch.tools.serve_demo                # rc 0
    python -m ceph_tpu_torch.tools.serve_demo --validate --json
    python -m ceph_tpu_torch.tools.serve_demo --erasures 4   # > m: rc 2

Differences from the reference, by design: the stream runs on the
device executor by default (the reference's default is the host
executor), on ``--device host|cuda|cpu`` (default ``cuda``;
``NoDeviceError`` without a card).  ``--device host`` (or the
reference's ``--executor host``) is the host executor.

Exit codes: 0 = every request served byte-identical within the
scenario (report printed); 2 = structured unrecoverable failure (the
erasure budget exceeds what the codes can decode — the report names
the culprit); 1 = usage/config error.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..chaos import ShardErasure, inject
from ..serve import (
    LoadGenerator,
    default_spec,
    run_serving_scenario,
    throughput_service_model,
    verify_results,
)
from ..utils.retry import FakeClock
from . import _demo


def degrade_repairs_via_chaos(gen: LoadGenerator, reqs, seed: int
                              ) -> int:
    """Rebuild every repair request's survivor payload by READING a
    chaos-damaged ShardStore: the stripe's shards go into a store, the
    seeded ShardErasure injector deletes exactly the request's erased
    set, and the payload becomes what a degraded read actually
    returns.  Byte-equal to the direct slice by construction — the
    point is that the serving path consumes the chaos machinery's
    output, not a shortcut around it."""
    # map (plugin, profile items, stripe size) -> codec state
    by_codec = {(st.codec.plugin,
                 tuple(sorted(st.codec.profile.items())),
                 st.codec.stripe_size): st
                for st in gen.states}
    degraded = 0
    for req in reqs:
        if req.op != "repair":
            continue
        st = by_codec[(req.plugin, tuple(sorted(req.profile.items())),
                       req.stripe_size)]
        # recover which pool stripe this request was drawn from by
        # matching the expected reconstruction (pool is small)
        rec_expect = req.expect[0]
        stripe = next(
            j for j in range(st.allchunks.shape[0])
            if np.array_equal(st.allchunks[j, list(req.erased), :],
                              rec_expect)
            and np.array_equal(
                st.allchunks[j, list(req.available), :], req.payload))
        shards = {i: st.allchunks[stripe, i, :].tobytes()
                  for i in range(st.n)}
        store, _ = inject(
            shards, [ShardErasure(shards=list(req.erased))],
            seed=seed + req.req_id, chunk_size=st.chunk)
        survivors = np.stack([
            np.frombuffer(store.read(i), dtype=np.uint8)
            for i in req.available])
        req.payload = survivors
        degraded += 1
    return degraded


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="serve_demo",
        description="seeded serving scenario: mixed stream, chaos-"
                    "degraded repair slice, SLO report")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--size", type=int, default=4096,
                    help="stripe size (bytes) for every codec")
    ap.add_argument("--erasures", type=int, default=1,
                    help="erasures per decode/repair request (> every "
                         "code's budget => structured rc 2)")
    ap.add_argument("--arrival", default="closed",
                    choices=["closed", "open"])
    ap.add_argument("--executor", default="device",
                    choices=["host", "device"],
                    help="device = the engine's serve dispatch on "
                         "--device (default); host = numpy batch "
                         "surfaces")
    ap.add_argument("--device", default="cuda", choices=_demo.DEVICES,
                    help="cuda: the card (default); cpu: CPU tensors; "
                         "host: the host executor")
    ap.add_argument("--validate", action="store_true",
                    help="validate the unified telemetry dump against "
                         "the schema after the run")
    ap.add_argument("--json", action="store_true", dest="json_out")
    a = ap.parse_args(argv)

    spec = default_spec(seed=a.seed, n_requests=a.requests,
                        stripe_size=a.size, arrival=a.arrival,
                        erasures=a.erasures)
    spec.ladder = (1, 4, 16)

    try:
        gen = LoadGenerator(spec)
    except IOError as e:
        # structured unrecoverable: the requested erasure budget
        # exceeds what (at least) one code in the mix can decode
        report = {"unrecoverable": True,
                  "error": f"{type(e).__name__}: {e}",
                  "seed": a.seed, "erasures": a.erasures}
        print(json.dumps(report) if a.json_out
              else f"UNRECOVERABLE: {report['error']}")
        return 2

    reqs, offsets = gen.generate()
    degraded = degrade_repairs_via_chaos(gen, reqs, a.seed)

    run = run_serving_scenario(
        spec, clock=FakeClock(), service_model=throughput_service_model(),
        requests=reqs, offsets=offsets,
        **_demo.run_kwargs("host" if a.executor == "host" else a.device))

    bad = verify_results(run.results)
    report = dict(run.report)
    report["degraded_repairs"] = degraded
    report["verified"] = len(run.results) - len(bad)
    report["corrupted"] = sorted(bad)
    report["dispatches"] = [
        {k: d[k] for k in ("op", "occupancy", "rung")}
        for d in run.batcher.dispatch_log]

    if a.validate:
        from .. import telemetry
        errors = telemetry.validate_dump(telemetry.dump_all())
        report["telemetry_schema_errors"] = errors
        if errors:
            print(json.dumps(report) if a.json_out
                  else f"SCHEMA INVALID: {errors}")
            return 2

    if bad or len(run.results) != len(reqs):
        report["unrecoverable"] = True
        print(json.dumps(report) if a.json_out
              else f"CORRUPTED: {sorted(bad)} "
                   f"({len(run.results)}/{len(reqs)} served)")
        return 2

    if a.json_out:
        print(json.dumps(report))
    else:
        print(f"served {report['requests']} requests "
              f"({degraded} chaos-degraded repairs) in "
              f"{report['elapsed_s']:.4f}s sim: "
              f"p50={report['p50_ms']:.3f}ms "
              f"p99={report['p99_ms']:.3f}ms "
              f"miss={report['deadline_miss_rate']:.3f} "
              f"GB/s-under-SLO={report['gbps_under_slo']}")
        print(f"padding_overhead="
              f"{report['padding']['padding_overhead']} over "
              f"{report['padding']['dispatches']} dispatches; "
              f"all outputs byte-identical to ground truth")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
