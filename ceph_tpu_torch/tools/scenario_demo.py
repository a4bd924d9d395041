"""scenario_demo — one seeded "production day" through the scenario
harness, printing the ScenarioReport and gating its claims: the
counterpart of the reference's ``tools/scenario_demo.py``.

The composed run: a mixed rs/shec/clay client stream serves at tight
SLOs on a FakeClock while a churn storm remaps the cluster, recovery
rounds heal straggler-skewed shard damage and scrub verifies in the
background — every background step admission-gated by the mClock QoS
arbiter (scenario/qos.py), which the client deadline-miss burn rate
feeds live.

Gates (all must hold for rc 0):
- the run replays byte-identically: two runs from --seed produce the
  SAME ScenarioReport JSON;
- the client stream is byte-identical to ground truth;
- recovery converges with byte-identical heal (zero data loss);
- arbiter-on client p99 AND deadline-miss-rate are strictly better
  than the arbiter-off control, while recovery converges in both.

    python -m ceph_tpu_torch.tools.scenario_demo
    python -m ceph_tpu_torch.tools.scenario_demo --requests 192 \
        --churn 8 --json
    python -m ceph_tpu_torch.tools.scenario_demo --erasures 4  # rc 2

Differences from the reference, by design: the day runs on the device
executor (the reference's demo runs the host executor), on ``--device
host|cuda|cpu`` (default ``cuda``; ``NoDeviceError`` without a card);
``--device host`` is the host executor.

Exit codes: 0 = all gates held; 2 = unrecoverable objects reported
(structured report still printed); 3 = a gate failed (must never
happen); 1 = usage/config error.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..scenario import default_scenario, run_scenario
from ..serve.loadgen import throughput_service_model
from ..utils.retry import FakeClock
from . import _demo


def _run(spec, enabled=None, device: str = "cuda"):
    return run_scenario(spec, clock=FakeClock(),
                        service_model=throughput_service_model(),
                        enable_arbiter=enabled, **_demo.run_kwargs(device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="scenario_demo",
        description="seeded production-day scenario — serving + churn "
                    "+ recovery under mClock QoS arbitration")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--stripe", type=int, default=1 << 14,
                    help="client stripe size (bytes)")
    ap.add_argument("--objects", type=int, default=4,
                    help="damaged objects recovery must heal")
    ap.add_argument("--erasures", type=int, default=1,
                    help="shards erased per damaged object")
    ap.add_argument("--churn", type=int, default=6,
                    help="churn-storm event budget (0 disables)")
    ap.add_argument("--slow-factor", type=float, default=10.0,
                    help="the straggler's slowdown on shard 0")
    ap.add_argument("--no-arbiter", action="store_true",
                    help="report the arbiter-off control run instead "
                         "(skips the strictly-better gate)")
    ap.add_argument("--device", default="cuda", choices=_demo.DEVICES,
                    help="host: the host executor; cuda (default) or "
                         "cpu: the device executor there")
    ap.add_argument("--json", action="store_true", dest="json_out")
    a = ap.parse_args(argv)
    if a.requests < 1 or a.stripe < 1 or a.objects < 1 \
            or a.erasures < 0 or a.churn < 0:
        print("scenario_demo: --requests/--stripe/--objects must be "
              ">= 1, --erasures/--churn >= 0", file=sys.stderr)
        return 1

    try:
        spec = default_scenario(
            seed=a.seed, n_requests=a.requests, stripe_size=a.stripe,
            damaged_objects=a.objects, erasures=a.erasures,
            storm_events=a.churn, straggler_factor=a.slow_factor)
    except (ValueError, IOError) as e:
        print(f"scenario_demo: bad spec: {e}", file=sys.stderr)
        return 1

    # spec JSON round trip is part of the replay story: the printed
    # spec IS the reproducer
    assert type(spec).from_json(spec.to_json()) == spec

    run = _run(spec, enabled=not a.no_arbiter, device=a.device)
    rep = run.report
    replay = _run(spec, enabled=not a.no_arbiter, device=a.device)
    gates = {
        "replay_identical": rep.to_json() == replay.report.to_json(),
        "converged": rep.gates["converged"],
        "healed": rep.gates["healed"],
        "verified_requests": rep.gates["verified_requests"],
    }
    control = None
    if not a.no_arbiter:
        off = _run(spec, enabled=False, device=a.device).report
        control = {
            "p99_ms": off.p99_ms,
            "deadline_miss_rate": off.deadline_miss_rate,
            "gbps_under_slo": off.gbps_under_slo,
            "converged": off.gates["converged"],
            "healed": off.gates["healed"],
        }
        gates["arbiter_p99_strictly_better"] = (
            rep.p99_ms is not None and off.p99_ms is not None
            and rep.p99_ms < off.p99_ms)
        gates["arbiter_miss_rate_strictly_better"] = (
            rep.deadline_miss_rate < off.deadline_miss_rate)
        gates["control_converged_healed"] = (
            off.gates["converged"] and off.gates["healed"])

    out = {"spec": spec.to_dict(), "report": rep.to_dict(),
           "control": control, "gates": gates}
    rc = 0
    if rep.gates["unrecoverable"]:
        rc = 2
    elif not all(gates.values()):
        rc = 3

    if a.json_out:
        print(json.dumps(out, indent=1, sort_keys=True))
        return rc

    slo = rep.slo
    print(f"scenario '{rep.name}' seed={rep.seed} "
          f"arbiter={'on' if rep.arbiter_enabled else 'off'}: "
          f"{slo['requests']} requests in {rep.elapsed_s:.3f}s "
          f"({rep.turns} turns)")
    print(f"  client: p99 {rep.p99_ms} ms, miss rate "
          f"{rep.deadline_miss_rate}, GB/s-under-SLO "
          f"{rep.gbps_under_slo}, burn trips {rep.slo_burn_trips}")
    print(f"  qos: scale_min {rep.qos['scale_min']}, grants "
          + " ".join(f"{c}={s['grants']}" for c, s in
                     sorted(rep.qos["classes"].items())))
    r = rep.recovery
    print(f"  recovery: {rep.recovery_rounds} rounds, "
          f"completed={r['ops_completed']} replans={r['replans']} "
          f"fence={r['fence_deferrals']} "
          f"throttle={r['throttle_deferrals']}")
    print(f"  churn: {rep.churn['events']} events "
          f"({rep.churn['storm_events']} in-storm, "
          f"{rep.churn['drained']} drained), remapped "
          f"{rep.churn['remapped_sample']}/{rep.churn['sampled_pgs']} "
          f"sampled pgs")
    print(f"  rateless: p99 ratio {rep.rateless['p99_ratio']} "
          f"(straggler x{a.slow_factor}), reassignments "
          f"{rep.rateless['straggler_reassignments']}")
    if control:
        print(f"  control (arbiter off): p99 {control['p99_ms']} ms, "
              f"miss rate {control['deadline_miss_rate']}")
    if rep.gates["unrecoverable"]:
        print(f"UNRECOVERABLE objects: {rep.gates['unrecoverable']}")
    bad = [k for k, v in gates.items() if not v]
    print("gates: " + ("ALL OK" if not bad else f"FAILED {bad}"))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
