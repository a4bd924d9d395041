"""device_chaos_demo — kill the backend mid-scenario, watch the
supervised dispatch plane survive it: the counterpart of the
reference's ``tools/device_chaos_demo.py``.

One seeded "production day" (the scenario harness, FakeClock + sim
service model, the DEVICE executor so the engine's kernels really
dispatch) loses its backend at a WARM seam: a persistent DispatchFault
(chaos/dispatch.py) fires at the fused-repair seam's Nth call and stays
down until the client stream drains.  The supervisor
(ops/supervisor.py) must classify it and survive it.

Gates (all must hold for rc 0):
- the run replays byte-identically (two runs, same ScenarioReport);
- the client stream byte-verifies and recovery converges healed;
- the heal is BYTE-IDENTICAL to the unfailed control run;
- the fault fired and the survival is visible (``survived_visibly``,
  ``demotion_flight_dump``, ``repromoted_after_heal`` for a loss or a
  hang; retries for a transient, rung downshifts for an OOM);
- (--corrupt) a bit-flipped output buffer in self-verify mode is
  CAUGHT (verify_failures >= 1, ``output_corruption`` flight dump) and
  the corrupted bytes are never returned.

    python -m ceph_tpu_torch.tools.device_chaos_demo
    python -m ceph_tpu_torch.tools.device_chaos_demo --fault hang --at 3
    python -m ceph_tpu_torch.tools.device_chaos_demo --erasures 4  # rc 2

Differences from the reference, by design (``--device host|cuda|cpu``,
default ``cuda``; ``NoDeviceError`` without a card; ``host`` runs the
host executor):

- On CPU tensors (``--device cpu``) a loss demotes the tier live
  (torch → numpy), completes on the numpy twin and re-promotes after
  clean probes, as in the reference.
- On the card the work never leaves the card: a loss raises
  ``DeviceDispatchError`` (``card_failures``, flight trigger
  ``backend_lost``) and the scenario re-queues the recovery round
  until the fault clears.  There ``survived_visibly`` reads
  ``card_failures >= 1``, ``demotion_flight_dump`` the
  ``backend_lost`` dump, and ``repromoted_after_heal`` that nothing is
  demoted at the end (nothing was demoted, so there is nothing to
  re-promote).

Exit codes: 0 = all gates held; 2 = unrecoverable objects reported
(structured report still printed); 3 = a gate failed (must never
happen); 1 = usage/config error.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import replace

from ..ops.supervisor import DispatchSupervisor, set_global_supervisor
from ..scenario import default_scenario, run_scenario
from ..serve.loadgen import throughput_service_model
from ..utils.retry import FakeClock
from . import _demo
from ._demo import dump_triggers as _dump_triggers
from ._demo import stores_identical as _stores_identical


def _run(spec, device: str = "cuda"):
    return run_scenario(spec, clock=FakeClock(),
                        service_model=throughput_service_model(),
                        **_demo.run_kwargs(device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="device_chaos_demo",
        description="seeded mid-scenario backend loss through the "
                    "supervised dispatch plane")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--stripe", type=int, default=2048)
    ap.add_argument("--objects", type=int, default=2,
                    help="damaged objects recovery must heal")
    ap.add_argument("--erasures", type=int, default=1,
                    help="shards erased per damaged object")
    ap.add_argument("--churn", type=int, default=2,
                    help="churn-storm event budget")
    ap.add_argument("--fault", default="backend_loss",
                    choices=["backend_loss", "hang", "transient",
                             "oom"],
                    help="the device-plane fault kind to inject")
    ap.add_argument("--seam", default="engine.fused_repair")
    ap.add_argument("--at", type=int, default=2,
                    help="the seam's Nth call the fault first fires "
                         "on (2 = after warm-up)")
    ap.add_argument("--calls", type=int, default=0,
                    help="faulted-call window (0 = persistent until "
                         "the client stream drains)")
    ap.add_argument("--corrupt", action="store_true",
                    help="also run the self-verify gate: a "
                         "bit-flipped output buffer must be caught "
                         "and never returned")
    ap.add_argument("--device", default="cuda", choices=_demo.DEVICES,
                    help="cuda (default) or cpu: the device executor "
                         "there; host: the host executor")
    ap.add_argument("--json", action="store_true", dest="json_out")
    a = ap.parse_args(argv)
    if a.requests < 1 or a.objects < 1 or a.erasures < 0 or a.at < 1:
        print("device_chaos_demo: bad arguments", file=sys.stderr)
        return 1

    base = default_scenario(
        seed=a.seed, n_requests=a.requests, stripe_size=a.stripe,
        damaged_objects=a.objects, erasures=a.erasures,
        storm_events=a.churn)
    spec = replace(base, chaos=replace(
        base.chaos, dispatch_fault=a.fault,
        dispatch_fault_seam=a.seam, dispatch_fault_at=a.at,
        dispatch_fault_calls=a.calls or None))
    control = replace(base, chaos=replace(
        base.chaos, dispatch_fault=None))

    # one untimed warm-up pass: device-executor runs count
    # post-warmup compiles (slo.stream_compiles), and the FIRST run
    # in a fresh process pays cold compiles the replay would not —
    # warming first makes run and replay start from identical program
    # state (a fault run that demotes clears the pattern cache on
    # re-promotion, which is symmetric across runs by construction)
    _run(spec, a.device)

    run = _run(spec, a.device)
    rep = run.report
    if rep.gates["unrecoverable"]:
        out = {"report": rep.to_dict(), "gates": {}}
        print(json.dumps(out, indent=1, sort_keys=True)
              if a.json_out else
              f"UNRECOVERABLE objects: {rep.gates['unrecoverable']}")
        return 2
    replay = _run(spec, a.device)
    ctrl = _run(control, a.device)
    on_card = a.device == "cuda"

    sup = rep.supervisor or {}
    counters = sup.get("counters", {})
    loss_kind = a.fault in ("backend_loss", "hang")
    gates = {
        "replay_identical": rep.to_json() == replay.report.to_json(),
        "converged": rep.gates["converged"],
        "healed": rep.gates["healed"],
        "verified_requests": rep.gates["verified_requests"],
        "control_converged_healed": (
            ctrl.report.gates["converged"]
            and ctrl.report.gates["healed"]),
        "heal_byte_identical_vs_control": _stores_identical(
            run.stores, ctrl.stores),
        "fault_fired": sup.get("plan", {}).get("fired", 0) >= 1,
        "survived_visibly": (
            counters.get("card_failures", 0) >= 1
            if loss_kind and on_card else
            counters.get("demotions", 0) >= 1 if loss_kind else
            counters.get("rung_downshifts", 0) >= 1 if a.fault == "oom"
            else counters.get("retries", 0) >= 1),
    }
    if loss_kind and on_card:
        # the card's work never left it: the loss raised, was
        # flight-recorded and re-queued; nothing was demoted
        gates["demotion_flight_dump"] = \
            "backend_lost" in _dump_triggers()
        gates["repromoted_after_heal"] = not sup.get("demoted_at_end")
    elif loss_kind:
        gates["demotion_flight_dump"] = any(
            t in ("backend_demoted", "device_quarantined")
            for t in _dump_triggers())
        gates["repromoted_after_heal"] = (
            counters.get("repromotions", 0) >= 1
            and not sup.get("demoted_at_end"))

    corrupt_result = None
    if a.corrupt:
        # self-verify gate: run the SAME day with a corrupt fault and
        # a self-verifying supervisor — the bit-flip must be caught,
        # reclassified, flight-recorded and never returned
        cspec = replace(base, chaos=replace(
            base.chaos, dispatch_fault="corrupt",
            dispatch_fault_seam=a.seam, dispatch_fault_at=a.at,
            dispatch_fault_calls=1))
        prev_sup = set_global_supervisor(
            DispatchSupervisor(self_verify=True))
        try:
            crun = _run(cspec, a.device)
        finally:
            set_global_supervisor(prev_sup)
        ccount = (crun.report.supervisor or {}).get("counters", {})
        corrupt_result = {
            "verify_failures": ccount.get("verify_failures", 0),
            "healed": crun.report.gates["healed"],
            "verified_requests":
                crun.report.gates["verified_requests"],
            "heal_byte_identical_vs_control": _stores_identical(
                crun.stores, ctrl.stores),
        }
        gates["corruption_caught"] = (
            corrupt_result["verify_failures"] >= 1)
        gates["corruption_never_written_back"] = (
            corrupt_result["healed"]
            and corrupt_result["verified_requests"]
            and corrupt_result["heal_byte_identical_vs_control"])
        gates["corruption_flight_dump"] = (
            "output_corruption" in _dump_triggers())

    out = {"spec": spec.to_dict(), "report": rep.to_dict(),
           "corrupt": corrupt_result, "gates": gates}
    rc = 0 if all(gates.values()) else 3

    if a.json_out:
        print(json.dumps(out, indent=1, sort_keys=True))
        return rc
    print(f"device-chaos '{rep.name}' seed={rep.seed} "
          f"fault={a.fault}@{a.seam}#{a.at} "
          f"calls={a.calls or 'persistent'}")
    print(f"  supervisor: {dict(sorted(counters.items()))}")
    print(f"  plan: {sup.get('plan')}")
    print(f"  flight dumps: {_dump_triggers()}")
    if corrupt_result:
        print(f"  corrupt phase: {corrupt_result}")
    bad = [k for k, v in gates.items() if not v]
    print("gates: " + ("ALL OK" if not bad else f"FAILED {bad}"))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
