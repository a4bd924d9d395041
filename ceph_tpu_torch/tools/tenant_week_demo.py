"""tenant_week_demo — the seeded multi-tenant compressed week end to
end, printing per-tenant scorecards and gating the isolation claims:
the counterpart of the reference's ``tools/tenant_week_demo.py``.

Three tenants with diurnal arrival curves share one serving plane for
a compressed week on a discrete-event clock — per-tenant mClock at the
admission door, scrub/churn cadences in the background, and a staged
disaster schedule (rack loss at peak, backend-seam loss, host loss, a
noisy-neighbor burst storm) firing arm/fire/heal on the week's
timeline, each stage dumping the flight recorder.

Gates (all must hold for rc 0):
- the run replays byte-identically: two runs from --seed produce the
  SAME report JSON, and the discrete-event run matches the
  stepped-clock run;
- every staged disaster converges and heals byte-identically, every
  served request is byte-verified;
- the isolation gate: each victim tenant's p99 and deadline-miss rate
  stay within fixed factors of its isolated baseline with the arbiter
  on, while the arbiter-off control arm FAILS the same gate.

    python -m ceph_tpu_torch.tools.tenant_week_demo          # tiny week
    python -m ceph_tpu_torch.tools.tenant_week_demo --full   # ~1e5 req.
    python -m ceph_tpu_torch.tools.tenant_week_demo --json

Differences from the reference, by design: the week runs on the device
executor (the reference's runs the host executor), on ``--device
host|cuda|cpu`` (default ``cuda``; ``NoDeviceError`` without a card);
``--device host`` is the host executor.

Exit codes: 0 = all gates held; 3 = a gate failed (must never
happen); 1 = usage/config error.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..scenario import (isolated_baseline, isolation_gate,
                        run_tenant_week, tenant_week_scenario)
from . import _demo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tenant_week_demo",
        description="seeded multi-tenant compressed week — diurnal "
                    "streams + per-tenant mClock + staged disasters "
                    "on a discrete-event clock")
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--days", type=int, default=2)
    ap.add_argument("--day-s", type=float, default=6.0)
    ap.add_argument("--burst-factor", type=float, default=80.0)
    ap.add_argument("--full", action="store_true",
                    help="the full-scale week (~1e5 requests, "
                    "7 days x 40s): the acceptance-run shape")
    ap.add_argument("--device", default="cuda", choices=_demo.DEVICES,
                    help="host: the host executor; cuda (default) or "
                         "cpu: the device executor there")
    ap.add_argument("--json", action="store_true", dest="json_out")
    a = ap.parse_args(argv)
    if a.days < 1 or a.day_s <= 0 or a.burst_factor < 1:
        print("tenant_week_demo: --days >= 1, --day-s > 0, "
              "--burst-factor >= 1", file=sys.stderr)
        return 1

    if a.full:
        spec = tenant_week_scenario(seed=a.seed)
    else:
        spec = tenant_week_scenario(
            seed=a.seed, days=a.days, day_s=a.day_s,
            peak_rates=(40.0, 30.0, 20.0),
            burst_factor=a.burst_factor)
    # spec JSON round trip is part of the replay story: the printed
    # spec IS the reproducer
    assert type(spec).from_json(spec.to_json()) == spec

    kw = _demo.run_kwargs(a.device)
    run = run_tenant_week(spec, **kw)
    rep = run.report
    replay = run_tenant_week(spec, **kw).report
    stepped = run_tenant_week(spec, clock_mode="step", **kw).report
    victims = tuple(t.name for t in spec.tenants if t.limit == 0.0)
    base = {n: isolated_baseline(spec, n, **kw) for n in victims}
    gate_on = isolation_gate(rep, base, victims=victims)
    off = run_tenant_week(spec, enable_arbiter=False, **kw).report
    gate_off = isolation_gate(off, base, victims=victims)

    gates = {
        "replay_identical": rep.to_json() == replay.to_json(),
        "clock_modes_identical": rep.to_json() == stepped.to_json(),
        "converged": rep.gates["converged"],
        "healed": rep.gates["healed"],
        "verified_requests": rep.gates["verified_requests"],
        "all_disasters_healed": all(d["healed"]
                                    for d in rep.disasters),
        "isolation_arbiter_on": gate_on["ok"],
        "isolation_control_fails": not gate_off["ok"],
        "control_converged_healed": (off.gates["converged"]
                                     and off.gates["healed"]),
    }
    rc = 0 if all(gates.values()) else 3

    out = {"spec": spec.to_dict(), "report": rep.to_dict(),
           "isolation": {"on": gate_on, "off": gate_off},
           "gates": gates}
    if a.json_out:
        print(json.dumps(out, indent=1, sort_keys=True))
        return rc

    g = rep.gates
    print(f"tenant week '{rep.name}' seed={rep.seed}: "
          f"{g['requests_offered']} requests offered, "
          f"{g['dispatched']} dispatches over {rep.elapsed_s:.1f}s "
          f"sim ({rep.turns} turns)")
    for name, t in sorted(rep.tenants.items()):
        rej = sum(t["rejected"].values()) if t["rejected"] else 0
        print(f"  {name}: {t['requests']} offered, {t['served']} "
              f"served, {rej} rejected, p99 {t['p99_ms']} ms, miss "
              f"rate {round(t['deadline_miss_rate'], 4)}")
    for d in rep.disasters:
        print(f"  disaster {d['kind']}: fired {d['fired_at']}s, "
              f"{d['recovery_rounds']} rounds "
              f"(fence {d['fence_deferrals']}), healed "
              f"{d['healed']} at {d['healed_at']}s")
    for name in victims:
        v = gate_on["victims"][name]
        print(f"  isolation {name}: p99 {v['p99_ms']} vs baseline "
              f"{v['baseline_p99_ms']} ms, miss "
              f"{round(v['miss_rate'], 4)} vs "
              f"{round(v['baseline_miss_rate'], 4)}")
    bad = [k for k, v in gates.items() if not v]
    print("gates: " + ("ALL OK" if not bad else f"FAILED {bad}"))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
