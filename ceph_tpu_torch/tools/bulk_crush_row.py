"""BASELINE.md row 5 on the port: a 1M-PG bulk CRUSH sweep on the card —
the counterpart of the reference's ``tools/bulk_crush_row.py``.

Prints one JSON line with the reference's keys and metric names
(``bulk_crush_mappings_per_s``, or ``bulk_crush_ec_rule_mappings_per_s``
with ``--ec``: the canonical mon-generated erasure rule, SET steps +
chooseleaf indep 0, 6 wide, in place of the replicated firstn rule), over
``crush/bulk.py`` on ``build_two_level(8, 4)``.

One ``CompiledCrushMap`` serves the warm-up and the timed call; the
warm-up runs at the full sweep shape, as the reference's does.
``bulk_do_rule`` returns its mappings as host arrays, so the timed window
closes only after every mapping is on the host: it times the work, not
the launches.

``--device cuda|cpu`` (default ``cuda``; without a card ``NoDeviceError``).

Usage:  python -m ceph_tpu_torch.tools.bulk_crush_row [--ec] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

SWEEP_X = 1_000_000


def build_map(ec: bool):
    """(CrushMap, nrep): the reference row's two-level map with rule 0,
    the replicated firstn rule (3 wide) or the EC indep rule (6 wide)."""
    from ..crush.builder import CrushBuilder
    from ..crush.types import (step_chooseleaf_indep, step_emit,
                               step_set_choose_tries,
                               step_set_chooseleaf_tries, step_take)

    b = CrushBuilder()
    root = b.build_two_level(8, 4)
    if ec:
        b.add_rule(0, [step_set_chooseleaf_tries(5),
                       step_set_choose_tries(100), step_take(root),
                       step_chooseleaf_indep(0, b.type_id("host")),
                       step_emit()])
        return b.map, 6
    b.add_simple_rule(0, root, "host", firstn=True)
    return b.map, 3


def run(ec: bool, n: int = SWEEP_X, device="cuda") -> dict:
    """Warm at the full shape, then time one sweep of ``n`` x.  Returns
    the row's JSON fields and, under ``"mappings"``, the timed sweep's
    (n, nrep) int32 results."""
    from ..crush import bulk

    crush, nrep = build_map(ec)
    xs = np.arange(n)
    cm = bulk.CompiledCrushMap(crush, device=device)
    bulk.bulk_do_rule(cm, 0, xs, nrep)
    t0 = time.perf_counter()
    # bulk_do_rule returns host arrays: the window closes with every
    # mapping on the host
    mappings, _ = bulk.bulk_do_rule(cm, 0, xs, nrep)
    dt = time.perf_counter() - t0
    metric = ("bulk_crush_ec_rule_mappings_per_s" if ec
              else "bulk_crush_mappings_per_s")
    return {"metric": metric, "value": round(len(xs) / dt),
            "unit": "mappings/s", "n": len(xs), "seconds": round(dt, 3),
            "mappings": mappings}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ec", action="store_true",
                    help="sweep the canonical EC rule (indep, 6 wide)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    row = run(args.ec, SWEEP_X, args.device)
    row.pop("mappings")
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
