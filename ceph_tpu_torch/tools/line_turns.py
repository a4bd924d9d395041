"""The port's bench line in turns across checkouts: one JSON line per run.

    python ceph_tpu_torch/tools/line_turns.py --root A --root B --root B --root A

Runs ``python -m ceph_tpu_torch.bench.bench_line`` from each ``--root``
(a checkout of the repo; ``.`` is this one) in the order given, so two
versions are compared on one card in one session, in turns (the
host-paced rows move up to 2.4x between sessions).  For each run it
prints the root, the line's ``value``, its carry, slice and per-call
GB/s, each encode row's host milliseconds per step (the row's data bytes
per step over its GB/s: a ``--loop`` step and a per-call iteration both
encode ``--batch`` stripes of ``--size`` bytes), the decode rows' GB/s,
the device-chaos row, the card's name and power limit, and any
``partial_error``.  The full line of each run goes to ``--out`` (one
JSON object per line).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

STEP_BYTES = 64 * (1 << 20)     # the encode rows: --batch 64 of 1 MiB


def run_line(root: str) -> dict:
    """The bench line of the checkout at ``root`` (its last output
    line, parsed)."""
    out = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.bench.bench_line"],
        cwd=root, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=os.path.abspath(root)))
    return json.loads(out.stdout.strip().splitlines()[-1])


def summary(root: str, line: dict) -> dict:
    rows = line.get("encode_rows") or {}
    chaos = (line.get("device_chaos_rows") or {}).get(
        "rs_k8_m3_device_chaos")
    return {
        "root": root,
        "value": line.get("value"),
        "carry_chain_gbps": line.get("carry_chain_gbps"),
        "slice_gbps": line.get("slice_gbps"),
        "percall_gbps": line.get("percall_gbps"),
        "host_ms_per_step": {
            name: (STEP_BYTES / (r["gbps"] * 1e9) * 1e3
                   if r.get("gbps") else None)
            for name, r in rows.items()},
        "decode_gbps": {name: (r or {}).get("gbps") for name, r in
                        (line.get("decode_rows") or {}).items()},
        "device_chaos": (None if chaos is None else
                         {k: chaos.get(k) for k in (
                             "gbps", "faults_fired", "supervisor",
                             "demoted_at_end")}),
        "card": {k: (line.get("topology") or {}).get(k)
                 for k in ("name", "power_limit")},
        "partial_error": line.get("partial_error"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", required=True,
                    help="a checkout to run (repeat, in turn order)")
    ap.add_argument("--out", default=None,
                    help="append each run's full line here")
    args = ap.parse_args(argv)
    for root in args.root:
        line = run_line(root)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps({"root": root, "line": line}) + "\n")
        print(json.dumps(summary(root, line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
