"""bench_diff — the perf-regression sentinel over the port's bench
trajectory: the counterpart of the reference's ``tools/bench_diff.py``.

The same parsing, series, categories, noise floors, ``--json`` report
and exit codes as the reference:

1. **Parse the trajectory** — every ``BENCH_r*.json`` run record
   (``{n, cmd, rc, tail, parsed}``, or a raw bench line) in ``--repo``,
   across every metric_version (bare-float rows through ``{gbps,
   lat_*}`` dicts; error lines contribute their embedded ``last_good``
   record, deduped by (git_sha, timestamp)).
2. **Normalize** to named higher-is-better series: ``headline``,
   ``decode:<row>``, ``composite_decode:<row>`` (shec/clay decodes),
   ``degraded:<row>``, ``serving:<row>`` (GB/s under SLO),
   ``multichip:<row>``, ``scenario:<row>``, ``device_chaos:<row>``,
   ``host_chaos:<row>`` (recovery under a lost host fault domain),
   ``profile:<row>``, ``autotune:<row>`` (utilization %),
   ``tenant_isolation:<row>`` (the victims' GB/s under SLO) and the
   one lower-is-better series, ``serving_padding:<row>``.
3. **Diff with per-category noise floors** — the current record
   (``BENCH_LAST_GOOD.json`` in ``--repo``, or ``--candidate FILE``, a
   fresh ``python -m ceph_tpu_torch.bench.bench_line`` line) regresses
   a row when it falls below the best prior value by more than the
   row's floor (``--floor cat=frac`` overrides).
4. **Fail loudly** — rc 4 with the failing rows named.

The trajectory is the port's own: ``--repo`` defaults to
``bench_records/`` at the repository root, where the card's bench lines
are kept.  The ``BENCH_r*.json`` and ``BENCH_LAST_GOOD.json`` at the
root are the TPU's records; they are never read as the port's
trajectory unless ``--repo`` names that directory on purpose (the CPU
tests use them as parsing fixtures).

Exit codes: 0 clean · 2 usage · 3 no usable trajectory · 4 regression.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

REPO = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "bench_records")

# per-category relative noise floors: a row only regresses when it
# drops below best_prior * (1 - floor).  Device --loop chains repeat
# within a few percent; host-timed recovery/serving rows swing wildly
# with scheduler load.
FLOORS: Dict[str, float] = {
    "headline": 0.15,
    "decode": 0.20,
    # the shec/clay composite-decode rows: device-chained
    # like the RS decode row, so they share its tight floor — a
    # reopened composite gap must trip the sentinel, not hide in a
    # generic category
    "composite_decode": 0.20,
    "multichip": 0.25,
    "degraded": 0.45,
    "serving": 0.45,
    "cluster": 0.50,
    # scenario rows measure the client stream UNDER deliberate
    # background contention on a host-scheduled clock — the noisiest
    # category by construction, but a silent p99-under-contention
    # cliff must still trip the sentinel
    "scenario": 0.55,
    # tenant-week isolation: the victims' GB/s-under-SLO
    # with the noisy tenant's burst storm raging, arbiter on.  The
    # whole week is a deterministic EventClock simulation (modeled
    # service time, no wall clock), so the series repeats exactly
    # from a seed — a tight floor: movement here means the arbiter,
    # the batcher or the stage machine changed behaviour, not that
    # the host scheduler hiccuped
    "tenant_isolation": 0.20,
    # recovery-under-fault: the supervised dispatch plane
    # absorbing an injected transient/OOM/backend-loss script — the
    # GB/s includes retries, rung splits, live demotion and program
    # rebuilds on re-promotion, so it swings like the host-timed
    # rows; a silent cliff (e.g. the supervisor thrashing the
    # pattern cache) must still trip the sentinel
    "device_chaos": 0.55,
    # recovery-under-host-loss: a whole simulated host
    # fault domain drops mid-run — the GB/s includes the host-granular
    # reshrink, the journal-reclaim hook and the re-promotion rebuild,
    # so it shares device_chaos's wide floor; a silent survival-path
    # cliff must still trip the sentinel
    "host_chaos": 0.55,
    "profile": 0.60,
    # the autotune rows track the tuner's best after-utilization-%:
    # modeled (analytic) rows are deterministic, timed rows swing
    # with scheduler load like the other host-clocked categories — a
    # tuned config silently regressing to the default's utilization
    # must still trip the sentinel
    "autotune": 0.50,
    # serving padding_overhead: the one LOWER-is-better
    # category — the fraction of dispatched bytes that were padding.
    # The paged rows sit near zero (page tails only), so the ratio is
    # taken with an absolute slack (PADDING_EPS) and a wide relative
    # floor: a paged row silently reinflating toward dense-bucket
    # padding must trip the sentinel, seeded-mix jitter must not
    "serving_padding": 0.50,
}

# categories where SMALLER current values are better: best prior is
# the minimum, and a regression is current ABOVE best * (1 + floor)
LOWER_IS_BETTER = frozenset({"serving_padding"})

# absolute slack for near-zero lower-is-better ratios: 0.01 is the
# paged acceptance bound (padding_overhead < 0.01 under the pinned
# mixed-size contention test), so movement inside it never trips
PADDING_EPS = 0.01


def _gbps(value) -> Optional[float]:
    """A row value across metric_versions: v1/v2 bare floats, v3+
    {gbps, lat_*} dicts; None/garbage -> None."""
    if isinstance(value, bool):
        return None
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, dict):
        g = value.get("gbps")
        if isinstance(g, (int, float)) and not isinstance(g, bool):
            return float(g)
    return None


def extract_series(rec: dict) -> Dict[str, float]:
    """Normalize one bench record into named higher-is-better series."""
    series: Dict[str, float] = {}
    v = rec.get("value")
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        series["headline"] = float(v)
    for section, cat in (("decode_rows", "decode"),
                         ("degraded_rows", "degraded"),
                         ("multichip_rows", "multichip"),
                         ("device_chaos_rows", "device_chaos"),
                         ("host_chaos_rows", "host_chaos"),
                         ("profile_rows", "profile")):
        body = rec.get(section)
        if not isinstance(body, dict):
            continue
        for name, row in sorted(body.items()):
            g = _gbps(row)
            if g is not None and g > 0:
                rcat = cat
                if cat == "decode" and name.startswith(("shec", "clay")):
                    # the composite-decode gap gets its own category
                    # (and floor) across the WHOLE trajectory — old
                    # records renormalize identically, so best-prior
                    # comparisons stay well-defined
                    rcat = "composite_decode"
                series[f"{rcat}:{name}"] = g
    # autotune rows: the tuner's best after-utilization-%
    # is the series — higher is better, and unlike this row's gbps
    # (sweep wall-time bookkeeping) it is what the tuner optimizes
    body = rec.get("autotune_rows")
    if isinstance(body, dict):
        for name, row in sorted(body.items()):
            if not isinstance(row, dict):
                continue
            u = row.get("utilization_pct")
            if isinstance(u, (int, float)) and not isinstance(u, bool) \
                    and u > 0:
                series[f"autotune:{name}"] = float(u)
    # tenant-week rows: the victims' GB/s-under-SLO is
    # the isolation series — unlike this row's aggregate gbps (which
    # the noisy tenant's clamped storm dominates), it is what the
    # arbiter exists to protect
    body = rec.get("tenant_week_rows")
    if isinstance(body, dict):
        for name, row in sorted(body.items()):
            if not isinstance(row, dict):
                continue
            g = row.get("victim_gbps_under_slo")
            if isinstance(g, (int, float)) and not isinstance(g, bool) \
                    and g > 0:
                series[f"tenant_isolation:{name}"] = float(g)
    # serving + scenario rows: GB/s-under-SLO is the series (raw
    # gbps as the fallback for rows predating the field)
    for section, cat in (("serving_rows", "serving"),
                         ("scenario_rows", "scenario")):
        body = rec.get(section)
        if not isinstance(body, dict):
            continue
        for name, row in sorted(body.items()):
            if not isinstance(row, dict):
                continue
            g = row.get("gbps_under_slo")
            if not (isinstance(g, (int, float))
                    and not isinstance(g, bool)):
                g = _gbps(row)
            if g is not None and g > 0:
                series[f"{cat}:{name}"] = float(g)
            if cat == "serving":
                # the lower-is-better padding series: zero
                # is a real, meaningful value here, so >= 0 not > 0
                p = row.get("padding_overhead")
                if isinstance(p, (int, float)) \
                        and not isinstance(p, bool) and p >= 0:
                    series[f"serving_padding:{name}"] = float(p)
    return series


def _record_id(rec: dict) -> Tuple:
    return (rec.get("git_sha"), rec.get("timestamp"),
            rec.get("value"))


def load_trajectory(repo: str) -> List[Tuple[str, dict]]:
    """(label, record) for every usable measurement in the BENCH_r*
    trajectory, oldest first, deduped: a direct good round's parsed
    line, or the last_good record an error line carries."""
    out: List[Tuple[str, dict]] = []
    seen: set = set()

    def _add(label: str, rec) -> None:
        if not isinstance(rec, dict) or rec.get("value") is None:
            return
        rid = _record_id(rec)
        if rid in seen:
            return
        seen.add(rid)
        out.append((label, rec))

    for path in sorted(glob.glob(os.path.join(repo, "BENCH_r*.json"))):
        base = os.path.basename(path)
        try:
            with open(path, encoding="utf-8") as f:
                d = json.load(f)
        except (OSError, ValueError):
            continue
        parsed = d.get("parsed")
        if not isinstance(parsed, dict):
            # tolerate a raw bench line checked in directly
            parsed = d if "metric" in d else None
        if not isinstance(parsed, dict):
            continue
        _add(base, parsed)
        _add(f"{base}:last_good", parsed.get("last_good"))
    return out


def load_current(repo: str, candidate: Optional[str]
                 ) -> Tuple[str, Optional[dict]]:
    if candidate:
        with open(candidate, encoding="utf-8") as f:
            rec = json.load(f)
        if rec.get("value") is None and isinstance(
                rec.get("last_good"), dict):
            # an error-line candidate is judged by its embedded
            # last-good device measurement, same as the trajectory
            return (f"{os.path.basename(candidate)}:last_good",
                    rec["last_good"])
        return os.path.basename(candidate), rec
    path = os.path.join(repo, "BENCH_LAST_GOOD.json")
    try:
        with open(path, encoding="utf-8") as f:
            return "BENCH_LAST_GOOD.json", json.load(f)
    except (OSError, ValueError):
        return "BENCH_LAST_GOOD.json", None


def diff(trajectory: List[Tuple[str, dict]], current_label: str,
         current: dict, floors: Dict[str, float]) -> dict:
    """The sentinel verdict: per-row status against the best prior
    value, with per-category noise floors."""
    cur_id = _record_id(current)
    prior: Dict[str, Tuple[float, str]] = {}
    for label, rec in trajectory:
        if _record_id(rec) == cur_id:
            continue  # the current record riding in the trajectory
        for name, v in extract_series(rec).items():
            lower = name.split(":", 1)[0] in LOWER_IS_BETTER
            best = prior.get(name)
            if best is None or (v < best[0] if lower else v > best[0]):
                prior[name] = (v, label)
    cur_series = extract_series(current)
    rows, regressions, improvements = [], [], []
    for name in sorted(set(prior) | set(cur_series)):
        cat = name.split(":", 1)[0]
        floor = floors.get(cat, 0.25)
        cur = cur_series.get(name)
        best = prior.get(name)
        row = {"row": name, "current": cur,
               "best_prior": best[0] if best else None,
               "best_prior_src": best[1] if best else None,
               "noise_floor": floor, "status": "ok"}
        if best is None:
            row["status"] = "new"          # first sample: nothing to diff
        elif cur is None:
            # the row vanished from the current record — that is a
            # regression of the HARNESS (a silently dropped
            # measurement is how a cliff hides), not of the kernel
            row["status"] = "missing"
            regressions.append(row)
        elif cat in LOWER_IS_BETTER:
            # inverted sense, with absolute slack: near-zero padding
            # values would make a bare ratio explode on noise
            ratio = (cur + PADDING_EPS) / (best[0] + PADDING_EPS)
            row["ratio"] = round(ratio, 4)
            if ratio > 1.0 + floor:
                row["status"] = "regression"
                regressions.append(row)
            elif ratio < 1.0 - floor:
                row["status"] = "improvement"
                improvements.append(row)
        else:
            ratio = cur / best[0]
            row["ratio"] = round(ratio, 4)
            if ratio < 1.0 - floor:
                row["status"] = "regression"
                regressions.append(row)
            elif ratio > 1.0 + floor:
                row["status"] = "improvement"
                improvements.append(row)
        rows.append(row)
    return {"current": current_label,
            "samples": len(trajectory),
            "rows": rows,
            "regressions": [r["row"] for r in regressions],
            "improvements": [r["row"] for r in improvements],
            "ok": not regressions}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=REPO,
                    help="directory holding the port's BENCH_r*.json "
                         "+ BENCH_LAST_GOOD.json (default: "
                         "bench_records/ at the repository root)")
    ap.add_argument("--candidate", default=None, metavar="FILE",
                    help="judge this bench JSON line instead of "
                         "BENCH_LAST_GOOD.json (a fresh run's output)")
    ap.add_argument("--floor", action="append", default=[],
                    metavar="CAT=FRAC",
                    help="override a category noise floor, e.g. "
                         "headline=0.1 (repeatable)")
    ap.add_argument("--json", action="store_true", dest="json_out")
    args = ap.parse_args(argv)

    floors = dict(FLOORS)
    for spec in args.floor:
        if "=" not in spec:
            ap.error(f"--floor {spec!r} must be CAT=FRAC")
        cat, frac = spec.split("=", 1)
        try:
            floors[cat] = float(frac)
        except ValueError:
            ap.error(f"--floor {spec!r}: {frac!r} is not a number")

    trajectory = load_trajectory(args.repo)
    label, current = load_current(args.repo, args.candidate)
    if current is None or current.get("value") is None:
        # no current device measurement at all: nothing to judge — an
        # outage is the error line's job to report, not a regression
        print("bench_diff: no current device measurement "
              f"({label}); nothing to diff", file=sys.stderr)
        return 0 if trajectory else 3
    if not trajectory:
        print("bench_diff: no BENCH_r*.json trajectory found",
              file=sys.stderr)
        return 3

    report = diff(trajectory, label, current, floors)
    if args.json_out:
        print(json.dumps(report, sort_keys=True))
    else:
        print(f"bench_diff: {len(trajectory)} trajectory sample(s), "
              f"current={report['current']}")
        for row in report["rows"]:
            cur = row["current"]
            best = row["best_prior"]
            line = (f"  {row['status'].upper():<12} {row['row']}: "
                    f"{cur if cur is not None else '-'} "
                    f"vs best {best if best is not None else '-'}"
                    f" (floor {int(row['noise_floor'] * 100)}%"
                    + (f", x{row['ratio']}" if "ratio" in row else "")
                    + (f", from {row['best_prior_src']}"
                       if row["best_prior_src"] else "") + ")")
            print(line)
    if not report["ok"]:
        print("bench_diff: REGRESSION on "
              + ", ".join(report["regressions"]), file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
