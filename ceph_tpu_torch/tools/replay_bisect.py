"""replay_bisect — the divergence witness for the determinism tier: the
counterpart of the reference's ``tools/replay_bisect.py``.  Run ONE
seeded multi-tenant week twice, digest each run into a cumulative
per-phase checkpoint chain, and binary-search to the FIRST checkpoint
where the two runs disagree — naming the seam (which dispatch, which
bucket, which report fragment).

Checkpoint stream (in phase order, per run):

1. ``dispatch[i]`` — every batcher dispatch's composition (bucket | op |
   occupancy | rung | rider req_ids), from
   ``ContinuousBatcher.dispatch_log``;
2. ``qos.arbiter`` — the mClock arbiter snapshot;
3. ``recovery.counters`` — recovery rounds and the report's recovery
   block;
4. ``report.<fragment>`` — the week's report, one checkpoint per
   top-level fragment.

Digests are a cumulative sha256 chain, so the first divergent
checkpoint is monotone and the binary search is valid.

Self-test (``--inject-jitter``): perturb ONE service-time sample on
run B through ``serve.batcher.set_service_jitter`` and require the
witness to localize it.

    python -m ceph_tpu_torch.tools.replay_bisect            # identical
    python -m ceph_tpu_torch.tools.replay_bisect --inject-jitter
    python -m ceph_tpu_torch.tools.replay_bisect --json

``--device host|cuda|cpu`` (default ``cuda``; ``NoDeviceError`` without
a card): the week runs on the device executor on that device, or on
the host executor with ``host``.

Exit codes: 0 = the verdict matches the expectation (identical
normally; divergence localized under --inject-jitter); 3 = the
opposite; 1 = usage error.
"""

from __future__ import annotations

import argparse
import hashlib
import json
from typing import Dict, List, Optional, Tuple

from ..scenario.spec import tenant_week_scenario
from ..scenario.week import run_tenant_week
from ..serve import batcher as _batcher
from . import _demo

Checkpoint = Tuple[str, str]  # (label, canonical JSON payload)


def _canon(payload) -> str:
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


def checkpoint_stream(run) -> List[Checkpoint]:
    """Flatten one TenantWeekRun into the ordered checkpoint stream
    (labels + canonical-JSON payloads) the digest chain is built on."""
    stream: List[Checkpoint] = []
    for i, entry in enumerate(run.batcher.dispatch_log):
        label = (f"dispatch[{i:05d}] {entry['bucket']} "
                 f"op={entry['op']}")
        stream.append((label, _canon(entry)))
    stream.append(("qos.arbiter", _canon(run.arbiter.snapshot())))
    rep = run.report
    stream.append(("recovery.counters", _canon(
        {"recovery_rounds": rep.recovery_rounds,
         "recovery": rep.recovery})))
    doc = rep.to_dict()
    for key in sorted(doc):
        stream.append((f"report.{key}", _canon(doc[key])))
    return stream


def digest_chain(stream: List[Checkpoint]) -> List[str]:
    """Cumulative sha256 chain: chain[i] folds chain[i-1], so chain
    equality at *i* certifies the whole prefix — divergence is
    monotone and binary-searchable."""
    chain: List[str] = []
    h = b""
    for label, payload in stream:
        h = hashlib.sha256(
            h + label.encode() + b"\x00" + payload.encode()).digest()
        chain.append(h.hex())
    return chain


def first_divergence(stream_a: List[Checkpoint],
                     stream_b: List[Checkpoint]) -> Optional[Dict]:
    """Binary-search the cumulative chains to the first divergent
    checkpoint; None when the runs replayed byte-identically."""
    chain_a = digest_chain(stream_a)
    chain_b = digest_chain(stream_b)
    n = min(len(chain_a), len(chain_b))
    if n and chain_a[n - 1] == chain_b[n - 1]:
        if len(chain_a) == len(chain_b):
            return None
        # identical common prefix, one run kept going: the divergence
        # IS the length mismatch (e.g. an extra dispatch)
        longer = stream_a if len(stream_a) > len(stream_b) else stream_b
        return {"index": n, "probes": 1,
                "label_a": (stream_a[n][0]
                            if n < len(stream_a) else None),
                "label_b": (stream_b[n][0]
                            if n < len(stream_b) else None),
                "payload_a": (stream_a[n][1]
                              if n < len(stream_a) else None),
                "payload_b": (stream_b[n][1]
                              if n < len(stream_b) else None),
                "kind": "length",
                "extra_checkpoints": len(longer) - n}
    probes = 0
    lo, hi = 0, n - 1  # invariant: chain differs at hi, matches below lo
    while lo < hi:
        mid = (lo + hi) // 2
        probes += 1
        if chain_a[mid] == chain_b[mid]:
            lo = mid + 1
        else:
            hi = mid
    return {"index": lo, "probes": probes,
            "label_a": stream_a[lo][0], "label_b": stream_b[lo][0],
            "payload_a": stream_a[lo][1],
            "payload_b": stream_b[lo][1],
            "kind": "payload"}


def _deterministic_jitter(service: float, dispatch_index: int) -> float:
    """The self-test's injected fault: one service-time sample,
    10x-inflated, at dispatch 8 — enough to move that bucket's EWMA
    (and so its slack deadline) and change downstream batch
    composition, while staying invisible in the dispatch that absorbs
    it: the witness must walk the divergence back to the first
    dispatch whose riders actually changed."""
    if dispatch_index == 8:
        return service * 10.0
    return service


def run_week_stream(spec, *, jitter=None,
                    device: str = "cuda") -> List[Checkpoint]:
    """One seeded week on ``device`` → its checkpoint stream.
    ``jitter`` (if any) is installed on the batcher seam for the
    duration and always cleared after."""
    _batcher.set_service_jitter(jitter)
    try:
        run = run_tenant_week(spec, **_demo.run_kwargs(device))
    finally:
        _batcher.set_service_jitter(None)
    return checkpoint_stream(run)


def bisect_runs(spec_kwargs: Dict, *, inject_jitter: bool = False,
                device: str = "cuda") -> Dict:
    """Run the week twice (run B optionally jittered) and report the
    verdict: identical, or the first divergent checkpoint."""
    spec_a = tenant_week_scenario(**spec_kwargs)
    spec_b = tenant_week_scenario(**spec_kwargs)
    stream_a = run_week_stream(spec_a, device=device)
    stream_b = run_week_stream(
        spec_b, jitter=_deterministic_jitter if inject_jitter else None,
        device=device)
    div = first_divergence(stream_a, stream_b)
    return {"replay_bisect_schema_version": 1,
            "checkpoints_a": len(stream_a),
            "checkpoints_b": len(stream_b),
            "injected": inject_jitter,
            "identical": div is None,
            "divergence": div}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="replay_bisect",
        description="run one seeded tenant week twice and "
                    "binary-search the first divergent checkpoint")
    ap.add_argument("--device", default="cuda", choices=_demo.DEVICES,
                    help="host: the host executor; cuda (default) or "
                         "cpu: the device executor there")
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--days", type=int, default=2)
    ap.add_argument("--day-s", type=float, default=6.0)
    ap.add_argument("--inject-jitter", action="store_true",
                    help="self-test: perturb one service time on run "
                         "B and require the witness to localize it")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    verdict = bisect_runs(
        dict(seed=args.seed, days=args.days, day_s=args.day_s,
             peak_rates=(40.0, 30.0, 20.0), burst_factor=80.0),
        inject_jitter=args.inject_jitter, device=args.device)

    if args.json:
        print(json.dumps(verdict, indent=2, sort_keys=True))
    elif verdict["identical"]:
        print(f"replay_bisect: deterministic — "
              f"{verdict['checkpoints_a']} checkpoints, "
              f"digest chains identical")
    else:
        d = verdict["divergence"]
        print(f"replay_bisect: DIVERGENCE at checkpoint "
              f"{d['index']}/{verdict['checkpoints_a']} "
              f"({d['probes']} probes)")
        print(f"  run A: {d['label_a']}\n    {d['payload_a']}")
        print(f"  run B: {d['label_b']}\n    {d['payload_b']}")

    # the witness passes when reality matches the expectation the
    # flags set up: identical normally, localized under injection
    ok = verdict["identical"] != args.inject_jitter
    if not ok and not args.json:
        print("replay_bisect: FAILED — " + (
            "injected fault not localized" if args.inject_jitter
            else "runs diverged without injection"))
    return 0 if ok else 3


if __name__ == "__main__":
    raise SystemExit(main())
