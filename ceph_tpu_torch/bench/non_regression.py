"""Byte-stability non-regression corpus.

A port of ``ceph_tpu/bench/non_regression.py``, with ``--device``
(default the card; ``cpu`` asks for the CPU).  Role of src/test/erasure-code/ceph_erasure_code_non_regression.cc +
qa/workunits/erasure-code/encode-decode-non-regression.sh: encode a
deterministic payload for every supported (plugin, profile) into a
content-addressed directory; later versions re-encode and byte-compare.
THE guard for "byte-identical parity" (SURVEY.md §4 byte-stability row,
§7 step 4): stored parity must remain decodable forever, so any change
to matrix generation, padding, or region math that alters even one
parity byte turns the committed corpus red.

Layout (one directory per profile under the corpus base):

    <base>/<plugin>__<k=v joined by __>/
        manifest.json   — profile, payload size/sha256, per-chunk sha256
        content         — the deterministic payload
        0, 1, ... n-1   — the encoded chunks

CLI:
    python -m ceph_tpu_torch.bench.non_regression --base-dir tests/corpus \
        --check [--device cuda|cpu]
    python -m ceph_tpu_torch.bench.non_regression --base-dir DIR --create
    # single profile:
    ... --plugin jerasure --parameter technique=reed_sol_van \
        --parameter k=4 --parameter m=2 --create

The standard matrix below covers every plugin and technique the
framework ships; tests/test_torch_non_regression.py re-checks the
committed corpus against the reference's checker.

On the card, sections 1-3 go through ``encode`` / ``decode``: at the
corpus's 24041-byte payloads the codes take their host tier below
``min_xla_bytes``, as the reference's do.  Section 4, the batched
composite decode of shec and clay, runs ``decode_chunks_torch`` on the
code's device.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..codes.registry import ErasureCodePluginRegistry

# every (plugin, profile) the corpus pins.  One entry per technique and
# word size; ks/ms chosen to exercise the construction quirks
# (systematization, packet layouts, sub-chunking, layered locality).
STANDARD_MATRIX: List[Tuple[str, Dict[str, str]]] = [
    ("example", {}),
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2",
                  "w": "16"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "3", "m": "2",
                  "w": "32"}),
    ("jerasure", {"technique": "reed_sol_r6_op", "k": "4", "m": "2"}),
    ("jerasure", {"technique": "cauchy_orig", "k": "4", "m": "2",
                  "packetsize": "32"}),
    ("jerasure", {"technique": "cauchy_good", "k": "8", "m": "3",
                  "packetsize": "32"}),
    ("jerasure", {"technique": "liberation", "k": "4", "m": "2", "w": "7",
                  "packetsize": "32"}),
    ("jerasure", {"technique": "blaum_roth", "k": "4", "m": "2", "w": "6",
                  "packetsize": "32"}),
    ("jerasure", {"technique": "liber8tion", "k": "4", "m": "2",
                  "packetsize": "32"}),
    ("isa", {"technique": "reed_sol_van", "k": "4", "m": "2"}),
    ("isa", {"technique": "cauchy", "k": "8", "m": "3"}),
    ("shec", {"k": "6", "m": "3", "c": "2"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
    ("clay", {"k": "4", "m": "2", "d": "5"}),
    ("clay", {"k": "8", "m": "4", "d": "11"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("lrc", {"mapping": "__DD__DD",
             "layers": '[["_cDD_cDD",""],["cDDD____",""],'
                       '["____cDDD",""]]'}),
]

DEFAULT_SIZE = 24041  # odd, not chunk-aligned: exercises padding paths

# ---- composite-decode cost guard ---------------------------------------
#
# The reference's ratchet, unchanged: the modeled cost of every
# shec/clay/lrc single-erasure decode pattern against the RS k=8,m=3 e2
# decode matrix's dense model (the worst models at 1.17x it; shec
# data-erasure plans and lrc composites XOR-schedule to <= 0.8 ops per
# input column), so a regression in the scheduler, the probe, or the
# composite constructions fails the corpus check loudly.  The model is
# the reference's cost model, host arithmetic only.

# per-pattern ceiling: modeled best-tier vector ops per input column,
# relative to the RS k=8,m=3 two-erasure decode matrix's dense model
COMPOSITE_DECODE_MAX_RATIO = 1.5
# the scheduler-alive ratchet: shec/lrc corpus profiles must keep at
# least one single-erasure pattern on the XOR tier at or below this
# ops-per-column cost (pure XOR chains measure 0.3-0.8)
XOR_PLAN_MAX_OPS_PER_COL = 1.5


def _rs_reference_cost_per_col() -> float:
    """Dense modeled cost/column of the RS k=8,m=3 e=(0,1) decode
    matrix — the denominator of the composite-decode ratio (the bench
    line's rs_k8_m3_e2 decode row).  Host arithmetic: a CPU instance."""
    from ..ops.xor_schedule import dense_vpu_cost
    ec = _factory("jerasure", {"technique": "reed_sol_van",
                               "k": "8", "m": "3"}, device="cpu")
    _, ms, _ = ec._decode_matrix(
        tuple(i for i in range(11) if i not in (0, 1)), (0, 1))
    return dense_vpu_cost(ms) / len(ms[0])


def composite_decode_guard(dirpath: str, plugin: str, ec) -> List[str]:
    """Section 5 of check(): the modeled composite-decode cost ratchet
    (runs for shec/clay/lrc corpus entries; numbers above).  Purely
    host-side and deterministic — no device."""
    from ..ops.xor_schedule import dense_vpu_cost, preferred_schedule
    from .erasure_code_benchmark import ErasureCodeBench

    errors: List[str] = []
    if getattr(ec, "w", 8) != 8:
        return errors
    ref = _rs_reference_cost_per_col()
    n = ec.get_chunk_count()
    best_sched_cost = None
    for e in range(n):
        avail = tuple(i for i in range(n) if i != e)
        ms = ErasureCodeBench._decode_matrix_static(ec, avail, (e,))
        if ms is None:
            continue
        cols = len(ms[0])
        cost = dense_vpu_cost(ms) / cols
        sched = preferred_schedule(ms, 8)
        if sched is not None:
            sched_cost = sched.vpu_ops / cols
            cost = min(cost, sched_cost)
            best_sched_cost = (sched_cost if best_sched_cost is None
                               else min(best_sched_cost, sched_cost))
        ratio = cost / ref
        if ratio > COMPOSITE_DECODE_MAX_RATIO:
            errors.append(
                f"{dirpath}: composite-decode cost regression: pattern "
                f"({e},) models at {ratio:.2f}x the RS decode reference "
                f"(> {COMPOSITE_DECODE_MAX_RATIO}x ratchet); "
                f"cost/col={cost:.1f}, ref={ref:.1f}")
    if plugin in ("shec", "lrc"):
        if best_sched_cost is None:
            errors.append(
                f"{dirpath}: XOR scheduler regression: no single-"
                f"erasure pattern routes to the XOR tier (shec/lrc "
                f"plan decodes must stay scheduled)")
        elif best_sched_cost > XOR_PLAN_MAX_OPS_PER_COL:
            errors.append(
                f"{dirpath}: XOR schedule cost regression: best "
                f"scheduled pattern costs {best_sched_cost:.2f} "
                f"ops/col (> {XOR_PLAN_MAX_OPS_PER_COL} ratchet)")
    return errors


def profile_dir_name(plugin: str, profile: Dict[str, str]) -> str:
    """Content-addressed directory name (profile order-independent)."""
    parts = [plugin] + [f"{k}={profile[k]}" for k in sorted(profile)]
    name = "__".join(parts)
    # layers JSON etc. are not filesystem-safe; replace the offenders
    for ch in '[]",/ ':
        name = name.replace(ch, "-")
    return name


def _payload(name: str, size: int) -> bytes:
    seed = int.from_bytes(hashlib.sha256(name.encode()).digest()[:8],
                          "little")
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _factory(plugin: str, profile: Dict[str, str], device=None):
    return ErasureCodePluginRegistry.instance().factory(
        plugin, dict(profile), device=device)


def create(plugin: str, profile: Dict[str, str], base_dir: str,
           size: int = DEFAULT_SIZE, device=None) -> str:
    name = profile_dir_name(plugin, profile)
    d = os.path.join(base_dir, name)
    os.makedirs(d, exist_ok=True)
    ec = _factory(plugin, profile, device)
    payload = _payload(name, size)
    n = ec.get_chunk_count()
    encoded = ec.encode(set(range(n)), payload)
    with open(os.path.join(d, "content"), "wb") as f:
        f.write(payload)
    chunks = {}
    for i in range(n):
        with open(os.path.join(d, str(i)), "wb") as f:
            f.write(encoded[i])
        chunks[str(i)] = _sha(encoded[i])
    manifest = {
        "plugin": plugin,
        "profile": profile,
        "size": size,
        "content_sha256": _sha(payload),
        "chunk_sha256": chunks,
    }
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return d


def check(dirpath: str, decode_pairs: bool = True,
          device=None) -> List[str]:
    """Re-encode and byte-compare against the stored corpus entry, then
    decode the STORED chunks under erasures, with the code on
    ``device`` (default: the card).  Returns a list of error strings
    (empty = byte-stable and decodable)."""
    errors: List[str] = []
    with open(os.path.join(dirpath, "manifest.json")) as f:
        manifest = json.load(f)
    plugin = manifest["plugin"]
    profile = manifest["profile"]
    size = manifest["size"]
    ec = _factory(plugin, profile, device)
    with open(os.path.join(dirpath, "content"), "rb") as f:
        payload = f.read()
    if _sha(payload) != manifest["content_sha256"]:
        errors.append(f"{dirpath}: payload corrupted on disk")
        return errors
    n = ec.get_chunk_count()
    stored = {}
    for i in range(n):
        with open(os.path.join(dirpath, str(i)), "rb") as f:
            stored[i] = f.read()
    # 1. byte-stability: today's encode must reproduce the archive
    encoded = ec.encode(set(range(n)), payload)
    for i in range(n):
        if encoded[i] != stored[i]:
            errors.append(
                f"{dirpath}: chunk {i} re-encode differs from archive "
                f"({_sha(encoded[i])[:12]} != {_sha(stored[i])[:12]})")
    # 2. stored data stays decodable: single erasures always, pairs for
    #    small codes (mirrors the reference's erasure sweep)
    k = ec.get_data_chunk_count()
    chunk_size = len(stored[0])
    patterns = [(i,) for i in range(n)]
    if decode_pairs and n <= 12 and ec.get_coding_chunk_count() >= 2:
        patterns += list(itertools.combinations(range(n), 2))
    for erased in patterns:
        avail = {i: stored[i] for i in range(n) if i not in erased}
        want = set(erased)
        try:
            need = ec.minimum_to_decode(want, set(avail))
            decoded = ec.decode(want, {i: avail[i] for i in need
                                       if i in avail} or avail, chunk_size)
        except Exception as e:  # non-MDS codes may not cover a pattern
            if len(erased) > ec.get_coding_chunk_count():
                continue
            try:  # full-availability fallback mirrors the reference
                decoded = ec.decode(want, avail, chunk_size)
            except Exception:
                errors.append(f"{dirpath}: decode {erased} raised {e!r}")
                continue
        for c in erased:
            if c not in decoded:
                errors.append(
                    f"{dirpath}: decode {erased} did not produce chunk {c}")
            elif decoded[c] != stored[c]:
                errors.append(
                    f"{dirpath}: decode {erased} chunk {c} mismatch")
    # 3. payload reassembly
    data_chunks = b"".join(stored[i] for i in range(k))
    if data_chunks[:size] != payload:
        mapping = ec.get_chunk_mapping()
        if not mapping:  # systematic codes must carry payload verbatim
            errors.append(f"{dirpath}: data chunks do not carry payload")
    # 4. composite decode rows (shec/clay — the unified decode
    #    engine): the BATCHED per-pattern composite decode on the
    #    code's device — the path the bench decode_rows run — must
    #    reproduce the archived bytes for every single erasure.  A
    #    drift here ships wrong repair bytes even while the scalar
    #    decode sweep above stays green.
    if plugin in ("shec", "clay"):
        stack = torch.from_numpy(np.stack(
            [np.frombuffer(stored[i], dtype=np.uint8)
             for i in range(n)])).to(ec.device)
        for e in range(n):
            avail = tuple(i for i in range(n) if i != e)
            try:
                rec = ec.decode_chunks_torch(
                    stack[None, list(avail)], avail, (e,)).cpu().numpy()
            except Exception as exc:  # noqa: BLE001 - recorded below
                errors.append(
                    f"{dirpath}: composite decode ({e},) raised {exc!r}")
                continue
            if rec[0, 0].tobytes() != stored[e]:
                errors.append(
                    f"{dirpath}: composite decode ({e},) chunk {e} "
                    f"mismatch")
    # 5. composite-decode cost ratchet: the modeled per-pattern decode
    #    cost must stay within the XOR-schedule envelope of the RS
    #    reference — a scheduler/probe/composite regression fails here
    #    loudly
    if plugin in ("shec", "clay", "lrc"):
        errors.extend(composite_decode_guard(dirpath, plugin, ec))
    return errors


def corpus_dirs(base_dir: str) -> List[str]:
    return sorted(
        os.path.join(base_dir, d) for d in os.listdir(base_dir)
        if os.path.isfile(os.path.join(base_dir, d, "manifest.json")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--base-dir", required=True)
    ap.add_argument("--create", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--plugin")
    ap.add_argument("--parameter", "-P", action="append", default=[])
    ap.add_argument("--size", type=int, default=DEFAULT_SIZE)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the codes run: the card (default) or "
                         "the CPU")
    args = ap.parse_args(argv)
    if args.create:
        if args.plugin:
            profile = dict(p.split("=", 1) for p in args.parameter)
            d = create(args.plugin, profile, args.base_dir, args.size,
                       args.device)
            print(f"created {d}")
        else:
            for plugin, profile in STANDARD_MATRIX:
                d = create(plugin, profile, args.base_dir, args.size,
                           args.device)
                print(f"created {d}")
        return 0
    if args.check:
        failures = []
        for d in corpus_dirs(args.base_dir):
            errs = check(d, device=args.device)
            status = "FAIL" if errs else "ok"
            print(f"{status} {os.path.basename(d)}")
            failures.extend(errs)
        for e in failures:
            print(e, file=sys.stderr)
        return 1 if failures else 0
    ap.error("one of --create / --check required")
    return 2


if __name__ == "__main__":
    sys.exit(main())
