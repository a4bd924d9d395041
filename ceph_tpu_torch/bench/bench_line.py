"""The port's bench line: jerasure reed_sol_van k=8 m=3 encode on 1 MiB
stripes, on the card, as ONE JSON line.

    python -m ceph_tpu_torch.bench.bench_line

The counterpart of the repo root's ``bench.py`` ``main`` for the rows
whose workloads the port has (encode, decode, degraded, repair-batched,
recovery-churn, device-chaos, serving), each run through
:class:`~ceph_tpu_torch.bench.erasure_code_benchmark.ErasureCodeBench`
with ``--device cuda``:

- ``value``: the best ``--loop`` carry chain (packed or bytes layout) at
  ``--batch 64 --loop 1024``, GB/s of data-chunk input, as ``bench.py``
  picks it; ``slice_gbps`` the packed slice chain, ``percall_gbps`` the
  resident per-call run (enqueue timed, one barrier at the end).  The
  chains launch one Python step per slab: where a step's kernels take
  less time than the host takes to launch them, the GB/s is the host's
  pace.
- ``decode_rows``: ``bench.py``'s DECODE_ROWS (RS e=2, shec k=6 m=3 c=2
  e=1, clay k=8 m=4 d=11 e=1); ``decode_gbps`` is the RS row's GB/s.
- ``serving_rows``: the mixed rs/shec/clay stream closed-loop, dense and
  paged, on the real clock.
- ``degraded_rows``: ``bench.py``'s DEGRADED_ROWS, the recovery path: the
  three ``degraded`` rows (scrub verify at 0 faults, 1 erasure, 2
  erasures + 1 corruption) on the host, as in the reference, and
  ``repair-batched`` and ``recovery-churn`` on the card, each with its
  pattern-batch, device-call and (churn) replan / regroup counts.
- ``device_chaos_rows``: ``bench.py``'s DEVICE_CHAOS_ROWS, batched
  recovery through the supervised fused-repair seam while a seeded
  fault script fires mid-run (transient error, out of memory, a lost
  backend for two calls), each row with the supervisor's counter
  deltas, the faults fired and whether the tier ended demoted.
- ``vs_baseline``: against the in-tree C++ AVX2 RS benchmark
  (``native/build/ceph_erasure_code_benchmark``) run live on this host,
  or null with ``baseline`` saying it is not built.
- ``topology``: platform, device count, mesh shape (the active data
  plane's, null without one), and the card's name and power limit
  (``nvidia-smi``).
- every row carries ``kernel_launches``: the kernel launches of its run
  (``ops/launches.py``).

Without a card it prints the error line (``value`` null, an ``error``
naming the missing CUDA device, ``host_gbps`` from a ``--device host``
run, ``platform`` null) and exits 0.  It never prints a device number
taken on the CPU, and writes no file.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

from .erasure_code_benchmark import ErasureCodeBench

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_BENCH = os.path.join(REPO, "native", "build",
                            "ceph_erasure_code_benchmark")

METRIC = "encode_gbps_jerasure_rs_k8_m3_1MiB_stripes"

NORTH_STAR = ["--plugin", "jerasure",
              "--parameter", "technique=reed_sol_van",
              "--parameter", "k=8", "--parameter", "m=3",
              "--size", str(1 << 20), "--workload", "encode"]

# the headline candidates (bench.py's): three --loop chains and the
# resident per-call run
ENCODE_ROWS = [
    ("packed_slice", NORTH_STAR + ["--device", "cuda", "--batch", "64",
                                   "--loop", "1024", "--layout", "packed",
                                   "--chain", "slice"]),
    ("packed_carry", NORTH_STAR + ["--device", "cuda", "--batch", "64",
                                   "--loop", "1024", "--layout", "packed",
                                   "--chain", "carry"]),
    ("bytes_carry", NORTH_STAR + ["--device", "cuda", "--batch", "64",
                                  "--loop", "1024", "--layout", "bytes",
                                  "--chain", "carry"]),
    ("percall", NORTH_STAR + ["--device", "cuda", "--batch", "64",
                              "--iterations", "100", "--resident"]),
]

# bench.py's DECODE_ROWS, on the card
DECODE_ROWS = [
    ("rs_k8_m3_e2",
     ["--plugin", "jerasure", "--parameter", "technique=reed_sol_van",
      "--parameter", "k=8", "--parameter", "m=3", "--size", str(1 << 20),
      "--workload", "decode", "-e", "2",
      "--device", "cuda", "--batch", "64", "--loop", "1024",
      "--layout", "packed", "--chain", "slice"]),
    ("shec_k6_m3_c2_e1",
     ["--plugin", "shec", "--parameter", "k=6", "--parameter", "m=3",
      "--parameter", "c=2", "--size", str(6 * 131072),
      "--workload", "decode", "-e", "1",
      "--device", "cuda", "--batch", "32", "--loop", "256",
      "--layout", "packed", "--chain", "slice"]),
    ("clay_k8_m4_d11_e1",
     ["--plugin", "clay", "--parameter", "k=8", "--parameter", "m=4",
      "--parameter", "d=11", "--size", str(1 << 20),
      "--workload", "decode", "-e", "1",
      "--device", "cuda", "--batch", "16", "--loop", "64",
      "--layout", "packed", "--chain", "carry"]),
]

# bench.py's SERVING_ROWS, on the card
SERVING_ROWS = [
    ("serving_mixed_closed",
     ["--workload", "serving", "--device", "cuda",
      "--size", str(1 << 16), "--requests", "256",
      "--concurrency", "64", "--seed", "42"]),
    ("serving_mixed_paged",
     ["--workload", "serving", "--device", "cuda",
      "--size", str(1 << 16), "--requests", "256",
      "--concurrency", "64", "--seed", "42", "--paged"]),
]

# bench.py's DEGRADED_ROWS: the degraded rows stay on the host (the
# scrub CRC and classification are host math); repair-batched and
# recovery-churn run their fused repair on the card.  argparse's
# last-wins lets a row override the common workload, device and size.
DEGRADED_COMMON = ["--plugin", "jerasure",
                   "--parameter", "technique=reed_sol_van",
                   "--parameter", "k=8", "--parameter", "m=3",
                   "--size", str(1 << 20), "--workload", "degraded",
                   "--device", "host", "--batch", "4"]
DEGRADED_ROWS = [
    ("rs_k8_m3_scrub_e0", ["-e", "0"]),
    ("rs_k8_m3_degraded_e1", ["-e", "1"]),
    ("rs_k8_m3_degraded_e2_c1", ["-e", "2", "--corruptions", "1"]),
    ("rs_k8_m3_repair_batched_e1",
     ["--workload", "repair-batched", "--device", "cuda",
      "--size", str(1 << 18), "--batch", "16", "-e", "1"]),
    ("rs_k8_m3_recovery_churn",
     ["--workload", "recovery-churn", "--device", "cuda",
      "--size", str(1 << 18), "--batch", "8", "-e", "1",
      "--churn-every", "2"]),
]

# bench.py's DEVICE_CHAOS_ROWS, on the card: batched recovery while the
# supervisor absorbs a seeded fault script (a transient error, an
# out-of-memory error, a backend lost for two calls); the heal is
# gated in the workload
DEVICE_CHAOS_ROWS = [
    ("rs_k8_m3_device_chaos",
     ["--plugin", "jerasure", "--parameter", "technique=reed_sol_van",
      "--parameter", "k=8", "--parameter", "m=3",
      "--size", str(1 << 16), "--workload", "device-chaos",
      "--device", "cuda", "--batch", "8", "--iterations", "2",
      "-e", "1", "--seed", "42"]),
]
DEVICE_CHAOS_FIELDS = ("supervisor", "faults_fired", "demoted_at_end",
                       "erasures", "verified")

# the recovery counts a degraded row carries where its workload has them
RECOVERY_FIELDS = ("erasures", "corruptions", "pattern_batches",
                   "device_calls", "host_batches", "replans", "regroups",
                   "rounds", "epochs_advanced")

SERVING_FIELDS = ("gbps_under_slo", "deadline_miss_rate",
                  "padding_overhead", "requests", "rejected",
                  "stream_compiles", "tail_attribution", "paged",
                  "cached_programs", "page_pool")


def run_row(argv: list) -> tuple:
    """(result row, kernel launches) of one ErasureCodeBench run: the
    launch counters are set to 0 just before it and read just after."""
    from ..ops.launches import launch_counts, reset_launch_counts
    bench = ErasureCodeBench()
    bench.setup(argv)
    reset_launch_counts()
    res = bench.run()
    return res, sum(launch_counts().values())


def _row_result(res: dict, launches: int) -> dict:
    """GB/s, the latency percentiles the workload's histogram recorded,
    config provenance and the run's kernel launches."""
    row = {"gbps": res["gbps"]}
    for f in ("lat_p50_ms", "lat_p99_ms", "lat_p999_ms", "lat_samples",
              "config_source", "tune_key_hash", "platform"):
        row[f] = res.get(f)
    if res.get("mesh_shape") is not None:
        row["mesh_shape"] = res["mesh_shape"]
    row["kernel_launches"] = launches
    return row


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (None where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        name, limit = (part.strip() for part in out.rsplit(",", 1))
        return {"name": name, "power_limit": limit}
    except Exception:  # noqa: BLE001 - provenance only, never fatal
        return {"name": None, "power_limit": None}


def native_baseline() -> tuple:
    """(GB/s or None, provenance) of the in-tree C++ AVX2 RS benchmark,
    k=8 m=3, 1 MiB stripes, 100 iterations, run live on this host."""
    if not os.path.exists(NATIVE_BENCH):
        return None, ("cpp-rs-avx2: not built (native/build/"
                      "ceph_erasure_code_benchmark is absent)")
    try:
        out = subprocess.run(
            [NATIVE_BENCH, "-p", "rs", "-w", "encode", "-i", "100",
             "-s", str(1 << 20), "-P", "k=8", "-P", "m=3",
             "-d", os.path.dirname(NATIVE_BENCH)],
            capture_output=True, text=True, timeout=300, check=True)
        elapsed, kib = out.stdout.split()
        return (float(kib) * 1024 / float(elapsed) / 1e9,
                "cpp-rs-avx2 (measured live)")
    except Exception as e:  # noqa: BLE001 - recorded in the line
        return None, f"cpp-rs-avx2: run failed ({type(e).__name__}: {e})"


def _topology(on_card: bool) -> dict:
    from ..parallel.plane import plane_topology
    topo = {"platform": "gpu" if on_card else None,
            "device_count": torch.cuda.device_count() if on_card else 0,
            "mesh_shape": plane_topology() if on_card else None}
    topo.update(card() if on_card else {"name": None,
                                        "power_limit": None})
    return topo


def _host_run(batch: int, iterations: int) -> dict:
    bench = ErasureCodeBench()
    bench.setup(NORTH_STAR + ["--device", "host", "--batch", str(batch),
                              "--iterations", str(iterations)])
    return bench.run()


def error_line(msg: str, host_gbps: float) -> dict:
    """The line of a run that could not measure the card: no device
    number, the host region ops' GB/s beside the error."""
    base_gbps, base_src = native_baseline()
    return {
        "metric": METRIC,
        "value": None,
        "unit": "GB/s",
        "vs_baseline": None,
        "baseline": base_src,
        "baseline_gbps": base_gbps,
        "error": msg,
        "topology": _topology(False),
        "host_gbps": host_gbps,
    }


def measure() -> dict:
    """Every row on the card, and the line they make."""
    host = _host_run(batch=4, iterations=3)
    base_gbps, base_src = native_baseline()
    errors = []
    encode_rows = {}
    for name, argv in ENCODE_ROWS:
        try:
            encode_rows[name] = run_row(argv)
        except (Exception, SystemExit) as e:  # noqa: BLE001 - recorded
            errors.append(f"encode/{name}: {type(e).__name__}: {e}")
    if not encode_rows:
        return error_line("device runs failed on the card: "
                          + "; ".join(errors), host["gbps"])
    decode_rows = {}
    for name, argv in DECODE_ROWS:
        try:
            res, launches = run_row(argv)
            row = _row_result(res, launches)
            row["engine"] = res.get("engine")
            row["xor_schedule"] = res.get("xor_schedule")
            decode_rows[name] = row
        except (Exception, SystemExit) as e:  # noqa: BLE001 - recorded
            errors.append(f"decode/{name}: {type(e).__name__}: {e}")
            decode_rows[name] = None
    serving_rows = {}
    for name, argv in SERVING_ROWS:
        try:
            res, launches = run_row(argv)
            row = _row_result(res, launches)
            for f in SERVING_FIELDS:
                row[f] = res.get(f)
            serving_rows[name] = row
        except (Exception, SystemExit) as e:  # noqa: BLE001 - recorded
            errors.append(f"serving/{name}: {type(e).__name__}: {e}")
            serving_rows[name] = None

    degraded_rows = {}
    for name, extra in DEGRADED_ROWS:
        argv = DEGRADED_COMMON + ["--iterations", "3"] + extra
        try:
            res, launches = run_row(argv)
            row = _row_result(res, launches)
            for f in RECOVERY_FIELDS:
                if f in res:
                    row[f] = res[f]
            degraded_rows[name] = row
        except (Exception, SystemExit) as e:  # noqa: BLE001 - recorded
            errors.append(f"degraded/{name}: {type(e).__name__}: {e}")
            degraded_rows[name] = None

    device_chaos_rows = {}
    for name, argv in DEVICE_CHAOS_ROWS:
        try:
            res, launches = run_row(argv)
            row = _row_result(res, launches)
            for f in DEVICE_CHAOS_FIELDS:
                row[f] = res.get(f)
            device_chaos_rows[name] = row
        except (Exception, SystemExit) as e:  # noqa: BLE001 - recorded
            errors.append(f"device-chaos/{name}: {type(e).__name__}: {e}")
            device_chaos_rows[name] = None

    results = {name: res for name, (res, _) in encode_rows.items()}
    carry = [r for r in results.values()
             if r["chain"] == "carry" and r["loop"]]
    best = max(carry or list(results.values()), key=lambda r: r["gbps"])
    percall = results.get("percall")
    slice_ = results.get("packed_slice")
    out = {}
    if errors:
        # a partial line is never mistaken for a clean measurement
        out["partial_error"] = "; ".join(errors)
    out |= {
        "metric": METRIC,
        "value": best["gbps"],
        "unit": "GB/s",
        "vs_baseline": (best["gbps"] / base_gbps if base_gbps else None),
        "baseline": base_src,
        "baseline_gbps": base_gbps,
        "layout": best["layout"],
        "chain": best["chain"],
        "carry_chain_gbps": (max(r["gbps"] for r in carry)
                             if carry else None),
        "slice_gbps": slice_["gbps"] if slice_ else None,
        "percall_gbps": percall["gbps"] if percall else None,
        "encode_rows": {name: _row_result(res, launches)
                        for name, (res, launches) in encode_rows.items()},
        "topology": _topology(True),
        "decode_gbps": (decode_rows.get("rs_k8_m3_e2") or {}).get("gbps"),
        "decode_rows": decode_rows,
        "serving_rows": serving_rows,
        "degraded_rows": degraded_rows,
        "device_chaos_rows": device_chaos_rows,
        "lat_p50_ms": best.get("lat_p50_ms"),
        "lat_p99_ms": best.get("lat_p99_ms"),
        "lat_p999_ms": best.get("lat_p999_ms"),
        "host_gbps": host["gbps"],
        "vs_host_groundtruth": (best["gbps"] / host["gbps"]
                                if host["gbps"] > 0 else None),
    }
    return out


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        # the honest line, fast: a small host run, no device number
        host = _host_run(batch=2, iterations=1)
        print(json.dumps(error_line(
            "no CUDA device: torch.cuda.is_available() is False; host "
            "numpy GB/s in host_gbps", host["gbps"])))
        return 0
    print(json.dumps(measure()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
