"""Member-count sweep of the sharded paths — the port's counterpart of
the reference's ``tools/sharded_bench.py``.

Measures at 1/2/4/8 data-plane members:

- the bulk CRUSH sweep (``parallel/sharded_crush.py``), mappings/s:
  data parallelism over the x axis;
- the sharded erasure encode (``parallel/sharded_codes.py``, stripe
  sharding, tp=1), input GB/s.

Each member count runs in a child process with
``CEPH_TPU_TORCH_VIRTUAL_DEVICES=N`` (the knob is read when a mesh is
made, and a child keeps each width's kernel builds and caches apart).
The per-member work partition is read from the output
(``utils/shard.py::last_partition``), so the table shows both the wall
clock and the 1/N division of work.

Reading the wall clock over virtual members: N members of one device
run their shards one after another on that device, so the wall clock
stays flat (or grows by the per-shard issue) with N; the evidence of
scaling there is the partition and the equal bytes, with the wall clock
of real multi-device hosts left to such hosts.

Usage:  python -m ceph_tpu_torch.tools.sharded_bench [--device cpu]
        python -m ceph_tpu_torch.tools.sharded_bench --child N [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

LANES = 200_000
ENC_BATCH, ENC_K, ENC_CHUNK, ENC_LOOP = 32, 8, 128 * 1024, 4


def child(n: int, device: str = "cuda") -> dict:
    """One width: a plane of ``n`` members (the caller sets
    ``CEPH_TPU_TORCH_VIRTUAL_DEVICES`` or has ``n`` cards) over
    ``device``'s kind."""
    import torch

    from ceph_tpu_torch.crush import CrushBuilder
    from ceph_tpu_torch.matrices.jerasure import \
        reed_sol_vandermonde_coding_matrix
    from ceph_tpu_torch.ops.fallback import resolve_device
    from ceph_tpu_torch.parallel.mesh import Mesh, visible_devices
    from ceph_tpu_torch.parallel.sharded_codes import sharded_encode
    from ceph_tpu_torch.parallel.sharded_crush import sharded_bulk_do_rule
    from ceph_tpu_torch.utils.shard import last_partition

    dev = resolve_device(device)
    devs = visible_devices(dev.type)
    if len(devs) < n:
        raise ValueError(f"{len(devs)} members visible, asked for {n}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # -- bulk CRUSH sweep, dp over the x axis ------------------------------
    b = CrushBuilder()
    root = b.build_two_level(8, 4)
    b.add_simple_rule(0, root, "host", firstn=True)
    cmesh = Mesh(grid, ("x",))
    xs = np.arange(LANES)
    sharded_bulk_do_rule(cmesh, b.map, 0, xs, 3, device=dev)   # warm
    t0 = time.perf_counter()
    out, _ = sharded_bulk_do_rule(cmesh, b.map, 0, xs, 3, device=dev)
    crush_dt = time.perf_counter() - t0
    assert out.shape == (LANES, 3)

    # -- sharded encode, dp over the stripe axis ---------------------------
    emesh = Mesh(grid.reshape(n, 1), ("stripe", "chunk"))
    matrix = reed_sol_vandermonde_coding_matrix(ENC_K, 3, 8)
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (ENC_BATCH * n, ENC_K, ENC_CHUNK),
                        dtype=np.uint8)
    darr = torch.from_numpy(data).to(dev)
    sharded_encode(emesh, darr, matrix)                          # warm
    sync()
    t0 = time.perf_counter()
    for _ in range(ENC_LOOP):
        sharded_encode(emesh, darr, matrix)
    sync()
    enc_dt = time.perf_counter() - t0
    return {
        "n_devices": n,
        "crush_mappings_per_s": round(LANES / crush_dt),
        "crush_seconds": round(crush_dt, 3),
        "encode_gbps": round(data.nbytes * ENC_LOOP / enc_dt / 1e9, 3),
        "encode_stripes_per_device": last_partition(),
        "devices": [str(d) for d in devs[:n]],
        "physical_devices": len(set(devs[:n])),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", type=int, default=None, metavar="N")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--widths", default="1,2,4,8")
    args = ap.parse_args(argv)
    if args.child is not None:
        print(json.dumps(child(args.child, args.device)))
        return 0
    rows = []
    for n in (int(w) for w in args.widths.split(",")):
        env = dict(os.environ, CEPH_TPU_TORCH_VIRTUAL_DEVICES=str(n))
        try:
            r = subprocess.run(
                [sys.executable, "-m", "ceph_tpu_torch.tools.sharded_bench",
                 "--child", str(n), "--device", args.device],
                capture_output=True, text=True, env=env, timeout=1200)
        except subprocess.TimeoutExpired:
            print(json.dumps({"n_devices": n,
                              "error": ["timeout after 1200s"]}))
            continue
        if r.returncode != 0:
            print(json.dumps({"n_devices": n, "error":
                              r.stderr.strip().splitlines()[-1:]}))
            continue
        row = json.loads(r.stdout.strip().splitlines()[-1])
        rows.append(row)
        print(json.dumps(row))
    if len(rows) > 1:
        base = rows[0]
        print(json.dumps({
            "metric": "sharded_scaling",
            "physical_cores": os.cpu_count(),
            "baseline_devices": base["n_devices"],
            "max_devices": rows[-1]["n_devices"],
            "crush_speedup_at_max": round(
                rows[-1]["crush_mappings_per_s"]
                / base["crush_mappings_per_s"], 2),
            "encode_speedup_at_max": round(
                rows[-1]["encode_gbps"] / base["encode_gbps"], 2),
        }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
