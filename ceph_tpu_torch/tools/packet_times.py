"""Device times of the GF(2) packet kernel (``csrc/gf2_bitmatrix.cu``)
at the shapes the main path gives it, on the card.

    python ceph_tpu_torch/tools/packet_times.py [--root DIR] [--seed N]
                                                [--sweep]

``--root`` names the checkout whose ``ceph_tpu_torch`` is measured
(default: the one holding this file), so one call can time an earlier
checkout and this one on the same card, in turns.  The shapes, all
jerasure cauchy_good k=8 m=3 at packetsize 2048 unless named otherwise:

- the encode at 64 stripes of 128 KiB chunks, plain and scheduled;
- the scheduled decode (3, 9) at 4 stripes (the shape of the decode
  path's scheduled launches) and at 64;
- the plain decode e=1 (3,) at 4 stripes;
- a random w=7 bitmatrix (2 x 7 chunks, 224-byte blocks of packets of
  32 bytes) at 64 stripes, plain and through its schedule;
- the minimal-density path's six launches, as ``chip_smoke.py`` drives
  them: liberation k=7 w=7, blaum_roth k=6 w=6 and liber8tion k=8
  (packetsize 8), the encode and one 2-erasure decode each, at 4 stripes
  of about 128 KiB chunks, each product the one its codec routes to.

Each line of output is one JSON object: the shape, the wrapper, the
kernel's own device time per call from a ``torch.profiler`` trace
(``dense_times.kernel_ms``), the bytes the call must move and its bound
(:func:`work`: the program profiler's ``analytic_bitmatrix_cost``, each
input packet a row reads once and each output once, and the least XOR
instructions, ``bitmatrix_op_count`` / ``schedule_op_count``, at the
card's roofline; where the checkout has the profiler) and,
where the checkout has ``packet_plan``, the launch: the grid (blocks, row
groups), the unit in bytes and the threads of a block.

``--sweep`` (this checkout's kernel only) also times every unit (16, 8,
4 bytes) and, at 4 stripes, every row-group count of
``gf_kernels.PACKET_GROUPS`` at each shape, each in a grid of one wave
of persistent blocks and in one of a unit per thread, each launch first
checked against the plan's output byte for byte.  No card: the run
fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

try:
    from .dense_times import bound_ms, kernel_ms
except ImportError:           # run as a script: the tools directory
    from dense_times import bound_ms, kernel_ms


def shapes(seed: int):
    """(name, kind, key, n_in, w, packetsize, chunks, r) of every
    measured shape, on the card: ``kind`` "plain" (``key`` the row
    masks) or "schedule" (``key`` the schedule's static tuple)."""
    import numpy as np
    import torch
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops.torch_ops import bitmatrix_to_static
    from ceph_tpu_torch.ops.xor_schedule import probe_bitmatrix_schedule
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    k, m, chunk = 8, 3, 128 * 1024
    cg = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "cauchy_good", "k": str(k), "m": str(m)})
    ps = cg.packetsize
    data = torch.from_numpy(rng.integers(0, 256, (64, k, chunk),
                                         dtype=np.uint8)).to(dev)
    rows = cg._bitmatrix_static
    out = [("cauchy_good encode (64, 8, 131072)", "plain", rows, k * 8, 8,
            ps, data, m),
           ("cauchy_good encode (64, 8, 131072)", "schedule",
            cg._encode_sched.static, k * 8, 8, ps, data, m)]
    parity = cg.encode_chunks_torch(data)
    full = torch.cat([data, parity], dim=1)
    for erased, batch in (((3, 9), 4), ((3, 9), 64), ((3,), 4)):
        avail = tuple(i for i in range(k + m) if i not in erased)
        _, drows, _, sched = cg._decode_bitmatrix(avail, erased)
        surv = full[:batch].index_select(
            1, torch.tensor(avail, device=dev))[:, :k]
        name = f"cauchy_good decode {erased} ({batch}, 8, 131072)"
        if sched is None:
            out.append((name, "plain", tuple(drows), k * 8, 8, ps, surv,
                        len(erased)))
        else:
            out.append((name, "schedule", sched.static, k * 8, 8, ps, surv,
                        len(erased)))
    w, s, r, ps7 = 7, 7, 2, 32
    bm = (rng.random((r * w, s * w)) < 0.4).astype(np.uint8)
    brows = bitmatrix_to_static(bm)
    x7 = torch.from_numpy(rng.integers(0, 256, (64, s, w * ps7 * 512),
                                       dtype=np.uint8)).to(dev)
    name = f"random w=7 (64, 7, {w * ps7 * 512}) packetsize 32"
    out.append((name, "plain", brows, s * w, w, ps7, x7, r))
    sched = probe_bitmatrix_schedule(brows, w)
    if sched is not None:
        out.append((name, "schedule", sched.static, s * w, w, ps7, x7, r))
    for prof, erased in (({"technique": "liberation", "k": "7", "w": "7"},
                          (0, 8)),
                         ({"technique": "blaum_roth", "k": "6", "w": "6"},
                          (0, 7)),
                         ({"technique": "liber8tion", "k": "8"}, (3, 9))):
        code = ErasureCodePluginRegistry.instance().factory("jerasure",
                                                            dict(prof))
        kk, w, ps = code.k, code.w, code.packetsize
        c = code.get_chunk_size(kk * chunk)
        xd = torch.from_numpy(rng.integers(0, 256, (4, kk, c),
                                           dtype=np.uint8)).to(dev)
        name = f"{prof['technique']} encode (4, {kk}, {c}) packetsize {ps}"
        sched = code._encode_sched
        out.append((name, "plain", code._bitmatrix_static, kk * w, w, ps,
                    xd, code.m) if sched is None else
                   (name, "schedule", sched.static, kk * w, w, ps, xd,
                    code.m))
        full = torch.cat([xd, code.encode_chunks_torch(xd)], dim=1)
        avail = tuple(i for i in range(kk + code.m) if i not in erased)
        _, drows, ns, sched = code._decode_bitmatrix(avail, erased)
        surv = full.index_select(1, torch.tensor(avail, device=dev))[:, :ns]
        name = (f"{prof['technique']} decode {erased} (4, {kk}, {c}) "
                f"packetsize {ps}")
        out.append((name, "plain", tuple(drows), kk * w, w, ps, surv,
                    len(erased)) if sched is None else
                   (name, "schedule", sched.static, kk * w, w, ps, surv,
                    len(erased)))
    return out


def work(gk, kind, key, n_in, w, ps, x, r) -> dict:
    """The analytic cost (telemetry/profiler.py::analytic_bitmatrix_cost)
    of the product at one shape: each input packet row a row reads and
    each output packet row once, and the least XORs
    (``bitmatrix_op_count`` / ``schedule_op_count`` per 32-bit word
    position)."""
    from ceph_tpu_torch.telemetry.profiler import analytic_bitmatrix_cost
    if kind == "plain":
        union = 0
        for mask in key:
            union |= int(mask)
        reads, ops = bin(union).count("1"), gk.bitmatrix_op_count(key)
    else:
        reads, ops = n_in, gk.schedule_op_count(key)
    return analytic_bitmatrix_cost(x.shape[0], r, n_in // w, x.shape[-1],
                                   ops, w, reads=reads)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]),
                    help="checkout whose ceph_tpu_torch is measured")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", action="store_true",
                    help="also time every unit and row-group count, in both "
                         "grids (this checkout only)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("packet_times: no CUDA device", file=sys.stderr)
        return 2
    from ceph_tpu_torch.ops import gf_kernels as gk
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    for name, kind, key, n_in, w, ps, x, r in shapes(args.seed):
        if kind == "plain":
            wrapper = "apply_bitmatrix_cuda"
            fn = (lambda x=x, key=key, w=w, ps=ps:
                  gk.apply_bitmatrix_cuda(x, key, w, ps))
        else:
            wrapper = "apply_bitmatrix_xor_cuda"
            fn = (lambda x=x, key=key, w=w, ps=ps:
                  gk.apply_bitmatrix_xor_cuda(x, key, w, ps))
        try:
            cost = work(gk, kind, key, n_in, w, ps, x, r)
        except ImportError:     # a checkout without the profiler
            cost = None
        bound, by = bound_ms(cost) if cost is not None else (None, None)
        row = {"root": args.root, "card": smi, "shape": name,
               "wrapper": wrapper,
               "ms": kernel_ms(fn, "gf2_packet_kernel", iters=50),
               "moved_bytes": cost and cost["bytes accessed"],
               "bound_ms": bound, "bound_by": by}
        plan_fn = getattr(gk, "packet_plan", None)
        if plan_fn is not None:
            plan = gk.packet_launch_plan(x, r, w, ps, kind, key, n_in)
            row.update(grid=[plan.blocks, plan.groups], unit=plan.unit,
                       threads=plan.threads)
        print(json.dumps(row), flush=True)
        if args.sweep and plan_fn is not None:
            sweep(gk, name, kind, key, n_in, w, ps, x, r, fn, bound, smi)
    return 0


def sweep(gk, name, kind, key, n_in, w, ps, x, r, fn, bound, smi) -> None:
    """Time the kernel at one shape under every unit and (below 64
    stripes) row-group count, in both grids; one JSON line each."""
    import torch
    dev = x.device
    want = fn()
    batch, c = x.shape[0], x.shape[-1]
    limits = gk._device_limits(dev.index)
    rw = r * w
    groups = [g for g in gk.PACKET_GROUPS if g <= rw] if batch < 64 else [1]
    for unit in (16, 8, 4):
        if ps % unit:
            continue
        for g in groups:
            n, extra = gk.packet_slots(kind, key, n_in, w)(g)
            units = batch * (c // (w * ps)) * (ps // unit)
            try:
                wave = gk._packet_grid(units, unit, g, n, extra, limits)
            except ValueError:
                continue
            # one wave of persistent blocks, and a grid of one unit per
            # thread
            every = wave._replace(blocks=-(-units // wave.threads))
            for plan in {wave: 0, every: 0}:
                def run(plan=plan):
                    return gk._packet_launch(x, r, w, ps, kind, key, n_in,
                                             plan=plan)
                got = run()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"{name}: {plan} differs from the "
                                       f"plan's output")
                ms = kernel_ms(run, "gf2_packet_kernel", iters=50)
                print(json.dumps({
                    "card": smi, "shape": name, "kind": kind, "sweep": True,
                    "ms": ms, "bound_ms": bound, "plan": plan._asdict()}),
                    flush=True)


if __name__ == "__main__":
    sys.exit(main())
