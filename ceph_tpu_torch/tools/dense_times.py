"""Device times of the dense GF(2^w) matrix kernel at the shapes the main
path gives it, on the card.

    python ceph_tpu_torch/tools/dense_times.py [--root DIR] [--seed N]

``--root`` names the checkout whose ``ceph_tpu_torch`` is measured
(default: the one holding this file), so one call can time an earlier
checkout and this one on the same card, in turns.  The shapes:

- the RS k=8 m=3 encode at 64 stripes of 128 KiB chunks, bytes and
  packed layouts;
- the RS decode e=2 (erasures 3 and 9) at 4 stripes, bytes and packed
  (the shape of most decode launches), and at 64 stripes; the decode
  e=1 (3) at 4 stripes;
- clay k=8 m=4 d=11's (64, 704) repair of chunk 8 at (4, 704, 2048),
  the table variant;
- reed_sol_van k=8 m=3 at w=16 and w=32, (64, 8, 65536) words;
- the ragged kernel over a (512, 8, 4096) pool at 25, 50 and 100 %
  live pages, bytes and packed.

Each line of output is one JSON object: the shape, the wrapper, the
kernel's own device time per call from a ``torch.profiler`` trace
(``kernel_ms``) and, where the checkout has ``sm90_op_floor`` and the
program profiler's models, the bound: the profiler's analytic kernel
cost (each input read once, each output written once, the floor's
INT32 instructions a word position) at the card's roofline (3.35 TB/s,
16.7 Tops/s), the same work its attribution rows count.  No card: the
run fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

def kernel_ms(fn, kernel, iters: int = 20, tries: int = 3):
    """Device time per call of the CUDA kernels that ``fn`` launches,
    from a profiler trace of ``iters`` calls (CUPTI records each
    kernel's own start and end, so the host's issue pace does not
    enter): the kernels whose names hold ``kernel``, or each name of a
    tuple, every call launching at least one kernel of each name.  A
    trace that lost some of the launches (fewer than ``iters`` of a
    name) is taken again, up to ``tries`` traces; None when none holds
    them all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [[e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA and name in e.name]
              for name in names]
        if all(len(u) >= iters for u in us):
            return sum(map(sum, us)) / 1e3 / iters
    return None


def bound_ms(cost: dict) -> tuple[float, str]:
    """The least time the card could take for an analytic cost of the
    program profiler (``telemetry/profiler.py``: bytes accessed, INT32
    instructions): its roofline at 3.35 TB/s and 16.7 Tops/s."""
    from ceph_tpu_torch.telemetry.profiler import roofline_ms
    return roofline_ms(cost)


def shapes(seed: int):
    """(name, wrapper name, call, cost dims (stripes, output rows, input
    chunks, chunk bytes, live stripes or None), matrix, w, (stripes,
    chunk bytes) of the dense plan) of every measured shape, on the
    card."""
    import numpy as np
    import torch
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops import gf_kernels as gk
    from ceph_tpu_torch.ops import regionops
    from ceph_tpu_torch.ops.torch_ops import WORD_DTYPE, matrix_to_static
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    reg = ErasureCodePluginRegistry.instance()
    k, m, chunk = 8, 3, 128 * 1024
    rs = reg.factory("jerasure", {"technique": "reed_sol_van", "k": "8",
                                  "m": "3"})
    enc = matrix_to_static(rs.matrix)
    data = torch.from_numpy(rng.integers(0, 256, (64, k, chunk),
                                         dtype=np.uint8)).to(dev)
    out = []

    def both(name, x, mat, r):
        cost = (x.shape[0], r, len(mat[0]), x.shape[-1], None)
        words = gk.pack_chunks(x)
        dims = (x.shape[0], x.shape[-1])
        out.append((name, "apply_matrix_cuda",
                    lambda: gk.apply_matrix_cuda(x, mat), cost, mat, 8,
                    dims))
        out.append((name, "apply_matrix_cuda_packed",
                    lambda: gk.apply_matrix_cuda_packed(words, mat), cost,
                    mat, 8, dims))

    both("rs encode (64, 8, 131072)", data, enc, m)
    for erased, batch in (((3, 9), 4), ((3, 9), 64), ((3,), 4)):
        avail = [i for i in range(k + m) if i not in erased]
        dm = matrix_to_static(regionops.matrix_decode_matrix(
            rs.matrix, k, avail[:k], list(erased)))
        x = data[:batch].clone()
        name = f"rs decode {erased} ({batch}, 8, 131072)"
        if batch == 4 and len(erased) == 2:
            both(name, x, dm, len(erased))
        else:
            out.append((name, "apply_matrix_cuda",
                        lambda x=x, dm=dm: gk.apply_matrix_cuda(x, dm),
                        (batch, len(erased), k, chunk, None), dm, 8,
                        (batch, chunk)))
    clay = reg.factory("clay", {"k": "8", "m": "4", "d": "11"})
    sub = clay.get_sub_chunk_count()
    sc = clay.get_chunk_size(1 << 20) // sub
    avail = tuple(i for i in range(12) if i != 8)
    rep = clay._decode_composite(avail, (8,))[1]
    cx = torch.from_numpy(rng.integers(0, 256, (4, 704, sc),
                                       dtype=np.uint8)).to(dev)
    out.append((f"clay repair (8,) (4, 704, {sc})", "apply_matrix_cuda",
                lambda: gk.apply_matrix_cuda(cx, rep), (4, 1, 704, sc, None),
                rep, 8, (4, sc)))
    for w in (16, 32):
        wc = reg.factory("jerasure", {"technique": "reed_sol_van", "k": "8",
                                      "m": "3", "w": str(w)})
        wm = matrix_to_static(wc.matrix)
        xw = torch.from_numpy(rng.integers(0, 256, (64, k, 65536 * w // 8),
                                           dtype=np.uint8)).to(dev).view(
                                               WORD_DTYPE[w])
        out.append((f"w={w} encode (64, 8, 65536)", "apply_matrix_cuda_words",
                    lambda xw=xw, wm=wm, w=w: gk.apply_matrix_cuda_words(
                        xw, wm, w), (64, m, k, 65536 * w // 8, None), wm,
                    w, (64, 65536 * w // 8)))
    pool = torch.from_numpy(rng.integers(0, 256, (512, k, 4096),
                                         dtype=np.uint8)).to(dev)
    pool_words = gk.pack_chunks(pool)
    for share in (0.25, 0.5, 1.0):
        live = np.zeros(512, np.uint8)
        live[rng.permutation(512)[:int(512 * share)]] = 1
        mk = torch.from_numpy(live).to(dev)
        cost = (512, m, k, 4096, int(live.sum()))
        name = f"ragged {share:.0%} live (512, 8, 4096)"
        out.append((name, "apply_matrix_cuda_ragged",
                    lambda mk=mk: gk.apply_matrix_cuda_ragged(pool, enc, mk),
                    cost, enc, 8, (512, 4096)))
        out.append((name, "apply_matrix_cuda_packed_ragged",
                    lambda mk=mk: gk.apply_matrix_cuda_packed_ragged(
                        pool_words, enc, mk), cost, enc, 8, (512, 4096)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]),
                    help="checkout whose ceph_tpu_torch is measured")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("dense_times: no CUDA device", file=sys.stderr)
        return 2
    from ceph_tpu_torch.ops import gf_kernels as gk
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    floor = getattr(gk, "sm90_op_floor", None)
    try:
        from ceph_tpu_torch.telemetry import profiler
        if not hasattr(profiler, "analytic_kernel_cost"):
            floor = None
    except ImportError:         # a checkout without the profiler
        floor = None
    plan = getattr(gk, "dense_plan", None)
    for name, wrapper, fn, cost, mat, w, dims in shapes(args.seed):
        row = {"root": args.root, "card": smi, "shape": name,
               "wrapper": wrapper, "ms": kernel_ms(fn, "gf_matrix",
                                                   iters=50)}
        if floor is not None:
            row["bound_ms"], row["bound_by"] = bound_ms(
                profiler.analytic_kernel_cost(*cost[:4], floor(mat, w),
                                              live=cost[4]))
        if plan is not None and w == 8:
            row["grid"] = plan(*dims, mat, torch.device("cuda", 0))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
