#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ceph_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with a CUDA device.  It
builds every kernel from ``ceph_tpu_torch/ops/csrc`` (one ``nvcc`` per
source, all started together) and then, in order:

1. prints the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions and the kernel build time;
2. holds each kernel against its plain torch version on the card
   (``torch.equal``: GF(2^w) and GF(2) math is integer, so the tolerance
   is 0):

   - the GF(2^8) kernel (bytes and packed wrappers): the jerasure RS k=8
     m=3 matrix at (64, 8, 131072), random matrices with zero entries for
     r in {1, 3, 8, 11}, a chunk size off the 16-byte vector (4096 + 4),
     no leading batch dimension, a strided survivor slice; the RS decode
     e=2 matrix at 1, 4 and 64 stripes, on both sides of the kernel's
     one-wave rule (``gf_kernels.dense_plan`` reports the grid);
   - the w=16/32 word kernel: the reed_sol_van k=8 m=3 matrices at (64,
     8, 65536) words, random matrices, a tail, a strided slice;
   - the packet-layout bitmatrix kernel through both its wrappers (the
     plain product and a CSE schedule): the jerasure cauchy_good k=8 m=3
     bitmatrix (packetsize 2048) and its e=2 decode schedule at (64, 8,
     131072), and random bitmatrices for w in {6, 7, 8} and packetsizes
     {8, 32, 2048}, with and without a leading batch dimension, through a
     strided survivor slice; the cauchy_good decodes (3,), (3, 9) and
     (5, 6, 7) at 4 stripes (row groups on grid y) and 64 (one group)
     through the wrappers, and random bitmatrices at the packet sizes
     that take each other unit width (16 bytes at 32, 4 at 12, 1 at 3);
   - the XOR-schedule kernel (bytes and packed wrappers): the
     reed_sol_r6_op k=8 m=2 encode schedule (the ring transform) at (64,
     8, 131072), an lrc k=4 m=2 l=3 local repair at (64, 7, 262144), the
     4 shec k=4 m=3 c=2 plans that take a schedule, random sparse and
     monomial schedules, a strided slice and C = 4096 + 4;
   - the ragged kernel (bytes and packed wrappers): the serving pool
     (512 pages, 8 rows, 4096 bytes) under a scattered half-live, an
     all-dead and an all-live mask, for the RS encode matrix and random
     r in {1, 3, 11}, also against the dense kernel on the masked pool;
     dead pages must be zero;
   - the "mxu" row's column-walk kernel (bytes and packed wrappers),
     against its plain version over the same kernel data
     (``apply_matrix_walk_torch``) and the reference's MXU twin
     (``apply_matrix_mxu_torch``): the clay k=8 m=4 d=11 encode
     composite (256 x 512) at (64, 512, 2048), a (64, 704)
     single-erasure decode composite at (4, 704, 2048), where the kernel
     splits the columns, and at (64, 704, 2048), where it does not,
     random matrices with zeros for r in {16, 64, 300, 513, 600} (up to
     three row tiles) and s from 24 to 704, C off the tile and the word
     (2048 + 4, 1000, 1003), no batch dimension, with and without the
     split;
   - the dense kernel's table variant (a table above 2048
     coefficients): the four clay (64, 704) parity repair composites,
     dense and ragged (half-live mask), bytes and packed;
   - the roofline probes' copy and fold kernels on a (64, 8, 256, 128)
     slab (64 MiB);

   and two stripes of each against the numpy ground truth;
3. drives the paths through the entry points a user calls, each with
   the kernel launch counters set to 0 just before it and read just
   after; every kernel a path runs must have launched there:

   - RS: ``ErasureCodePluginRegistry.factory("jerasure", reed_sol_van
     k=8 m=3)`` on the card encodes 64 x 1 MiB stripes through
     ``encode_chunks_torch``, ``encode_chunks_batch`` and the packed
     entry, decodes every 1-, 2- and 3-erasure pattern (231) of a
     4-stripe batch in both layouts and checks the recovered bytes, and
     runs the isa reed_sol_van k=8 m=3 code once;
   - cauchy_good: jerasure cauchy_good k=8 m=3 (packetsize 2048) encodes
     64 x 1 MiB through ``encode_chunks_torch`` and
     ``encode_chunks_batch``, and decodes all 231 patterns of a 4-stripe
     batch through ``decode_chunks_torch`` (9 plain, 222 scheduled
     launches), then repeats them warm: the same launches and bytes, no
     kernel setup;
   - minimal density: liberation k=7 w=7, blaum_roth k=6 w=6 and
     liber8tion k=8, an encode and a decode each;
   - wide words: reed_sol_van w=16 and w=32 k=8 m=3, an encode and a
     3-erasure decode each;
   - lrc k=4 m=2 l=3: 64 x 1 MiB encode through ``encode_chunks_torch``
     and the packed entry, and all 36 one- and two-erasure decodes of a
     4-stripe batch in both layouts (29 take the XOR-schedule kernel);
   - r6: jerasure reed_sol_r6_op k=8 m=2, 64 x 1 MiB encode through the
     tensor and packed entries (the XOR-schedule kernel) and its 55 one-
     and two-erasure decodes in both layouts (the XOR-schedule kernel for
     (9,) and (8, 9), the dense kernel for the rest);
   - shec k=4 m=3 c=2: 64 x 1 MiB encode, and every 1-, 2- and 3-erasure
     pattern of a 4-stripe batch in both layouts (the undecodable ones
     must raise);
   - serving: one closed-loop stream of 512 requests (64 in flight;
     RS k=8 m=3 at 64 KiB, 1 MiB and 4 MiB, shec k=6 m=3 c=2 at 1 MiB;
     encode / decode / repair) through ``run_serving_scenario`` on the
     real clock, dense (rung ladder 1/4/16/64) and paged (pages of 4096
     bytes, 512 per pool): every output verified byte for byte, no
     kernel setup after warmup, the pools drained; the ragged kernel
     launches on the paged run and never on the dense one;
   - ``apply_matrix_packed_best_ragged``, the packed ragged ops entry,
     once;
   - clay: ``factory("clay", k=8 m=4 d=11)`` on the card encodes 64 x
     1 MiB stripes through ``encode_chunks_torch``,
     ``encode_chunks_batch`` and the packed entry, decodes all 78 one-
     and two-erasure patterns of a 4-stripe batch in both layouts (the
     column-walk kernel on the 74 "mxu" patterns, the dense kernel's table
     variant on the 4 parity repairs), repairs one chunk through the
     dict API from the sub-chunk runs of ``minimum_to_decode``, and runs
     clay k=4 m=2 d=5 once;
   - the serving stream above carries the reference ``default_spec``'s
     clay share (clay k=8 m=4 d=11 at 1 MiB, weight 1 beside RS 3 and
     shec 2), dense and paged;
   - the roofline tool (``ceph_tpu_torch.tools.roofline``): its five
     probes at 64 MiB slabs, loop 64;
4. times each kernel, its plain version and a copy of the same bytes
   with CUDA events at its main shape, with the host's issue time beside
   it, and each kernel's own device time per launch from a profiler
   trace, against the bound (the larger of the bytes over HBM bandwidth
   and the integer ops over the INT32 peak, the GF(2^w) matrices' ops
   the floor of the chain per column and per row,
   ``gf_kernels.sm90_op_floor``; for the "mxu" row the dense GEMM at the
   int8 peak, the reference's MXU form, printed beside it as the GEMM
   bound); the dense kernel's by-value and table variants on the RS k=8
   m=3 encode (w=8 and w=16); the dense kernel at the shapes of
   ``ceph_tpu_torch/tools/dense_times.py`` (the RS encode, the decode
   e=2 at 4 and 64 stripes, e=1 at 4, clay's (64, 704) repair through
   the device program, w=16/32, the ragged pool) with the instructions
   per word position its row program spends and its grid; the packet
   kernel at the shapes of ``ceph_tpu_torch/tools/packet_times.py`` (the
   cauchy_good encode plain and scheduled, the scheduled decode (3, 9)
   at 4 and 64 stripes, the plain decode (3,) at 4, a random w=7
   bitmatrix at packetsize 32) with its bound and plan; the RS path's
   launches per decode call (phase 3); the ragged kernel at 25,
   50 and 100 % live pages beside the dense kernel on the same bytes;
   the host-to-device copy of one pool; the serving runs' GB/s, GB/s
   under SLO and p50/p99 per op, and where one fire's time goes (copy
   in, the call, copy out, demux), paged and dense; and prints one JSON
   line ``{"kernels": [...]}`` (thirteen wrappers; "ms" is the profiler's
   device time, the event time where the trace has no kernel); the
   column-walk kernel on the three clay shapes (the encode, the (0,)
   decode and the (8,) repair; the two decodes split their columns at
   4 stripes and are also timed at 64, where they do not split),
   beside the dense kernel and ``torch._int_mm`` on the materialised
   bit-planes of the same matrices (the library GEMM, timed here and
   used nowhere in the port) and the bit-plane kernel's earlier times,
   each with its share of the floor; the copy kernel, ``copy_`` into a
   buffer allocated once and ``clone`` in turns on the same slab; the
   host issue per call of clay's encode and decode entry points, and the
   host time of the clay composite probes.

5. runs the bench line's rows (``ceph_tpu_torch/bench/bench_line.py``)
   through ``ErasureCodeBench`` in this process with ``--json --device
   cuda``, each with the launch counters at 0 just before it and read
   just after: the four headline encode candidates (packed/slice,
   packed/carry, bytes/carry at ``--batch 64 --loop 1024``, the resident
   per-call run), the three decode rows (RS k=8 m=3 e=2, shec k=6 m=3
   c=2 e=1, clay k=8 m=4 d=11 e=1) and the two serving rows (256
   requests of 64 KiB, dense and paged).  Every row must launch a kernel
   and report ``platform: "gpu"``; each --loop row's configuration runs
   once more at an odd number of steps (15 encodes, 7 decodes), its
   carry held byte for byte to the numpy tier's outputs XORed over the
   same slabs (at an even count the carry cancels whatever the step
   computes); the serving rows must verify with no kernel setup after
   warmup; the profiler's device time per chain step is printed beside
   each row's GB/s; ``non_regression.check`` runs every corpus entry on
   the card with 0 errors.  It prints one ``{"bench": {...}}`` line.

The last line of standard output is ``{"ok": true, "device": {...}}``,
after the ``{"kernels": [...]}`` line.
Any failed check raises, so the script exits non-zero and prints no
result.  Without a CUDA device, or without the package beside it, it
exits non-zero before printing anything to standard output.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

# H100 SXM peaks: HBM3 bandwidth (NVIDIA data sheet), and the INT32 rate
# of the SMs outside the tensor cores: 132 SMs x 64 INT32 lanes x 1.98 GHz
# boost clock.  The SWAR xtime/XOR walks and the packet XORs are INT32
# work, counted at the least they need on sm_90 (4 instructions per
# xtime at w=8 and w=16, 3 at w=32, XORs folded three at a time by LOP3:
# gf_kernels.sm90_op_floor, the cheaper of the doubling chain per input
# column and per output row; bitmatrix_op_count, schedule_op_count).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# the dense int8 tensor-core peak (the bit-plane kernel's operand type)
INT8_OPS_PER_S = 1979e12

K, M, BATCH, CHUNK = 8, 3, 64, 128 * 1024     # 64 x 1 MiB stripes
LRC_K, LRC_CHUNK = 4, 256 * 1024              # lrc / shec k=4: 1 MiB stripes
DECODE_BATCH = 4
PACKETSIZE = 2048                             # jerasure's default
CLAY = {"k": "8", "m": "4", "d": "11"}        # the reference's clay mix
ROOF_MIB, ROOF_LOOP = 64, 64                  # the roofline tool's defaults
WORDS = 65536                                 # w=16/32 words per chunk
SRC = "ceph_tpu_torch/ops/csrc/"

# the serving stream: 512 closed-loop requests, 64 in flight; RS k=8 m=3
# at 64 KiB (the bench serving row's size), 1 MiB (the north-star stripe)
# and 4 MiB (RADOS's default object size), shec k=6 m=3 c=2 at 1 MiB,
# weighted 3 : 2 between RS and shec as the reference's default_spec
# does; pages of 4096 bytes (Ceph's default EC stripe_unit, which divides
# every RS chunk of the mix), 512 per pool; and default_spec's clay share,
# clay k=8 m=4 d=11 at 1 MiB, weight 1
SERVE_REQUESTS, SERVE_CONCURRENCY = 512, 64
PAGE, SERVE_POOL_PAGES = 4096, 512
RAG_PAGES = 512                               # the ragged kernel's pool
# the dense encode's profiler time under the chain per input column, the
# form the row form replaced, and the card it was read on
EARLIER_DENSE_MS, EARLIER_CARD = 0.060692, "H100 80GB HBM3, 700 W"
# the bit-plane tensor-core kernel's profiler times on the three clay
# shapes before the column walk replaced it (the same card), printed
# beside this run's times
EARLIER_MXU_MS = {"clay encode": 9.498964, "clay decode (0,)": 0.235018,
                  "clay repair (8,)": 0.239114}


def serving_spec(paged: bool):
    """The serving stream's TrafficSpec (seed 0), dense or paged."""
    from ceph_tpu_torch.serve import CodecSpec, TrafficSpec
    rs = {"technique": "reed_sol_van", "k": "8", "m": "3"}
    codecs = [CodecSpec(f"rs_k8_m3_{size >> 10}k", "jerasure", dict(rs),
                        size, weight=1.0)
              for size in (64 << 10, 1 << 20, 4 << 20)]
    codecs.append(CodecSpec("shec_k6_m3_c2_1024k", "shec",
                            {"k": "6", "m": "3", "c": "2"}, 1 << 20,
                            weight=2.0))
    codecs.append(CodecSpec("clay_k8_m4_d11_1024k", "clay", dict(CLAY),
                            1 << 20, weight=1.0))
    return TrafficSpec(seed=0, n_requests=SERVE_REQUESTS, codecs=codecs,
                       concurrency=SERVE_CONCURRENCY, erasures=1,
                       ladder=(1, 4, 16, 64), paged=paged,
                       page_size=PAGE if paged else None,
                       pool_pages=SERVE_POOL_PAGES if paged else None)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, iters: int, warmup: int = 2) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn`` over ``iters``
    back-to-back calls after ``warmup`` calls: the device time between
    two CUDA events, and the host time to issue the calls.  Where the
    host time is the larger, the device waited on the host and the
    device time measures the dispatch, not the kernel."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host


def walk_kernels(splits: int) -> tuple[str, ...]:
    """The kernels one column-walk call launches: the walk, and the
    zeroing kernel before it where the columns are split."""
    return ("gf8_column_walk_kernel",) + (
        ("gf8_column_walk_zero",) if splits > 1 else ())


def bound_ms(moved_bytes: int, ops: int, peak: float = INT32_OPS_PER_S
             ) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    HBM bandwidth and the ops over their type's peak (INT32 unless
    ``peak`` says otherwise)."""
    t_mem = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_mem, t_ops), ("operations" if t_ops >= t_mem else "bytes")


def max_abs_err(a, b) -> int:
    """The largest difference between two tensors' bytes."""
    import torch
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    a8 = a.contiguous().view(torch.uint8).to(torch.int16)
    b8 = b.contiguous().view(torch.uint8).to(torch.int16)
    return int((a8 - b8).abs().max().item()) if a8.numel() else 0


class Errors(dict):
    """Largest error seen per kernel, over every comparison."""

    def hold(self, name: str, got, want, what: str) -> None:
        import torch
        torch.cuda.synchronize()
        self[name] = max(self.get(name, 0), max_abs_err(got, want))
        check(torch.equal(got, want), f"{name}: {what}")


def drive(name: str, counts, reset, fn, need) -> dict:
    """Run one path with the launch counters at 0 just before it, read
    them just after, and require a launch of every kernel in ``need``."""
    import torch
    reset()
    fn()
    torch.cuda.synchronize()
    got = counts()
    for kernel in need:
        check(got[kernel] >= 1, f"{kernel} launched on the {name} path")
    print(f"phase 3: {name} path ok; launches {got}")
    return got


def _host_truth(bench_argv: list, slabs, packed: bool, pattern=None):
    """The XOR over the slabs of each slab's output from the numpy tier
    (``--device host``): the ground truth of an odd-step carry."""
    import numpy as np
    from ceph_tpu_torch.bench.erasure_code_benchmark import ErasureCodeBench
    from ceph_tpu_torch.ops.gf_kernels import unpack_chunks
    host = ErasureCodeBench()
    host.setup(list(bench_argv) + ["--device", "host", "--layout", "bytes"])
    ec = host._instance()
    truth = None
    for slab in slabs:
        x = np.ascontiguousarray(
            (unpack_chunks(slab) if packed else slab).cpu().numpy())
        out = (ec.decode_chunks_batch(x, *pattern) if pattern
               else ec.encode_chunks_batch(x))
        truth = out if truth is None else truth ^ out
    return truth


def _chain(argv: list, kind: str):
    """(bench, code, input bytes per step, (available, erased) or None,
    chained, slabs) of one --loop configuration."""
    from ceph_tpu_torch.bench.erasure_code_benchmark import ErasureCodeBench
    bench = ErasureCodeBench()
    bench.setup(argv)
    if kind == "encode":
        ec = bench._instance()
        data = bench._make_batch(ec)
        return (bench, ec, data.nbytes, None) + bench._encode_chain(ec, data)
    ec, data, allchunks, pats = bench._decode_setup()
    n = ec.get_chunk_count()
    pattern = (tuple(i for i in range(n) if i not in pats[0]), pats[0])
    return (bench, ec, data.nbytes, pattern) + bench._decode_chain(
        ec, allchunks, *pattern)


def bench_phase(kernel_ms) -> dict:
    """Phase 5: the bench line's rows (``ceph_tpu_torch.bench.bench_line``)
    through ``ErasureCodeBench`` in this process, ``--json --device
    cuda``, each with the launch counters at 0 just before it and read
    just after (every row must launch a kernel and report the card);
    each --loop row's configuration once more at an odd number of steps
    (15 encodes over 15 slabs, 7 decodes over 7: at an even count the
    carry cancels whatever the step computes), its carry held byte for
    byte to the numpy tier's outputs XORed over the same slabs (a slice
    chain's one-element carry, and the carry chain of the same
    configuration); the profiler's device time per step of the row's
    chain (every kernel of a step, the carry's XOR included) beside the
    row's GB/s; the per-call row's parity and device time per call; the
    serving rows verified with no kernel setup after warmup; and the
    corpus check on the card with 0 errors.  Returns the ``{"bench":
    ...}`` blob."""
    import numpy as np
    import torch
    from ceph_tpu_torch.bench import bench_line, non_regression
    from ceph_tpu_torch.bench.erasure_code_benchmark import ErasureCodeBench
    from ceph_tpu_torch.ops.gf_kernels import unpack_chunks
    from ceph_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from ceph_tpu_torch.serve import verify_results

    rows = {}
    truths = {}
    for kind, table in (("encode", bench_line.ENCODE_ROWS),
                        ("decode", bench_line.DECODE_ROWS),
                        ("serving", bench_line.SERVING_ROWS)):
        for name, argv in table:
            bench = ErasureCodeBench()
            bench.setup(list(argv) + ["--json"])
            reset_launch_counts()
            res = bench.run()
            torch.cuda.synchronize()
            got = {k: v for k, v in launch_counts().items() if v}
            check(sum(got.values()) >= 1,
                  f"bench row {name} launched a kernel")
            check(res["platform"] == "gpu" and res["device"] == "cuda",
                  f"bench row {name} ran on the card")
            row = {"gbps": res["gbps"], "seconds": res["seconds"],
                   "total_bytes": res["total_bytes"], "launches": got,
                   "lat_p50_ms": res.get("lat_p50_ms"),
                   "lat_p99_ms": res.get("lat_p99_ms")}
            rows[name] = row
            print(f"phase 5: {name}: {res['gbps']:.6f} GB/s in "
                  f"{res['seconds']:.6f} s, launches {got}")
            if kind == "serving":
                check(res["stream_compiles"] == 0,
                      f"{name}: no kernel setup after warmup "
                      f"({res['stream_compiles']})")
                check(verify_results(bench.last_run.results) == [],
                      f"{name}: every request verifies")
                if res["paged"]:
                    check(res["page_pool"]["used_pages"] == 0,
                          f"{name}: the pools drained")
                for f in ("gbps_under_slo", "deadline_miss_rate",
                          "padding_overhead", "requests", "dispatches",
                          "stream_compiles"):
                    row[f] = res[f]
                continue
            if kind == "decode":
                row["engine"] = res["engine"]
            if not res["loop"]:
                # the resident per-call row: one call's parity against
                # the numpy tier, and its device time per call
                ec = bench._instance()
                data = bench._make_batch(ec)
                on_card = torch.from_numpy(data).cuda()
                out = ec.encode_chunks_torch(on_card).cpu().numpy()
                check(np.array_equal(out, _host_truth(
                    list(argv), [torch.from_numpy(data)], False)),
                    f"{name}: parity equals the numpy tier's")
                step_ms = kernel_ms(lambda: ec.encode_chunks_torch(on_card),
                                    "", iters=20)
                in_bytes = data.nbytes
            else:
                steps = 15 if kind == "encode" else 7
                odd, ec, in_bytes, pattern, chained, slabs = _chain(
                    list(argv) + ["--loop", str(steps)], kind)
                packed = odd.args.layout == "packed"
                check(slabs.shape[0] == steps, f"{name}: {steps} slabs")
                key = (kind, odd.args.layout, name if kind == "decode"
                       else "")
                if key not in truths:
                    truths[key] = _host_truth(list(argv), slabs, packed,
                                              pattern)
                truth = truths[key]
                check(truth.any(), f"{name}: the odd-step truth is zero")
                if odd.args.chain == "slice":
                    carry = chained(slabs)
                    got1 = carry.reshape(1).view(torch.uint8).cpu().numpy()
                    check(np.array_equal(got1, truth.reshape(-1)[
                        :got1.size]), f"{name}: the slice carry at {steps} "
                                      f"steps equals the numpy tier's")
                _, _, _, _, full, slabs = _chain(
                    list(argv) + ["--loop", str(steps), "--chain", "carry"],
                    kind)
                carry = full(slabs)
                check(np.array_equal(
                    (unpack_chunks(carry) if packed else carry).cpu().numpy(),
                    truth), f"{name}: the carry at {steps} steps equals "
                            f"the numpy tier's, byte for byte")
                dev_ms = kernel_ms(lambda: chained(slabs), "", iters=3)
                step_ms = None if dev_ms is None else dev_ms / steps
                row["odd_steps_checked"] = steps
            row["device_ms_per_step"] = step_ms
            row["device_implied_gbps"] = (None if not step_ms
                                          else in_bytes / step_ms / 1e6)
            print(f"phase 5: {name}: bytes equal the numpy tier's; device "
                  f"time per step " + (
                      "not measured" if step_ms is None else
                      f"{step_ms:.6f} ms (every kernel of a step), "
                      f"{row['device_implied_gbps']:.6f} GB/s if the card "
                      f"never waited; the row's {res['gbps']:.6f} GB/s is "
                      f"{res['gbps'] / row['device_implied_gbps']:.4f} "
                      f"of it"))

    reset_launch_counts()
    corpus = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "corpus")
    dirs = non_regression.corpus_dirs(corpus)
    errors = []
    for d in dirs:
        errors.extend(non_regression.check(d, device="cuda"))
    torch.cuda.synchronize()
    corpus_launches = sum(launch_counts().values())
    for e in errors:
        print(f"phase 5: corpus: {e}")
    check(not errors, f"corpus check: {len(errors)} errors")
    check(corpus_launches >= 1, "the corpus check launched a kernel")
    print(f"phase 5: corpus check on the card: {len(dirs)} entries, 0 "
          f"errors, {corpus_launches} kernel launches")
    return {"rows": rows, "corpus": {"entries": len(dirs), "errors": 0,
                                     "launches": corpus_launches}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random data (default 0)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA device", file=sys.stderr)
        return 2
    # the port lives beside this script; a bare copy fails here
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops import _build, gf_kernels, regionops
    from ceph_tpu_torch.ops.launches import (
        device_and_stream, launch_counts, reset_launch_counts)
    from ceph_tpu_torch.ops.gf_kernels import (
        MXU_MATRIX_MIN, apply_bitmatrix_cuda, apply_bitmatrix_xor_cuda,
        apply_matrix_cuda, apply_matrix_cuda_packed,
        apply_matrix_cuda_packed_ragged, apply_matrix_cuda_ragged,
        apply_matrix_cuda_words, apply_matrix_mxu_cuda,
        apply_matrix_mxu_cuda_packed, apply_matrix_packed_best_ragged,
        apply_matrix_xor_cuda, apply_matrix_xor_cuda_packed,
        bitmatrix_op_count, dense_op_count, pack_chunks, schedule_op_count,
        dense_plan, dense_program, program_op_count, select_matrix_engine,
        sm90_op_count, sm90_op_floor, sm90_row_op_count, unpack_chunks,
        walk_data,
        walk_splits, xor_schedule_op_count)
    from ceph_tpu_torch.ops.probe_kernels import (
        copy_slab_cuda, copy_slab_torch, fold_slab_cuda, fold_slab_torch)
    from ceph_tpu_torch.ops.torch_ops import (
        WORD_DTYPE, apply_bitmatrix_torch, apply_bitmatrix_xor_torch,
        apply_matrix_mxu_torch, apply_matrix_packed_ragged_torch,
        apply_matrix_ragged_torch, apply_matrix_torch,
        apply_matrix_walk_torch, apply_matrix_xor_torch,
        bitmatrix_to_static, mask_pages, matrix_to_static, mxu_bitmatrix)
    from ceph_tpu_torch.telemetry import metrics as tel
    from ceph_tpu_torch.tools import dense_times, packet_times, roofline
    from ceph_tpu_torch.tools.dense_times import kernel_ms
    from ceph_tpu_torch.codes.engine import (serve_dispatch_call,
                                             serve_dispatch_ragged)
    from ceph_tpu_torch.serve import (EcRequest, run_serving_scenario,
                                      verify_results)
    from ceph_tpu_torch.ops.xor_schedule import (
        build_schedule, preferred_schedule, probe_bitmatrix_schedule,
        word_program)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    err = Errors()

    # -- phase 1: the card and the build ---------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    props = torch.cuda.get_device_properties(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"sms {props.multi_processor_count}")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"kernel build {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{n} -> {p.name}" for n, p in sorted(built.items())))
    for name, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- phase 2: each kernel against its plain version, on the card --------
    reg = ErasureCodePluginRegistry.instance()
    ec = reg.factory("jerasure", {"technique": "reed_sol_van",
                                  "k": str(K), "m": str(M)})
    check(ec.device.type == "cuda", f"code runs on {ec.device}")
    mat = ec.matrix
    ms = matrix_to_static(mat)
    host = rng.integers(0, 256, (BATCH, K, CHUNK), dtype=np.uint8)
    data = torch.from_numpy(host).to(dev)

    got = apply_matrix_cuda(data, ms)
    plain = apply_matrix_torch(data, ms, 8)
    err.hold("apply_matrix_cuda", got, plain, "bytes kernel, main shape")
    gotp = unpack_chunks(apply_matrix_cuda_packed(pack_chunks(data), ms))
    err.hold("apply_matrix_cuda_packed", gotp, plain,
             "packed kernel, main shape")
    ref2 = regionops.matrix_encode(host[:2], mat, 8)
    check(np.array_equal(got[:2].cpu().numpy(), ref2),
          "bytes kernel == numpy ground truth, 2 stripes")
    print(f"phase 2: main shape {tuple(data.shape)} equal in both layouts "
          f"and to the host ground truth")

    cases = []
    for r in (1, 3, 8, 11):
        for s, c, lead in ((8, 65536, (4,)), (5, 4096 + 4, (3,)),
                           (6, 8192, ())):
            cases.append((r, s, c, lead))
    for r, s, c, lead in cases:
        m_r = rng.integers(0, 256, (r, s))
        m_r[rng.random((r, s)) < 0.25] = 0
        m_r[0, 0] = 0
        x = torch.from_numpy(rng.integers(0, 256, lead + (s, c),
                                          dtype=np.uint8)).to(dev)
        mr = matrix_to_static(m_r)
        want = apply_matrix_torch(x, mr, 8)
        err.hold("apply_matrix_cuda", apply_matrix_cuda(x, mr), want,
                 f"bytes kernel r={r} s={s} C={c}")
        if c % 512 == 0:
            gotp = unpack_chunks(apply_matrix_cuda_packed(pack_chunks(x),
                                                          mr))
            err.hold("apply_matrix_cuda_packed", gotp, want,
                     f"packed kernel r={r} s={s}")
        if lead:
            # a survivor slice: strided chunk axis, no copy
            wide = torch.cat([x, x[..., :1, :]], dim=-2)
            err.hold("apply_matrix_cuda", apply_matrix_cuda(
                wide[..., :s, :], mr), want, f"strided slice r={r} s={s}")
    print(f"phase 2: {len(cases)} random GF(2^8) cases equal (r in 1,3,8,"
          f"11; tail C=4100; no batch dim; strided slices)")

    # the dense kernel on either side of its one-wave rule: the RS decode
    # e=2 (3, 9) matrix at 1, 4 and 64 stripes (below a wave of the card
    # each block takes one stripe; above, a block walks several), both
    # layouts
    e2_avail = [i for i in range(K + M) if i not in (3, 9)]
    dm_e2 = matrix_to_static(regionops.matrix_decode_matrix(
        mat, K, e2_avail[:K], [3, 9]))
    plans = {}
    for nb_ in (1, DECODE_BATCH, BATCH):
        x = data[:nb_]
        plans[nb_] = dense_plan(nb_, CHUNK, dm_e2, dev)
        want = apply_matrix_torch(x, dm_e2, 8)
        err.hold("apply_matrix_cuda", apply_matrix_cuda(x, dm_e2), want,
                 f"decode e=2 at {nb_} stripes")
        err.hold("apply_matrix_cuda_packed", unpack_chunks(
            apply_matrix_cuda_packed(pack_chunks(x), dm_e2)), want,
            f"packed decode e=2 at {nb_} stripes")
    check(plans[1][1] == 1 and plans[DECODE_BATCH][1] == DECODE_BATCH
          and plans[BATCH][1] < BATCH,
          f"grids on both sides of the one-wave rule: {plans}")
    print(f"phase 2: dense kernel equal on the decode e=2 matrix at 1, "
          f"{DECODE_BATCH} and {BATCH} stripes in both layouts; grids "
          f"(unit tiles, stripe blocks, row blocks) {plans}")

    # the w=16/32 word kernel: the reed_sol_van matrices at the main shape
    wide_codes = {w: reg.factory("jerasure", {
        "technique": "reed_sol_van", "k": str(K), "m": str(M),
        "w": str(w)}) for w in (16, 32)}
    word_data = {}
    for w, wc in wide_codes.items():
        nbytes = WORDS * w // 8
        wh = rng.integers(0, 256, (BATCH, K, nbytes), dtype=np.uint8)
        x = torch.from_numpy(wh).to(dev).view(WORD_DTYPE[w])
        word_data[w] = (wh, x)
        wms = matrix_to_static(wc.matrix)
        got = apply_matrix_cuda_words(x, wms, w)
        err.hold("apply_matrix_cuda_words", got,
                 apply_matrix_torch(x, wms, w), f"w={w} main shape")
        check(np.array_equal(
            got[:2].cpu().numpy(),
            regionops.matrix_encode(regionops.words_view(wh[:2], w),
                                    wc.matrix, w)),
            f"word kernel w={w} == numpy ground truth, 2 stripes")
        for r, s, nb, lead in ((1, 3, 4096 + 4, (2,)), (9, 5, 1028, ()),
                               (3, 8, 8192, (3,))):
            m_r = rng.integers(0, 1 << w, (r, s), dtype=np.uint64)
            m_r[0, 0] = 0
            mr = matrix_to_static(m_r)
            xs = torch.from_numpy(rng.integers(
                0, 256, lead + (s + 1, nb), dtype=np.uint8)).to(dev).view(
                    WORD_DTYPE[w])[..., :s, :]
            err.hold("apply_matrix_cuda_words",
                     apply_matrix_cuda_words(xs, mr, w),
                     apply_matrix_torch(xs.contiguous(), mr, w),
                     f"word kernel w={w} r={r} s={s} bytes={nb}")
    print(f"phase 2: word kernel equal for w=16/32 at (64, 8, {WORDS}) "
          f"words, 3 random cases each (tail, no batch dim, strided "
          f"slices), and to the host ground truth")

    # the bitmatrix kernels: cauchy_good k=8 m=3 at the main shape
    cg = reg.factory("jerasure", {"technique": "cauchy_good", "k": str(K),
                                  "m": str(M)})
    check(cg.packetsize == PACKETSIZE and cg.w == 8, "cauchy_good default")
    rows = cg._bitmatrix_static
    enc_sched = cg._encode_sched
    check(enc_sched is not None, "cauchy_good encode has a schedule")
    got = apply_bitmatrix_cuda(data, rows, 8, PACKETSIZE)
    plain_bm = apply_bitmatrix_torch(data, rows, 8, PACKETSIZE)
    err.hold("apply_bitmatrix_cuda", got, plain_bm,
             "plain packet kernel, cauchy_good encode, main shape")
    gots = apply_bitmatrix_xor_cuda(data, enc_sched.static, 8, PACKETSIZE)
    err.hold("apply_bitmatrix_xor_cuda", gots,
             apply_bitmatrix_xor_torch(data, enc_sched.static, 8,
                                       PACKETSIZE),
             "schedule kernel, cauchy_good encode, main shape")
    check(torch.equal(gots, got), "schedule == plain product")
    check(np.array_equal(got[:2].cpu().numpy(), regionops.bitmatrix_encode(
        host[:2], cg.bitmatrix, 8, PACKETSIZE)),
        "bitmatrix kernel == numpy ground truth, 2 stripes")
    cg_full = torch.cat([data, gots], dim=1)
    e2 = (3, 9)
    e2_avail = tuple(i for i in range(K + M) if i not in e2)
    e2_surv = cg_full.index_select(1, torch.tensor(e2_avail, device=dev))
    e2_dm, e2_rows, _, e2_sched = cg._decode_bitmatrix(e2_avail, e2)
    check(e2_sched is not None, "cauchy_good decode e=2 has a schedule")
    got = apply_bitmatrix_xor_cuda(e2_surv[:, :K], e2_sched.static, 8,
                                   PACKETSIZE)
    err.hold("apply_bitmatrix_xor_cuda", got, apply_bitmatrix_xor_torch(
        e2_surv[:, :K], e2_sched.static, 8, PACKETSIZE),
        "schedule kernel, decode e=2, main shape")
    check(torch.equal(got, cg_full[:, list(e2)]), "decode e=2 recovers")

    n_bm = 0
    for w in (6, 7, 8):
        for ps in (8, 32, PACKETSIZE):
            for lead in ((3,), ()):
                s, r = 5, 2
                bm = (rng.random((r * w, s * w)) < 0.4).astype(np.uint8)
                bm[0] = 0
                brows = bitmatrix_to_static(bm)
                xh = rng.integers(0, 256, lead + (s + 2, 2 * w * ps),
                                  dtype=np.uint8)
                xs = torch.from_numpy(xh).to(dev)[..., :s, :]
                want = apply_bitmatrix_torch(xs, brows, w, ps)
                err.hold("apply_bitmatrix_cuda",
                         apply_bitmatrix_cuda(xs, brows, w, ps), want,
                         f"plain packet kernel w={w} ps={ps} lead={lead}")
                sched = probe_bitmatrix_schedule(brows, w)
                check(sched is not None, f"random w={w} has a schedule")
                err.hold("apply_bitmatrix_xor_cuda",
                         apply_bitmatrix_xor_cuda(xs, sched.static, w, ps),
                         apply_bitmatrix_xor_torch(xs, sched.static, w, ps),
                         f"schedule kernel w={w} ps={ps} lead={lead}")
                check(np.array_equal(want.cpu().numpy(),
                                     regionops.bitmatrix_encode(
                                         xh[..., :s, :], bm, w, ps)),
                      f"plain w={w} ps={ps} == numpy ground truth")
                n_bm += 1
    print(f"phase 2: both bitmatrix kernels equal at the cauchy_good "
          f"main shape (encode, decode e=2) and on {n_bm} random cases "
          f"(w in 6,7,8; packetsize 8, 32, 2048; with and without a batch "
          f"dim; strided slices)")

    # the packet kernel's launches (gf_kernels.packet_launch_plan), all
    # through the wrappers, each against the plain version: the decodes at
    # 4 stripes (row groups on grid y) and 64 (one group), 8-byte units;
    # every other unit width at the packet size that selects it
    packet_seen = {"unit": set(), "groups": set()}

    def hold_packet(x, r, kind, key, what, w=8, ps=PACKETSIZE):
        wrapper, plain_fn = (
            (apply_bitmatrix_cuda, apply_bitmatrix_torch) if kind == "plain"
            else (apply_bitmatrix_xor_cuda, apply_bitmatrix_xor_torch))
        got = wrapper(x, key, w, ps)
        plan = gf_kernels.packet_launch_plan(x, r, w, ps, kind, key,
                                             x.shape[-2] * w)
        err.hold(wrapper.__name__, got, plain_fn(x, key, w, ps),
                 f"packet kernel, {what}, {plan}")
        packet_seen["unit"].add(plan.unit)
        packet_seen["groups"].add(plan.groups)
        return plan

    def cauchy_decode(erased):
        avail = tuple(i for i in range(K + M) if i not in erased)
        _, drows, _, dsched = cg._decode_bitmatrix(avail, erased)
        surv = cg_full.index_select(1, torch.tensor(avail, device=dev))
        if dsched is None:
            return surv[:, :K], "plain", tuple(drows)
        return surv[:, :K], "schedule", dsched.static

    packet_lines = []
    for erased in ((3,), (3, 9), (5, 6, 7)):
        x, kind, key = cauchy_decode(erased)
        for batch in (DECODE_BATCH, BATCH):
            plan = hold_packet(x[:batch], len(erased), kind, key,
                               f"decode {erased} at {batch} stripes")
            check((plan.groups == 1) == (batch == BATCH),
                  f"decode {erased} at {batch} stripes: {plan}")
            packet_lines.append(f"decode {erased} at {batch}: {plan}")
    # (w, packetsize, the unit the plan must take): 16 bytes at packets of
    # 32 (the minimal-density codes' size), 4 at 12, single bytes at 3
    for w, ps, unit in ((7, 32, 16), (8, 12, 4), (5, 3, 1)):
        s, r = 7, 2
        bm = (rng.random((r * w, s * w)) < 0.4).astype(np.uint8)
        brows = bitmatrix_to_static(bm)
        x = torch.from_numpy(rng.integers(0, 256, (BATCH, s, 512 * w * ps),
                                          dtype=np.uint8)).to(dev)
        plan = hold_packet(x, r, "plain", brows,
                           f"random w={w} packetsize {ps}", w, ps)
        check(plan.unit == unit, f"w={w} packetsize {ps}: {plan}")
        packet_lines.append(f"w={w} packetsize {ps}: {plan}")
        sched = probe_bitmatrix_schedule(brows, w)
        if sched is not None:
            hold_packet(x, r, "schedule", sched.static,
                        f"random w={w} packetsize {ps}, scheduled", w, ps)
    check(packet_seen["unit"] >= {16, 8, 4, 1}
          and max(packet_seen["groups"]) > 1,
          f"the packet kernel's launches cover {packet_seen}")
    print(f"phase 2: the packet kernel equal to the plain versions through "
          f"its wrappers (" + "; ".join(packet_lines) + f"): unit widths "
          f"{sorted(packet_seen['unit'])}, row groups "
          f"{sorted(packet_seen['groups'])}")

    # the XOR-schedule kernel: the r6 encode (ring schedule) at the main
    # shape, an lrc local repair at 64 x 1 MiB stripes, the shec plans
    def xor_static(ms):
        sched = preferred_schedule(ms, 8, mxu_min=MXU_MATRIX_MIN)
        check(sched is not None, f"{ms} has a preferred schedule")
        return sched.static

    def hold_xor(x, st, what, ground=None):
        """Both XOR wrappers against the plain schedule on x; when
        ``ground`` (the matrix) is given, two stripes against the numpy
        ground truth."""
        want = apply_matrix_xor_torch(x, st)
        got = apply_matrix_xor_cuda(x, st)
        err.hold("apply_matrix_xor_cuda", got, want, what)
        if x.shape[-1] % 512 == 0:
            xw = pack_chunks(x)
            err.hold("apply_matrix_xor_cuda_packed", unpack_chunks(
                apply_matrix_xor_cuda_packed(xw, st)), want, what)
        if ground is not None:
            def two(t):
                return t.reshape((-1,) + tuple(t.shape[-2:]))[:2].cpu().numpy()
            check(np.array_equal(two(got), regionops.matrix_encode(
                two(x), np.asarray(ground), 8)),
                f"{what}: XOR kernel == numpy ground truth, 2 stripes")
        return got

    r6 = reg.factory("jerasure", {"technique": "reed_sol_r6_op",
                                  "k": str(K)})
    r6_ms = matrix_to_static(r6.matrix)
    r6_st = xor_static(r6_ms)
    check(preferred_schedule(r6_ms, 8).transform == "ring",
          "the r6 encode takes the ring schedule")
    r6_parity = hold_xor(data, r6_st, "r6 encode, main shape", r6.matrix)
    lrc = reg.factory("lrc", {"k": "4", "m": "2", "l": "3"})
    lrc_avail = tuple(range(1, 8))
    lrc_dm, lrc_ms = lrc._decode_composite(lrc_avail, (0,))
    lrc_st = xor_static(lrc_ms)
    lrc_surv = torch.from_numpy(rng.integers(
        0, 256, (BATCH, 7, LRC_CHUNK), dtype=np.uint8)).to(dev)
    hold_xor(lrc_surv, lrc_st, "lrc local repair (0,), 64 x 1 MiB", lrc_dm)
    shec = reg.factory("shec", {"k": "4", "m": "3", "c": "2"})
    n_shec = shec.k + shec.m
    shec_xor = []
    for e in range(n_shec):
        avail = tuple(i for i in range(n_shec) if i != e)
        plan = shec._plan(avail, (e,))
        dm, dm_static = shec._plan_static(plan)
        sched = preferred_schedule(dm_static, 8, mxu_min=MXU_MATRIX_MIN)
        if sched is None:
            continue
        shec_xor.append(e)
        x = torch.from_numpy(rng.integers(0, 256, (8, len(plan.reads),
                                                   8192), dtype=np.uint8)
                             ).to(dev)
        hold_xor(x, sched.static, f"shec plan for erasure {e}", dm)
    check(shec_xor == [0, 1, 2, 4], f"shec XOR plans {shec_xor}")
    n_rand = 0
    for i, (lead, c) in enumerate(itertools.product(((3,), ()),
                                                    (4096 + 4, 8192))):
        for kind in ("sparse", "monomial"):
            r, s = 3, 6
            if kind == "sparse":
                m_r = rng.integers(0, 256, (r, s)) * (rng.random((r, s)) < 0.4)
            else:
                m_r = (1 << rng.integers(0, 8, (r, s))) \
                    * (rng.random((r, s)) < 0.7)
            m_r[0, 0] = 1
            st = build_schedule(matrix_to_static(m_r)).static
            xh = rng.integers(0, 256, lead + (s + 1, c), dtype=np.uint8)
            x = torch.from_numpy(xh).to(dev)[..., :s, :]   # strided slice
            hold_xor(x, st, f"random {kind} lead={lead} C={c}", m_r)
            n_rand += 1
    print(f"phase 2: XOR-schedule kernel equal in both layouts on the r6 "
          f"encode (64, 8, {CHUNK}), an lrc repair (64, 7, {LRC_CHUNK}), "
          f"the shec plans of erasures {shec_xor} and {n_rand} random "
          f"sparse/monomial schedules (strided slices, C=4100, no batch "
          f"dim), and to the host ground truth")

    # the ragged kernel (bytes and packed wrappers): the serving pool
    # shape, (512 pages, 8 rows, 4096 bytes), under a scattered half-live
    # mask, all-dead and all-live, for the RS encode matrix and random
    # r in {1, 3, 11}; against the plain version and against the dense
    # kernel on mask_pages(pool); dead pages zero
    rag_host = rng.integers(0, 256, (RAG_PAGES, K, PAGE), dtype=np.uint8)
    rag_pool = torch.from_numpy(rag_host).to(dev)
    rag_words = pack_chunks(rag_pool)
    rag_masks = {
        "half-live": torch.from_numpy(
            (rng.random(RAG_PAGES) < 0.5).astype(np.uint8)).to(dev),
        "all-dead": torch.zeros(RAG_PAGES, dtype=torch.uint8, device=dev),
        "all-live": torch.ones(RAG_PAGES, dtype=torch.uint8, device=dev)}
    rag_mats = {"rs encode": ms}
    for r in (1, 3, 11):
        m_r = rng.integers(0, 256, (r, K))
        m_r[rng.random((r, K)) < 0.25] = 0
        rag_mats[f"random r={r}"] = matrix_to_static(m_r)
    for (mname, m_s), (kind, mk) in itertools.product(rag_mats.items(),
                                                      rag_masks.items()):
        what = f"{mname}, {kind} mask, {tuple(rag_pool.shape)}"
        got = apply_matrix_cuda_ragged(rag_pool, m_s, mk)
        err.hold("apply_matrix_cuda_ragged", got,
                 apply_matrix_ragged_torch(rag_pool, m_s, mk), what)
        err.hold("apply_matrix_cuda_ragged", got,
                 apply_matrix_cuda(mask_pages(rag_pool, mk), m_s),
                 f"{what} vs the dense kernel on the masked pool")
        check(not got[mk == 0].any(), f"{what}: dead pages are zero")
        gotp = apply_matrix_cuda_packed_ragged(rag_words, m_s, mk)
        err.hold("apply_matrix_cuda_packed_ragged", gotp,
                 apply_matrix_packed_ragged_torch(rag_words, m_s, mk), what)
        err.hold("apply_matrix_cuda_packed_ragged", unpack_chunks(gotp), got,
                 f"{what}, packed == bytes")
    print(f"phase 2: both ragged wrappers equal their plain versions and "
          f"the dense kernel on the masked pool at ({RAG_PAGES}, {K}, "
          f"{PAGE}), {len(rag_mats)} matrices x {len(rag_masks)} masks; "
          f"dead pages zero")

    # the "mxu" row's column-walk kernel (bytes and packed wrappers),
    # held to its plain version over the same kernel data
    # (apply_matrix_walk_torch) and to the reference's MXU twin
    # (apply_matrix_mxu_torch): the clay k=8 m=4 d=11 encode composite at
    # its main shape, a (64, 704) decode composite at 4 stripes, with and
    # without the column split, random matrices with zeros, r over one row
    # tile, C off the word and the tile, no batch dim, strided slices
    clay = reg.factory("clay", dict(CLAY))
    check(clay.device.type == "cuda", f"clay runs on {clay.device}")
    sub = clay.get_sub_chunk_count()
    clay_chunk = clay.get_chunk_size(1 << 20)
    check((sub, clay_chunk) == (64, CHUNK), f"clay geometry {sub} "
          f"sub-chunks of a {clay_chunk} byte chunk")
    sc = clay_chunk // sub
    n_clay = clay.k + clay.m
    t0 = time.perf_counter()
    clay_enc, clay_enc_ms = clay._encode_composite()
    clay_probe_s = {"encode": time.perf_counter() - t0}
    e1_clay = (0,)
    a1_clay = tuple(i for i in range(n_clay) if i not in e1_clay)
    t0 = time.perf_counter()
    clay_dec, clay_dec_ms = clay._decode_composite(a1_clay, e1_clay)
    clay_probe_s["decode (0,)"] = time.perf_counter() - t0
    check(clay_enc.shape == (256, 512) and clay_dec.shape == (64, 704),
          f"clay composites {clay_enc.shape} {clay_dec.shape}")
    clay_host = rng.integers(0, 256, (BATCH, clay.k, clay_chunk),
                             dtype=np.uint8)
    clay_data = torch.from_numpy(clay_host).to(dev)
    clay_x = clay_data.reshape(BATCH, clay.k * sub, sc)     # (64, 512, 2048)

    def hold_walk(x, mat_s, what, packed=True):
        """The column walk on x (both layouts when C is whole rows)
        against its plain version and the MXU twin; returns it and the
        column splits it took."""
        z = walk_splits(int(np.prod(x.shape[:-2])), x.shape[-1], mat_s, dev)
        got = apply_matrix_mxu_cuda(x, mat_s)
        want = apply_matrix_walk_torch(x, walk_data(mat_s), len(mat_s))
        err.hold("apply_matrix_mxu_cuda", got, want, f"{what}, plain walk")
        err.hold("apply_matrix_mxu_cuda", got, apply_matrix_mxu_torch(
            x, mat_s), f"{what}, MXU twin")
        if packed and x.shape[-1] % 512 == 0:
            err.hold("apply_matrix_mxu_cuda_packed", unpack_chunks(
                apply_matrix_mxu_cuda_packed(pack_chunks(x), mat_s)), want,
                f"{what}, packed")
        return got, z

    got, z = hold_walk(clay_x, clay_enc_ms,
                       f"clay encode composite, {tuple(clay_x.shape)}")
    taken = {"clay encode": z}
    check(np.array_equal(got[:2].cpu().numpy(), regionops.matrix_encode(
        clay_host[:2].reshape(2, clay.k * sub, sc), clay_enc, 8)),
        "column walk == numpy ground truth, 2 stripes")
    clay_parity = got.reshape(BATCH, clay.m, clay_chunk)
    clay_full = torch.cat([clay_data[:DECODE_BATCH],
                           clay_parity[:DECODE_BATCH]], dim=1)
    dec_x = clay_full[:, list(a1_clay)].reshape(DECODE_BATCH,
                                                len(a1_clay) * sub, sc)
    got, z = hold_walk(dec_x, clay_dec_ms,
                       f"clay decode (0,), {tuple(dec_x.shape)}")
    taken["clay decode (0,)"] = z
    check(z > 1, "the 4-stripe decode splits its columns")
    check(torch.equal(got.reshape(DECODE_BATCH, clay_chunk),
                      clay_full[:, 0]), "the (0,) composite recovers")
    # the same decode at BATCH stripes fills the card: no split
    dec_wide = torch.cat([clay_x, torch.flip(clay_x, (0,))[:, :192]], dim=1)
    _, z = hold_walk(dec_wide, clay_dec_ms,
                     f"clay decode (0,), {tuple(dec_wide.shape)}")
    taken[f"clay decode (0,) at {BATCH} stripes"] = z
    check(z == 1, f"the {BATCH}-stripe decode takes no column split")
    n_mxu, rand_splits = 0, []
    for r, s_, c, lead in (
            (16, 48, 8192, (3,)),
            (64, 176, 2048 + 4, (2,)),
            (64, 704, 2048, ()),
            (16, 176, 4096, ()),
            (64, 48, 1000, (5,)),
            (16, 704, 512, (2,)),
            (300, 40, 1003, (2,)),                    # 2 row tiles, C % 4
            (513, 24, 4096, (2,)),                    # 3 row tiles
            (600, 256, 4096, (2,))):                  # 3 row tiles, split
        m_r = rng.integers(0, 256, (r, s_))
        m_r[rng.random((r, s_)) < 0.7] = 0
        mr = matrix_to_static(m_r)
        xh = rng.integers(0, 256, lead + (s_ + 1, c), dtype=np.uint8)
        x = torch.from_numpy(xh).to(dev)[..., :s_, :]        # strided slice
        want, z = hold_walk(x, mr, f"column walk r={r} s={s_} C={c} "
                            f"lead={lead}")
        rand_splits.append(z)
        flat = xh[..., :s_, :].reshape((-1, s_, c))[:2]
        check(np.array_equal(want.reshape((-1, r, c))[:2].cpu().numpy(),
                             np.stack([regionops.matrix_encode(f, m_r, 8)
                                       for f in flat])),
              f"column walk r={r} s={s_} == numpy ground truth")
        n_mxu += 1
    check(min(rand_splits) == 1 < max(rand_splits),
          f"random matrices with and without the column split: "
          f"{rand_splits}")
    print(f"phase 2: column-walk kernel equal to its plain walk and the MXU "
          f"twin in both layouts on the clay encode composite and the "
          f"(64, 704) decode (0,), column splits taken {taken}, and "
          f"{n_mxu} random matrices (r in 16, 64, 300, 513, 600: up to 3 "
          f"row tiles; s in 24 to 704; C = 2052, 1000, 1003; no batch dim; "
          f"strided slices; column splits {rand_splits}), and to the host "
          f"ground truth")

    # the dense kernel's table variant: the four (64, 704) parity repairs
    # of clay (45056 coefficients, above the 2048 taken by value), dense
    # and ragged, bytes and packed
    big = []
    for e in range(clay.k, n_clay):
        avail = tuple(i for i in range(n_clay) if i != e)
        dm, dm_ms = clay._decode_composite(avail, (e,))
        check(len(dm_ms) * len(dm_ms[0]) > 2048, "a table above 2048")
        check(select_matrix_engine(8, dev, shape=(DECODE_BATCH, 704, sc),
                                   matrix_t=dm_ms) == "cuda",
              f"the repair of chunk {e} routes to the dense kernel")
        x = clay_full[:, list(avail)].reshape(DECODE_BATCH, 704, sc)
        want = apply_matrix_torch(x, dm_ms, 8)
        got = apply_matrix_cuda(x, dm_ms)
        err.hold("apply_matrix_cuda", got, want, f"table variant, repair {e}")
        check(torch.equal(got.reshape(DECODE_BATCH, clay_chunk),
                          clay_full[:, e]), f"repair {e} recovers")
        err.hold("apply_matrix_cuda_packed", unpack_chunks(
            apply_matrix_cuda_packed(pack_chunks(x), dm_ms)), want,
            f"table variant packed, repair {e}")
        mk = torch.tensor([1, 0, 1, 1], dtype=torch.uint8, device=dev)
        err.hold("apply_matrix_cuda_ragged", apply_matrix_cuda_ragged(
            x, dm_ms, mk), apply_matrix_ragged_torch(x, dm_ms, mk),
            f"table variant ragged, repair {e}")
        err.hold("apply_matrix_cuda_packed_ragged",
                 apply_matrix_cuda_packed_ragged(pack_chunks(x), dm_ms, mk),
                 apply_matrix_packed_ragged_torch(pack_chunks(x), dm_ms, mk),
                 f"table variant packed ragged, repair {e}")
        big.append((e, dm, dm_ms, avail))
    check(np.array_equal(got[:2].cpu().numpy(), regionops.matrix_encode(
        clay_full[:2, list(big[-1][3])].reshape(2, 704, sc).cpu().numpy(),
        big[-1][1], 8)), "table variant == numpy ground truth, 2 stripes")
    print(f"phase 2: the dense kernel's table variant equal on the 4 clay "
          f"(64, 704) parity repairs at ({DECODE_BATCH}, 704, {sc}), dense "
          f"and ragged, bytes and packed, and to the host ground truth")

    # the roofline probes' kernels on one 64 MiB slab
    slab_host = rng.integers(0, 1 << 32, (BATCH, K, CHUNK // 512, 128),
                             dtype=np.uint32)
    slab = torch.from_numpy(slab_host).to(dev)
    err.hold("copy_slab_cuda", copy_slab_cuda(slab), copy_slab_torch(slab),
             f"copy {tuple(slab.shape)}")
    fold_got = fold_slab_cuda(slab)
    err.hold("fold_slab_cuda", fold_got, fold_slab_torch(slab),
             f"fold {tuple(slab.shape)}")
    check(np.array_equal(fold_got[:2].cpu().numpy(), np.bitwise_xor.reduce(
        slab_host[:2], axis=1, keepdims=True)),
        "fold == numpy ground truth, 2 stripes")
    check(np.array_equal(copy_slab_cuda(slab)[:2].cpu().numpy(),
                         slab_host[:2]), "copy == the slab, 2 stripes")
    print(f"phase 2: copy and fold kernels equal their plain versions on "
          f"{tuple(slab.shape)} and the numpy ground truth")

    # -- phase 3: the paths, through the user's entry points ----------------
    counts, reset = launch_counts, reset_launch_counts
    n = K + M
    patterns = [e for t in range(1, M + 1)
                for e in itertools.combinations(range(n), t)]
    check(len(patterns) == 231, f"{len(patterns)} patterns")
    results = {}

    def rs_path():
        parity = ec.encode_chunks_torch(data)
        torch.cuda.synchronize()
        check(torch.equal(parity, plain), "encode_chunks_torch parity")
        n0 = counts()["apply_matrix_cuda"]
        check(n0 >= 1, "encode_chunks_torch launched the bytes kernel")
        parity_host = ec.encode_chunks_batch(host)
        check(np.array_equal(parity_host, parity.cpu().numpy()),
              "encode_chunks_batch parity")
        check(counts()["apply_matrix_cuda"] > n0,
              "encode_chunks_batch launched the bytes kernel")
        parity_packed = ec.encode_chunks_packed_torch(pack_chunks(data))
        torch.cuda.synchronize()
        check(torch.equal(unpack_chunks(parity_packed), parity),
              "encode_chunks_packed_torch parity")
        check(counts()["apply_matrix_cuda_packed"] >= 1,
              "packed encode launched the packed kernel")
        full = torch.cat([data[:DECODE_BATCH], parity[:DECODE_BATCH]],
                         dim=1)
        before = counts()
        for erased in patterns:
            avail = tuple(i for i in range(n) if i not in erased)
            idx = torch.tensor(avail, device=dev)
            want = full[:, list(erased)]
            rec = ec.decode_chunks_torch(full.index_select(1, idx), avail,
                                         erased)
            check(torch.equal(rec, want), f"decode {erased}")
            recp = ec.decode_chunks_packed_torch(
                pack_chunks(full.index_select(1, idx)), avail, erased)
            check(torch.equal(unpack_chunks(recp), want),
                  f"packed decode {erased}")
        mid = counts()
        per_call = {name: (mid[name] - before[name]) / len(patterns)
                    for name in ("apply_matrix_cuda",
                                 "apply_matrix_cuda_packed")}
        print(f"  RS decodes: {len(patterns)} calls per layout at "
              f"{DECODE_BATCH} stripes, launches per call {per_call}")
        check(per_call == {"apply_matrix_cuda": 1.0,
                           "apply_matrix_cuda_packed": 1.0},
              f"one dense launch per decode call: {per_call}")
        for erased in ((3,), (0, 9), (1, 5, 10)):
            avail = tuple(i for i in range(n) if i not in erased)
            host_full = full.cpu().numpy()
            rec = ec.decode_chunks_batch(host_full[:, list(avail)], avail,
                                         erased)
            check(np.array_equal(rec, host_full[:, list(erased)]),
                  f"decode_chunks_batch {erased}")
        after = counts()
        check(after["apply_matrix_cuda"] - before["apply_matrix_cuda"]
              >= len(patterns), "every decode launched the bytes kernel")
        check(after["apply_matrix_cuda_packed"]
              - before["apply_matrix_cuda_packed"] >= len(patterns),
              "every packed decode launched the packed kernel")
        isa = reg.factory("isa", {"technique": "reed_sol_van", "k": str(K),
                                  "m": str(M)})
        n1 = counts()["apply_matrix_cuda"]
        isa_parity = isa.encode_chunks_torch(data)
        check(np.array_equal(isa_parity[:2].cpu().numpy(),
                             regionops.matrix_encode(host[:2], isa.matrix,
                                                     8)),
              "isa encode == numpy ground truth")
        isa_full = torch.cat([data[:DECODE_BATCH],
                              isa_parity[:DECODE_BATCH]], dim=1)
        erased = (2, 7, 9)
        avail = tuple(i for i in range(n) if i not in erased)
        rec = isa.decode_chunks_torch(
            isa_full.index_select(1, torch.tensor(avail, device=dev)),
            avail, erased)
        check(torch.equal(rec, isa_full[:, list(erased)]), "isa decode")
        check(counts()["apply_matrix_cuda"] > n1, "isa launched the kernel")

    results["rs"] = drive("RS k=8 m=3 (64 x 1 MiB encode via tensor, "
                          "numpy and packed entries; 231 decode patterns x "
                          "2 layouts; isa)", counts, reset, rs_path,
                          ("apply_matrix_cuda", "apply_matrix_cuda_packed"))
    check(results["rs"]["apply_matrix_xor_cuda"] == 0
          and results["rs"]["apply_matrix_xor_cuda_packed"] == 0,
          "reed_sol_van k=8 m=3 routes no pattern to the XOR kernel")

    def cauchy_path():
        parity = cg.encode_chunks_torch(data)
        torch.cuda.synchronize()
        check(torch.equal(parity, gots), "cauchy_good encode_chunks_torch")
        n0 = counts()["apply_bitmatrix_xor_cuda"]
        check(n0 >= 1, "cauchy_good encode launched the schedule kernel")
        check(np.array_equal(cg.encode_chunks_batch(host),
                             parity.cpu().numpy()),
              "cauchy_good encode_chunks_batch")
        check(counts()["apply_bitmatrix_xor_cuda"] > n0,
              "encode_chunks_batch launched the schedule kernel")
        full = torch.cat([data[:DECODE_BATCH], parity[:DECODE_BATCH]],
                         dim=1)
        before = counts()
        t0 = time.perf_counter()
        for erased in patterns:
            avail = tuple(i for i in range(n) if i not in erased)
            rec = cg.decode_chunks_torch(
                full.index_select(1, torch.tensor(avail, device=dev)),
                avail, erased)
            check(torch.equal(rec, full[:, list(erased)]),
                  f"cauchy_good decode {erased}")
        after = counts()
        plain_n = (after["apply_bitmatrix_cuda"]
                   - before["apply_bitmatrix_cuda"])
        sched_n = (after["apply_bitmatrix_xor_cuda"]
                   - before["apply_bitmatrix_xor_cuda"])
        check(plain_n == 9 and sched_n == 222,
              f"cauchy_good decodes: {plain_n} plain, {sched_n} scheduled")
        print(f"  cauchy_good: 231 patterns decoded in "
              f"{time.perf_counter() - t0:.2f} s host clock (first use: "
              f"decode matrix and CSE per pattern); {plain_n} plain, "
              f"{sched_n} scheduled")

    results["cauchy_good"] = drive(
        "cauchy_good k=8 m=3 (64 x 1 MiB encode via tensor and numpy "
        "entries; 231 decode patterns)", counts, reset, cauchy_path,
        ("apply_bitmatrix_cuda", "apply_bitmatrix_xor_cuda"))
    # a warm repeat of the 231 decodes: the kernel data is cached per
    # (matrix, row groups), so it sets up nothing; each decode still
    # recovers the erased chunks
    setups, before = tel.kernel_setups(), counts()
    full = torch.cat([data[:DECODE_BATCH], gots[:DECODE_BATCH]], dim=1)
    for erased in patterns:
        avail = tuple(i for i in range(n) if i not in erased)
        rec = cg.decode_chunks_torch(full.index_select(
            1, torch.tensor(avail, device=dev)), avail, erased)
        check(torch.equal(rec, full[:, list(erased)]),
              f"warm cauchy_good decode {erased}")
    torch.cuda.synchronize()
    after = counts()
    warm = (after["apply_bitmatrix_cuda"] - before["apply_bitmatrix_cuda"],
            after["apply_bitmatrix_xor_cuda"]
            - before["apply_bitmatrix_xor_cuda"])
    check(warm == (9, 222) and tel.kernel_setups() == setups,
          f"warm cauchy_good decodes: {warm} launches, "
          f"{tel.kernel_setups() - setups} kernel setups")
    print(f"phase 3: warm repeat of the 231 cauchy_good decodes: {warm[0]} "
          f"plain and {warm[1]} scheduled launches, no kernel setup")

    def density_path():
        for prof, erased in (
                ({"technique": "liberation", "k": "7", "w": "7"}, (0, 8)),
                ({"technique": "blaum_roth", "k": "6", "w": "6"}, (0, 7)),
                ({"technique": "liber8tion", "k": "8"}, (3, 9))):
            code = reg.factory("jerasure", dict(prof))
            kk, nn = code.k, code.k + code.m
            c = code.get_chunk_size(kk * CHUNK)
            xh = rng.integers(0, 256, (DECODE_BATCH, kk, c), dtype=np.uint8)
            x = torch.from_numpy(xh).to(dev)
            par = code.encode_chunks_torch(x)
            check(np.array_equal(par[:2].cpu().numpy(),
                                 regionops.bitmatrix_encode(
                                     xh[:2], code.bitmatrix, code.w,
                                     code.packetsize)),
                  f"{prof['technique']} encode == numpy ground truth")
            full = torch.cat([x, par], dim=1)
            avail = tuple(i for i in range(nn) if i not in erased)
            rec = code.decode_chunks_torch(full[:, list(avail)], avail,
                                           erased)
            check(torch.equal(rec, full[:, list(erased)]),
                  f"{prof['technique']} decode {erased}")

    results["minimal_density"] = drive(
        "liberation k=7 w=7 / blaum_roth k=6 w=6 / liber8tion k=8 "
        "(encode + decode each)", counts, reset, density_path,
        ("apply_bitmatrix_cuda", "apply_bitmatrix_xor_cuda"))

    def words_path():
        for w, wc in wide_codes.items():
            wh, x = word_data[w]
            par = wc.encode_chunks_torch(x.view(torch.uint8))
            want = apply_matrix_torch(x, matrix_to_static(wc.matrix), w)
            check(torch.equal(par, want.view(torch.uint8)),
                  f"reed_sol_van w={w} encode")
            full = torch.cat([x.view(torch.uint8)[:DECODE_BATCH],
                              par[:DECODE_BATCH]], dim=1)
            erased = (1, 5, 10)
            avail = tuple(i for i in range(n) if i not in erased)
            rec = wc.decode_chunks_torch(full[:, list(avail)], avail,
                                         erased)
            check(torch.equal(rec, full[:, list(erased)]),
                  f"reed_sol_van w={w} decode {erased}")

    results["words"] = drive(
        "reed_sol_van w=16 / w=32 k=8 m=3 (encode + 3-erasure decode "
        "each)", counts, reset, words_path, ("apply_matrix_cuda_words",))

    def erasures(n, most):
        return [e for t in range(1, most + 1)
                for e in itertools.combinations(range(n), t)]

    def decode_both(code, full, erased, want_xor):
        """Decode ``erased`` from the rest of ``full`` through the tensor
        and packed entries; require the XOR-schedule kernel in both
        layouts when ``want_xor``, the dense kernel otherwise."""
        avail = tuple(i for i in range(full.shape[1]) if i not in erased)
        surv = full.index_select(1, torch.tensor(avail, device=dev))
        before = counts()
        rec = code.decode_chunks_torch(surv, avail, erased)
        recp = code.decode_chunks_packed_torch(pack_chunks(surv), avail,
                                               erased)
        torch.cuda.synchronize()
        after = counts()
        want = full[:, list(erased)]
        check(torch.equal(rec, want), f"decode {erased}")
        check(torch.equal(unpack_chunks(recp), want),
              f"packed decode {erased}")
        ran = {k: after[k] - before[k] for k in after}
        if want_xor:
            check(ran["apply_matrix_xor_cuda"] == 1
                  and ran["apply_matrix_xor_cuda_packed"] == 1,
                  f"decode {erased} took the XOR kernel: {ran}")
        else:
            check(ran["apply_matrix_cuda"] >= 1
                  and ran["apply_matrix_cuda_packed"] >= 1
                  and ran["apply_matrix_xor_cuda"] == 0,
                  f"decode {erased} took the dense kernel: {ran}")

    def routes_xor(code, avail, erased, ms=None):
        if ms is None:
            ms = code._decode_composite(avail, erased)[1]
        return preferred_schedule(ms, 8, mxu_min=MXU_MATRIX_MIN) is not None

    lrc_host = rng.integers(0, 256, (BATCH, LRC_K, LRC_CHUNK),
                            dtype=np.uint8)
    lrc_data = torch.from_numpy(lrc_host).to(dev)

    def lrc_path():
        parity = lrc.encode_chunks_torch(lrc_data)
        parity_p = lrc.encode_chunks_packed_torch(pack_chunks(lrc_data))
        torch.cuda.synchronize()
        check(torch.equal(unpack_chunks(parity_p), parity),
              "lrc packed encode")
        check(np.array_equal(parity[:2].cpu().numpy(),
                             lrc.encode_chunks_batch(lrc_host[:2])),
              "lrc encode == encode_chunks_batch (host schedule)")
        n_lrc = lrc.get_chunk_count()
        full = torch.empty((DECODE_BATCH, n_lrc, LRC_CHUNK),
                           dtype=torch.uint8, device=dev)
        dpos = lrc.data_positions
        ppos = [p for p in range(n_lrc) if p not in dpos]
        full[:, dpos] = lrc_data[:DECODE_BATCH]
        full[:, ppos] = parity[:DECODE_BATCH]
        n_xor = 0
        for erased in erasures(n_lrc, 2):
            avail = tuple(i for i in range(n_lrc) if i not in erased)
            xor = routes_xor(lrc, avail, erased)
            n_xor += xor
            decode_both(lrc, full, erased, xor)
        check(n_xor == 29, f"lrc: {n_xor} of 36 patterns on the XOR kernel")

    results["lrc"] = drive(
        "lrc k=4 m=2 l=3 (64 x 1 MiB encode via tensor and packed "
        "entries; 36 decode patterns x 2 layouts, 29 scheduled)", counts,
        reset, lrc_path, ("apply_matrix_cuda", "apply_matrix_cuda_packed",
                          "apply_matrix_xor_cuda",
                          "apply_matrix_xor_cuda_packed"))

    def r6_path():
        parity = r6.encode_chunks_torch(data)
        parity_p = r6.encode_chunks_packed_torch(pack_chunks(data))
        torch.cuda.synchronize()
        check(torch.equal(parity, r6_parity), "r6 encode_chunks_torch")
        check(torch.equal(unpack_chunks(parity_p), parity),
              "r6 packed encode")
        check(counts()["apply_matrix_xor_cuda"] == 1
              and counts()["apply_matrix_xor_cuda_packed"] == 1,
              "the r6 encode took the XOR kernel in both layouts")
        n6 = r6.k + r6.m
        full = torch.cat([data[:DECODE_BATCH], parity[:DECODE_BATCH]],
                         dim=1)
        on_xor = []
        for erased in erasures(n6, 2):
            avail = tuple(i for i in range(n6) if i not in erased)
            dm_static = r6._decode_matrix(avail, erased)[1]
            xor = routes_xor(r6, avail, erased, dm_static)
            if xor:
                on_xor.append(erased)
            decode_both(r6, full, erased, xor)
        check(on_xor == [(9,), (8, 9)], f"r6 XOR decodes {on_xor}")

    results["r6"] = drive(
        "reed_sol_r6_op k=8 m=2 (64 x 1 MiB encode via tensor and packed "
        "entries on the XOR kernel; 55 decode patterns x 2 layouts)",
        counts, reset, r6_path,
        ("apply_matrix_cuda", "apply_matrix_cuda_packed",
         "apply_matrix_xor_cuda", "apply_matrix_xor_cuda_packed"))

    shec_chunk = shec.get_chunk_size(LRC_K * LRC_CHUNK)
    shec_host = rng.integers(0, 256, (BATCH, shec.k, shec_chunk),
                             dtype=np.uint8)

    def shec_path():
        x = torch.from_numpy(shec_host).to(dev)
        parity = shec.encode_chunks_torch(x)
        check(np.array_equal(parity[:2].cpu().numpy(),
                             regionops.matrix_encode(shec_host[:2],
                                                     shec.matrix, 8)),
              "shec encode == numpy ground truth")
        full = torch.cat([x[:DECODE_BATCH], parity[:DECODE_BATCH]], dim=1)
        done = refused = n_xor = 0
        for erased in erasures(n_shec, 3):
            avail = tuple(i for i in range(n_shec) if i not in erased)
            try:
                shec.minimum_to_decode(set(erased), set(avail))
            except IOError:
                refused += 1
                continue
            plan = shec._plan(avail, erased)
            xor = routes_xor(shec, avail, erased,
                             shec._plan_static(plan)[1])
            n_xor += xor
            decode_both(shec, full, erased, xor)
            done += 1
        check(done + refused == 63 and n_xor == 4,
              f"shec: {done} decoded, {refused} undecodable, {n_xor} "
              f"scheduled")
        print(f"  shec: {done} patterns decoded ({n_xor} on the XOR "
              f"kernel), {refused} undecodable (IOError, as the "
              f"reference)")

    results["shec"] = drive(
        "shec k=4 m=3 c=2 (64 x 1 MiB encode; every 1-3 erasure pattern x "
        "2 layouts)", counts, reset, shec_path,
        ("apply_matrix_cuda", "apply_matrix_cuda_packed",
         "apply_matrix_xor_cuda", "apply_matrix_xor_cuda_packed"))

    def clay_path():
        parity = clay.encode_chunks_torch(clay_data)
        torch.cuda.synchronize()
        check(torch.equal(parity, clay_parity), "clay encode_chunks_torch")
        check(counts()["apply_matrix_mxu_cuda"] == 1,
              "the clay encode took the column-walk kernel")
        check(np.array_equal(clay.encode_chunks_batch(clay_host),
                             parity.cpu().numpy()),
              "clay encode_chunks_batch")
        check(counts()["apply_matrix_mxu_cuda"] == 2,
              "encode_chunks_batch took the column-walk kernel")
        parity_p = clay.encode_chunks_packed_torch(pack_chunks(clay_data))
        torch.cuda.synchronize()
        check(torch.equal(unpack_chunks(parity_p), parity),
              "clay packed encode")
        check(counts()["apply_matrix_mxu_cuda_packed"] == 1,
              "the packed encode took the column-walk kernel")
        full = torch.cat([clay_data[:DECODE_BATCH], parity[:DECODE_BATCH]],
                         dim=1)
        t0 = time.perf_counter()
        for erased in erasures(n_clay, 2):
            avail = tuple(i for i in range(n_clay) if i not in erased)
            clay._decode_composite(avail, erased)
        clay_probe_s["all 78 decodes (2 built above)"] = \
            time.perf_counter() - t0
        on_mxu = on_dense = 0
        for erased in erasures(n_clay, 2):
            avail = tuple(i for i in range(n_clay) if i not in erased)
            surv = full.index_select(1, torch.tensor(avail, device=dev))
            before = counts()
            rec = clay.decode_chunks_torch(surv, avail, erased)
            recp = clay.decode_chunks_packed_torch(pack_chunks(surv), avail,
                                                   erased)
            torch.cuda.synchronize()
            ran = {k: v - before[k] for k, v in counts().items()}
            want = full[:, list(erased)]
            check(torch.equal(rec, want), f"clay decode {erased}")
            check(torch.equal(unpack_chunks(recp), want),
                  f"clay packed decode {erased}")
            if ran["apply_matrix_mxu_cuda"] == 1 \
                    and ran["apply_matrix_mxu_cuda_packed"] == 1:
                on_mxu += 1
            elif ran["apply_matrix_cuda"] >= 1 \
                    and ran["apply_matrix_cuda_packed"] >= 1:
                on_dense += 1
                check(len(erased) == 1 and erased[0] >= clay.k,
                      f"only the parity repairs take the dense kernel, "
                      f"not {erased}")
            else:
                check(False, f"clay decode {erased} launched {ran}")
        check((on_mxu, on_dense) == (74, 4),
              f"clay decodes: {on_mxu} on the column-walk kernel, {on_dense} "
              f"on the dense kernel")
        # one single-chunk repair through the dict API: the d helpers'
        # sub-chunk runs only
        host_full = full[:1].cpu().numpy()
        lost = 2
        avail = set(range(n_clay)) - {lost}
        need = clay.minimum_to_decode({lost}, avail)
        check(len(need) == clay.d and all(
            sum(n for _, n in runs) == sub // clay.q
            for runs in need.values()), f"repair reads {need}")
        reads = {c: b"".join(host_full[0, c, off * sc:(off + n) * sc]
                             .tobytes() for off, n in runs)
                 for c, runs in need.items()}
        got = clay.decode({lost}, reads, clay_chunk)
        check(got[lost] == host_full[0, lost].tobytes(),
              "clay dict repair from partial reads")
        small = reg.factory("clay", {"k": "4", "m": "2", "d": "5"})
        sh = rng.integers(0, 256, (DECODE_BATCH, 4, small.get_chunk_size(
            1 << 20)), dtype=np.uint8)
        sx = torch.from_numpy(sh).to(dev)
        sp = small.encode_chunks_torch(sx)
        check(np.array_equal(sp.cpu().numpy(),
                             small.encode_chunks_batch(sh)),
              "clay k=4 m=2 d=5 encode")
        sfull = torch.cat([sx, sp], dim=1)
        erased = (1, 4)
        avail = (0, 2, 3, 5)
        check(torch.equal(small.decode_chunks_torch(sfull[:, list(avail)],
                                                    avail, erased),
                          sfull[:, list(erased)]),
              "clay k=4 m=2 d=5 decode (1, 4)")
        print(f"  clay: 78 decode patterns x 2 layouts ({on_mxu} on the "
              f"column-walk kernel, {on_dense} on the dense kernel's table "
              f"variant); dict repair of chunk {lost} from "
              f"{len(need)} helpers' sub-chunk runs; k=4 m=2 d=5 ok")

    results["clay"] = drive(
        "clay k=8 m=4 d=11 (64 x 1 MiB encode via tensor, numpy and packed "
        "entries; 78 decode patterns x 2 layouts; dict repair; k=4 m=2 "
        "d=5)", counts, reset, clay_path,
        ("apply_matrix_mxu_cuda", "apply_matrix_mxu_cuda_packed",
         "apply_matrix_cuda", "apply_matrix_cuda_packed"))

    # the serving plane: one closed-loop stream of 512 requests, dense
    # (the rung ladder) and paged (512 pages of 4096 bytes per queue),
    # through run_serving_scenario on the real clock
    serve_runs = {}

    def serve_path(paged):
        def fn():
            run = run_serving_scenario(serving_spec(paged))
            bad = verify_results(run.results)
            check(len(run.results) == SERVE_REQUESTS and not bad,
                  f"{len(run.results)} served, {len(bad)} wrong")
            check(run.report["stream_compiles"] == 0,
                  f"stream_compiles {run.report['stream_compiles']}")
            if paged:
                ps = run.batcher.pool_stats()
                check(ps["used_pages"] == 0
                      and ps["allocs"] == ps["reclaims"] > 0,
                      f"pools drained: {ps}")
            serve_runs["paged" if paged else "dense"] = run
        return fn

    results["serve_dense"] = drive(
        f"serving, dense rung ladder 1/4/16/64 ({SERVE_REQUESTS} requests: "
        f"RS k=8 m=3 at 64 KiB / 1 MiB / 4 MiB, shec k=6 m=3 c=2 at "
        f"1 MiB, clay k=8 m=4 d=11 at 1 MiB)", counts,
        reset, serve_path(False), ("apply_matrix_cuda",
                                   "apply_matrix_mxu_cuda"))
    check(results["serve_dense"]["apply_matrix_cuda_ragged"] == 0,
          "the dense run launches no ragged kernel")
    results["serve_paged"] = drive(
        f"serving, paged ({SERVE_POOL_PAGES} pages of {PAGE} bytes per "
        f"queue; same stream)", counts, reset, serve_path(True),
        ("apply_matrix_cuda_ragged", "apply_matrix_mxu_cuda"))
    for mode, run in serve_runs.items():
        st = run.batcher.padding_stats()
        print(f"  serving {mode}: {len(run.batcher.dispatch_log)} fires, "
              f"{st['warmup_dispatches']} warmup dispatches, "
              f"{st['cached_programs']} programs, padding overhead "
              f"{st['padding_overhead']}, stream_compiles "
              f"{run.report['stream_compiles']}"
              + (f", pools {st['pool']}" if mode == "paged" else ""))

    def packed_ragged_path():
        mk = rag_masks["half-live"]
        got = apply_matrix_packed_best_ragged(rag_words, ms, mk)
        check(torch.equal(got, apply_matrix_packed_ragged_torch(
            rag_words, ms, mk)), "apply_matrix_packed_best_ragged")

    results["packed_ragged"] = drive(
        f"apply_matrix_packed_best_ragged (the packed ragged ops entry, "
        f"{tuple(rag_words.shape)} words, half-live)", counts, reset,
        packed_ragged_path, ("apply_matrix_cuda_packed_ragged",))

    def roofline_path():
        for name in roofline.PROBES:
            row = roofline.probe(name, ROOF_MIB, ROOF_LOOP, "packed")
            check(row["input_gbps"] > 0 and row["traffic_mult"]
                  == roofline.traffic_mult(name), f"roofline row {row}")
            print(f"  roofline {json.dumps(row)}")

    results["roofline"] = drive(
        f"roofline tool (the five probes, {ROOF_MIB} MiB slabs, loop "
        f"{ROOF_LOOP})", counts, reset, roofline_path,
        ("copy_slab_cuda", "fold_slab_cuda", "apply_matrix_cuda_packed"))
    launches = {name: sum(r[name] for r in results.values())
                for name in counts()}
    for name, cnt in launches.items():
        check(cnt >= 1, f"{name} launched on the driven paths")
    print(f"phase 3: all paths ok; launches {launches}")

    # -- phase 4: times at the main shape ----------------------------------------
    words = pack_chunks(data)
    t_bytes, h_bytes = time_ms(lambda: apply_matrix_cuda(data, ms), 50)
    t_packed, h_packed = time_ms(lambda: apply_matrix_cuda_packed(words, ms),
                                 50)
    t_plain, h_plain = time_ms(lambda: apply_matrix_torch(data, ms, 8), 5,
                               warmup=1)
    t_plain_packed, h_plain_packed = time_ms(
        lambda: pack_chunks(apply_matrix_torch(unpack_chunks(words), ms,
                                               8)), 5, warmup=1)
    t_copy, h_copy = time_ms(lambda: data.clone(), 50)
    in_bytes = data.numel()
    words_per_chunk = in_bytes // K // 4
    moved = in_bytes * (K + M) // K
    bound, bound_by = bound_ms(moved, sm90_op_floor(ms) * words_per_chunk)
    print(f"bound of the encode: {moved} bytes moved, "
          f"{sm90_op_floor(ms)} int32 ops per word position (the floor: "
          f"chain per column {sm90_op_count(ms)}, per row "
          f"{sm90_row_op_count(ms)}; the dense kernel's program "
          f"{program_op_count(ms)}; reference dense cost model: "
          f"{dense_op_count(ms)}) x {words_per_chunk} word positions -> "
          f"{bound:.6f} ms, by {bound_by}")

    # decode e=2 at the main shape, through the user's entry point: the
    # survivors of all 64 stripes (a strided slice) -> the 2 lost chunks
    erased = (3, 9)
    avail = tuple(i for i in range(n) if i not in erased)
    surv = torch.cat([data, plain], dim=1).index_select(
        1, torch.tensor(avail, device=dev))
    dm = matrix_to_static(regionops.matrix_decode_matrix(
        mat, K, list(avail[:K]), list(erased)))
    t_dec, h_dec = time_ms(
        lambda: ec.decode_chunks_torch(surv, avail, erased), 50)
    dbound, dbound_by = bound_ms(in_bytes * (K + len(erased)) // K,
                                 sm90_op_floor(dm) * words_per_chunk)
    print(f"bound of decode e=2 {erased}: {sm90_op_floor(dm)} int32 ops "
          f"per word position (chain per column {sm90_op_count(dm)}, per "
          f"row {sm90_row_op_count(dm)}; the dense kernel's program "
          f"{program_op_count(dm)}; reference dense cost model: "
          f"{dense_op_count(dm)}) -> {dbound:.6f} ms, by {dbound_by}")
    # the numpy entry point end to end (host clock: copies included), and
    # one 1 MiB stripe through the tensor entry point (dispatch-bound)
    t0 = time.perf_counter()
    for _ in range(3):
        ec.encode_chunks_batch(host)
    t_batch = (time.perf_counter() - t0) * 1e3 / 3
    print(f"time encode_chunks_batch, 64 MiB numpy in and out: "
          f"{t_batch:.6f} ms host clock, {in_bytes / t_batch / 1e6:.3f} "
          f"GB/s of input")
    one = data[:1].contiguous()
    t_one, h_one = time_ms(lambda: ec.encode_chunks_torch(one), 200)
    print(f"time encode_chunks_torch, one 1 MiB stripe: {t_one:.6f} ms "
          f"device, {h_one:.6f} ms host issue per call")

    # the bitmatrix kernels at the cauchy_good k=8 m=3 main shape
    t_bm, h_bm = time_ms(
        lambda: apply_bitmatrix_cuda(data, rows, 8, PACKETSIZE), 50)
    t_bm_plain, h_bm_plain = time_ms(
        lambda: apply_bitmatrix_torch(data, rows, 8, PACKETSIZE), 5,
        warmup=1)
    t_xs, h_xs = time_ms(lambda: apply_bitmatrix_xor_cuda(
        data, enc_sched.static, 8, PACKETSIZE), 50)
    t_xs_plain, h_xs_plain = time_ms(lambda: apply_bitmatrix_xor_torch(
        data, enc_sched.static, 8, PACKETSIZE), 5, warmup=1)
    t_cg_enc, h_cg_enc = time_ms(lambda: cg.encode_chunks_torch(data), 50)
    t_cg_dec, h_cg_dec = time_ms(
        lambda: cg.decode_chunks_torch(e2_surv, e2_avail, e2), 50)
    e1 = (3,)
    e1_avail = tuple(i for i in range(n) if i not in e1)
    e1_surv = cg_full.index_select(1, torch.tensor(e1_avail, device=dev))
    _, e1_rows, _, e1_sched = cg._decode_bitmatrix(e1_avail, e1)
    check(e1_sched is None, "cauchy_good decode e=1 (3,) is plain")
    t_cg_dec1, h_cg_dec1 = time_ms(
        lambda: cg.decode_chunks_torch(e1_surv, e1_avail, e1), 50)
    bm_ops = bitmatrix_op_count(rows) * words_per_chunk // 8
    bm_bound, bm_by = bound_ms(moved, bm_ops)
    xs_ops = schedule_op_count(enc_sched.static) * words_per_chunk // 8
    xs_bound, xs_by = bound_ms(moved, xs_ops)
    dec2_bound, dec2_by = bound_ms(
        in_bytes * (K + 2) // K,
        schedule_op_count(e2_sched.static) * words_per_chunk // 8)
    dec1_bound, dec1_by = bound_ms(
        in_bytes * (K + 1) // K,
        bitmatrix_op_count(e1_rows) * words_per_chunk // 8)
    print(f"bound of the cauchy_good encode: {moved} bytes moved; plain "
          f"{bitmatrix_op_count(rows)} int32 ops per word position, "
          f"scheduled {schedule_op_count(enc_sched.static)} ({enc_sched.xor_ops}"
          f" XORs, {enc_sched.naive_xor_ops} naive) x "
          f"{words_per_chunk // 8} word positions -> plain "
          f"{bm_bound:.6f} ms by {bm_by}, scheduled {xs_bound:.6f} ms by "
          f"{xs_by}; decode e=2 {e2} {e2_sched.xor_ops} XORs -> "
          f"{dec2_bound:.6f} ms by {dec2_by}; decode e=1 {e1} plain -> "
          f"{dec1_bound:.6f} ms by {dec1_by}")

    # the word kernel at (64, 8, 65536) words
    word_times = {}
    for w, wc in wide_codes.items():
        _, x = word_data[w]
        wms = matrix_to_static(wc.matrix)
        t_w, h_w = time_ms(lambda: apply_matrix_cuda_words(x, wms, w), 20)
        t_wp, h_wp = time_ms(lambda: apply_matrix_torch(x, wms, w), 3,
                             warmup=1)
        w_bytes = x.numel() * (w // 8)
        w_pos = w_bytes // K // 4
        wb, wb_by = bound_ms(w_bytes * (K + M) // K,
                             sm90_op_floor(wms, w) * w_pos)
        word_times[w] = (t_w, h_w, t_wp, h_wp, wb, wb_by)
        print(f"bound of reed_sol_van w={w} encode at (64, 8, {WORDS}) "
              f"words: {w_bytes * (K + M) // K} bytes moved, "
              f"{sm90_op_floor(wms, w)} int32 ops per word position (per "
              f"column {sm90_op_count(wms, w)}, per row "
              f"{sm90_row_op_count(wms, w)}; the kernel's program "
              f"{program_op_count(wms, w)}) x "
              f"{w_pos}"
              f" -> {wb:.6f} ms, by {wb_by}")

    # the dense kernel's two ways of taking its row program, on the RS k=8
    # m=3 encodes at the main shape (w=8 bytes, w=16 words): by value (a
    # kernel parameter, up to BY_VALUE_MAX_PROG words) and from a device
    # buffer (any size, the clay repairs' way).  One call of the library
    # each, timed in the order value, table, table, value; both outputs
    # held against the plain version first
    lib_gf = gf_kernels._lib()
    for w, x, wms, want in (
            (8, data, ms, plain),
            (16, word_data[16][1], matrix_to_static(wide_codes[16].matrix),
             None)):
        prog = dense_program(wms, w)
        table = gf_kernels._device_program(wms, w, dev).data_ptr()
        nb = x.shape[-1] * x.element_size()
        out_w = torch.empty((x.shape[0], M) + x.shape[2:], dtype=x.dtype,
                            device=dev)
        geom = (x.data_ptr(), out_w.data_ptr(), x.shape[0], nb, K * nb, nb,
                M * nb, nb, M, K)

        def via(tab, w=w, geom=geom, prog=prog, x=x):
            def fn():
                e = (lib_gf.gf8_matrix_apply(*geom, prog.ctypes.data, tab,
                                             None, *device_and_stream(x))
                     if w == 8 else
                     lib_gf.gfw_matrix_apply(*geom, w, prog.ctypes.data, tab,
                                             *device_and_stream(x)))
                check(e == 0, f"the dense kernel launched (error {e})")
            return fn
        if want is None:
            want = apply_matrix_torch(x, wms, w)
        for tab in (None, table):
            out_w.zero_()
            via(tab)()
            check(torch.equal(out_w, want),
                  f"w={w} dense kernel, {'table' if tab else 'by value'}")
        got_t = {"by value": [], "table": []}
        for name, tab in (("by value", None), ("table", table),
                          ("table", table), ("by value", None)):
            got_t[name].append((kernel_ms(via(tab), "gf_matrix", iters=50),
                                time_ms(via(tab), 50)[0]))
        print(f"time RS k=8 m=3 encode w={w} at {tuple(x.shape)}, dense "
              f"kernel per call (profiler ms, events ms), in the order "
              f"value, table, table, value: by value {got_t['by value']}, "
              f"table {got_t['table']}")

    # the dense kernel at the shapes of tools/dense_times.py (the encode,
    # the decodes at 4 and 64 stripes, clay's (64, 704) repair through the
    # device program, w=16/32, the ragged pool at 25/50/100 % live): its
    # profiler time per call beside the bound, the instructions per word
    # position its row program spends against the floor, and its plan
    for name, wrapper, fn, moved, mat_s, w, pos, dims in dense_times.shapes(
            args.seed):
        k_t = kernel_ms(fn, "gf_matrix", iters=50)
        b, b_by = bound_ms(moved, sm90_op_floor(mat_s, w) * pos)
        plan = dense_plan(*dims, mat_s, dev) if w == 8 else None
        print(f"time dense kernel, {name} via {wrapper}: profiler "
              + ("not measured" if k_t is None else f"{k_t:.6f} ms, "
                 f"{b / k_t:.4f} of bound")
              + f"; bound {b:.6f} ms by {b_by}; {program_op_count(mat_s, w)}"
              f" instructions per word position in its program (floor "
              f"{sm90_op_floor(mat_s, w)}); grid {plan}")

    # the packet kernel at the shapes of tools/packet_times.py (the
    # cauchy_good encode plain and scheduled, the scheduled decode (3, 9)
    # at 4 and 64 stripes, the plain decode (3,) at 4, a random w=7
    # bitmatrix at packetsize 32): its profiler time per call beside the
    # bound, and the plan it launched
    for name, kind, key, n_in, w, ps, x, r in packet_times.shapes(
            args.seed):
        fn = ((lambda x=x, key=key, w=w, ps=ps:
               apply_bitmatrix_cuda(x, key, w, ps)) if kind == "plain" else
              (lambda x=x, key=key, w=w, ps=ps:
               apply_bitmatrix_xor_cuda(x, key, w, ps)))
        b, b_by = bound_ms(*packet_times.work(gf_kernels, kind, key, n_in,
                                              w, ps, x, r))
        k_t = kernel_ms(fn, "gf2_packet_kernel", iters=50)
        plan = gf_kernels.packet_launch_plan(x, r, w, ps, kind, key, n_in)
        print(f"time packet kernel, {name}, {kind}: profiler "
              + ("not measured" if k_t is None else f"{k_t:.6f} ms, "
                 f"{b / k_t:.4f} of bound")
              + f"; bound {b:.6f} ms by {b_by}; plan {plan}")

    for name, t, h, b, nbytes in (
            ("bytes kernel", t_bytes, h_bytes, bound, in_bytes),
            ("packed kernel", t_packed, h_packed, bound, in_bytes),
            ("plain torch (bytes)", t_plain, h_plain, bound, in_bytes),
            ("plain torch (packed)", t_plain_packed, h_plain_packed, bound,
             in_bytes),
            ("copy floor (clone of the input)", t_copy, h_copy, bound,
             in_bytes),
            ("decode e=2 via decode_chunks_torch", t_dec, h_dec, dbound,
             in_bytes),
            ("cauchy_good encode, plain packet kernel", t_bm, h_bm,
             bm_bound, in_bytes),
            ("cauchy_good encode, plain torch (packets)", t_bm_plain,
             h_bm_plain, bm_bound, in_bytes),
            ("cauchy_good encode, schedule kernel", t_xs, h_xs, xs_bound,
             in_bytes),
            ("cauchy_good encode, plain torch (schedule)", t_xs_plain,
             h_xs_plain, xs_bound, in_bytes),
            ("cauchy_good encode via encode_chunks_torch", t_cg_enc,
             h_cg_enc, xs_bound, in_bytes),
            ("cauchy_good decode e=2 via decode_chunks_torch (schedule)",
             t_cg_dec, h_cg_dec, dec2_bound, in_bytes),
            ("cauchy_good decode e=1 via decode_chunks_torch (plain)",
             t_cg_dec1, h_cg_dec1, dec1_bound, in_bytes),
            *((f"reed_sol_van w={w} encode, word kernel", v[0], v[1], v[4],
               BATCH * K * WORDS * w // 8) for w, v in word_times.items()),
            *((f"reed_sol_van w={w} encode, plain torch", v[2], v[3], v[4],
               BATCH * K * WORDS * w // 8) for w, v in word_times.items())):
        print(f"time {name}: {t:.6f} ms device, {h:.6f} ms host issue, "
              f"{nbytes / t / 1e6:.3f} GB/s of input, {b / t:.4f} of "
              f"bound")

    # the XOR-schedule kernel: the r6 encode at the main shape and the lrc
    # local repair, both layouts, against the bytes each one must move
    def read_chunks(st):
        """The input chunks the schedule reads (the kernel loads no
        other)."""
        return {idx for leaves, _, _ in word_program(st)[1]
                for mem, idx, _, _ in leaves if mem}

    def xor_bound(st, x, r):
        c = x.shape[-1]
        moved = x.shape[0] * (len(read_chunks(st)) + r) * c
        return bound_ms(moved, xor_schedule_op_count(st) * x.shape[0]
                        * c // 4) + (moved,)

    xor_times = {}
    for label, x, st, mat_s in (
            ("r6 encode", data, r6_st, r6_ms),
            ("lrc local repair (0,)", lrc_surv, lrc_st, lrc_ms)):
        xw = pack_chunks(x)
        r = st[2]
        t_x, h_x = time_ms(lambda: apply_matrix_xor_cuda(x, st), 50)
        t_xp, h_xp = time_ms(lambda: apply_matrix_xor_cuda_packed(xw, st),
                             50)
        t_pl, h_pl = time_ms(lambda: apply_matrix_xor_torch(x, st), 5,
                             warmup=1)
        t_plp, h_plp = time_ms(lambda: pack_chunks(apply_matrix_xor_torch(
            unpack_chunks(xw), st)), 5, warmup=1)
        read = sorted(read_chunks(st))
        src = x[:, read]
        t_cp, h_cp = time_ms(lambda: src.clone(), 50)
        k_x = kernel_ms(lambda: apply_matrix_xor_cuda(x, st),
                        "gf8_xor_kernel")
        k_xp = kernel_ms(lambda: apply_matrix_xor_cuda_packed(xw, st),
                         "gf8_xor_kernel")
        # the dense kernel on the same matrix: what the schedule is for
        k_dense = kernel_ms(lambda: apply_matrix_cuda(x, mat_s),
                            "gf_matrix_kernel")
        b, b_by, moved = xor_bound(st, x, r)
        xor_times[label] = (k_x or t_x, k_xp or t_xp, t_pl, t_plp, b, b_by)
        print(f"bound of the {label} {tuple(x.shape)} -> {r} rows: reads "
              f"chunks {read}, {moved} bytes moved, "
              f"{xor_schedule_op_count(st)} int32 ops per word position "
              f"-> {b:.6f} ms, by {b_by}")
        for name, t, h, nbytes in (
                ("XOR-schedule kernel (bytes)", t_x, h_x, moved),
                ("XOR-schedule kernel (packed)", t_xp, h_xp, moved),
                ("plain torch schedule (bytes)", t_pl, h_pl, moved),
                ("plain torch schedule (packed)", t_plp, h_plp, moved),
                (f"copy floor (clone of the {len(read)} chunks read)", t_cp,
                 h_cp, 2 * src.numel())):
            print(f"time {label}, {name}: {t:.6f} ms device, {h:.6f} ms "
                  f"host issue, {nbytes / t / 1e6:.3f} GB/s moved, "
                  f"{b / t:.4f} of bound")
        for name, k_t in (("XOR-schedule kernel (bytes)", k_x),
                          ("XOR-schedule kernel (packed)", k_xp),
                          ("dense kernel on the same matrix", k_dense)):
            print(f"time {label}, {name}, profiler device time per "
                  f"launch: "
                  + ("not measured (no kernel in the trace)" if k_t is None
                     else f"{k_t:.6f} ms, {b / k_t:.4f} of bound"))
    t_r6e, h_r6e = time_ms(lambda: r6.encode_chunks_torch(data), 50)
    t_lrd, h_lrd = time_ms(lambda: lrc.decode_chunks_torch(
        lrc_surv, lrc_avail, (0,)), 50)
    print(f"time r6 encode via encode_chunks_torch: {t_r6e:.6f} ms device, "
          f"{h_r6e:.6f} ms host issue; lrc repair (0,) via "
          f"decode_chunks_torch: {t_lrd:.6f} ms device, {h_lrd:.6f} ms "
          f"host issue")

    # the ragged kernel at the serving pool shape, 25 / 50 / 100 % live,
    # beside the dense kernel on the same bytes; its bound counts the
    # reads of live pages, the writes of every page and the integer work
    # of live pages
    k_dense_main = kernel_ms(lambda: apply_matrix_cuda(data, ms),
                             "gf_matrix_kernel")
    print("dense encode at the main shape, profiler device time per "
          "launch: " + ("not measured" if k_dense_main is None
                        else f"{k_dense_main:.6f} ms")
          + f", beside {EARLIER_DENSE_MS} ms for the chain per column "
          f"it replaced ({EARLIER_CARD})")
    words_per_page = PAGE // 4
    rag_times = {}
    for share in (0.25, 0.5, 1.0):
        live = np.zeros(RAG_PAGES, np.uint8)
        live[rng.permutation(RAG_PAGES)[:int(RAG_PAGES * share)]] = 1
        mk = torch.from_numpy(live).to(dev)
        n_live = int(live.sum())
        b, b_by = bound_ms(n_live * K * PAGE + RAG_PAGES * M * PAGE
                           + RAG_PAGES,
                           sm90_op_floor(ms) * n_live * words_per_page)
        k_r = kernel_ms(lambda: apply_matrix_cuda_ragged(rag_pool, ms, mk),
                        "gf_matrix_kernel")
        k_rp = kernel_ms(lambda: apply_matrix_cuda_packed_ragged(
            rag_words, ms, mk), "gf_matrix_kernel")
        t_r, _ = time_ms(lambda: apply_matrix_cuda_ragged(rag_pool, ms, mk),
                         50)
        t_rpk, _ = time_ms(lambda: apply_matrix_cuda_packed_ragged(
            rag_words, ms, mk), 50)
        t_rp, _ = time_ms(lambda: apply_matrix_ragged_torch(rag_pool, ms,
                                                             mk), 5,
                          warmup=1)
        t_rpp, _ = time_ms(lambda: apply_matrix_packed_ragged_torch(
            rag_words, ms, mk), 5, warmup=1)
        rag_times[share] = (k_r or t_r, k_rp or t_rpk, t_rp, t_rpp, b, b_by)
        print(f"time ragged kernel, RS encode over ({RAG_PAGES}, {K}, "
              f"{PAGE}), {n_live} live pages ({share:.0%}): profiler "
              + ("not measured" if k_r is None else f"{k_r:.6f} ms")
              + " bytes, " + ("not measured" if k_rp is None
                              else f"{k_rp:.6f} ms") + " packed; events "
              f"{t_r:.6f} / {t_rpk:.6f} ms; plain {t_rp:.6f} / {t_rpp:.6f} "
              f"ms; bound {b:.6f} ms by {b_by}")
    k_pool_dense = kernel_ms(lambda: apply_matrix_cuda(rag_pool, ms),
                             "gf_matrix_kernel")
    pd_bound, pd_by = bound_ms(RAG_PAGES * (K + M) * PAGE,
                               sm90_op_floor(ms) * RAG_PAGES
                               * words_per_page)
    print(f"time dense kernel on the same ({RAG_PAGES}, {K}, {PAGE}) "
          f"bytes: profiler "
          + ("not measured" if k_pool_dense is None
             else f"{k_pool_dense:.6f} ms") + f"; bound {pd_bound:.6f} ms "
          f"by {pd_by}")

    # the host-to-device copy of one pool, as a fire makes it (pageable
    # numpy buffer, dead pages included)
    t0 = time.perf_counter()
    for _ in range(10):
        torch.from_numpy(rag_host).to(dev)
    torch.cuda.synchronize()
    t_copy_pool = (time.perf_counter() - t0) * 1e3 / 10
    print(f"time host-to-device copy of one {rag_host.nbytes} byte pool "
          f"({RAG_PAGES}, {K}, {PAGE}): {t_copy_pool:.6f} ms host clock, "
          f"{rag_host.nbytes / t_copy_pool / 1e6:.3f} GB/s")

    # the serving runs: GB/s, GB/s under SLO, p50/p99 per op, and the
    # mean service time of a fire (copy in, kernels, copy out, demux)
    for mode, run in serve_runs.items():
        rep = run.report
        fires = {(res.completed, res.service) for res in run.results}
        mean_fire = sum(sv for _, sv in fires) / len(fires) * 1e3
        per_op = "; ".join(
            f"{op} {row['requests']} req p50 {row['p50_ms']} ms p99 "
            f"{row['p99_ms']} ms miss {row['deadline_miss_rate']}"
            for op, row in sorted(rep["op_classes"].items()))
        print(f"serving {mode}: {rep['requests']} requests, {rep['bytes']} "
              f"bytes in {rep['elapsed_s']} s: {rep['gbps']} GB/s, "
              f"{rep['gbps_under_slo']} GB/s under SLO, p50 "
              f"{rep['p50_ms']} ms, p99 {rep['p99_ms']} ms; {len(fires)} "
              f"fires, mean service {mean_fire:.6f} ms; {per_op}")

    # where a fire's time goes: 16 RS k=8 m=3 1 MiB encodes, staged into
    # a full pool of the paged run's warm queue and stacked at rung 16 in
    # the dense run's warm bucket, each step of the fire timed on its own
    # (host clock, synchronised): copy in, the call, copy out, demux
    rs_1m = serving_spec(True).codecs[1]
    staged = [EcRequest(op="encode", plugin=rs_1m.plugin,
                        profile=rs_1m.profile, stripe_size=rs_1m.stripe_size,
                        payload=rng.integers(0, 256, (K, CHUNK),
                                             dtype=np.uint8), req_id=i)
              for i in range(16)]
    q = serve_runs["paged"].batcher._queue_for(staged[0])
    for r in staged:
        q.pool.write(r.req_id, r.payload)
    check(q.pool.free_pages() == 0, "16 x 1 MiB fill the pool")
    page_mask = q.pool.mask()
    pcall = serve_dispatch_ragged(q.ec, "encode", pages=q.pool.pages,
                                  page_size=q.page_size)
    bk = serve_runs["dense"].batcher._bucket_for(staged[0])
    stack = np.stack([r.payload for r in staged])
    dcall = serve_dispatch_call(bk.ec, "encode")
    anatomy = {}
    for mode in ("paged", "dense"):
        steps = {"copy in": 0.0, "call": 0.0, "copy out": 0.0,
                 "demux": 0.0}
        reps = 5
        for rep in range(reps + 1):
            t = [time.perf_counter()]
            if mode == "paged":
                args = (torch.from_numpy(q.pool.buf).to(dev),
                        torch.from_numpy(page_mask).to(dev))
                call = pcall
            else:
                args = (torch.from_numpy(stack).to(dev),)
                call = dcall
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            out = call(*args)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            host_out = out.cpu().numpy()
            t.append(time.perf_counter())
            got = ([q.pool.read(r.req_id, host_out) for r in staged]
                   if mode == "paged" else list(host_out))
            t.append(time.perf_counter())
            if rep == 0:
                continue           # the first round warms the allocator
            for name, a, b in zip(steps, t, t[1:]):
                steps[name] += (b - a) * 1e3 / reps
        anatomy[mode] = (steps, got, kernel_ms(lambda: call(*args),
                                               "gf_matrix_kernel"))
    check(all(np.array_equal(a, b) for a, b in zip(anatomy["paged"][1],
                                                   anatomy["dense"][1])),
          "paged and dense fires give the same parity")
    for r in staged:
        q.pool.reclaim(r.req_id)
    for mode, (steps, _, k_t) in anatomy.items():
        print(f"serving {mode}, where a fire's time goes (16 x 1 MiB RS "
              f"encodes, " + ("a full pool of 512 pages" if mode == "paged"
                              else "rung 16") + "): "
              + ", ".join(f"{n} {v:.6f} ms" for n, v in steps.items())
              + f", total {sum(steps.values()):.6f} ms; the kernels' "
              f"profiler time in the call "
              + ("not measured" if k_t is None else f"{k_t:.6f} ms"))

    # the column-walk kernel on the clay matrices, beside the dense kernel
    # on the same matrices and the library GEMM (torch._int_mm, else a
    # bf16 matmul) on the materialised bit-planes.  Its bound is the
    # function's: the same GF(2^8) matrix apply the dense kernel bounds,
    # the bytes or sm90_op_floor at the INT32 peak, the larger; the dense
    # GEMM over the whole bitmatrix at the int8 tensor-core peak (the
    # reference MXU form's cost) is printed beside it as the GEMM bound.
    # The (8,) repair routes to the dense kernel; the walk is timed on it
    # too.  "earlier" is the bit-plane kernel this one replaced (a constant
    # from its last run, printed beside this run's times).  A shape whose
    # blocks fill less than a wave splits its columns; the same matrix at
    # BATCH stripes, which takes no split, is timed beside it.
    def planes_of(x):
        """(b, s, C) uint8 -> (8s, b*C) int8 LSB-first bit-planes."""
        b_, s_, c_ = x.shape
        pl = torch.arange(8, dtype=torch.uint8, device=dev)
        bits = (x[:, :, None, :] >> pl[:, None]) & 1
        return bits.reshape(b_, 8 * s_, c_).permute(1, 0, 2).reshape(
            8 * s_, b_ * c_).to(torch.int8).contiguous()

    def library_gemm(bm, xp):
        try:
            torch._int_mm(bm, xp)
            return (lambda: torch._int_mm(bm, xp)), "torch._int_mm"
        except RuntimeError:
            bf, xf = bm.to(torch.bfloat16), xp.to(torch.bfloat16)
            return (lambda: torch.matmul(bf, xf)), "torch.matmul bf16"

    rep_e, rep_dm, rep_ms, rep_avail = big[0]
    rep_x = clay_full[:, list(rep_avail)].reshape(DECODE_BATCH, 704, sc)
    mxu_times = {}
    for label, x, mat_s in (
            ("clay encode", clay_x, clay_enc_ms),
            ("clay decode (0,)", dec_x, clay_dec_ms),
            (f"clay repair ({rep_e},)", rep_x, rep_ms)):
        r_, s_ = len(mat_s), len(mat_s[0])
        b_, _, c_ = x.shape
        xw = pack_chunks(x)
        z_m = walk_splits(b_, c_, mat_s, dev)
        k_m = kernel_ms(lambda: apply_matrix_mxu_cuda(x, mat_s),
                        walk_kernels(z_m))
        k_mp = kernel_ms(lambda: apply_matrix_mxu_cuda_packed(xw, mat_s),
                         walk_kernels(z_m))
        k_m1 = None
        if z_m > 1:
            xb = x.repeat(BATCH // b_, 1, 1)
            check(walk_splits(BATCH, c_, mat_s, dev) == 1,
                  f"{label} at {BATCH} stripes takes no column split")
            k_m1 = kernel_ms(lambda: apply_matrix_mxu_cuda(xb, mat_s),
                             walk_kernels(1))
            del xb
        t_m, h_m = time_ms(lambda: apply_matrix_mxu_cuda(x, mat_s), 10)
        t_pl, h_pl = time_ms(lambda: apply_matrix_walk_torch(
            x, walk_data(mat_s), r_), 1, warmup=1)
        k_d = kernel_ms(lambda: apply_matrix_cuda(x, mat_s), "gf_matrix",
                        iters=5)
        bm_host = mxu_bitmatrix(mat_s)
        bm = torch.from_numpy(bm_host.astype(np.int8)).to(dev)
        lib_fn, lib_name = library_gemm(bm, planes_of(x))
        k_lib = kernel_ms(lib_fn, "", iters=5)
        fn_ops = sm90_op_floor(mat_s)
        moved_x = b_ * (s_ + r_) * c_
        b, b_by = bound_ms(moved_x, fn_ops * (b_ * c_ // 4))
        gemm_ops = 2 * (8 * r_) * (8 * s_) * b_ * c_
        gemm_b, _ = bound_ms(moved_x, gemm_ops, INT8_OPS_PER_S)
        mxu_times[label] = (k_m or t_m, k_mp or t_m, t_pl, b, b_by, k_lib,
                            k_d, gemm_b)
        wd = walk_data(mat_s)
        print(f"bound of the {label} {tuple(x.shape)} -> {r_} rows: "
              f"{moved_x} bytes moved, {fn_ops} int32 ops per word position "
              f"x {b_ * c_ // 4} word positions -> {b:.6f} ms, by {b_by}; "
              f"as a dense GEMM {gemm_ops} int8 operations -> "
              f"{gemm_b:.6f} ms ({np.count_nonzero(mat_s)} nonzero of "
              f"{r_ * s_} coefficients; column-walk data {wd.size * 4} "
              f"bytes, {int(wd[0])} row tile(s), "
              f"{int(np.count_nonzero(np.asarray(mat_s).any(axis=0)))} "
              f"nonzero columns; {int(bm_host.sum())} ones of the "
              f"bitmatrix)")
        for name, k_t in (
                (f"column-walk kernel (bytes, {z_m} column splits)", k_m),
                ("column-walk kernel (packed)", k_mp),
                ("dense kernel on the same matrix", k_d),
                (f"{lib_name} on the materialised planes", k_lib)):
            print(f"time {label}, {name}, profiler device time per call: "
                  + ("not measured" if k_t is None
                     else f"{k_t:.6f} ms, {b / k_t:.4f} of bound, "
                          f"{gemm_b / k_t:.4f} of the GEMM bound"))
        if z_m > 1:
            print(f"time {label} at {BATCH} stripes, column-walk kernel "
                  f"(bytes, no column split), profiler device time per "
                  f"call: " + ("not measured" if k_m1 is None else
                               f"{k_m1:.6f} ms, {k_m1 * b_ / BATCH:.6f} ms "
                               f"per {b_} stripes"))
        print(f"time {label}, column-walk kernel events {t_m:.6f} ms "
              f"device, {h_m:.6f} ms host issue; plain walk {t_pl:.6f} ms; "
              f"earlier (the bit-plane kernel, {EARLIER_CARD}) "
              f"{EARLIER_MXU_MS[label]} ms")
    # the host's issue time per call through the entry points a user
    # calls (the engine table, the kernel-data caches, the launch)
    rep_surv = clay_full[:, list(rep_avail)]
    dec_surv = clay_full[:, list(a1_clay)]
    for name, fn in (
            ("encode_chunks_torch (64 x 1 MiB)",
             lambda: clay.encode_chunks_torch(clay_data)),
            ("decode_chunks_torch (0,) (4 stripes)",
             lambda: clay.decode_chunks_torch(dec_surv, a1_clay, e1_clay)),
            (f"decode_chunks_torch ({rep_e},) (4 stripes)",
             lambda: clay.decode_chunks_torch(rep_surv, rep_avail,
                                              (rep_e,)))):
        t_e, h_e = time_ms(fn, 20)
        print(f"time clay {name}: {t_e:.6f} ms device, {h_e:.6f} ms host "
              f"issue per call")
    for what, sec in clay_probe_s.items():
        print(f"time clay composite probe, {what}: {sec:.6f} s host clock")

    # the roofline probes' kernels on one 64 MiB slab.  The copy kernel
    # beside copy_ into a buffer allocated once (the library copy) and
    # clone (copy_ into a fresh tensor, as the wrapper allocates its
    # output), in turns: copy_, clone, kernel, kernel, clone, copy_
    copy_buf = torch.empty_like(slab.view(torch.int32))
    copies = {"copy_": (lambda: copy_buf.copy_(slab.view(torch.int32)), ""),
              "clone": (lambda: slab.view(torch.int32).clone(), ""),
              "copy kernel": (lambda: copy_slab_cuda(slab), "probe_copy")}
    turns = {name: [] for name in copies}
    for name in ("copy_", "clone", "copy kernel", "copy kernel", "clone",
                 "copy_"):
        turns[name].append(kernel_ms(*copies[name], iters=50))
    for name, ts in turns.items():
        print(f"time {name} on {tuple(slab.shape)}, profiler ms in turns: "
              + ", ".join("not measured" if t is None else f"{t:.6f}"
                          for t in ts))
    k_copy, k_copy_lib, k_clone = (
        None if None in turns[n] else sum(turns[n]) / len(turns[n])
        for n in ("copy kernel", "copy_", "clone"))
    k_fold = kernel_ms(lambda: fold_slab_cuda(slab), "probe_fold")
    t_copy, _ = time_ms(lambda: copy_slab_cuda(slab), 10)
    t_fold, _ = time_ms(lambda: fold_slab_cuda(slab), 10)
    t_copy_pl, _ = time_ms(lambda: copy_slab_torch(slab), 10)
    t_fold_pl, _ = time_ms(lambda: fold_slab_torch(slab), 10)
    copy_b, copy_by = bound_ms(2 * slab.numel() * 4, 0)
    fold_b, fold_by = bound_ms(slab.numel() * 4 * (K + 1) // K,
                               slab.numel() * (K - 1) // K)
    for name, k_t, b in (("copy kernel", k_copy, copy_b),
                         ("fold kernel", k_fold, fold_b),
                         ("copy_ (the library copy)", k_copy_lib, copy_b),
                         ("clone (copy_ into a fresh tensor)", k_clone,
                          copy_b)):
        moved = 2 * slab.numel() * 4 if "copy" in name \
            else slab.numel() * 4 * (K + 1) // K
        print(f"time {name} on {tuple(slab.shape)}: "
              + ("not measured" if k_t is None else
                 f"{k_t:.6f} ms, {moved / k_t / 1e6:.3f} GB/s moved, "
                 f"{b / k_t:.4f} of bound"))

    # each kernel's "ms" is its own device time per launch from the
    # profiler (the event times above include the host's issue pace where
    # that is the slower); the event time where the trace has no kernel
    w16 = word_data[16][1]
    w16_ms = matrix_to_static(wide_codes[16].matrix)
    prof = {name: kernel_ms(fn, kernel) for name, fn, kernel in (
        ("apply_matrix_cuda", lambda: apply_matrix_cuda(data, ms),
         "gf_matrix_kernel"),
        ("apply_matrix_cuda_packed",
         lambda: apply_matrix_cuda_packed(words, ms), "gf_matrix_kernel"),
        ("apply_matrix_cuda_words",
         lambda: apply_matrix_cuda_words(w16, w16_ms, 16),
         "gf_matrix_kernel"),
        ("apply_bitmatrix_cuda",
         lambda: apply_bitmatrix_cuda(data, rows, 8, PACKETSIZE),
         "gf2_packet_kernel"),
        ("apply_bitmatrix_xor_cuda", lambda: apply_bitmatrix_xor_cuda(
            data, enc_sched.static, 8, PACKETSIZE), "gf2_packet_kernel"))}
    for name, k_t in prof.items():
        print(f"time {name} at its main shape, profiler device time per "
              f"launch: " + ("not measured (no kernel in the trace)"
                             if k_t is None else f"{k_t:.6f} ms"))
    kernels = []
    for name, t, tp, b, b_by, source, line in (
            ("apply_matrix_cuda", prof["apply_matrix_cuda"] or t_bytes,
             t_plain, bound, bound_by, "gf8_matrix.cu", 195),
            ("apply_matrix_cuda_packed",
             prof["apply_matrix_cuda_packed"] or t_packed, t_plain_packed,
             bound, bound_by, "gf8_matrix.cu", 350),
            ("apply_matrix_cuda_words",
             prof["apply_matrix_cuda_words"] or word_times[16][0],
             word_times[16][2], word_times[16][4], word_times[16][5],
             "gf8_matrix.cu", 283),
            ("apply_bitmatrix_cuda", prof["apply_bitmatrix_cuda"] or t_bm,
             t_bm_plain, bm_bound, bm_by, "gf2_bitmatrix.cu", 559),
            ("apply_bitmatrix_xor_cuda",
             prof["apply_bitmatrix_xor_cuda"] or t_xs, t_xs_plain, xs_bound,
             xs_by, "gf2_bitmatrix.cu", 782),
            ("apply_matrix_xor_cuda", xor_times["r6 encode"][0],
             xor_times["r6 encode"][2], xor_times["r6 encode"][4],
             xor_times["r6 encode"][5], "gf8_xor_schedule.cu", 623),
            ("apply_matrix_xor_cuda_packed", xor_times["r6 encode"][1],
             xor_times["r6 encode"][3], xor_times["r6 encode"][4],
             xor_times["r6 encode"][5], "gf8_xor_schedule.cu", 664),
            ("apply_matrix_cuda_ragged", rag_times[0.5][0], rag_times[0.5][2],
             rag_times[0.5][4], rag_times[0.5][5], "gf8_matrix.cu", 1253),
            ("apply_matrix_cuda_packed_ragged", rag_times[0.5][1],
             rag_times[0.5][3], rag_times[0.5][4], rag_times[0.5][5],
             "gf8_matrix.cu", 1294)):
        kernels.append({
            "name": name, "route": "cuda", "source": SRC + source,
            "replaces": f"ceph_tpu/ops/pallas_gf.py:{line}",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": t, "plain_ms": tp, "bound_ms": b, "bound_by": b_by,
            "library_ms": None, "ok": True})
    enc_t = mxu_times["clay encode"]
    for name, t, tp, b, b_by, lib_t, source, replaces in (
            ("apply_matrix_mxu_cuda", enc_t[0], enc_t[2], enc_t[3],
             enc_t[4], enc_t[5], "gf8_column_walk.cu",
             "ceph_tpu/ops/xla_ops.py:241"),
            ("apply_matrix_mxu_cuda_packed", enc_t[1], enc_t[2], enc_t[3],
             enc_t[4], enc_t[5], "gf8_column_walk.cu",
             "ceph_tpu/ops/xla_ops.py:241"),
            ("copy_slab_cuda", k_copy or t_copy, t_copy_pl, copy_b,
             copy_by, k_copy_lib, "roofline_probes.cu",
             "tools/roofline.py:79"),
            ("fold_slab_cuda", k_fold or t_fold, t_fold_pl, fold_b,
             fold_by, None, "roofline_probes.cu", "tools/roofline.py:106")):
        kernels.append({
            "name": name, "route": "cuda", "source": SRC + source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": t, "plain_ms": tp,
            "bound_ms": b, "bound_by": b_by, "library_ms": lib_t,
            "ok": True})
    # -- phase 5: the bench line's rows and the corpus, on the card ---------
    print(json.dumps({"bench": bench_phase(kernel_ms)}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
