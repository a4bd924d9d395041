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
     no leading batch dimension, a strided survivor slice;
   - the w=16/32 word kernel: the reed_sol_van k=8 m=3 matrices at (64,
     8, 65536) words, random matrices, a tail, a strided slice;
   - the packet-layout bitmatrix kernel through both its wrappers (the
     plain product and a CSE schedule): the jerasure cauchy_good k=8 m=3
     bitmatrix (packetsize 2048) and its e=2 decode schedule at (64, 8,
     131072), and random bitmatrices for w in {6, 7, 8} and packetsizes
     {8, 32, 2048}, with and without a leading batch dimension, through a
     strided survivor slice;

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
     batch through ``decode_chunks_torch``;
   - minimal density: liberation k=7 w=7, blaum_roth k=6 w=6 and
     liber8tion k=8, an encode and a decode each;
   - wide words: reed_sol_van w=16 and w=32 k=8 m=3, an encode and a
     3-erasure decode each;
4. times each kernel, its plain version and a copy of the same bytes
   with CUDA events at its main shape, with the host's issue time beside
   it, against the bound (the larger of the bytes over HBM bandwidth
   and the integer ops over the INT32 peak), and prints one JSON line
   ``{"kernels": [...]}``.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Any failed check raises, so the script exits non-zero and prints no
result.  Without a CUDA device, or without the package beside it, it
exits non-zero before printing anything to standard output.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time

# H100 SXM peaks: HBM3 bandwidth (NVIDIA data sheet), and the INT32 rate
# of the SMs outside the tensor cores: 132 SMs x 64 INT32 lanes x 1.98 GHz
# boost clock.  The SWAR xtime/XOR walks and the packet XORs are INT32
# work, counted at the least they need on sm_90 (4 instructions per
# xtime at w=8 and w=16, 3 at w=32, XORs folded three at a time by LOP3:
# gf_kernels.sm90_op_count, bitmatrix_op_count, schedule_op_count).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

K, M, BATCH, CHUNK = 8, 3, 64, 128 * 1024     # 64 x 1 MiB stripes
DECODE_BATCH = 4
PACKETSIZE = 2048                             # jerasure's default
WORDS = 65536                                 # w=16/32 words per chunk
SRC = "ceph_tpu_torch/ops/csrc/"


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


def bound_ms(moved_bytes: int, ops: int) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    HBM bandwidth and the integer ops over the INT32 peak."""
    t_mem = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
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
    from ceph_tpu_torch.ops.gf_kernels import (
        apply_bitmatrix_cuda, apply_bitmatrix_xor_cuda, apply_matrix_cuda,
        apply_matrix_cuda_packed, apply_matrix_cuda_words,
        bitmatrix_op_count, dense_op_count, pack_chunks, schedule_op_count,
        sm90_op_count, unpack_chunks)
    from ceph_tpu_torch.ops.torch_ops import (
        WORD_DTYPE, apply_bitmatrix_torch, apply_bitmatrix_xor_torch,
        apply_matrix_torch, bitmatrix_to_static, matrix_to_static)
    from ceph_tpu_torch.ops.xor_schedule import probe_bitmatrix_schedule

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

    # -- phase 3: the paths, through the user's entry points ----------------
    counts = gf_kernels.launch_counts
    reset = gf_kernels.reset_launch_counts
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
    bound, bound_by = bound_ms(moved, sm90_op_count(ms) * words_per_chunk)
    print(f"bound of the encode: {moved} bytes moved, "
          f"{sm90_op_count(ms)} int32 ops per word position (reference "
          f"dense cost model: {dense_op_count(ms)}) x {words_per_chunk} "
          f"word positions -> {bound:.6f} ms, by {bound_by}")

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
                                 sm90_op_count(dm) * words_per_chunk)
    print(f"bound of decode e=2 {erased}: {sm90_op_count(dm)} int32 ops "
          f"per word position (reference dense cost model: "
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
                             sm90_op_count(wms, w) * w_pos)
        word_times[w] = (t_w, h_w, t_wp, h_wp, wb, wb_by)
        print(f"bound of reed_sol_van w={w} encode at (64, 8, {WORDS}) "
              f"words: {w_bytes * (K + M) // K} bytes moved, "
              f"{sm90_op_count(wms, w)} int32 ops per word position x "
              f"{w_pos}"
              f" -> {wb:.6f} ms, by {wb_by}")

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

    kernels = []
    for name, t, tp, b, b_by, source, line in (
            ("apply_matrix_cuda", t_bytes, t_plain, bound, bound_by,
             "gf8_matrix.cu", 195),
            ("apply_matrix_cuda_packed", t_packed, t_plain_packed, bound,
             bound_by, "gf8_matrix.cu", 350),
            ("apply_matrix_cuda_words", word_times[16][0],
             word_times[16][2], word_times[16][4], word_times[16][5],
             "gf8_matrix.cu", 283),
            ("apply_bitmatrix_cuda", t_bm, t_bm_plain, bm_bound, bm_by,
             "gf2_bitmatrix.cu", 559),
            ("apply_bitmatrix_xor_cuda", t_xs, t_xs_plain, xs_bound, xs_by,
             "gf2_bitmatrix.cu", 782)):
        kernels.append({
            "name": name, "route": "cuda", "source": SRC + source,
            "replaces": f"ceph_tpu/ops/pallas_gf.py:{line}",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": t, "plain_ms": tp, "bound_ms": b, "bound_by": b_by,
            "library_ms": None, "ok": True})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
