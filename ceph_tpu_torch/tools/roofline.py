"""Roofline probes for the encode path, on the card.

    python -m ceph_tpu_torch.tools.roofline [--probe all] [--mib 64]
        [--loop 64] [--layout packed|bytes] [--device cuda|cpu]

A port of the JAX package's ``tools/roofline.py``.  The bench harness
(``bench/erasure_code_benchmark.py::build_chain``) chains S encodes and
XOR-folds each step's parity into a carry.  Its "GB/s" is INPUT bytes /
time, but the memory traffic behind one step is

    read data slab        1.000 x input
    kernel writes parity  m/k   x input          (0.375 at k=8,m=3)
    carry XOR: read parity + read carry + write carry
                          3*m/k x input          (1.125)
    total                ~2.5   x input

These probes separate the terms:

  cuda-fold  carry ^= xor-fold(slab)   -> (1 + 2/k) x input (pure read)
  cuda-copy  identity copy of the slab  -> 2x      (the 2-stream ceiling)
  xor3       carry ^= slab (full size)  -> 3x      (stream ceiling)
  kernel     encode, one-element carry  -> 1.375x  (the kernel alone)
  harness    encode, full parity carry  -> 2.5x    (what the bench runs)

``traffic_mult`` keeps the reference's values, so the rows compare with
its own.  In eager torch the ``cuda-fold`` chain moves more than its
1 + 2/k: the kernel writes 1/k of the input, and the carry XOR then
reads that output, reads the carry and writes it, 1 + 4/k in all (1.5
at k=8), so its ``implied_hbm_gbps`` reads low by (k + 4) / (k + 2)
(a sixth at k=8).

``cuda-fold`` and ``cuda-copy`` run the two hand-written kernels of
``ops/csrc/roofline_probes.cu`` (``ops/probe_kernels.py``); ``kernel``
and ``harness`` run the port's RS k=8 m=3 ``encode_chunks_packed_torch``
(``encode_chunks_torch`` in the bytes layout) through ``build_chain``.
Each probe prints one JSON line with the measured input-rate GB/s, the
traffic multiplier, the implied memory GB/s and the device it ran on.
The default device is the card (no card: the run fails); ``--device
cpu`` runs the plain versions on the host, which measures the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..bench.erasure_code_benchmark import build_chain
from ..codes.registry import ErasureCodePluginRegistry
from ..ops.fallback import resolve_device
from ..ops.gf_kernels import pack_chunks
from ..ops.probe_kernels import copy_slab_cuda, fold_slab_cuda

K, M = 8, 3
CHUNK = 128 * 1024          # the BASELINE stripe / k
PROBES = ("cuda-fold", "cuda-copy", "xor3", "kernel", "harness")


def traffic_mult(name: str) -> float:
    """Memory bytes moved per input byte of one chain step, as the
    reference counts them (cuda-fold moves 1 + 4/k here: see the module
    docstring)."""
    return {"cuda-fold": 1.0 + 2.0 / K, "cuda-copy": 2.0, "xor3": 3.0,
            "kernel": 1.0 + M / K, "harness": 1.0 + 4.0 * M / K}[name]


def make_slabs(mib: int, n_slabs: int, packed: bool,
               device: torch.device, seed: int = 1234):
    """(n_slabs, batch, k, chunk) uint8 slabs (packed: (n_slabs, batch,
    k, R, 128) uint32) of ``mib`` MiB of input each, slab i the seeded
    data XOR i (each byte, or each packed word), made on ``device`` as
    the reference's ``_slabs`` makes them; and the bytes of one slab."""
    batch = (mib << 20) // (K * CHUNK)
    if batch < 1:
        raise ValueError(f"--mib {mib} holds no {K} x {CHUNK} byte stripe")
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.integers(0, 256, size=(batch, K, CHUNK),
                                         dtype=np.uint8)).to(device)
    if packed:
        iota = torch.arange(n_slabs, dtype=torch.int32, device=device)
        words = pack_chunks(data).view(torch.int32)
        slabs = (words[None] ^ iota[:, None, None, None, None]).view(
            torch.uint32)
    else:
        iota = torch.arange(n_slabs, dtype=torch.uint8, device=device)
        slabs = data[None] ^ iota[:, None, None, None]
    return slabs, data.numel()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, slabs, in_bytes_per_chain: int, device: torch.device
           ) -> float:
    """Input GB/s of the best of 3 runs after one warm-up, each ended by
    a device synchronise."""
    fn(slabs)
    _sync(device)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        fn(slabs)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return in_bytes_per_chain / best / 1e9


def probe(name: str, mib: int, loop: int, layout: str,
          device=None) -> dict:
    """Run one probe; returns its JSON row."""
    if name not in PROBES:
        raise SystemExit(f"unknown probe {name}")
    dev = resolve_device(device)
    packed = layout == "packed"
    if name.startswith("cuda-") and not packed:
        raise SystemExit("cuda probes are packed-layout only")
    n_slabs = min(loop, 16)
    reps = -(-loop // n_slabs)
    slabs, slab_bytes = make_slabs(mib, n_slabs, packed, dev)
    total = slab_bytes * n_slabs * reps

    # every probe is one chain of build_chain: "carry" XOR-folds each
    # step's whole output into the carry, "slice" one element of it
    if name == "cuda-fold":
        # pure-read probe: the kernel XOR-folds each stripe's k chunks
        # into one, so every input byte is read once and 1/k is written
        op, chain = fold_slab_cuda, "carry"

        def init(s):
            return torch.zeros((s.shape[1], 1) + tuple(s.shape[3:]),
                               dtype=s.dtype, device=s.device)
    elif name == "cuda-copy":
        # 2-stream probe: the identity copy; the carry reads one word
        op, chain, init = copy_slab_cuda, "slice", None
    elif name == "xor3":
        # carry ^= slab at full size: read slab, read and write carry
        op, chain = (lambda slab: slab), "carry"

        def init(s):
            return torch.zeros(tuple(s.shape[1:]), dtype=s.dtype,
                               device=s.device)
    else:
        # the bench's own chained harness: 'kernel' = chain slice (the
        # encode's own traffic; eager torch runs every step in full),
        # 'harness' = chain carry (full parity XOR-folds)
        ec = ErasureCodePluginRegistry.instance().factory(
            "jerasure", {"technique": "reed_sol_van", "k": str(K),
                         "m": str(M)}, device=dev)
        op = ec.encode_chunks_packed_torch if packed \
            else ec.encode_chunks_torch
        chain = "slice" if name == "kernel" else "carry"

        def init(s):
            return torch.zeros((s.shape[1], M) + tuple(s.shape[3:]),
                               dtype=s.dtype, device=s.device)
    fn = build_chain(op, chain, packed, init, reps)
    gbps = _timed(fn, slabs, total, dev)
    mult = traffic_mult(name)
    return {"probe": name, "layout": layout, "slab_mib": mib,
            "loop": loop, "input_gbps": round(gbps, 1),
            "traffic_mult": mult,
            "implied_hbm_gbps": round(gbps * mult, 1),
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--probe", default="all", choices=("all",) + PROBES)
    ap.add_argument("--mib", type=int, default=64,
                    help="input MiB per slab (default 64, the BASELINE "
                         "north-star slab)")
    ap.add_argument("--loop", type=int, default=64)
    ap.add_argument("--layout", default="packed",
                    choices=["packed", "bytes"])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    a = ap.parse_args(argv)
    names = PROBES if a.probe == "all" else (a.probe,)
    for name in names:
        row = probe(name, a.mib, a.loop, a.layout, a.device)
        print(json.dumps(row))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
