"""Closed-loop erasure-code requests on resident slabs: full-stripe
writes (``op: encode``) or degraded reads (``op: decode``).

Set-up makes every slab on the card from the seed: data stripes, and
for reads each slab's survivor stack with the parity worked out by the
plain reference (``gf256``), one slab set per loss pattern (every
``lost_data_chunks``-subset of the data chunks).  Requests take the
slabs in a seeded permutation, cycled, so every seed does the same work
in another order.  Up to ``in_flight`` requests are queued on the
card's stream; when the oldest completes the next is issued.  A request
is one call of the codec's ``encode_chunks_torch`` or
``decode_chunks_torch`` on ``stripes_per_request`` stripes; its latency
runs from the host clock at issue to the return of a synchronise on its
own CUDA event.

After the window a seeded reservoir of ``sample_requests`` answers is
compared byte for byte: parity with the reference's encode of the same
slab, rebuilt chunks with the data they replace.
"""

from __future__ import annotations

import gc
import itertools
import time
from collections import deque

import numpy as np
import torch

from .. import costs, faults, gf256
from ..record import Check, Run
from ..trace import Tracer


def _codec(profile: dict, device: torch.device):
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    args = {k: v for k, v in profile.items() if k != "plugin"}
    return ErasureCodePluginRegistry.instance().factory(
        profile["plugin"], args, device=device)


class _Reservoir:
    """A seeded uniform sample of ``size`` of the answers seen."""

    def __init__(self, size: int, rng) -> None:
        self.size, self.rng, self.seen, self.kept = size, rng, 0, []

    def offer(self, item) -> None:
        if len(self.kept) < self.size:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(self.seen + 1))
            if j < self.size:
                self.kept[j] = item
        self.seen += 1


def _marker(device):
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stage(cell, seed: int, device: torch.device):
    """(code, slabs, lost data per slab, loss patterns per slab, chunk
    bytes, seconds of the plain reference's encode): every input of the
    window, made on ``device`` from the seed."""
    profile, traffic = cell.config["profile"], cell.traffic
    code = _codec(profile, device)
    k, m = int(profile["k"]), int(profile["m"])
    chunk = code.get_chunk_size(cell.config["stripe_bytes"])
    b = traffic["stripes_per_request"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & 0xFFFFFFFFFFFF)
    matrix = gf256.coding_matrix(profile)

    def data():
        return torch.randint(0, 256, (b, k, chunk), dtype=torch.uint8,
                             device=device, generator=gen)

    if traffic["op"] == "encode":
        slabs = [data() for _ in range(traffic["slabs"])]
        return (code, slabs, [None] * len(slabs), [None] * len(slabs),
                chunk, 0.0)
    slabs, lost_data, patterns = [], [], []
    ref_s = 0.0
    for lost in itertools.combinations(range(k),
                                       traffic["lost_data_chunks"]):
        avail = tuple(c for c in range(k + m) if c not in lost)
        for _ in range(traffic["slabs_per_pattern"]):
            d = data()
            _sync(device)
            a = time.perf_counter()
            parity = gf256.encode(d, matrix)
            _sync(device)
            ref_s += time.perf_counter() - a
            full = torch.cat([d, parity], dim=1)
            slabs.append(full[:, list(avail)].contiguous())
            lost_data.append(d[:, list(lost)].contiguous())
            patterns.append((avail, lost))
            del d, parity, full
    return code, slabs, lost_data, patterns, chunk, ref_s


def run(cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, inject=None) -> Run:
    from ceph_tpu_torch.ops.launches import launch_counts, \
        reset_launch_counts
    profile, traffic = cell.config["profile"], cell.traffic
    op = traffic["op"]
    matrix = gf256.coding_matrix(profile)
    t_stage = time.perf_counter()
    code, slabs, lost_data, patterns, chunk, ref_s = stage(cell, seed,
                                                           device)
    t_warm = time.perf_counter()
    k = int(profile["k"])
    b = traffic["stripes_per_request"]
    depth = traffic["in_flight"]

    def program(x, available, lost):
        if op == "encode":
            return code.encode_chunks_torch(x)
        return code.decode_chunks_torch(x, available, lost)

    entry = faults.ec_entry(inject, program, op, matrix)
    rng = np.random.default_rng([seed, 0xEC])
    order = rng.permutation(len(slabs))

    def call(s):
        avail, lost = patterns[s] if patterns[s] else (None, None)
        return entry(slabs[s], avail, lost)

    # warm: every slab's shape and pattern, and as many live answers as
    # the window holds, so that nothing builds or allocates inside it
    hold = traffic["sample_requests"] + depth + 1
    warm = [call(s) for s in range(len(slabs))]
    warm += [call(int(order[0])) for _ in range(hold)]
    _sync(device)
    del warm
    # the peak is the window's own: slabs, answers in flight and kept
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # the least device time of a request: the mean over the slabs, which
    # the window takes equally often
    if op == "encode":
        costs_s = [costs.roofline_s(costs.gf_apply_cost(
            b, k, int(profile["m"]), chunk, matrix))]
    else:
        costs_s = [costs.roofline_s(costs.gf_apply_cost(
            b, costs.min_reads(profile, lost), len(lost), chunk))
            for _, lost in patterns]
    bound_s = float(np.mean([c[0] for c in costs_s]))
    bound_by = "+".join(sorted({c[1] for c in costs_s}))

    sample = _Reservoir(traffic["sample_requests"],
                        np.random.default_rng([seed, 0x5A]))
    issued, done, slab_of = [], [], []
    spans = {"issue": [], "wait": []}
    inflight = deque()

    def complete():
        r, ev, out = inflight.popleft()
        a = time.perf_counter()
        if ev is not None:
            ev.synchronize()
        t = time.perf_counter()
        spans["wait"].append((a, t))
        done.append(t)
        sample.offer((r, out))

    def window():
        t0 = time.perf_counter()
        t_end = t0 + seconds
        r = 0
        while time.perf_counter() < t_end:
            if len(inflight) >= depth:
                complete()
                continue
            s = int(order[r % len(order)])
            a = time.perf_counter()
            out = call(s)
            t = time.perf_counter()
            inflight.append((r, _marker(device), out))
            issued.append(a)
            slab_of.append(s)
            spans["issue"].append((a, t))
            r += 1
        while inflight:
            complete()
        return t0, t_end

    reset_launch_counts()
    # set-up's objects leave the collector's scans: a full collection
    # over them stalls the loop for tens of milliseconds
    gc.collect()
    gc.freeze()
    tracer = None
    if trace:
        with Tracer(device) as tracer:
            t0, t1 = window()
    else:
        t0, t1 = window()
    # the plain reference's seconds are the check's, not set-up's
    setup_s = t0 - t_start - ref_s
    launches = sum(launch_counts().values())

    run = Run(op=op, setup_s=setup_s, t0=t0, t1=t1,
              work=float(b * k * chunk), issued=np.array(issued),
              done=np.array(done),
              spans=spans, launches=launches, bound_s=bound_s,
              bound_by=bound_by)
    if tracer is not None:
        run.trace = tracer.reduce(spans)
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else 0)
    run.setup_parts = {"before": t_stage - t_start,
                       "stage": t_warm - t_stage - ref_s,
                       "warm": t0 - t_warm,
                       "reference (not counted)": ref_s}

    # the comparison, once the window has closed and its peak is read
    t_check = time.perf_counter()
    kept = sorted(sample.kept, key=lambda rs: rs[0])
    expected = {}
    mismatched, wrong = 0, 0
    for r, out in kept:
        s = slab_of[r]
        if s not in expected:
            expected[s] = (gf256.encode(slabs[s], matrix) if op == "encode"
                           else lost_data[s])
        bad = int((out != expected[s]).sum()) if out.shape == \
            expected[s].shape else int(expected[s].numel())
        mismatched += bad
        wrong += bad > 0
    run.checks = [Check("mismatched_bytes", mismatched, 0),
                  Check("unanswered_requests", len(issued) - len(done), 0)]
    run.sampled = len(kept)
    run.failed = wrong + len(issued) - len(done)
    run.check_s = time.perf_counter() - t_check
    return run


__all__ = ["run", "stage"]
