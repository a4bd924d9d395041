"""Closed-loop single-chunk repairs of a clay code on resident slabs
(``op: decode``).

Before anything is staged, the codec's repair entry is called once on
one stripe of zeros: a program without it (no ``chunk_size`` on
``decode_chunks_torch``) fails there, at once.  Set-up then makes, from
the seed, one slab per single-chunk loss (every chunk, data and parity):
the d helpers' repair sub-chunks, as ECBackend hands them to ``decode``
after reading the runs ``minimum_to_decode`` names, (stripes, d, repair
sub-chunks x sub-chunk bytes) on the card.  The parity comes from the
plain reference's encode (``yardstick/clay.py``), whose seconds are not
set-up's; the program's ``minimum_to_decode`` must name the reference's
helpers and runs.  Requests take the slabs in a seeded permutation,
cycled, up to ``in_flight`` queued on the card's stream; a request is
one ``decode_chunks_torch(planes, helpers, (lost,), chunk_size=C)`` on
``stripes_per_request`` stripes.

After the window a seeded reservoir of ``sample_requests`` answers is
compared byte for byte with the chunk they replace: the data itself, or
the reference's parity.
"""

from __future__ import annotations

import gc
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from .. import costs
from ..clay import Clay
from ..faults import EC_FAULTS, _flip
from ..record import Check, Run
from ..trace import Tracer
from .ec_stream import _codec, _marker, _Reservoir, _sync


@dataclass
class RepairRun(Run):
    stripes: int = 0          # stripes a request


def resolve(code, ref: Clay, chunk: int, device) -> None:
    """One repair of chunk 0 from a stripe of zeros, or a clear error."""
    helpers = ref.helpers(0)
    width = len(ref.repair_planes(0)) * chunk // ref.sub
    x = torch.zeros((1, ref.d, width), dtype=torch.uint8, device=device)
    try:
        out = code.decode_chunks_torch(x, helpers, (0,), chunk_size=chunk)
    except TypeError as e:
        raise RuntimeError(
            "the program's clay decode_chunks_torch has no sub-chunk "
            "repair (decode_chunks_torch(planes, helpers, (lost,), "
            "chunk_size=C))") from e
    if tuple(out.shape) != (1, 1, chunk):
        raise RuntimeError(f"the repair entry answered {tuple(out.shape)} "
                           f"for (1, 1, {chunk})")


def _plan_of(ref: Clay, lost: int) -> dict:
    """minimum_to_decode's answer for ``lost``: {helper: [(offset,
    count)]} runs of the repair planes."""
    runs = []
    for z in ref.repair_planes(lost):
        if runs and runs[-1][0] + runs[-1][1] == z:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1)
        else:
            runs.append((z, 1))
    return {h: runs for h in ref.helpers(lost)}


def stage(cell, seed: int, device: torch.device):
    """(code, reference, slabs, the chunks they rebuild, lost chunk per
    slab, chunk bytes, seconds of the plain reference)."""
    profile, traffic = cell.config["profile"], cell.traffic
    code = _codec(profile, device)
    ref = Clay.from_profile(profile)
    chunk = code.get_chunk_size(cell.config["stripe_bytes"])
    resolve(code, ref, chunk, device)
    k, n = ref.k, ref.k + ref.m
    b = traffic["stripes_per_request"]
    sc = chunk // ref.sub
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & 0xFFFFFFFFFFFF)
    slabs, expected, lost_of = [], [], []
    ref_s = 0.0
    for lost in range(n):
        plan = _plan_of(ref, lost)
        got = code.minimum_to_decode({lost}, set(range(n)) - {lost})
        if {c: list(r) for c, r in got.items()} != plan:
            raise RuntimeError(f"minimum_to_decode names {got} for chunk "
                               f"{lost}; the reference reads {plan}")
        helpers, planes = tuple(plan), ref.repair_planes(lost)
        for _ in range(traffic["slabs_per_loss"]):
            data = torch.randint(0, 256, (b, k, chunk), dtype=torch.uint8,
                                 device=device, generator=gen)
            _sync(device)
            a = time.perf_counter()
            parity = ref.encode(data)
            _sync(device)
            ref_s += time.perf_counter() - a
            full = torch.cat([data, parity], dim=1)
            del data, parity
            slabs.append(full[:, list(helpers)].reshape(
                b, ref.d, ref.sub, sc)[:, :, planes].reshape(b, ref.d, -1)
                .contiguous())
            expected.append(full[:, lost:lost + 1].clone())
            lost_of.append(lost)
            del full
    return code, ref, slabs, expected, lost_of, chunk, ref_s


def _entry(name, program, ref: Clay):
    """``program`` with the control or fault ``name`` planted
    (``None``: as it is)."""
    if name is None:
        return program
    if name == "control":
        return lambda x, helpers, lost: _flip(ref.repair(x, lost, helpers))
    if name == "alter":
        return lambda x, helpers, lost: _flip(program(x, helpers, lost))
    if name == "half":
        def half(x, helpers, lost):
            out = program(x[:x.shape[0] // 2], helpers, lost)
            rest = torch.zeros((x.shape[0] - out.shape[0],) + out.shape[1:],
                               dtype=out.dtype, device=out.device)
            return torch.cat([out, rest])
        return half
    raise ValueError(f"unknown EC fault {name!r}; one of {EC_FAULTS}")


def run(cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, inject=None) -> Run:
    from ceph_tpu_torch.ops.launches import launch_counts, \
        reset_launch_counts
    traffic = cell.traffic
    if traffic["op"] != "decode":
        raise ValueError("ec_repair traffic is op decode")
    t_stage = time.perf_counter()
    code, ref, slabs, expected, lost_of, chunk, ref_s = stage(cell, seed,
                                                              device)
    b = traffic["stripes_per_request"]
    depth = traffic["in_flight"]
    sub, sc = ref.sub, chunk // ref.sub
    # the least device time of a request: the reference's repair
    # composite of each loss, (sub, d * n_rp) over sub-chunk rows, the
    # mean over the slabs, which the window takes equally often
    a = time.perf_counter()
    costs_s = []
    for lost in lost_of:
        mat = ref.repair_composite(lost)
        costs_s.append(costs.roofline_s(costs.gf_apply_cost(
            b, mat.shape[1], sub, sc, mat)))
    ref_s += time.perf_counter() - a
    bound_s = float(np.mean([c[0] for c in costs_s]))
    bound_by = "+".join(sorted({c[1] for c in costs_s}))
    t_warm = time.perf_counter()

    def program(x, helpers, lost):
        return code.decode_chunks_torch(x, helpers, (lost,),
                                        chunk_size=chunk)

    entry = _entry(inject, program, ref)
    helpers_of = [ref.helpers(lost) for lost in lost_of]
    rng = np.random.default_rng([seed, 0xEC])
    order = rng.permutation(len(slabs))

    def call(s):
        return entry(slabs[s], helpers_of[s], lost_of[s])

    hold = traffic["sample_requests"] + depth + 1
    warm = [call(s) for s in range(len(slabs))]
    warm += [call(int(order[0])) for _ in range(hold)]
    _sync(device)
    del warm
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

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
    gc.collect()
    gc.freeze()
    tracer = None
    if trace:
        with Tracer(device) as tracer:
            t0, t1 = window()
    else:
        t0, t1 = window()
    setup_s = t0 - t_start - ref_s
    launches = sum(launch_counts().values())

    run = RepairRun(op="decode", setup_s=setup_s, t0=t0, t1=t1,
                    work=float(b * ref.k * chunk), issued=np.array(issued),
                    done=np.array(done), spans=spans, launches=launches,
                    bound_s=bound_s, bound_by=bound_by, stripes=b)
    if tracer is not None:
        run.trace = tracer.reduce(spans)
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else 0)
    run.setup_parts = {"before": t_stage - t_start,
                       "stage": t_warm - t_stage - ref_s,
                       "warm": t0 - t_warm,
                       "reference (not counted)": ref_s}

    t_check = time.perf_counter()
    kept = sorted(sample.kept, key=lambda rs: rs[0])
    mismatched, wrong = 0, 0
    for r, out in kept:
        want = expected[slab_of[r]]
        bad = int((out != want).sum()) if out.shape == want.shape \
            else int(want.numel())
        mismatched += bad
        wrong += bad > 0
    run.checks = [Check("mismatched_bytes", mismatched, 0),
                  Check("unanswered_requests", len(issued) - len(done), 0)]
    run.sampled = len(kept)
    run.failed = wrong + len(issued) - len(done)
    run.check_s = time.perf_counter() - t_check
    return run


__all__ = ["RepairRun", "resolve", "run", "stage"]
