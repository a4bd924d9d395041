"""The traced window: ``torch.profiler`` over the device, and the
reduction of its trace to busy seconds, seconds by device op and idle
seconds by what the host was doing.

The profiler records the device alone (no host op events, so that a
window of thousands of requests stays cheap to read).  The host's own
spans come from the loop's clock; the trace's clock is tied to it by a
marker kernel launched between two synchronisations before the window.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
import time

import torch

from .record import Trace

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    """``with Tracer(device) as t: <window>``; then ``t.reduce(spans)``."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.cuda = device.type == "cuda"

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CUDA if self.cuda
                else torch.profiler.ProfilerActivity.CPU]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._sync()
        a = time.perf_counter()
        torch.empty(1, device=self.device).fill_(1)
        self._sync()
        b = time.perf_counter()
        self.marker_host = (a + b) / 2
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.__exit__(*exc)

    def _device_events(self) -> list:
        tmp = tempfile.mkdtemp(prefix="benchmark-trace-")
        try:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return sorted(((float(e["ts"]), float(e.get("dur", 0.0)), e["name"])
                       for e in events if e.get("ph") == "X"
                       and e.get("cat") in DEVICE_CATS),
                      key=lambda e: e[0])

    def reduce(self, spans: dict) -> Trace:
        """The window's device time, from the first device event (the
        marker) on, with idle gaps named by the host span under them
        ("loop" where none is)."""
        window_s = self.t1 - self.t0
        events = self._device_events() if self.cuda else []
        if not events:
            return Trace(window_s=window_s, busy_s=0.0, op_s={}, gaps_s={})
        offset = self.marker_host - events[0][0] * 1e-6
        lo, hi = self.t0, self.t1
        op_s: dict = {}
        ivals = []
        for ts, dur, name in events[1:]:
            a = max(ts * 1e-6 + offset, lo)
            b = min((ts + dur) * 1e-6 + offset, hi)
            if b <= a:
                continue
            op_s[name] = op_s.get(name, 0.0) + (b - a)
            ivals.append((a, b))
        busy, gaps = 0.0, []
        cur_a, cur_b = lo, lo
        for a, b in ivals:
            if a > cur_b:
                busy += cur_b - cur_a
                gaps.append((cur_b, a))
                cur_a = a
            cur_b = max(cur_b, b)
        busy += cur_b - cur_a
        gaps.append((cur_b, hi))
        flat = sorted((a, b, name) for name, ss in spans.items()
                      for a, b in ss)
        starts = [s[0] for s in flat]
        gaps_s: dict = {}
        for a, b in gaps:
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid) - 1
            name = flat[i][2] if i >= 0 and flat[i][1] >= mid else "loop"
            gaps_s[name] = gaps_s.get(name, 0.0) + (b - a)
        return Trace(window_s=window_s, busy_s=busy, op_s=op_s,
                     gaps_s=gaps_s)


def breakdown(trace: Trace) -> dict:
    """The ten device ops that took most time (names cut to 120
    characters) and the idle seconds by host span, as the result line
    carries them."""
    top = sorted(trace.op_s.items(), key=lambda kv: -kv[1])[:10]
    top = [(n[:120], s) for n, s in top]
    gaps = sorted(trace.gaps_s.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}


__all__ = ["Tracer", "breakdown"]
