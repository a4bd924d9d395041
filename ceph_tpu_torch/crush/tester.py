"""CrushTester — mapping sweeps + distribution statistics; a copy of
``ceph_tpu.crush.tester`` whose bulk engine is the port's evaluator.

Mirrors src/crush/CrushTester.{h,cc} (CrushTester::test) and the
crushtool --test CLI surface (src/tools/crushtool.cc): evaluate a rule
for x in [min_x, max_x], aggregate per-device counts, report expected
vs actual placement, optionally show mappings.

Two engines:
- host:  the mapper.py reference loop (any bucket algorithm);
- bulk:  the lane-batched torch evaluator (crush/bulk.py) on
  ``device`` — the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from .mapper import crush_do_rule
from .types import CRUSH_ITEM_NONE, CrushMap


@dataclass
class TestResult:
    num_mappings: int
    num_rep: int
    device_counts: Dict[int, int]
    bad_mappings: int            # mappings with fewer than num_rep devices
    elapsed_s: float
    engine: str
    mappings: Optional[np.ndarray] = None

    @property
    def mappings_per_s(self) -> float:
        return self.num_mappings / self.elapsed_s if self.elapsed_s else 0.0

    def report(self) -> str:
        """crushtool --test --show-statistics style output."""
        lines = [
            f"rule, num_rep {self.num_rep}, num_mappings "
            f"{self.num_mappings} ({self.engine}, "
            f"{self.mappings_per_s:,.0f} mappings/s)"]
        total = sum(self.device_counts.values())
        for dev in sorted(self.device_counts):
            n = self.device_counts[dev]
            lines.append(f"  device {dev}:\t{n}\t[{n / max(total, 1):.4f}]")
        lines.append(f"  bad mappings: {self.bad_mappings}")
        return "\n".join(lines)

    def utilization_report(self, crush_weights: Sequence[int],
                           reweights: Optional[Sequence[int]] = None
                           ) -> str:
        """crushtool --show-utilization style output: per-device actual
        vs expected placements.  Expected share = crush hierarchy
        weight x the reweight fraction actually applied to the run
        (Ceph's effective capacity: crush weight x reweight)."""
        eff = []
        for dev, w in enumerate(crush_weights):
            rw = reweights[dev] if reweights and dev < len(reweights) \
                else 0x10000
            eff.append(max(w, 0) * min(max(rw, 0), 0x10000) / 0x10000)
        total_w = sum(eff) or 1
        placed = sum(self.device_counts.values())
        lines = []
        for dev, w in enumerate(eff):
            n = self.device_counts.get(dev, 0)
            expected = placed * w / total_w
            ratio = n / expected if expected else float("inf") if n else 1.0
            lines.append(f"  device {dev}:\tstored {n}\texpected "
                         f"{expected:.1f}\t[{ratio:.2f}]")
        return "\n".join(lines)


def test_rule(cmap: CrushMap, ruleno: int, num_rep: int,
              min_x: int = 0, max_x: int = 1023,
              weight: Optional[Sequence[int]] = None,
              engine: str = "host",
              keep_mappings: bool = False,
              choose_args=None, device=None) -> TestResult:
    """CrushTester::test equivalent.  ``device`` applies to the bulk
    engine (default: the card)."""
    rules = cmap.cmap.rules if hasattr(cmap, "cmap") else cmap.rules
    if ruleno not in rules:
        raise ValueError(f"rule {ruleno} does not exist "
                         f"(have {sorted(rules)})")
    n = max_x - min_x + 1
    counts: Dict[int, int] = {}
    bad = 0
    if engine == "bulk":
        from .bulk import CompiledCrushMap, bulk_do_rule
        cm = (cmap if isinstance(cmap, CompiledCrushMap)
              else CompiledCrushMap(cmap, choose_args, device=device))
        xs = np.arange(min_x, max_x + 1)
        # untimed warm call: one-time setup (the caching allocator's
        # first blocks, library loads) must not pollute the mappings/s
        # figure (the encode bench warms up the same way)
        bulk_do_rule(cm, ruleno, xs, num_rep, weight=weight,
                     choose_args=choose_args)
        t0 = time.perf_counter()
        out, cnt = bulk_do_rule(cm, ruleno, xs, num_rep, weight=weight,
                                choose_args=choose_args)
        elapsed = time.perf_counter() - t0
        devs, dcnt = np.unique(out[out != CRUSH_ITEM_NONE],
                               return_counts=True)
        counts = {int(d): int(c) for d, c in zip(devs, dcnt)}
        placed = (out != CRUSH_ITEM_NONE).sum(axis=1)
        bad = int((placed < num_rep).sum())
        mappings = out if keep_mappings else None
    elif engine == "host":
        mappings_list: List[List[int]] = []
        t0 = time.perf_counter()
        for x in range(min_x, max_x + 1):
            r = crush_do_rule(cmap, ruleno, x, num_rep, weight=weight,
                              choose_args=choose_args)
            placed = [d for d in r if d != CRUSH_ITEM_NONE]
            for d in placed:
                counts[d] = counts.get(d, 0) + 1
            if len(placed) < num_rep:
                bad += 1
            if keep_mappings:
                mappings_list.append(
                    r + [CRUSH_ITEM_NONE] * (num_rep - len(r)))
        elapsed = time.perf_counter() - t0
        mappings = (np.asarray(mappings_list)
                    if keep_mappings else None)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    from ..utils.perf import global_perf
    perf = global_perf()
    perf.inc(f"crush_mappings_{engine}", n)
    perf.tinc(f"crush_test_time_{engine}", elapsed)
    return TestResult(num_mappings=n, num_rep=num_rep,
                      device_counts=counts, bad_mappings=bad,
                      elapsed_s=elapsed, engine=engine, mappings=mappings)
