"""The benchmark's own seeded map churn: one OSD event per epoch, and
the OSD states those events leave.

An event marks an up OSD down and out, revives a down one (up, weight
1.0), or reweights an up OSD within a stated range, with no more than
``max_down`` OSDs down at once.  The sequence of ops is the same for
every seed, so every seed has as many OSDs down at each epoch and does
the same amount of work; the seed picks the OSDs and the weights.  The
same seed gives the same events.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

IN_WEIGHT = 0x10000


@dataclass
class Event:
    op: str       # "down_out", "revive" or "reweight"
    osd: int
    weight: int   # 16.16 weight the OSD has after the event


class OsdStates:
    """up flags and 16.16 weights of every OSD, all up and in at first."""

    def __init__(self, n_osds: int) -> None:
        self.up = np.ones(n_osds, dtype=bool)
        self.weight = np.full(n_osds, IN_WEIGHT, dtype=np.int64)

    def apply(self, ev: Event) -> None:
        self.up[ev.osd] = ev.op != "down_out"
        self.weight[ev.osd] = ev.weight

    def down(self) -> np.ndarray:
        return np.flatnonzero(~self.up)


def events(seed: int, n_osds: int, traffic: dict):
    """Endless seeded events for ``n_osds`` OSDs under a traffic mix's
    ``actions`` (relative odds of each op), ``max_down`` and
    ``reweight_range`` (fractions of 1.0)."""
    rng = np.random.default_rng([seed, 0xC4])
    op_rng = np.random.default_rng(0xC4)
    state = OsdStates(n_osds)
    ops = sorted(traffic["actions"])
    odds = np.array([traffic["actions"][o] for o in ops], dtype=float)
    lo, hi = traffic["reweight_range"]
    while True:
        n_down = int((~state.up).sum())
        allowed = np.array([(op != "down_out" or n_down < traffic["max_down"])
                            and (op != "revive" or n_down > 0)
                            for op in ops])
        p = odds * allowed
        op = ops[int(op_rng.choice(len(ops), p=p / p.sum()))]
        if op == "revive":
            osd = int(rng.choice(state.down()))
            ev = Event(op, osd, IN_WEIGHT)
        else:
            osd = int(rng.choice(np.flatnonzero(state.up)))
            w = 0 if op == "down_out" else \
                int(round(rng.uniform(lo, hi) * IN_WEIGHT))
            ev = Event(op, osd, w)
        state.apply(ev)
        yield ev


__all__ = ["Event", "IN_WEIGHT", "OsdStates", "events"]
