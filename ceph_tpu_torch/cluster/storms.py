"""Churn-storm convergence at cluster scale — MapChurn through the
incremental path, measured entirely via the bulk evaluator; a copy of
``ceph_tpu/cluster/storms.py``.

The scenario the mon's publication model must absorb: a storm of
epoch-ordered down/out, revive and reweight deltas
(chaos/adversaries.py::MapChurn → crush/incremental.py) hits a
full-size cluster, and the question is how much of the cluster
remaps per epoch and how long until placement is quiescent.  Every
per-epoch measurement is a whole-pool sweep through
``OSDMap.pg_to_up_bulk`` (engine="bulk" — the bulk evaluator on the
map's device, its compiled map reused across all epochs because churn
never edits the crush tree; "sharded" over every member of the
device's kind), diffed row-wise
against the previous epoch's placement.

After the storm fires its event budget, the run DRAINS: every
still-downed osd is revived by its own epoch-ordered incremental, so
the report's trajectory covers the full down→recover→quiescent arc
and ``epochs_to_quiescence`` is the last epoch that remapped any pg.

``verify_storm_equivalence`` is the correctness gate: the incrementally-advanced map, a map
REBUILT at the net final state, and a fresh map fast-forwarded by
``catch_up`` over the recorded deltas must place identically on the
bulk evaluator (and on scalar spot-checks).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..chaos.adversaries import MapChurn
from ..crush.incremental import catch_up, get_epoch
from ..crush.osdmap import OSDMap


@dataclass
class StormReport:
    """One storm run's accounting: per-epoch remap counts over the
    whole cluster, quiescence, and the event mix."""

    seed: int = 0
    engine: str = "bulk"
    pool_ids: List[int] = field(default_factory=list)
    total_pgs: int = 0
    epoch_start: int = 0
    epoch_end: int = 0
    events: int = 0
    drain_events: int = 0
    event_kinds: Dict[str, int] = field(default_factory=dict)
    # epoch -> pgs whose up mapping changed at that epoch
    remapped_per_epoch: List[int] = field(default_factory=list)
    total_remapped: int = 0
    peak_remapped: int = 0

    @property
    def epochs(self) -> int:
        return self.epoch_end - self.epoch_start

    @property
    def epochs_to_quiescence(self) -> int:
        """Epochs from storm start through the LAST epoch that
        remapped any pg (trailing no-op epochs — e.g. reweights CRUSH
        shrugged off — don't extend it)."""
        last = 0
        for i, n in enumerate(self.remapped_per_epoch):
            if n:
                last = i + 1
        return last

    @property
    def mean_remap_fraction(self) -> float:
        if not self.remapped_per_epoch or not self.total_pgs:
            return 0.0
        return (self.total_remapped
                / (len(self.remapped_per_epoch) * self.total_pgs))

    def to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "engine": self.engine,
            "pool_ids": list(self.pool_ids),
            "total_pgs": self.total_pgs,
            "epoch_start": self.epoch_start,
            "epoch_end": self.epoch_end,
            "events": self.events,
            "drain_events": self.drain_events,
            "event_kinds": dict(self.event_kinds),
            "remapped_per_epoch": list(self.remapped_per_epoch),
            "total_remapped": self.total_remapped,
            "peak_remapped": self.peak_remapped,
            "epochs_to_quiescence": self.epochs_to_quiescence,
            "mean_remap_fraction": round(self.mean_remap_fraction, 6),
        }


def _snapshot(m: OSDMap, pids: Sequence[int], engine: str
              ) -> Dict[int, np.ndarray]:
    return {pid: m.pg_to_up_bulk(pid, engine=engine)[0]
            for pid in pids}


def _diff_count(prev: Dict[int, np.ndarray],
                cur: Dict[int, np.ndarray]) -> int:
    """PGs whose up mapping changed (rows compared as sets of slots —
    widths may differ when an override widened an array)."""
    from ..crush.types import CRUSH_ITEM_NONE
    changed = 0
    for pid, a in prev.items():
        b = cur[pid]
        w = max(a.shape[1], b.shape[1])
        if a.shape[1] != w:
            a = np.pad(a, ((0, 0), (0, w - a.shape[1])),
                       constant_values=CRUSH_ITEM_NONE)
        if b.shape[1] != w:
            b = np.pad(b, ((0, 0), (0, w - b.shape[1])),
                       constant_values=CRUSH_ITEM_NONE)
        changed += int((a != b).any(axis=1).sum())
    return changed


def run_churn_storm(m: OSDMap, *, seed: int = 0, events: int = 100,
                    max_down: int = 4,
                    pool_ids: Optional[Sequence[int]] = None,
                    engine: str = "bulk", drain: bool = True,
                    avoid_osds: Sequence[int] = (),
                    churn: Optional[MapChurn] = None,
                    measure_every: int = 1) -> StormReport:
    """Fire a seeded ``events``-epoch churn storm at ``m`` through the
    incremental path, measuring full-cluster remaps per epoch on the
    bulk evaluator; then (``drain``) revive every still-downed osd,
    one epoch each, until the cluster is whole again.

    Thin wrapper over the scenario runner's storm loop
    (scenario/runner.py::drive_storm — THE storm loop; composed
    scenarios step the same churn machinery turn-by-turn under QoS
    arbitration instead of in one burst).

    ``measure_every``: diff the cluster every Nth epoch (>1 trades
    per-epoch resolution for wall time on very large sweeps; the
    remap count then covers the whole stride)."""
    from ..scenario.runner import drive_storm

    return drive_storm(m, seed=seed, events=events, max_down=max_down,
                       pool_ids=pool_ids, engine=engine, drain=drain,
                       avoid_osds=avoid_osds, churn=churn,
                       measure_every=measure_every)


def verify_storm_equivalence(m: OSDMap, churn: MapChurn,
                             base_factory: Callable[[], OSDMap],
                             *, engine: str = "bulk",
                             scalar_samples: int = 16) -> None:
    """The churn-sequence property at cluster scale: ``m`` (advanced
    incrementally) must place every pg identically to (a) a fresh map
    fast-forwarded by ``catch_up`` over the recorded incrementals and
    (b) a map REBUILT with the net final osd state applied as direct
    edits — on the bulk evaluator for every pg, and on the scalar
    pipeline for ``scalar_samples`` evenly-spaced pgs per pool.
    Raises AssertionError on any divergence."""
    m_replay = base_factory()
    catch_up(m_replay, churn.incrementals)
    assert get_epoch(m_replay) == get_epoch(m), \
        f"replay epoch {get_epoch(m_replay)} != {get_epoch(m)}"
    m_rebuilt = base_factory()
    for osd in range(m.max_osd):
        m_rebuilt.osd_weight[osd] = m.osd_weight[osd]
        m_rebuilt.osd_up[osd] = m.osd_up[osd]
        m_rebuilt.osd_exists[osd] = m.osd_exists[osd]
    for pid in sorted(m.pools):
        up_i, pr_i = m.pg_to_up_bulk(pid, engine=engine)
        for label, other in (("catch_up", m_replay),
                             ("rebuilt", m_rebuilt)):
            up_o, pr_o = other.pg_to_up_bulk(pid, engine=engine)
            assert np.array_equal(up_i, up_o) \
                and np.array_equal(pr_i, pr_o), \
                f"pool {pid}: incremental != {label} on {engine}"
        pg_num = m.pools[pid].pg_num
        step = max(1, pg_num // max(scalar_samples, 1))
        for ps in range(0, pg_num, step):
            want = m.pg_to_up_acting_osds(pid, ps)
            assert m_replay.pg_to_up_acting_osds(pid, ps) == want, \
                f"pool {pid} pg {ps}: scalar catch_up divergence"
            assert m_rebuilt.pg_to_up_acting_osds(pid, ps) == want, \
                f"pool {pid} pg {ps}: scalar rebuild divergence"


__all__ = ["StormReport", "run_churn_storm", "verify_storm_equivalence"]
