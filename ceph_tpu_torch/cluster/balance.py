"""Device-closed balancer loop — cluster-scale calc_pg_upmaps with a
convergence report; a copy of ``ceph_tpu/cluster/balance.py``.

Per round, the cluster-wide placement scan (PG distribution → per-osd
deviation) runs through the bulk CRUSH evaluator on the map's device
(``engine="bulk"``, or ``"sharded"`` over every member of the
device's kind), move proposals are validated
host-side against the sparse up-sets, and the applied move re-derives
only the touched pg from the cached device result
(crush/balancer.py's incremental path — stage 1 is upmap-invariant).
``engine="host"`` runs the identical loop over the host mapper:
byte-identical proposals by the bulk evaluator's ladder invariant.

The report carries what the acceptance gate needs: iterations, the
max-deviation trajectory, the applied-move count, and the remap
fraction (pgs whose mapping the proposals changed / total pgs).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..crush.balancer import calc_pg_upmaps
from ..crush.osdmap import OSDMap
from ..telemetry import metrics as tel
from ..telemetry.spans import global_tracer


def _downsample(xs: List[float], n: int) -> List[float]:
    if len(xs) <= n:
        return list(xs)
    step = (len(xs) - 1) / (n - 1)
    return [xs[round(i * step)] for i in range(n - 1)] + [xs[-1]]


@dataclass
class BalanceReport:
    """One balance run's accounting (demo/bench/test artifact)."""

    engine: str = "bulk"
    pool_ids: List[int] = field(default_factory=list)
    max_deviation: float = 1.0
    iterations: int = 0
    moves: int = 0
    converged: bool = False
    max_dev_start: float = 0.0
    max_dev_final: float = 0.0
    trajectory: List[float] = field(default_factory=list)
    remapped_pgs: int = 0
    total_pgs: int = 0
    changes: Dict[Tuple[int, int], List[Tuple[int, int]]] = \
        field(default_factory=dict)

    @property
    def remap_fraction(self) -> float:
        return self.remapped_pgs / self.total_pgs if self.total_pgs \
            else 0.0

    def to_dict(self) -> dict:
        return {
            "engine": self.engine,
            "pool_ids": list(self.pool_ids),
            "max_deviation": self.max_deviation,
            "iterations": self.iterations,
            "moves": self.moves,
            "converged": self.converged,
            "max_dev_start": round(self.max_dev_start, 4),
            "max_dev_final": round(self.max_dev_final, 4),
            # bounded: 10k-OSD runs converge over thousands of moves;
            # the artifact keeps an even ~64-point downsample (first
            # and last always included)
            "trajectory": [round(d, 4) for d in _downsample(
                self.trajectory, 64)],
            "remapped_pgs": self.remapped_pgs,
            "total_pgs": self.total_pgs,
            "remap_fraction": round(self.remap_fraction, 6),
        }


def balance_cluster(m: OSDMap, pool_ids: Optional[Sequence[int]] = None,
                    *, max_deviation: float = 1.0,
                    max_iterations: int = 100000,
                    engine: str = "bulk") -> BalanceReport:
    """Run the balancer loop to convergence (or move exhaustion /
    ``max_iterations``) and report the trajectory.

    One stage-1 device evaluation per pool, then host-side incremental
    rounds — the default ``max_iterations`` is sized for 10k-OSD runs,
    where thousands of single-replica moves are normal (each is O(pg
    scan), not O(cluster re-evaluate))."""
    pids = sorted(m.pools) if pool_ids is None else sorted(pool_ids)
    rep = BalanceReport(engine=engine, pool_ids=list(pids),
                        max_deviation=max_deviation)
    rep.total_pgs = sum(m.pools[pid].pg_num for pid in pids)

    def observe(it: int, dev) -> None:
        rep.iterations = it + 1
        rep.trajectory.append(float(max(dev.max(), -dev.min())))

    tracer = global_tracer()
    with tracer.span("cluster.balance", engine=engine,
                     pools=len(pids)):
        changes = calc_pg_upmaps(m, pids, max_deviation=max_deviation,
                                 max_iterations=max_iterations,
                                 engine=engine, on_iteration=observe)
    rep.changes = changes
    rep.moves = sum(len(v) for v in changes.values())
    rep.remapped_pgs = len(changes)
    if rep.trajectory:
        rep.max_dev_start = rep.trajectory[0]
        rep.max_dev_final = rep.trajectory[-1]
    rep.converged = rep.max_dev_final <= max_deviation
    tel.counter("cluster_balancer_iterations", rep.iterations)
    tel.counter("cluster_balancer_moves", rep.moves)
    tel.gauge("cluster_remap_fraction", rep.remap_fraction,
              phase="balance")
    tel.gauge("cluster_balancer_max_dev", rep.max_dev_final)
    return rep


__all__ = ["BalanceReport", "balance_cluster"]
