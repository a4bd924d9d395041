"""Per-OSD recovery throttle — bounded in-flight repair writes.

A copy of ``ceph_tpu/recovery/throttle.py``.

Reference: osd_recovery_max_active / the AsyncReserver recovery
reservations (src/common/AsyncReserver.h, PeeringState's
RemoteRecoveryReservation machinery): a recovering cluster must not
let repair traffic starve client I/O on any one device, so each OSD
admits a bounded number of concurrent recovery ops and the rest wait
their turn.  Here the orchestrator dispatches in rounds; the throttle
is the per-round admission control: an op is admitted only when EVERY
target OSD it writes to has a free slot, otherwise it defers to the
next round (counted — the report proves the bound held).

Weighted limits: the rateless recovery plan measures
per-shard completion skew — which devices are actually slow — and
feeds it back as a per-OSD weight vector (``set_osd_weights``).  A
weighted OSD's round budget scales down from ``max_inflight``
(floored at one slot, so a slow-but-alive device still makes
progress and a wide op spanning it can never starve forever); an
unweighted OSD keeps the full global limit, so the pre-weights
behavior — and every existing test — is unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Mapping


@dataclass
class OsdRecoveryThrottle:
    """Admit at most ``limit_for(osd)`` recovery write-ops per OSD per
    round (``max_inflight`` scaled by the osd's weight, if any).
    ``admit(targets)`` reserves a slot on every target OSD or none
    (all-or-nothing, so a wide op cannot starve by partially
    reserving); ``reset_round()`` opens the next round.

    Live updates: ``set_osd_weights`` and ``set_scale``
    may land while ops are in flight — the QoS arbiter
    (scenario/qos.py) turns client-SLO burn into a shrinking
    ``scale`` mid-round.  Admission always checks the CURRENT
    effective limit, so a lowered limit can never over-admit: ops
    already holding slots keep them, but no new op is admitted until
    ``release``/``reset_round`` brings the count back under the NEW
    limit (the re-clamp; regression-pinned in
    tests/test_torch_recovery.py)."""

    max_inflight: int = 4
    # osd -> relative speed in (0, 1]; absent = 1.0 (full limit).
    # Fed by rateless completion skew (cluster/rateless.py).
    osd_weights: Dict[int, float] = field(default_factory=dict)
    # global background-pressure multiplier in (0, 1], fed live by
    # the QoS arbiter's burn-rate scale (scenario/qos.py)
    scale: float = 1.0
    inflight: Dict[int, int] = field(default_factory=dict)
    deferrals: int = 0        # lifetime count of refused admissions
    admitted: int = 0         # lifetime count of granted admissions
    released: int = 0         # slots handed back before round reset
    peak: int = 0             # max per-osd admissions ever observed

    def limit_for(self, osd: int) -> int:
        """This OSD's CURRENT per-round admission budget:
        max_inflight scaled by the arbiter's live ``scale`` and the
        osd's weight (both clamped to (0, 1]), never below one slot —
        a slow or yielded device is throttled, not starved."""
        if self.max_inflight <= 0:
            return 0
        w = self.osd_weights.get(int(osd))
        s = min(max(self.scale, 0.0), 1.0)
        if (w is None or w >= 1.0) and s >= 1.0:
            return self.max_inflight
        eff = self.max_inflight * s
        if w is not None and w < 1.0:
            eff *= max(w, 0.0)
        return max(1, int(round(eff)))

    def set_osd_weights(self, weights: Mapping[int, float]) -> None:
        """Install the per-OSD weight vector (replaces any previous
        one) — safe while ops are in flight: existing reservations
        stand, new admissions re-clamp against the new limits
        immediately.  Values clamp into (0, 1] at use; 1.0 entries
        are dropped (identical to absent)."""
        self.osd_weights = {int(o): float(w) for o, w in weights.items()
                            if float(w) < 1.0}
        from ..telemetry import metrics as tel
        tel.event("recovery_throttle_weights",
                  weighted_osds=len(self.osd_weights))

    def set_scale(self, scale: float) -> None:
        """Install the live global scale (the arbiter's burn-rate
        lever).  Same in-flight contract as ``set_osd_weights``: a
        shrinking scale never over-admits, it just stops new
        admissions until releases catch up (re-clamp)."""
        scale = min(max(float(scale), 0.0), 1.0)
        if scale != self.scale:
            self.scale = scale
            from ..telemetry import metrics as tel
            tel.gauge("recovery_throttle_scale", scale)

    def admit(self, targets: Iterable[int]) -> bool:
        from ..telemetry import metrics as tel
        osds = [int(o) for o in targets]
        if any(self.inflight.get(o, 0) >= self.limit_for(o)
               for o in osds):
            self.deferrals += 1
            tel.counter("recovery_throttle_deferrals")
            return False
        for o in osds:
            self.inflight[o] = self.inflight.get(o, 0) + 1
            self.peak = max(self.peak, self.inflight[o])
        self.admitted += 1
        tel.counter("recovery_throttle_admitted")
        return True

    def release(self, targets: Iterable[int]) -> None:
        """Hand back the slots of one completed op (the long-running
        alternative to ``reset_round``).  Floors at zero — releasing
        more than was admitted is a caller bug but must not mint
        phantom capacity — and never bypasses the re-clamp: a
        release under a lowered limit only narrows the gap, admission
        still checks ``limit_for`` live."""
        for o in targets:
            o = int(o)
            cur = self.inflight.get(o, 0)
            if cur > 0:
                self.inflight[o] = cur - 1
        self.released += 1

    def reset_round(self) -> None:
        self.inflight.clear()


__all__ = ["OsdRecoveryThrottle"]
