"""Explicit cuda -> torch -> numpy tier policy, with the live tier.

Counterpart of ``ceph_tpu/ops/fallback.py`` (Pallas -> XLA -> numpy).
The tier of a matrix apply follows from where its tensor lives:

- a CUDA tensor runs the hand-written kernel (``"cuda"``);
- a CPU tensor runs the plain torch version (``"torch"``), because the
  caller put it on the CPU;
- ``"numpy"`` (the host ground truth) runs only when forced or demoted.

Two ways move a call off that default, and they are kept apart:

- **A forced tier.** ``CEPH_TPU_ENGINE=cuda|torch|numpy`` (or
  ``force=``) forces one tier for every call, as the reference's
  override does.  A forced torch or numpy tier applies only to tensors
  the caller put on the CPU: on a CUDA tensor it raises, so an
  inherited setting never takes work off the kernel (a caller who
  wants the plain version on the card calls
  ``torch_ops.apply_matrix_torch`` itself).
- **A live demotion**, which only the supervised dispatch plane
  (``ops/supervisor.py``) makes when a dispatch seam reports a
  persistent backend failure: :meth:`FallbackPolicy.demote` steps down
  the ladder torch -> numpy for the tensors the caller put on the CPU
  and for the host rows (``device=None``).  It never applies to a CUDA
  tensor: on the card a wrapper launches its kernel or raises, and the
  supervisor raises ``DeviceDispatchError`` for a persistent failure
  there.  Each step is counted, logged once as a ``fallback_tier``
  event and frozen in the flight recorder by the supervisor; its health
  probe re-promotes with :meth:`FallbackPolicy.promote`.

:func:`numpy_tier` is the thread-local override the supervisor runs
its self-verify ground truth and its host twins under, so a
verification pass never dispatches through the backend it verifies.
There is no automatic drop to the CPU: :func:`resolve_device` raises
when the caller did not ask for the CPU and no CUDA device is present,
and a kernel that fails to build, or fails in a way of its own making,
raises instead of handing its work to a slower tier.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import List, Optional, Tuple

import torch

from ..utils.errors import NoDeviceError
from ..utils.locks import make_lock
from ..utils.log import dout

ENGINES = ("cuda", "torch", "numpy")

class _NumpyDepth(threading.local):
    numpy = 0           # a class default: no AttributeError on a new thread


_tls = _NumpyDepth()


@contextmanager
def numpy_tier():
    """Thread-local numpy-tier override: inside the block every
    ``engine()`` answer is ``"numpy"``, so the host batch surfaces
    (codes/techniques.py) run the ground-truth numpy path without
    mutating process state.  The supervised dispatch plane computes its
    self-verify ground truth and its demoted-completion twins under
    this."""
    _tls.numpy += 1
    try:
        yield
    finally:
        _tls.numpy -= 1


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    the card.  Raises :class:`NoDeviceError` for a CUDA device when
    none is present — only an explicit ``"cpu"`` runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev} is neither cuda nor cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError(
            f"device {dev} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    return dev


class FallbackPolicy:
    """Maps a tensor's device to a compute tier, honouring a forced
    tier (``force`` argument, else ``CEPH_TPU_ENGINE``) and the live
    demotion stack."""

    def __init__(self, force: Optional[str] = None) -> None:
        env = os.environ.get("CEPH_TPU_ENGINE", "").strip().lower()
        self.force = force if force is not None else (env or None)
        if self.force is not None and self.force not in ENGINES:
            raise ValueError(
                f"engine {self.force!r} must be one of {ENGINES}")
        self._lock = make_lock("ops.fallback.FallbackPolicy._lock")
        self._logged: set = set()
        self._kind: Optional[str] = None
        # the live tier (None: not demoted) and the stack of the tiers
        # each demote() replaced, so promote() restores exactly
        self._live: Optional[str] = None
        self._demote_stack: List[Optional[str]] = []
        self.demotions = 0
        self.promotions = 0

    # -- probe -----------------------------------------------------------

    def device_kind(self) -> str:
        """``"cuda"`` when torch sees a card, else ``"cpu"``; cached
        until :meth:`invalidate` (the supervisor calls it around a live
        demotion and a re-promotion)."""
        with self._lock:
            if self._kind is not None:
                return self._kind
        kind = "cuda" if torch.cuda.is_available() else "cpu"
        with self._lock:
            if self._kind is None:
                self._kind = kind
            return self._kind

    def invalidate(self) -> None:
        """Drop the cached :meth:`device_kind`: the next call probes
        again."""
        with self._lock:
            self._kind = None

    def demote(self, to: Optional[str] = None, device=None) -> str:
        """LIVE tier demotion: the next tier down the cuda -> torch ->
        numpy ladder from the tier ``device``'s tensors run now (or the
        explicit ``to``), for CPU tensors and host rows until
        :meth:`promote` (a CUDA tensor keeps its kernel).  Returns the
        new tier; the step is logged and counted."""
        cur = self.engine(device)
        if to is None:
            to = ENGINES[min(ENGINES.index(cur) + 1, len(ENGINES) - 1)]
        if to not in ENGINES:
            raise ValueError(f"demote target {to!r} must be one of "
                             f"{ENGINES}")
        with self._lock:
            self._demote_stack.append(self._live)
            self._live = to
            self.demotions += 1
        self.invalidate()
        dout("ec", 1, f"backend fallback policy: LIVE demotion "
                      f"{cur} -> {to}")
        self._log_once(f"demoted-from-{cur}", to)
        return to

    def promote(self, device=None) -> Optional[str]:
        """Undo the most recent :meth:`demote` (the health probe's
        re-promotion); returns the tier ``device``'s tensors run now, or
        None when nothing was demoted."""
        with self._lock:
            if not self._demote_stack:
                return None
            self._live = self._demote_stack.pop()
            self.promotions += 1
        self.invalidate()
        eng = self.engine(device)
        dout("ec", 1, f"backend fallback policy: re-promoted to "
                      f"engine={eng}")
        return eng

    @property
    def demoted(self) -> bool:
        with self._lock:
            return bool(self._demote_stack)

    # -- selection -------------------------------------------------------

    def engine(self, device=None) -> str:
        """The tier for a tensor on ``device``: "numpy" inside
        :func:`numpy_tier`, the live tier while demoted (CPU tensors and
        host rows only), the forced tier when one is set, else
        ``"cuda"`` on the card and ``"torch"`` on the CPU.  Raises
        ValueError when a torch or numpy tier is forced for a CUDA
        tensor (the numpy tier's own functions raise for one too)."""
        if _tls.numpy:          # inside numpy_tier() (every apply asks)
            return "numpy"
        on_card = device is not None and torch.device(device).type == "cuda"
        live = self._live
        if live is not None and not on_card:
            eng, forced = live, True
        elif self.force is None:
            eng, forced = ("cuda" if on_card else "torch"), False
        elif on_card and self.force != "cuda":
            raise ValueError(
                f"engine {self.force!r} is forced, but the tensor is on "
                f"{device}: the {self.force} tier runs only on CPU tensors")
        else:
            eng, forced = self.force, True
        kind = "cuda" if on_card else "cpu"
        if (kind, eng) not in self._logged:     # the hot path: one lookup
            self._log_once(kind, eng, forced)
        return eng

    def _log_once(self, kind: str, eng: str, forced: bool = False) -> None:
        key: Tuple[str, str] = (kind, eng)
        with self._lock:
            if key in self._logged:
                return
            self._logged.add(key)
        why = ("forced via CEPH_TPU_ENGINE or a live demotion" if forced
               else f"device={kind}")
        dout("ec", 1, f"backend fallback policy: engine={eng} ({why})")
        # the log-once transition is also a counter and a structured
        # event (which the flight recorder's ring keeps): a tier drop
        # mid-fleet is a metric to alert on
        from ..telemetry import metrics as tel
        tel.counter("fallback_tier_transitions", device=kind, engine=eng)
        tel.event("fallback_tier", device=kind, engine=eng, forced=forced,
                  probe_error=None)
        if eng == "numpy" and not forced:
            # an unforced drop to the numpy ground truth — in the port
            # only a live demotion's first step onto the floor (a
            # process without a card raises NoDeviceError instead) — is
            # an outage: freeze the post-mortem, as the reference does
            from ..telemetry import recorder
            recorder.trip("backend_lost",
                          f"fallback to numpy tier: {why}",
                          device=kind, engine=eng)


_global: Optional[FallbackPolicy] = None
_global_lock = make_lock("ops.fallback._global_lock")


def global_policy() -> FallbackPolicy:
    global _global
    pol = _global       # installed: one read, no lock (every selection asks)
    if pol is not None:
        return pol
    with _global_lock:
        if _global is None:
            _global = FallbackPolicy()
        return _global


def set_global_policy(policy: Optional[FallbackPolicy]) -> \
        Optional[FallbackPolicy]:
    """Swap the process policy (tests); returns the previous one."""
    global _global
    with _global_lock:
        prev = _global
        _global = policy
        return prev
