"""Instrumented locks — the runtime lock-order validator; a port of
``ceph_tpu/utils/locks.py``.

Every lock in the package is created through :func:`make_lock` /
:func:`make_rlock` with its *declared id* — the dotted name of its
creation site, ranked by the port's lock-order registry
(``ceph_tpu_torch/analysis/lockmodel.py``).  By default the factories
return plain ``threading.Lock`` / ``threading.RLock`` objects: zero
wrapper overhead, nothing recorded.

Under ``CEPH_TPU_LOCKCHECK=1`` the factories instead return checked
wrappers feeding a process-global :class:`LockMonitor` that records,
per thread, the *actual* acquisition order:

- every held->acquired edge,
- declared-rank inversions (acquiring a lower/equal-rank lock while a
  higher-rank one is held) as ``order_violations``,
- cross-thread contention (try-acquire first; a miss records the
  owning thread before blocking for real),
- held-duration on an injectable clock — a hold longer than
  ``blocking_threshold`` seconds becomes a ``blocking_events`` entry.

The gate is creation-time: flipping the env var mid-process does not
re-instrument existing locks.  ``lockcheck_report()`` exports the
schema-versioned report (``lockcheck_schema_version``) that
tests/test_torch_lockcheck.py validates while the seeded
dispatch-chaos family runs, with every runtime edge predicted by the
static lock graph (``analysis/concurrency.py::static_lock_graph``).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

LOCKCHECK_ENV = "CEPH_TPU_LOCKCHECK"
LOCKCHECK_SCHEMA_VERSION = 1

# a hold longer than this (seconds, on the monitor clock) is recorded
# as a blocking-under-lock event — generous for pure bookkeeping
# critical sections, far below any real sleep/IO/dispatch stall
DEFAULT_BLOCKING_THRESHOLD_S = 0.05


def lockcheck_enabled() -> bool:
    return os.environ.get(LOCKCHECK_ENV) == "1"


def _declared_ranks() -> Dict[str, int]:
    # lazy + forgiving: the monitor must come up even if the analysis
    # package is mid-import (utils is imported by nearly everything)
    try:
        from ..analysis import lockmodel
        return dict(lockmodel.all_ranks())
    except Exception:
        return {}


class _Held:
    """One entry on a thread's held-lock stack."""

    __slots__ = ("name", "rank", "t0", "depth")

    def __init__(self, name: str, rank: Optional[int], t0: float) -> None:
        self.name = name
        self.rank = rank
        self.t0 = t0
        self.depth = 1  # RLock reentries bump this instead of stacking


class LockMonitor:
    """Process-global recorder for checked-lock activity.

    All mutation happens under ``_mu`` (a plain, *unchecked* lock:
    the monitor must not observe itself).  The per-thread held stack
    lives in a ``threading.local`` so reads of *this thread's* stack
    are lock-free.
    """

    def __init__(self,
                 clock: Optional[Callable[[], float]] = None,
                 ranks: Optional[Dict[str, int]] = None,
                 blocking_threshold: float = DEFAULT_BLOCKING_THRESHOLD_S,
                 ) -> None:
        self.clock = clock or time.monotonic
        self.ranks = dict(ranks) if ranks is not None else _declared_ranks()
        self.blocking_threshold = blocking_threshold
        # monitor-internal; never a make_lock product
        self._mu = threading.Lock()  # tpu-lint: disable=conc-registry-gap -- monitor bookkeeping lock: instrumenting it would recurse
        self._tls = threading.local()
        self._locks: Dict[str, Dict[str, object]] = {}
        self._edges: Set[Tuple[str, str]] = set()
        self._violations: List[Dict[str, object]] = []
        self._blocking: List[Dict[str, object]] = []
        self._unregistered: Set[str] = set()

    # -- per-thread stack ------------------------------------------------

    def _stack(self) -> List[_Held]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def held_depth(self, name: str) -> int:
        return sum(h.depth for h in self._stack() if h.name == name)

    def held_names(self) -> List[str]:
        return [h.name for h in self._stack()]

    # -- recording -------------------------------------------------------

    def _stat(self, name: str, kind: str) -> Dict[str, object]:
        st = self._locks.get(name)
        if st is None:
            st = self._locks[name] = {
                "kind": kind, "acquisitions": 0, "reentries": 0,
                "contentions": 0, "wait_total_s": 0.0,
                "held_total_s": 0.0, "held_max_s": 0.0,
            }
        return st

    def record_acquire(self, name: str, kind: str, *, reentrant: bool,
                       contended: bool, wait_s: float,
                       owner: Optional[int]) -> None:
        stack = self._stack()
        rank = self.ranks.get(name)
        with self._mu:
            st = self._stat(name, kind)
            if contended:
                st["contentions"] = int(st["contentions"]) + 1  # type: ignore[arg-type]
                st["wait_total_s"] = float(st["wait_total_s"]) + wait_s  # type: ignore[arg-type]
            if reentrant:
                st["reentries"] = int(st["reentries"]) + 1  # type: ignore[arg-type]
            else:
                st["acquisitions"] = int(st["acquisitions"]) + 1  # type: ignore[arg-type]
            if rank is None:
                self._unregistered.add(name)
            if not reentrant:
                for h in stack:
                    self._edges.add((h.name, name))
                if stack:
                    top = stack[-1]
                    if (rank is not None and top.rank is not None
                            and rank <= top.rank):
                        self._violations.append({
                            "lock": name, "rank": rank,
                            "held": top.name, "held_rank": top.rank,
                            "thread": threading.current_thread().name,
                        })
        if reentrant:
            for h in reversed(stack):
                if h.name == name:
                    h.depth += 1
                    break
        else:
            stack.append(_Held(name, rank, self.clock()))

    def record_release(self, name: str) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i].name == name:
                h = stack[i]
                if h.depth > 1:
                    h.depth -= 1
                    return
                del stack[i]
                held_s = max(0.0, self.clock() - h.t0)
                with self._mu:
                    st = self._stat(name, "lock")
                    st["held_total_s"] = float(st["held_total_s"]) + held_s  # type: ignore[arg-type]
                    if held_s > float(st["held_max_s"]):  # type: ignore[arg-type]
                        st["held_max_s"] = held_s
                    if held_s > self.blocking_threshold:
                        self._blocking.append({
                            "lock": name, "held_s": held_s,
                            "thread": threading.current_thread().name,
                        })
                return
        # release of a lock this thread never recorded: tolerated
        # (a lock handed across threads), but worth surfacing
        with self._mu:
            self._violations.append({
                "lock": name, "rank": self.ranks.get(name),
                "held": None, "held_rank": None,
                "thread": threading.current_thread().name,
                "detail": "released on a thread that never acquired it",
            })

    # -- export ----------------------------------------------------------

    def report(self) -> Dict[str, object]:
        with self._mu:
            return {
                "lockcheck_schema_version": LOCKCHECK_SCHEMA_VERSION,
                "enabled": lockcheck_enabled(),
                "locks": {k: dict(v) for k, v in sorted(self._locks.items())},
                "edges": sorted([list(e) for e in self._edges]),
                "order_violations": list(self._violations),
                "blocking_events": list(self._blocking),
                "unregistered": sorted(self._unregistered),
            }

    def reset(self) -> None:
        with self._mu:
            self._locks.clear()
            self._edges.clear()
            self._violations.clear()
            self._blocking.clear()
            self._unregistered.clear()


class _CheckedBase:
    """Shared acquire/release plumbing for CheckedLock/CheckedRLock."""

    _kind = "lock"

    def __init__(self, name: str,
                 monitor: Optional[LockMonitor] = None) -> None:
        self._name = name
        self._mon = monitor  # None -> resolve the global lazily
        self._inner = self._make_inner()
        self._owner: Optional[int] = None

    def _make_inner(self):
        return threading.Lock()

    @property
    def name(self) -> str:
        return self._name

    def _monitor(self) -> LockMonitor:
        return self._mon if self._mon is not None else global_monitor()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        mon = self._monitor()
        reentrant = (self._kind == "rlock"
                     and mon.held_depth(self._name) > 0)
        contended = False
        t0 = mon.clock()
        got = self._inner.acquire(blocking=False)
        if not got:
            if not blocking:
                return False
            contended = True
            if timeout is not None and timeout >= 0:
                got = self._inner.acquire(True, timeout)
            else:
                got = self._inner.acquire()
            if not got:
                return False
        wait_s = max(0.0, mon.clock() - t0)
        mon.record_acquire(self._name, self._kind, reentrant=reentrant,
                           contended=contended, wait_s=wait_s,
                           owner=self._owner)
        self._owner = threading.get_ident()
        return True

    def release(self) -> None:
        mon = self._monitor()
        if self._kind != "rlock" or mon.held_depth(self._name) <= 1:
            self._owner = None
        mon.record_release(self._name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{type(self).__name__} {self._name!r}>"


class CheckedLock(_CheckedBase):
    _kind = "lock"


class CheckedRLock(_CheckedBase):
    _kind = "rlock"

    def _make_inner(self):
        return threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        mon = self._monitor()
        reentrant = mon.held_depth(self._name) > 0
        if reentrant:
            # an RLock re-acquire by the owner can never block
            self._inner.acquire()
            mon.record_acquire(self._name, self._kind, reentrant=True,
                               contended=False, wait_s=0.0,
                               owner=self._owner)
            return True
        return _CheckedBase.acquire(self, blocking, timeout)


_monitor_global: Optional[LockMonitor] = None
_monitor_global_lock = threading.Lock()  # tpu-lint: disable=conc-registry-gap -- guards monitor construction: instrumenting it would recurse


def global_monitor() -> LockMonitor:
    global _monitor_global
    with _monitor_global_lock:
        if _monitor_global is None:
            _monitor_global = LockMonitor()
        return _monitor_global


def reset_monitor(clock: Optional[Callable[[], float]] = None,
                  ranks: Optional[Dict[str, int]] = None,
                  blocking_threshold: float = DEFAULT_BLOCKING_THRESHOLD_S,
                  ) -> LockMonitor:
    """Install a fresh global monitor (tests); returns it."""
    global _monitor_global
    with _monitor_global_lock:
        _monitor_global = LockMonitor(
            clock=clock, ranks=ranks,
            blocking_threshold=blocking_threshold)
        return _monitor_global


def lockcheck_report() -> Dict[str, object]:
    """The schema-versioned runtime report (empty-but-valid when the
    gate is off and nothing was ever recorded)."""
    return global_monitor().report()


def validate_lockcheck_report(doc: Dict[str, object]) -> None:
    """Raise ValueError unless ``doc`` is a valid lockcheck report."""
    if not isinstance(doc, dict):
        raise ValueError("lockcheck report: not a mapping")
    ver = doc.get("lockcheck_schema_version")
    if ver != LOCKCHECK_SCHEMA_VERSION:
        raise ValueError(
            f"lockcheck report: schema version {ver!r} != "
            f"{LOCKCHECK_SCHEMA_VERSION}")
    for key, typ in (("enabled", bool), ("locks", dict),
                     ("edges", list), ("order_violations", list),
                     ("blocking_events", list), ("unregistered", list)):
        if not isinstance(doc.get(key), typ):
            raise ValueError(f"lockcheck report: bad/missing {key!r}")
    for edge in doc["edges"]:  # type: ignore[union-attr]
        if (not isinstance(edge, list) or len(edge) != 2
                or not all(isinstance(x, str) for x in edge)):
            raise ValueError(f"lockcheck report: bad edge {edge!r}")
    for name, st in doc["locks"].items():  # type: ignore[union-attr]
        if not isinstance(st, dict) or "acquisitions" not in st:
            raise ValueError(f"lockcheck report: bad lock entry {name!r}")


def make_lock(name: str):
    """A ``threading.Lock`` under the declared id ``name`` — checked
    (instrumented) when ``CEPH_TPU_LOCKCHECK=1`` at creation time."""
    if lockcheck_enabled():
        return CheckedLock(name)
    return threading.Lock()


def make_rlock(name: str):
    """RLock twin of :func:`make_lock`."""
    if lockcheck_enabled():
        return CheckedRLock(name)
    return threading.RLock()
