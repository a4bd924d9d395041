"""Structured error taxonomy — a copy of ``ceph_tpu/utils/errors.py``
plus the device-tier errors of the port.

The reference signals failure through int error codes threaded from
the ObjectStore up through ECBackend (-EIO for a failed crc gate,
-ENOENT for a missing shard) and out to the client; scrub and repair
attach structured context (inconsistent-object lists, shard error
maps — src/osd/scrubber/* and ECBackend::handle_sub_read).  Python
surfaces raise instead, and these classes are the shared vocabulary:
every deliberate failure path in chaos/, scrub/ and utils/retry.py
raises one of them, so consumers can distinguish "retry this"
(TransientBackendError) from "this read set cannot be decoded, here is
exactly what is lost" (UnrecoverableError) without string matching.

The port adds four classes for the device tier, so a caller can tell
"no card" from "the kernel failed": :class:`NoDeviceError`,
:class:`KernelBuildError`, :class:`KernelLaunchError` and
:class:`DeviceDispatchError`.  None of them is ever caught to carry on
with a slower tier.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple


class CephTpuError(Exception):
    """Base of every structured error this framework raises on
    purpose (plain ValueError/IOError remain for argument validation
    and the reference-mirrored plugin contracts)."""


class TransientBackendError(CephTpuError):
    """A backend/device/store operation failed in a way expected to
    succeed on retry (the -EAGAIN/-EIO-on-flaky-media class).  The
    retryable type for utils/retry.py; chaos injects these."""


class RetryExhausted(CephTpuError):
    """retry_call gave up: every attempt raised a retryable error, or
    the policy's overall deadline expired mid-schedule.

    The last underlying error is chained as ``__cause__`` and kept as
    ``.last``; ``.attempts`` records how many tries ran, ``.elapsed``
    the wall (or FakeClock) seconds the whole schedule consumed, and
    ``.deadline_expired`` whether the budget that ran out was time
    rather than attempts.
    """

    def __init__(self, attempts: int, last: BaseException,
                 elapsed: Optional[float] = None,
                 deadline_expired: bool = False) -> None:
        msg = f"retry exhausted after {attempts} attempts"
        if elapsed is not None:
            msg += f" in {elapsed:.3f}s"
        if deadline_expired:
            msg += " (deadline expired)"
        super().__init__(f"{msg}: {type(last).__name__}: {last}")
        self.attempts = attempts
        self.last = last
        self.elapsed = elapsed
        self.deadline_expired = deadline_expired


class ProbeTimeout(CephTpuError):
    """A health/host probe burned its whole time budget without an
    answer — the probed endpoint is WEDGED, not flaky.

    Terminal by design: probe callers (utils/retry.py::probe_call)
    raise this instead of RetryExhausted so the supervisor classifies
    it as the hang class (``backend_loss``) and escalates the ladder
    — a slow probe must never fall into the ``transient`` retry loop
    against an endpoint that will not answer.  Carries ``.elapsed``
    and ``.deadline_expired`` like RetryExhausted (and ``.deadline``,
    the budget that ran out), so probe reports stay structurally
    interchangeable with retry reports.
    """

    def __init__(self, target: str, deadline: float,
                 elapsed: Optional[float] = None,
                 deadline_expired: bool = True,
                 last: Optional[BaseException] = None) -> None:
        msg = f"probe of {target!r} exceeded deadline {deadline}s"
        if elapsed is not None:
            msg += f" in {elapsed:.3f}s"
        if last is not None:
            msg += f": {type(last).__name__}: {last}"
        super().__init__(msg)
        self.target = target
        self.deadline = deadline
        self.elapsed = elapsed
        self.deadline_expired = deadline_expired
        self.last = last
        if last is not None:
            self.__cause__ = last


class InjectedCrash(CephTpuError):
    """A deterministic crash raised at a named crash site
    (chaos.CrashPoint) — the process-died stand-in the recovery
    orchestrator's journal replay must survive.  ``.site`` is the
    crash-site name, ``.hit`` which visit fired."""

    def __init__(self, site: str, hit: int = 1) -> None:
        super().__init__(f"injected crash at site {site!r} (hit {hit})")
        self.site = site
        self.hit = hit


class ScrubError(CephTpuError):
    """A scrub/repair invariant failed (repair produced bytes that do
    not re-verify, a store write-back failed, ...).  ``.shards`` names
    the shard ids involved when known."""

    def __init__(self, msg: str,
                 shards: Iterable[int] = ()) -> None:
        self.shards: Tuple[int, ...] = tuple(sorted(shards))
        if self.shards:
            msg = f"{msg} (shards {list(self.shards)})"
        super().__init__(msg)


class UnrecoverableError(ScrubError):
    """More shards are lost/corrupt than the code can reconstruct.

    Raised INSTEAD of returning garbage bytes.  Structured fields:

    - ``shards``  — every shard id classified missing or corrupt,
    - ``extents`` — the logical (offset, length) byte ranges of the
      object that cannot be reconstructed (lost DATA chunks only;
      parity loss costs durability, not client bytes), merged where
      adjacent.  Empty when the geometry is unknown to the caller.
    """

    def __init__(self, msg: str, shards: Iterable[int],
                 extents: Sequence[Tuple[int, int]] = (),
                 cause: Optional[BaseException] = None) -> None:
        self.extents: Tuple[Tuple[int, int], ...] = tuple(extents)
        detail = msg
        if self.extents:
            ext = ", ".join(f"[{o}, +{n})" for o, n in self.extents[:8])
            more = ("" if len(self.extents) <= 8
                    else f" and {len(self.extents) - 8} more")
            detail = f"{msg}; unrecoverable extents: {ext}{more}"
        super().__init__(detail, shards)
        if cause is not None:
            self.__cause__ = cause
        # Post-mortem flight dump: every raise
        # site constructs this class, so construction is the one choke
        # point where the flight recorder freezes "what the process
        # was doing right before data became unreadable".  Guarded —
        # observability must never mask the failure it records.
        try:
            from ..telemetry.recorder import record_unrecoverable
            record_unrecoverable(self)
        except Exception:  # noqa: BLE001
            pass


class NoDeviceError(CephTpuError, RuntimeError):
    """The caller asked for (or defaulted to) a CUDA device and none is
    present.  The port never drops to the CPU on its own: running on
    the CPU is something the caller asks for with ``device="cpu"``."""


class KernelBuildError(CephTpuError, RuntimeError):
    """``nvcc`` failed to build a kernel library, or the library did
    not load."""


class KernelLaunchError(CephTpuError, RuntimeError):
    """A kernel launch returned a CUDA error (``cudaGetLastError``), or
    a kernel library disagrees with its wrapper's plan.  ``code`` is the
    ``cudaError_t`` value where the CUDA runtime returned one (None for
    a plan mismatch): the supervised dispatch plane
    (ops/supervisor.py) classifies by this number, never by the
    message."""

    def __init__(self, msg: str, code: Optional[int] = None) -> None:
        super().__init__(msg)
        self.code = None if code is None else int(code)


class DeviceDispatchError(CephTpuError, RuntimeError):
    """A supervised dispatch on the card failed for good: its retries
    ran out, it ran out of memory at a batch of one, the card was lost
    (``kind`` "transient" / "oom" / "backend_loss" / "host_loss"), or
    self-verify caught a corrupted output ("corrupt").  ``seam`` names
    the dispatch seam; the error it stands for is ``__cause__``.  The
    supervised dispatch plane (ops/supervisor.py) raises it instead of
    moving a card tensor's work to the plain ops or to the host; the
    caller may re-queue the work."""

    def __init__(self, seam: str, kind: str, msg: str) -> None:
        super().__init__(f"supervised dispatch at seam {seam!r} failed on "
                         f"the card ({kind}): {msg}")
        self.seam = seam
        self.kind = kind
