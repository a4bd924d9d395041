"""The supervised dispatch plane — ONE choke point between every
host-side dispatch seam and the card, so a backend that fails AFTER
warm-up (device loss, HBM OOM, a hang, a corrupted output buffer) is
classified and survived instead of propagated.  A port of
``ceph_tpu/ops/supervisor.py``.

Every device-dispatch seam — ``engine.fused_repair``,
``engine.serve-{op}``, ``engine.serve-{op}-ragged``,
``ops.apply_matrix`` / ``ops.apply_matrix_packed`` and their ragged
twins, ``crush.bulk_rule`` — routes its calls through
:meth:`DispatchSupervisor.dispatch`, which classifies failures and
applies the matching response:

==================  ==================================================
classification      response
==================  ==================================================
transient error     bounded ``utils/retry`` backoff (injectable clock)
oom                 batch-rung downshift: split the stripe batch in
                    half and redispatch the halves (recursively, to
                    rung 1), outputs re-joined by ``torch.cat`` on
                    their own device, byte-identically
mesh-member loss    device quarantine: with a data plane of two or
                    more members active, a persistent failure halves
                    the plane (8 -> 4 -> 2 -> single-device) and the
                    seam's callable rebuilds on the narrowed plane; the
                    work stays where it was (card or CPU)
host loss           host quarantine: on a multi-host plane the hosts
                    halve (every member the lost domain contributed at
                    once), the journaled in-flight intents of the lost
                    host are reclaimed (``set_inflight_reclaim``), then
                    the device ladder runs inside the survivor
backend_loss        LIVE ``FallbackPolicy.demote()`` down the
                    torch -> numpy ladder (CPU tensors and host rows),
                    with the pattern cache cleared and the seam's
                    callable rebuilt on the demoted tier; at the numpy
                    floor the seam's host twin completes the dispatch
                    byte-identically.  On the card:
                    ``DeviceDispatchError``
hang                clock-injectable dispatch deadline; a dispatch
                    that burns past it is classified as backend loss
output corruption   (self-verify mode, ``CEPH_TPU_SELF_VERIFY=1``)
                    outputs are CRC-checked against the numpy ground
                    truth; a mismatch is reclassified as a backend
                    fault, flight-recorded, and re-run on a demoted
                    tier (on the card: ``DeviceDispatchError``) — the
                    corrupted bytes are NEVER returned
==================  ==================================================

Faults on the card.  Injected faults (``chaos/dispatch.py``)
classify exactly as in the reference.  Real errors classify by type
and by the ``cudaError_t`` number a :class:`KernelLaunchError` (its
``code``) or torch's ``AcceleratorError`` (its ``error_code``)
carries, never by the message (the values of ``enum cudaError`` in
the CUDA runtime's headers):

=====================================  ======  =====================
error                                  code    class
=====================================  ======  =====================
``torch.cuda.OutOfMemoryError``        —       oom
cudaErrorMemoryAllocation              2       oom
cudaErrorDevicesUnavailable            46      backend_loss
cudaErrorNoDevice                      100     backend_loss
cudaErrorECCUncorrectable              214     backend_loss
``KernelBuildError`` (nvcc, ``.so``)   —       never: propagates
cudaErrorInvalidValue                  1       never: propagates
cudaErrorInvalidConfiguration          9       never: propagates
cudaErrorNoKernelImageForDevice        209     never: propagates
cudaErrorIllegalAddress                700     never: propagates
cudaErrorLaunchOutOfResources          701     never: propagates
cudaErrorLaunchTimeout                 702     never: propagates
cudaErrorAssert                        710     never: propagates
cudaErrorIllegalInstruction            715     never: propagates
cudaErrorMisalignedAddress             716     never: propagates
cudaErrorLaunchFailure                 719     never: propagates
any other error, whatever its text     —       never: propagates
=====================================  ======  =====================

A launch-configuration error and a fault a kernel of ours can cause
itself (an illegal or misaligned address, a device-side assert, an
illegal instruction, a launch failure, a kernel that runs until the
watchdog stops it) are never classified: demoting past a bug in our
own kernel would hide it.

**The card's work stays on the card.** On the card a wrapper launches
its kernel or raises, so the ladder's tier steps apply only to
dispatches on CPU tensors and host rows; a plane's reshrink keeps the
work on the plane's surviving members, so it applies on the card too.
A dispatch on CUDA tensors keeps the retry and the rung split, both of
which launch the kernel again; a failure that would demote there
(retries exhausted, out of memory at a batch of one, a lost card or
host, a hang, a corrupted output caught by self-verify) raises
:class:`DeviceDispatchError` naming the seam and the class, counted as
``card_failures`` and frozen in the flight recorder
(``backend_lost``). The caller may re-queue the work, as the bench's
device-chaos row does. A plane already at width 1 cannot reshrink: on
the card its loss raises the same way.

What else differs from the reference:

- **Re-promotion** restores the tier, the plane's width and its host
  partition once the fault plans hold nothing persistent
  (``_probe_ok``); there is no health probe of the card itself.
- **The clean path is lean.**  With no fault plan armed, nothing
  demoted, self-verify off and no deadline, a dispatch is one counter
  increment and ``fn(*args)`` inside a ``try``: no synchronize, no host
  copy, no allocation.  An error there enters the full ladder as its
  first attempt's failure, so the counts are the reference's.
- **Nested seams.**  In the reference a fused repair is one jitted
  program and its inner matrix applies are traced, so they go
  unsupervised.  Here they are eager: while a seam's callable (or its
  host twin) runs, a thread-local mark sends every inner seam straight
  to its body, so one fused repair is exactly one supervised dispatch.
- Self-verify (off by default) is the only place the supervisor reads
  device bytes back: for a card dispatch it copies the inputs to the
  host, runs the seam's numpy twin there and compares CRCs.

Demote and re-promote each emit a telemetry counter and a structured
event AND freeze a flight-recorder post-mortem (telemetry/recorder.py).
Every supervised outcome is byte-identical to the unfailed run: every
tier of every seam is byte-identical (tests/test_torch_*.py), so retry,
split, demoted completion and host twins return the same bytes, or the
dispatch raises.
"""

from __future__ import annotations

import os
import threading
import zlib
from contextlib import contextmanager
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..chaos import dispatch as chaos_dispatch
from ..chaos import hosts as chaos_hosts
from ..utils.detcheck import default_clock
from ..utils.errors import (DeviceDispatchError, KernelBuildError,
                            KernelLaunchError, ProbeTimeout,
                            RetryExhausted, TransientBackendError)
from ..utils.locks import make_lock
from ..utils.log import dout
from ..utils.retry import RetryPolicy, SystemClock, retry_call

# cudaError_t values (the CUDA runtime's enum): MemoryAllocation; and
# DevicesUnavailable, NoDevice, ECCUncorrectable.  Every other code (a
# launch configuration, a fault of the kernel's own making: the
# docstring's table) is never classified
CUDA_OOM_CODES = frozenset({2})
CUDA_LOSS_CODES = frozenset({46, 100, 214})
# torch's error for a failed CUDA call (its ``error_code`` attribute is
# the cudaError_t); absent from older torch
_ACCELERATOR_ERROR = getattr(torch, "AcceleratorError", None)

# escalation ceiling per dispatch: transient-exhausted -> demote(torch)
# -> demote(numpy) can never loop
_MAX_ESCALATIONS = 6
_MAX_SPLIT_DEPTH = 8
_DEFAULT_HANG_S = 1.0

_HOST = object()        # _escalate verdict: complete on the host twin

class _SeamDepth(threading.local):
    depth = 0           # a class default: no AttributeError on a new thread


_tls = _SeamDepth()


@contextmanager
def _inside_seam():
    """Mark this thread as running a supervised seam's callable or host
    twin: any seam reached from inside goes straight to its callable
    (the port's counterpart of "traced calls bypass supervision")."""
    _tls.depth += 1
    try:
        yield
    finally:
        _tls.depth -= 1


def classify_dispatch_error(e: BaseException) -> Optional[str]:
    """Map a dispatch-seam exception to a supervised class —
    ``"transient"`` / ``"oom"`` / ``"backend_loss"`` / ``"host_loss"``
    — or None for errors that are NOT the backend's fault (a shape
    error, a plugin contract violation, a kernel that failed to build,
    a bad launch configuration, a fault of our own kernel's making):
    those propagate untouched, because retrying or demoting a genuine
    bug would only hide it."""
    from ..chaos.dispatch import (DispatchHang, InjectedBackendLoss,
                                  InjectedOom)
    from ..chaos.hosts import InjectedHostLoss, InjectedHostPartition
    if isinstance(e, RetryExhausted):
        inner = (classify_dispatch_error(e.last)
                 if e.last is not None else None)
        return inner or "transient"
    if isinstance(e, TransientBackendError):
        return "transient"
    if isinstance(e, InjectedOom):
        return "oom"
    if isinstance(e, (InjectedHostLoss, InjectedHostPartition)):
        return "host_loss"
    if isinstance(e, ProbeTimeout):
        # a probe that burned its deadline is the hang class: backend
        # loss, so the ladder acts — never the transient retry loop
        return "backend_loss"
    if isinstance(e, (InjectedBackendLoss, DispatchHang)):
        return "backend_loss"
    if isinstance(e, KernelBuildError):
        return None
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return "oom"
    code = _cuda_code(e)
    if code in CUDA_OOM_CODES:
        return "oom"
    if code in CUDA_LOSS_CODES:
        return "backend_loss"
    return None


def _cuda_code(e: BaseException) -> Optional[int]:
    """The cudaError_t an error carries: a launcher's
    :class:`KernelLaunchError` code, or torch's ``AcceleratorError``
    error code; None for any other error."""
    if isinstance(e, KernelLaunchError):
        return e.code
    if _ACCELERATOR_ERROR is not None and isinstance(e, _ACCELERATOR_ERROR):
        code = getattr(e, "error_code", None)
        return None if code is None else int(code)
    return None


def _host_bytes(p) -> bytes:
    if isinstance(p, torch.Tensor):
        p = p.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(p)).tobytes()


def _crc_output(out) -> int:
    """crc32 over the host bytes of one dispatch output (tensor, array
    or tuple of them) — the self-verify sample, and the only place the
    supervisor reads device bytes back."""
    parts = out if isinstance(out, (tuple, list)) else (out,)
    c = 0
    for p in parts:
        c = zlib.crc32(_host_bytes(p), c)
    return c


def _cat(a, b):
    if isinstance(a, torch.Tensor):
        return torch.cat([a, b.to(a.device)
                          if isinstance(b, torch.Tensor)
                          else torch.from_numpy(np.asarray(b)).to(a.device)],
                         dim=0)
    return np.concatenate([np.asarray(a), np.asarray(b)], axis=0)


def _concat_outputs(lo, hi):
    """Re-join a split redispatch along the batch axis, component-wise
    for multi-output seams, on the outputs' own device (numpy for numpy
    twins): a split moves no bytes to the host."""
    if isinstance(lo, (tuple, list)):
        return tuple(_cat(a, b) for a, b in zip(lo, hi))
    return _cat(lo, hi)


def _like(ref, host):
    """A corrupted copy (numpy, from the fault plan) back in the form of
    the output it replaces: tensors on their own device."""
    if isinstance(ref, (tuple, list)):
        return tuple(_like(r, h) for r, h in zip(ref, host))
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(host)).to(ref.device)
    return host


def _cut_batch(args, b: int, cut: slice) -> tuple:
    """One half of a rung split: every array argument whose leading
    axis is the batch's (the stack, and a ragged dispatch's page mask)
    cut alike, the rest passed whole."""
    return tuple(a[cut] if isinstance(a, (torch.Tensor, np.ndarray))
                 and a.ndim and a.shape[0] == b else a for a in args)


def _dispatch_kind(args) -> str:
    """The device type this dispatch runs on: its first tensor
    argument's ("cuda" or "cpu"), "cpu" for host rows."""
    for a in args:
        dev = getattr(a, "device", None)
        if isinstance(dev, torch.device):
            return dev.type
    return "cpu"


def _on_card(args) -> bool:
    """Does this dispatch run on the card (its first tensor argument a
    CUDA tensor)?  Its work then stays there: no tier step, no host
    twin."""
    return _dispatch_kind(args) == "cuda"


def _to_host(args) -> tuple:
    """Host copies of a card dispatch's tensor arguments: the inputs of
    self-verify's ground truth."""
    return tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                 for a in args)


class DispatchSupervisor:
    """The process dispatch supervisor (swap via
    :func:`set_global_supervisor` in tests; the selftest builds fully
    isolated instances).

    - ``clock``: injectable (FakeClock in tests) — backoff sleeps,
      hang deadlines and probe pacing all run on it.
    - ``deadline_s``: dispatch deadline for hang classification
      (``CEPH_TPU_DISPATCH_DEADLINE`` env; None = no hang detection).
    - ``self_verify``: CRC-sample every ``verify_every``-th supervised
      output against the numpy ground-truth twin
      (``CEPH_TPU_SELF_VERIFY=1``); detected corruption is
      reclassified as a backend fault and never returned.
    - ``promote_after``: consecutive clean health probes before a
      demoted tier / quarantined plane re-promotes.
    - ``policy`` / ``cache_clear``: injectable process couplings (the
      global FallbackPolicy, the engine PatternCache clear) so the
      selftests run on isolated state.
    """

    def __init__(self, clock=None, retry_policy: Optional[RetryPolicy]
                 = None, deadline_s: Optional[float] = None,
                 self_verify: Optional[bool] = None,
                 verify_every: int = 1, promote_after: int = 3,
                 probe_every: int = 4,
                 policy=None,
                 cache_clear: Optional[Callable[[], None]] = None
                 ) -> None:
        self.clock = clock if clock is not None \
            else default_clock("ops.supervisor.DispatchSupervisor",
                               SystemClock)
        self.retry_policy = retry_policy or RetryPolicy(
            attempts=3, base_delay=0.002, multiplier=2.0, max_delay=0.05)
        if deadline_s is None:
            env = os.environ.get("CEPH_TPU_DISPATCH_DEADLINE",
                                 "").strip()
            deadline_s = float(env) if env else None
        self.deadline_s = deadline_s
        if self_verify is None:
            self_verify = os.environ.get(
                "CEPH_TPU_SELF_VERIFY", "").strip().lower() in (
                    "1", "on", "true", "yes")
        self.self_verify = self_verify
        self.verify_every = max(1, verify_every)
        self.promote_after = max(1, promote_after)
        self.probe_every = max(1, probe_every)
        self._policy_override = policy
        self._cache_clear_override = cache_clear
        self._lock = make_lock("ops.supervisor.DispatchSupervisor._lock")
        # demotion state (what re-promotion must restore)
        self._floor: Optional[str] = None      # "numpy" once demoted
        self._tier_demotions = 0
        self._plane_width0: Optional[int] = None
        self._plane_hosts0: Optional[int] = None
        self._plane_kind0: Optional[str] = None
        self._clean_probes = 0
        self._since_probe = 0
        self._verify_seq = 0
        # journal-backed in-flight reclaim: the recovery layer registers
        # a callback that replays the lost host's intent records onto
        # the shrunken plane after a host quarantine
        self._inflight_reclaim: Optional[Callable[[str], int]] = None
        self.counters: Dict[str, int] = {
            "dispatches": 0, "retries": 0, "rung_downshifts": 0,
            "demotions": 0, "quarantines": 0, "repromotions": 0,
            "host_quarantines": 0, "host_repromotions": 0,
            "journal_redispatches": 0, "card_failures": 0,
            "hangs": 0, "slow_dispatches": 0, "host_completions": 0,
            "verify_failures": 0, "verified_clean": 0,
            "injected_faults": 0, "probe_clean": 0, "probe_failed": 0,
        }

    # -- injectable couplings --------------------------------------------

    def _policy(self):
        if self._policy_override is not None:
            return self._policy_override
        from .fallback import global_policy
        return global_policy()

    def _cache_clear(self) -> None:
        if self._cache_clear_override is not None:
            self._cache_clear_override()
            return
        from ..codes.engine import global_pattern_cache
        global_pattern_cache().clear()

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    # -- state -----------------------------------------------------------

    @property
    def demoted(self) -> bool:
        with self._lock:
            return (self._tier_demotions > 0
                    or self._plane_width0 is not None)

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["demoted"] = (self._tier_demotions > 0
                              or self._plane_width0 is not None)
            out["tier_floor"] = self._floor
            out["tier_demotions"] = self._tier_demotions
            out["plane_width0"] = self._plane_width0
            out["plane_hosts0"] = self._plane_hosts0
            out["clean_probes"] = self._clean_probes
        return out

    def set_inflight_reclaim(
            self, cb: Optional[Callable[[str], int]]
    ) -> Optional[Callable[[str], int]]:
        """Register the journal-backed in-flight reclaim hook: after a
        host quarantine, ``cb(seam)`` replays the lost host's intent
        records (recovery/journal.py, epoch-fenced) onto the shrunken
        plane and returns how many ops were re-dispatched.  Returns the
        previous hook so callers can restore it."""
        with self._lock:
            prev = self._inflight_reclaim
            self._inflight_reclaim = cb
        return prev

    def reset_pacing(self) -> None:
        """Zero the probe/verify pacing counters WITHOUT touching the
        cumulative counters or demotion state, so a seeded run's tick
        cadence is independent of earlier supervised work."""
        with self._lock:
            self._since_probe = 0
            self._verify_seq = 0
            self._clean_probes = 0

    def reset(self) -> None:
        """Forget demotion state and zero counters (tests)."""
        with self._lock:
            for k in self.counters:
                self.counters[k] = 0
            self._floor = None
            self._tier_demotions = 0
            self._plane_width0 = None
            self._plane_hosts0 = None
            self._plane_kind0 = None
            self._clean_probes = 0
            self._since_probe = 0
            self._verify_seq = 0

    # -- THE choke point -------------------------------------------------

    def dispatch(self, seam: str, fn: Callable, args: Tuple, *,
                 host_fn: Optional[Callable] = None,
                 rebuild: Optional[Callable] = None,
                 splittable: bool = True,
                 verifiable: bool = True,
                 _depth: int = 0):
        """Run one supervised device dispatch: ``fn(*args)`` with the
        full classification ladder above it.

        ``host_fn(*args)`` is the seam's numpy ground-truth twin
        (byte-identical by construction) — the numpy-floor completion
        path and the self-verify reference.  ``rebuild()`` re-derives
        the dispatch callable after a tier demotion or a plane reshrink
        (the seams pass their own cached-call constructors, so a rebuilt
        callable lands on the demoted tier or the narrowed plane).
        ``splittable``: the first argument carries the stripe batch on
        axis 0, so an OOM can downshift the rung by splitting it (and
        every argument whose leading axis is the batch's).
        ``verifiable=False`` opts the seam out of self-verify (crush
        bulk's need-host residue flags legitimately differ from the
        exact mapper's twin). Called from inside
        another seam's callable, it runs ``fn`` and nothing else.  A
        persistent failure first narrows an active data plane (host,
        then member quarantine); on CUDA tensors a failure that would
        then step the tier down raises :class:`DeviceDispatchError`
        instead (the card's work stays on the card).
        """
        if _tls.depth:
            return fn(*args)
        with self._lock:
            self.counters["dispatches"] += 1
        # the armed plans are read as the module globals they are (one
        # atomic read each: the clean path takes no lock for them)
        plan = chaos_dispatch._active
        first_err: Optional[BaseException] = None
        if (plan is None and self._floor is None and not self._tier_demotions
                and self._plane_width0 is None
                and not self.self_verify and self.deadline_s is None
                and chaos_hosts._active is None):
            # the clean path: the call and nothing else (the nested-seam
            # mark set inline: this thread's depth is 0 here)
            _tls.depth = 1
            try:
                return fn(*args)
            except BaseException as e:  # noqa: BLE001 — classified,
                # unclassified errors re-raise at once
                if classify_dispatch_error(e) is None:
                    raise
                first_err = e
            finally:
                _tls.depth = 0
        on_card = _on_card(args)
        if self._floor == "numpy" and host_fn is not None and not on_card:
            # the backend is gone: the seam call still advances the
            # chaos plans' windows (so a timed fault can clear), then
            # the ground-truth twin completes the dispatch
            if plan is not None:
                plan.poll(seam)
            hplan = chaos_hosts.active_host_plan()
            if hplan is not None:
                hplan.poll(seam, 0)
            out = self._host_complete(seam, host_fn, args)
            self._after_dispatch()
            return out
        cur_fn = fn
        escalations = 0
        while True:
            try:
                out = self._run_with_retry(seam, cur_fn, args, plan,
                                           first_err)
                break
            except BaseException as e:  # noqa: BLE001 — classified,
                # unclassified errors re-raise immediately below
                cls = classify_dispatch_error(e)
                if cls is None:
                    raise
                if cls == "oom":
                    b = self._batch_of(args)
                    if (splittable and b is not None and b > 1
                            and _depth < _MAX_SPLIT_DEPTH):
                        # the failed attempt's frames hold what it had
                        # allocated: drop them before the halves run
                        e.__traceback__ = None
                        first_err = None
                        return self._split_redispatch(
                            seam, cur_fn, args, host_fn=host_fn,
                            rebuild=rebuild, verifiable=verifiable,
                            depth=_depth)
                    # nothing left to split: the device genuinely
                    # cannot hold rung 1 — treat as backend loss
                escalations += 1
                if escalations > _MAX_ESCALATIONS:
                    raise
                verdict = self._escalate(seam, e, cur_fn,
                                         rebuild=rebuild,
                                         host_fn=host_fn, cls=cls,
                                         on_card=on_card,
                                         kind=_dispatch_kind(args))
                if verdict is _HOST:
                    out = self._host_complete(seam, host_fn, args)
                    break
                cur_fn = verdict
            finally:
                first_err = None
        if verifiable:
            out = self._maybe_self_verify(seam, out, args,
                                          host_fn=host_fn,
                                          rebuild=rebuild, fn=cur_fn,
                                          on_card=on_card)
        self._after_dispatch()
        return out

    # -- attempt layer ---------------------------------------------------

    def _run_with_retry(self, seam, fn, args, plan,
                        first_err: Optional[BaseException] = None):
        """One retry schedule over the seam.  ``first_err``: the clean
        path's call already ran and raised it; it stands as the
        schedule's first attempt."""
        from ..telemetry import metrics as tel
        from ..telemetry import tracing
        pending = [first_err] if first_err is not None else []

        def once():
            if pending:
                raise pending.pop()
            self._poll_host_plan(seam)
            fault = plan.poll(seam) if plan is not None else None
            return self._call_once(seam, fn, args, fault, plan)

        def on_retry(_i, delay, e):
            self._count("retries")
            tel.counter("supervisor_retries", seam=seam,
                        error=type(e).__name__)
            if tracing.enabled():
                # on_retry fires before the backoff sleep, so the
                # interval [now, now+delay] is the clock time this
                # dispatch spent backing off
                now = self.clock.monotonic()
                tracing.note_retry(seam, now, now + delay,
                                   error=type(e).__name__)

        return retry_call(once, policy=self.retry_policy,
                          clock=self.clock, on_retry=on_retry)

    def _poll_host_plan(self, seam) -> None:
        """One host-fault-plan poll per dispatch attempt: does this
        dispatch land on a host the adversary holds down?  The plan is
        polled with the plane's CURRENT host count (1 with no plane: the
        process itself is one fault domain), so a fault whose host the
        reshrink already evicted goes quiet."""
        from ..chaos.hosts import (InjectedHostLoss,
                                   InjectedHostPartition,
                                   active_host_plan)
        hplan = active_host_plan()
        if hplan is None:
            return
        from ..parallel import plane as planemod
        p = planemod.data_plane()
        hosts = 1 if p is None else p.hosts
        fault = hplan.poll(seam, hosts)
        if fault is None:
            return
        self._count("injected_faults")
        if fault.kind == "host_partition":
            raise InjectedHostPartition(
                f"injected partition: host {fault.host} fenced at "
                f"seam {seam!r} — its writes are stale and must be "
                f"epoch-fenced")
        raise InjectedHostLoss(
            f"injected loss of host {fault.host} at seam {seam!r}")

    def _call_once(self, seam, fn, args, fault, plan):
        from ..chaos.dispatch import (DispatchHang,
                                      InjectedBackendLoss, InjectedOom)
        from ..telemetry import metrics as tel
        from ..telemetry import recorder
        if fault is not None:
            self._count("injected_faults")
            if fault.kind == "transient":
                raise TransientBackendError(
                    f"injected transient dispatch error at seam "
                    f"{seam!r}")
            if fault.kind == "oom":
                raise InjectedOom(seam)
            if fault.kind == "backend_loss":
                raise InjectedBackendLoss(
                    f"injected backend loss at seam {seam!r}")
            if fault.kind == "hang":
                dl = self.deadline_s or _DEFAULT_HANG_S
                # the wedged call burns the deadline on the injectable
                # clock, then the supervisor classifies the overrun
                self.clock.sleep(dl * 2)
                self._count("hangs")
                tel.counter("supervisor_hangs", seam=seam)
                raise DispatchHang(
                    f"dispatch at seam {seam!r} exceeded deadline "
                    f"{dl}s (injected hang)")
        t0 = self.clock.monotonic()
        with _inside_seam():
            out = fn(*args)
        elapsed = self.clock.monotonic() - t0
        if self.deadline_s is not None and elapsed > self.deadline_s:
            # post-hoc hang detection: the result did arrive, but a
            # dispatch this slow is a wedging backend — count it and
            # breadcrumb the flight ring
            self._count("slow_dispatches")
            tel.counter("supervisor_slow_dispatches", seam=seam)
            recorder.note("supervisor_slow", seam=seam,
                          elapsed=round(elapsed, 6),
                          deadline=self.deadline_s)
        if fault is not None and fault.kind == "corrupt":
            out = _like(out, plan.corrupt_output(fault, seam, out))
        return out

    @staticmethod
    def _batch_of(args) -> Optional[int]:
        if not args:
            return None
        shape = getattr(args[0], "shape", None)
        if not shape:
            return None
        return int(shape[0])

    def _split_redispatch(self, seam, fn, args, *, host_fn, rebuild,
                          verifiable, depth):
        from ..telemetry import metrics as tel
        from ..telemetry import tracing
        stack = args[0]
        b = int(stack.shape[0])
        mid = (b + 1) // 2
        if tracing.enabled():
            tracing.annotate("supervisor_rung_downshift",
                             self.clock.monotonic(), seam=seam,
                             batch=b, split=f"{mid}+{b - mid}")
        self._count("rung_downshifts")
        tel.counter("supervisor_rung_downshifts", seam=seam)
        tel.event("supervisor_rung_downshift", seam=seam, batch=b,
                  split=(mid, b - mid))
        dout("ec", 1, f"supervisor: out of memory at {seam}; "
                      f"splitting batch {b} -> {mid}+{b - mid}")
        halves = []
        for cut in (slice(0, mid), slice(mid, b)):
            halves.append(self.dispatch(
                seam, fn, _cut_batch(args, b, cut), host_fn=host_fn,
                rebuild=rebuild, splittable=True,
                verifiable=verifiable, _depth=depth + 1))
        return _concat_outputs(halves[0], halves[1])

    # -- escalation ------------------------------------------------------

    def _card_failure(self, seam, cls, err) -> DeviceDispatchError:
        """A failure on the card that would step the tier down: counted,
        flight-recorded, and returned as the error to raise."""
        from ..telemetry import metrics as tel
        from ..telemetry import recorder
        what = f"{type(err).__name__}: {err}"
        self._count("card_failures")
        tel.counter("supervisor_card_failures", seam=seam, cls=cls)
        tel.event("supervisor_card_failure", seam=seam, cls=cls,
                  error=what)
        recorder.trip("backend_lost",
                      f"persistent dispatch failure on the card at "
                      f"{seam} ({cls}): {what}", seam=seam, cls=cls)
        dout("ec", 1, f"supervisor: {cls} on the card at {seam}; "
                      f"raising ({what})")
        return DeviceDispatchError(seam, cls, what)

    def _escalate(self, seam, err, cur_fn, *, rebuild, host_fn, cls=None,
                  on_card=False, kind="cpu"):
        """Persistent failure: quarantine a whole host fault domain
        (``host_loss`` on a multi-host plane), else a mesh member (a
        plane of two or more members and a seam that can rebuild), else
        — on the card — raise DeviceDispatchError, else demote the
        backend tier.  A plane is narrowed only for a dispatch of its own
        device ``kind``: a card plane is no help to a CPU tensor or a
        host row, nor a CPU plane to the card.  Returns the next callable
        to try, or ``_HOST``."""
        if rebuild is not None:
            from ..parallel import plane as planemod
            p = planemod.data_plane()
            if p is not None and p.kind == kind:
                if cls == "host_loss" and p.hosts > 1:
                    return self._host_quarantine(seam, p, rebuild)
                if p.n_devices > 1:
                    return self._quarantine(seam, p, rebuild)
        if on_card:
            raise self._card_failure(seam, cls or "backend_loss", err) \
                from err
        return self._demote_tier(seam, err, cur_fn, rebuild=rebuild,
                                 host_fn=host_fn)

    def _narrowed(self, p) -> None:
        """Remember the plane's original width, host partition and kind
        (what re-promotion restores), at its first reshrink."""
        with self._lock:
            if self._plane_width0 is None:
                self._plane_width0 = p.n_devices
                self._plane_kind0 = p.kind
            if self._plane_hosts0 is None and p.hosts > 1:
                self._plane_hosts0 = p.hosts

    def _host_quarantine(self, seam, p, rebuild):
        """Evict one host fault domain: halve the host count (every
        member the lost domain contributed goes at once), replay the
        lost host's journaled in-flight intents onto the survivor plane,
        and rebuild the seam's callable."""
        from ..parallel import plane as planemod
        from ..telemetry import metrics as tel
        from ..telemetry import recorder, tracing
        n_hosts, dph, n = p.hosts, p.devices_per_host, p.n_devices
        if tracing.enabled():
            tracing.annotate("supervisor_host_quarantine",
                             self.clock.monotonic(), seam=seam,
                             from_hosts=n_hosts, from_devices=n)
        self._narrowed(p)
        nxt_h = n_hosts // 2
        nxt = nxt_h * dph
        self._count("host_quarantines")
        tel.counter("supervisor_host_quarantines", seam=seam)
        tel.event("supervisor_host_quarantine", seam=seam,
                  from_hosts=n_hosts, to_hosts=max(nxt_h, 1),
                  from_devices=n, to_devices=max(nxt, 1))
        recorder.trip(
            "host_quarantined",
            f"host fault domain lost at {seam}: plane reshrink "
            f"{n_hosts}x{dph} -> {max(nxt_h, 1)}x{dph} hosts",
            seam=seam, from_hosts=n_hosts, to_hosts=max(nxt_h, 1),
            from_devices=n, to_devices=max(nxt, 1))
        plane_degraded(
            f"host quarantine at {seam}: {n_hosts} -> "
            f"{max(nxt_h, 1)} hosts", seam=seam,
            from_devices=n, to_devices=max(nxt, 1))
        dout("ec", 1, f"supervisor: quarantining host domain at "
                      f"{seam}; plane {n_hosts}x{dph} -> "
                      f"{max(nxt_h, 1)}x{dph}")
        if nxt >= 2:
            planemod.activate(nxt, hosts=nxt_h, kind=p.kind)
        else:
            planemod.deactivate()
        self._cache_clear()
        self._reclaim_inflight(seam)
        return rebuild()

    def _reclaim_inflight(self, seam) -> int:
        """Run the registered journal reclaim hook (if any): replay the
        lost host's intent records onto the shrunken plane; counted and
        flight-noted so the re-dispatch is attributable."""
        with self._lock:
            cb = self._inflight_reclaim
        if cb is None:
            return 0
        n = int(cb(seam) or 0)
        if n:
            from ..telemetry import metrics as tel
            from ..telemetry import recorder
            self._count("journal_redispatches", n)
            tel.counter("supervisor_journal_redispatches", seam=seam)
            tel.event("supervisor_journal_redispatch", seam=seam, ops=n)
            recorder.note("journal_redispatch", seam=seam, ops=n)
        return n

    def _quarantine(self, seam, p, rebuild):
        """Evict mesh members: halve the plane's width (keeping its host
        partition where it still divides the narrowed width) and rebuild
        the seam's callable."""
        from ..parallel import plane as planemod
        from ..telemetry import metrics as tel
        from ..telemetry import recorder, tracing
        n = p.n_devices
        if tracing.enabled():
            tracing.annotate("supervisor_quarantine",
                             self.clock.monotonic(), seam=seam,
                             from_devices=n)
        self._narrowed(p)
        nxt = n // 2
        self._count("quarantines")
        tel.counter("supervisor_quarantines", seam=seam)
        tel.event("supervisor_quarantine", seam=seam, from_devices=n,
                  to_devices=nxt)
        recorder.trip(
            "device_quarantined",
            f"mesh-member dispatch failure at {seam}: plane reshrink "
            f"{n} -> {max(nxt, 1)}",
            seam=seam, from_devices=n, to_devices=max(nxt, 1))
        plane_degraded(
            f"mesh-member quarantine at {seam}: {n} -> "
            f"{max(nxt, 1)} devices", seam=seam,
            from_devices=n, to_devices=max(nxt, 1))
        dout("ec", 1, f"supervisor: quarantining mesh member at "
                      f"{seam}; plane {n} -> {max(nxt, 1)}")
        if nxt >= 2:
            h = p.hosts if nxt % p.hosts == 0 else 1
            planemod.activate(nxt, hosts=h, kind=p.kind)
        else:
            planemod.deactivate()
        self._cache_clear()
        return rebuild()

    def _demote_tier(self, seam, err, cur_fn, *, rebuild, host_fn):
        """Step the backend tier down (CPU tensors and host rows)."""
        from ..telemetry import metrics as tel
        from ..telemetry import recorder
        pol = self._policy()
        cur = pol.engine()
        if cur == "numpy":
            # already at the floor: the ground-truth twin completes the
            # dispatch; with no twin there is nothing left
            if host_fn is not None:
                return _HOST
            raise err
        to = pol.demote()
        with self._lock:
            self._tier_demotions += 1
            if to == "numpy":
                self._floor = "numpy"
        from ..telemetry import tracing
        if tracing.enabled():
            tracing.annotate("supervisor_demote",
                             self.clock.monotonic(), seam=seam,
                             frm=cur, to=to,
                             error=type(err).__name__)
        self._count("demotions")
        tel.counter("supervisor_demotions", seam=seam, to=to)
        tel.event("supervisor_demote", seam=seam, frm=cur, to=to,
                  error=f"{type(err).__name__}: {err}")
        recorder.trip(
            "backend_demoted",
            f"persistent dispatch failure at {seam}: live demotion "
            f"{cur} -> {to} ({type(err).__name__}: {err})",
            seam=seam, frm=cur, to=to)
        self._cache_clear()
        if to == "numpy":
            if host_fn is not None:
                return _HOST
            raise err
        return rebuild() if rebuild is not None else cur_fn

    def _host_complete(self, seam, host_fn, args):
        from ..telemetry import metrics as tel
        from .fallback import numpy_tier
        self._count("host_completions")
        tel.counter("supervisor_host_completions", seam=seam)
        with numpy_tier(), _inside_seam():
            return host_fn(*args)

    # -- self-verify -----------------------------------------------------

    def _maybe_self_verify(self, seam, out, args, *, host_fn, rebuild,
                           fn, on_card=False):
        if (not self.self_verify or host_fn is None
                or (self._floor == "numpy" and not on_card)):
            return out
        parts = out if isinstance(out, (tuple, list)) else (out,)
        if not all(hasattr(p, "dtype") for p in parts):
            # only array outputs have CRC-comparable bytes; seams that
            # return host bookkeeping objects are not verifiable
            return out
        with self._lock:
            self._verify_seq += 1
            seq = self._verify_seq
        if seq % self.verify_every:
            return out
        from ..telemetry import metrics as tel
        from ..telemetry import recorder
        from .fallback import numpy_tier
        with numpy_tier(), _inside_seam():
            truth = host_fn(*(_to_host(args) if on_card else args))
        if _crc_output(out) == _crc_output(truth):
            self._count("verified_clean")
            return out
        # corrupted output: flight-record, reclassify as a backend
        # fault, redispatch on the demoted tier — and NEVER return the
        # corrupted bytes
        self._count("verify_failures")
        tel.counter("supervisor_verify_failures", seam=seam)
        tel.event("supervisor_verify_failure", seam=seam)
        recorder.trip(
            "output_corruption",
            f"self-verify CRC mismatch at {seam}: device output "
            f"differs from the numpy ground truth",
            seam=seam)
        dout("ec", 1, f"supervisor: self-verify CRC mismatch at "
                      f"{seam}; reclassifying as backend fault")
        err = RuntimeError(
            f"self-verify CRC mismatch at seam {seam!r}")
        if on_card:
            # the ground truth lies on the host: a card dispatch raises
            # rather than re-run on a narrowed plane and return host bytes
            raise self._card_failure(seam, "corrupt", err)
        try:
            verdict = self._escalate(seam, err, fn, rebuild=rebuild,
                                     host_fn=host_fn,
                                     kind=_dispatch_kind(args))
        except RuntimeError:
            return truth        # ladder exhausted: ground truth wins
        if verdict is _HOST:
            self._count("host_completions")
            return truth
        with _inside_seam():
            redone = verdict(*args)
        if _crc_output(redone) == _crc_output(truth):
            return redone
        return truth            # still corrupt: ground truth, always

    # -- health probe / re-promotion -------------------------------------

    def _after_dispatch(self) -> None:
        if not self.demoted:
            return
        with self._lock:
            self._since_probe += 1
            fire = self._since_probe >= self.probe_every
            if fire:
                self._since_probe = 0
        if fire:
            self.tick()

    def _probe_ok(self) -> bool:
        from ..chaos.dispatch import active_plan
        from ..chaos.hosts import active_host_plan
        plan = active_plan()
        if plan is not None and plan.pending_persistent():
            return False
        hplan = active_host_plan()
        return hplan is None or not hplan.pending_persistent()

    def tick(self) -> bool:
        """One health-probe step (supervised dispatches call it every
        ``probe_every`` completions while demoted; a caller may drive
        it).  Returns True when a re-promotion happened."""
        from ..telemetry import metrics as tel
        if not self.demoted:
            return False
        if self._probe_ok():
            with self._lock:
                self._clean_probes += 1
                promote = self._clean_probes >= self.promote_after
            self._count("probe_clean")
            tel.counter("supervisor_probe_clean")
            if promote:
                self._repromote()
                return True
        else:
            with self._lock:
                self._clean_probes = 0
            self._count("probe_failed")
            tel.counter("supervisor_probe_failed")
        return False

    def _repromote(self) -> None:
        from ..telemetry import metrics as tel
        from ..telemetry import recorder
        pol = self._policy()
        # claim the demotion state atomically, then act on the local
        # copy: pol.promote() takes its own lock and must not run under
        # ours (the lock-order registry's ranks)
        with self._lock:
            n_demotions = self._tier_demotions
            self._tier_demotions = 0
            width0, self._plane_width0 = self._plane_width0, None
            hosts0, self._plane_hosts0 = self._plane_hosts0, None
            kind0, self._plane_kind0 = self._plane_kind0, None
            self._floor = None
            self._clean_probes = 0
        restored = None
        for _ in range(n_demotions):
            restored = pol.promote()
        if width0 is not None:
            from ..parallel import plane as planemod
            # the recovered host re-joins: full width AND the original
            # host partition come back together
            planemod.activate(width0, hosts=hosts0 or 1, kind=kind0)
        self._cache_clear()
        from ..telemetry import tracing
        if tracing.enabled():
            tracing.annotate("supervisor_repromote",
                             self.clock.monotonic(),
                             tier=restored or "",
                             plane_width=width0 or 0,
                             plane_hosts=hosts0 or 0)
        self._count("repromotions")
        tel.counter("supervisor_repromotions")
        if hosts0 and hosts0 > 1:
            self._count("host_repromotions")
            tel.counter("supervisor_host_repromotions")
        tel.event("supervisor_repromote", tier=restored,
                  plane_width=width0, plane_hosts=hosts0)
        recorder.trip(
            "repromoted",
            f"health probe clean x{self.promote_after}: tier restored "
            f"to {restored or 'probed'}"
            + (f", plane restored to {width0} devices"
               if width0 else "")
            + (f" across {hosts0} hosts" if hosts0 else ""),
            tier=restored or "", plane_width=width0 or 0,
            plane_hosts=hosts0 or 0)
        dout("ec", 1, f"supervisor: re-promoted (tier={restored}, "
                      f"plane={width0}, hosts={hosts0})")


# ----------------------------------------------------------------------
# shared degrade bookkeeping: ONE emission shape for every path that
# narrows the data plane (activation-time degrade in parallel/plane.py,
# device and host quarantine)

def plane_degraded(reason: str, *, seam: str = "parallel.plane",
                   from_devices: Optional[int] = None,
                   to_devices: int = 1) -> None:
    """Record one plane-narrowing event: ``engine_mesh_degraded``
    counter + structured event + flight-ring note.

    Deliberately module-level and lock-free on the supervisor side
    (telemetry locks only, ranks 300+): the data plane calls this while
    holding its own lock, and routing through the rank-120
    ``global_supervisor()`` singleton lock there would invert the
    declared lock order (analysis/lockmodel.py)."""
    from ..telemetry import metrics as tel
    from ..telemetry import recorder
    tel.counter("engine_mesh_degraded")
    tel.event("engine_mesh_degraded", reason=reason, seam=seam,
              from_devices=from_devices, to_devices=to_devices)
    recorder.note("engine_mesh_degraded", reason=reason, seam=seam,
                  from_devices=from_devices, to_devices=to_devices)


# ----------------------------------------------------------------------
# the process supervisor

_global: Optional[DispatchSupervisor] = None
_global_lock = make_lock("ops.supervisor._global_lock")


def global_supervisor() -> DispatchSupervisor:
    global _global
    sup = _global       # installed: one read, no lock (every dispatch asks)
    if sup is not None:
        return sup
    with _global_lock:
        if _global is None:
            _global = DispatchSupervisor()
        return _global


def set_global_supervisor(sup: Optional[DispatchSupervisor]
                          ) -> Optional[DispatchSupervisor]:
    """Swap the process supervisor (tests); returns the previous one."""
    global _global
    with _global_lock:
        prev = _global
        _global = sup
        return prev


def supervised(seam: str, fn: Callable, args: Tuple, *,
               host_fn: Optional[Callable] = None,
               rebuild: Optional[Callable] = None,
               splittable: bool = True, verifiable: bool = True):
    """The seam-side entry: route one dispatch through the process
    supervisor (from inside another seam's callable it runs ``fn``
    alone, as the reference's traced calls bypass supervision)."""
    if _tls.depth:
        return fn(*args)
    return global_supervisor().dispatch(
        seam, fn, args, host_fn=host_fn, rebuild=rebuild,
        splittable=splittable, verifiable=verifiable)


# ----------------------------------------------------------------------
# the host-tier audit workload

def supervisor_selftest() -> dict:
    """The ``ops.supervisor`` host-tier audit entry: the full
    classification ladder — transient retry, OOM split, persistent
    backend loss with live demotion to the ground-truth twin,
    corrupt-output self-verify, health-probe re-promotion — on ISOLATED
    state (own FakeClock, own FallbackPolicy, own fault plan, no
    pattern cache): zero device tensors.  The supervisor is host
    control flow by construction — a recovery plane that itself needed
    the device would deadlock exactly when it matters."""
    from ..chaos.dispatch import (DispatchFault, DispatchFaultPlan,
                                  arm_plan)
    from ..utils.retry import FakeClock
    from .fallback import FallbackPolicy

    pol = FallbackPolicy(force="torch")
    sup = DispatchSupervisor(
        clock=FakeClock(), policy=pol, cache_clear=lambda: None,
        self_verify=True, promote_after=2,
        probe_every=1)
    data = np.arange(64, dtype=np.uint8).reshape(4, 16)

    def body(x):
        return x ^ np.uint8(0xA5)

    plan = DispatchFaultPlan([
        DispatchFault("transient", seam="selftest.seam", at=2,
                      calls=1),
        DispatchFault("oom", seam="selftest.seam", at=4, calls=1),
        DispatchFault("corrupt", seam="selftest.seam", at=7, calls=1),
        DispatchFault("backend_loss", seam="selftest.seam", at=9,
                      calls=3),
    ], seed=7)
    prev = arm_plan(plan)
    try:
        want = body(data)
        for _ in range(8):
            got = sup.dispatch("selftest.seam", body, (data,),
                               host_fn=body)
            if _crc_output(got) != _crc_output(want):
                raise AssertionError("supervised output diverged")
        st = sup.stats()
        if not (st["retries"] >= 1 and st["rung_downshifts"] >= 1
                and st["verify_failures"] >= 1):
            raise AssertionError(f"ladder not exercised: {st}")
        if st["demotions"] < 1 or not st["demoted"]:
            raise AssertionError(f"no demotion recorded: {st}")
        plan.clear()
        for _ in range(4):
            got = sup.dispatch("selftest.seam", body, (data,),
                               host_fn=body)
            if _crc_output(got) != _crc_output(want):
                raise AssertionError("post-heal output diverged")
        if not sup.stats()["repromotions"]:
            sup.tick()
        st = sup.stats()
        if not st["repromotions"] or st["demoted"]:
            raise AssertionError(f"re-promotion never happened: {st}")
        if pol.engine() != "torch":
            raise AssertionError("policy tier not restored")
    finally:
        arm_plan(prev)
    return sup.stats()


__all__ = ["CUDA_LOSS_CODES", "CUDA_OOM_CODES", "DispatchSupervisor",
           "classify_dispatch_error", "global_supervisor", "plane_degraded",
           "set_global_supervisor", "supervised",
           "supervisor_selftest"]
