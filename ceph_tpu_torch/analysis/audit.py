"""The entry-point audit — the port's counterpart of
``ceph_tpu/analysis/jaxpr_audit.py``.

There is no jaxpr to walk in eager torch, so the audit runs each
registered entry point (analysis/entrypoints.py) and checks what the
reference's jaxpr rules and recompile sentinel stand for:

1. **No rebuild** (``audit-setup``).  A cold run counts at most the
   entry's ``setup_budget`` kernel setups (libraries loaded, kernel data
   uploaded: ``telemetry.metrics.note_kernel_setup``), and a warm repeat
   counts none — the reference's warm == 0 compile sentinel.
2. **Every tier byte-identical** (``audit-bytes``).  A device entry's
   output equals, byte for byte, the torch tier's (the entry built on
   the CPU, run on host copies of the args) and the numpy ground
   truth's (the entry's ``twin``, else the CPU build under
   ``ops.fallback.numpy_tier``).
3. **No host sync on the hot path** (``audit-sync``), on the card only.
   A warm repeat runs under ``torch.cuda.set_sync_debug_mode("error")``:
   a synchronizing call raises.  A sync the entry declares
   (``sync_ok``, with its reason) is allowed; a declared sync that no
   longer happens is drift and fails too (the reference's allow sets
   fail on drift both ways).

Host entries run twice and must return no CUDA tensor and set up
nothing.  ``audit-error`` is an entry that fails to build or run; a
kernel that fails to build or launch raises instead.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from .entrypoints import Built, EntryPoint, registry

@dataclasses.dataclass
class EntryAudit:
    """One entry's audit: setup counts, tiers compared, the sync check,
    and the findings (``rule: message``)."""
    name: str
    kind: str
    device: str
    cold_setups: int = 0
    warm_setups: int = 0
    setup_budget: int = 0
    tiers: List[str] = dataclasses.field(default_factory=list)
    sync: str = "n/a"           # "none" | "declared" | "n/a" (off the card)
    findings: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings


def _flat(out) -> list:
    """An output (tensor, array, tuple/list/dict of them, scalar) as a
    flat list of leaves."""
    if isinstance(out, dict):
        return [v for k in sorted(out) for v in _flat(out[k])]
    if isinstance(out, (tuple, list)):
        return [v for o in out for v in _flat(o)]
    return [out]


def _leaf_bytes(x) -> tuple:
    """(dtype-free shape, bytes) of one output leaf."""
    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        if t.dtype != torch.uint8:
            t = t.view(torch.uint8)
        return tuple(t.shape), t.cpu().numpy().tobytes()
    a = np.ascontiguousarray(np.asarray(x))
    return tuple(a.view(np.uint8).shape), a.tobytes()


def output_bytes(out) -> list:
    """An entry's output as comparable bytes, leaf by leaf."""
    return [_leaf_bytes(x) for x in _flat(out)]


def _has_cuda(out) -> bool:
    import torch
    return any(isinstance(x, torch.Tensor) and x.device.type == "cuda"
               for x in _flat(out))


def _host_args(args) -> tuple:
    import torch
    return tuple(a.detach().cpu() if isinstance(a, torch.Tensor) else a
                 for a in args)


def _numpy_args(args) -> tuple:
    import torch
    return tuple(a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                 else a for a in args)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _setups(fn) -> tuple:
    """(fn's output, kernel setups it counted)."""
    from ..telemetry import metrics as tel
    before = tel.kernel_setups()
    out = fn()
    return out, tel.kernel_setups() - before


def _audit_host(entry: EntryPoint, res: EntryAudit) -> None:
    built = entry.build()
    out, res.cold_setups = _setups(lambda: built.fn(*built.args))
    out2, res.warm_setups = _setups(lambda: built.fn(*built.args))
    if _has_cuda(out) or _has_cuda(out2):
        res.findings.append("audit-host: a host entry returned a CUDA "
                            "tensor")
    if res.cold_setups or res.warm_setups:
        res.findings.append(
            f"audit-setup: a host entry set up kernels "
            f"({res.cold_setups} cold, {res.warm_setups} warm)")


def _audit_device(entry: EntryPoint, res: EntryAudit, dev) -> None:
    import torch

    from ..ops.fallback import numpy_tier

    built: Built = entry.build(dev)

    def run():
        out = built.fn(*built.args)
        _sync(dev)
        return out
    out, res.cold_setups = _setups(run)
    if res.cold_setups > entry.setup_budget:
        res.findings.append(
            f"audit-setup: cold run set up {res.cold_setups} kernels, "
            f"budget {entry.setup_budget}")
    warm, res.warm_setups = _setups(run)
    if res.warm_setups:
        res.findings.append(
            f"audit-setup: warm repeat set up {res.warm_setups} kernels")

    # the sync check: one more warm repeat with synchronizing calls
    # raising (the card only: the CPU has no host sync to find)
    if dev.type == "cuda":
        _sync(dev)
        found = None
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            built.fn(*built.args)
        except RuntimeError as e:
            found = str(e).splitlines()[0]
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        _sync(dev)
        if found and not entry.sync_ok:
            res.findings.append(f"audit-sync: warm repeat synchronized "
                                f"with the host: {found}")
        elif not found and entry.sync_ok:
            res.findings.append("audit-sync: declared sync did not happen "
                                f"(drift): {entry.sync_ok}")
        res.sync = "declared" if found else "none"

    # every tier byte-identical: the device's output, the torch tier's
    # (the CPU build on host copies), the numpy ground truth's
    got = output_bytes(out)
    tiers = {dev.type: got}
    if output_bytes(warm) != got:
        res.findings.append("audit-bytes: warm repeat differs from the "
                            "cold run")
    cpu = torch.device("cpu")
    host = entry.build(cpu) if dev.type != "cpu" else built
    host_args = _host_args(host.args)
    if dev.type != "cpu":
        tiers["torch"] = output_bytes(host.fn(*host_args))
    if built.twin is not None:
        tiers["numpy"] = output_bytes(built.twin(*_numpy_args(host_args)))
    else:
        with numpy_tier():
            tiers["numpy"] = output_bytes(host.fn(*host_args))
    res.tiers = sorted(tiers)
    for tier, b in sorted(tiers.items()):
        if b != got:
            res.findings.append(f"audit-bytes: the {tier} tier differs "
                                f"from the {dev.type} output")


def audit_entry(entry: EntryPoint, device=None) -> EntryAudit:
    """Run the checks of one entry; device entries on ``device`` (default
    the card; NoDeviceError without one)."""
    from ..ops.fallback import resolve_device
    from ..utils.errors import KernelBuildError, KernelLaunchError

    dev = resolve_device(device) if entry.kind == "device" else None
    res = EntryAudit(name=entry.name, kind=entry.kind,
                     device=str(dev) if dev is not None else "host",
                     setup_budget=entry.setup_budget)
    try:
        if entry.kind == "host":
            _audit_host(entry, res)
        else:
            _audit_device(entry, res, dev)
    except (KernelBuildError, KernelLaunchError):
        raise                   # a kernel that cannot run is not a finding
    except Exception as e:  # noqa: BLE001 — a failing entry is a finding
        res.findings.append(f"audit-error: {type(e).__name__}: {e}")
    return res


def audit_registry(entries: Optional[Sequence[EntryPoint]] = None,
                   device=None) -> List[EntryAudit]:
    """Audit every entry (default: the whole registry) in order, with
    telemetry recording on (the setup counts read the metrics plane)."""
    from ..telemetry import metrics as tel

    prev = tel.set_enabled(True)
    try:
        return [audit_entry(e, device)
                for e in (entries if entries is not None else registry())]
    finally:
        tel.set_enabled(prev)


__all__ = ["EntryAudit", "audit_entry", "audit_registry",
           "output_bytes"]
