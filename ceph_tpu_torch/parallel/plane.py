"""The process data plane — which members (if any) the engine shards
over; the port of ``ceph_tpu/parallel/plane.py``.

When a :class:`DataPlane` is active, ``ops/gf_kernels.py::
select_matrix_engine`` returns ``"mesh"`` for stripe-batched shapes
whose tensors are of the plane's device kind, ``apply_matrix_best`` /
``apply_matrix_packed_best`` run their per-member tier on equal shards
of the stripe batch (``utils/shard.py``), the engine's fused repair and
serving callables (codes/engine.py) build sharded variants cached in
the same PatternCache keyspace, and ``crush/bulk.py`` shards the x
axis.

Activation is explicit — ``activate()`` / the ``mesh_plane()`` context
manager / the ``CEPH_TPU_MESH`` env knob — never inferred from the
device count alone.

Degrade policy (as ops/fallback.py): a plane that cannot form (fewer
than 2 members, no device of the kind) degrades to the single-device
tier — never to the host — with a log line and the supervisor's
``engine_mesh_degraded`` counter (``ops/supervisor.py::plane_degraded``).

``CEPH_TPU_MESH``:
- unset / ``0`` / ``off``  — no auto-activation (explicit only);
- ``auto`` / ``on``        — activate over every visible member at
  first use;
- ``<N>``                  — activate over the first N members.

Host fault domains: the plane carries a ``hosts`` partition —
``n_devices = hosts * devices_per_host`` — so the supervisor can
quarantine a whole host (every member it contributes) in one reshrink
step.  ``CEPH_TPU_HOSTS``:

- unset / ``0`` / ``off`` / ``1`` — a single fault domain;
- ``auto`` / ``on``               — one domain per process of the
  ``torch.distributed`` group (its world size; 1 without one);
- ``<H>``                         — H simulated fault domains carved out
  of the visible members.

A host count that does not divide the member count clamps the plane
down to ``hosts * (n_devices // hosts)`` members: fault domains are
equal-width.  Real multi-process fleets bootstrap through
:func:`init_distributed`.

Members are ``torch.device``s of one kind: the card's when torch sees
one, else the CPU's (``mesh.default_kind``).  On one card (or one CPU)
a plane forms only over virtual members
(``CEPH_TPU_TORCH_VIRTUAL_DEVICES``, parallel/mesh.py).
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Optional

import torch

from ..utils.errors import NoDeviceError
from ..utils.locks import make_lock
from ..utils.log import dout

DEFAULT_AXIS = "stripe"


class DataPlane:
    """An active mesh + the axis name the stripe batch shards over.

    The mesh is 2-D ``(stripe, chunk)`` with tp=1 for the engine tier
    (pure data parallelism over independent stripes; the chunk-axis tp
    path stays in parallel/sharded_codes.py) — but any mesh whose axis
    ``axis`` is the batch axis works."""

    def __init__(self, mesh, axis: str = DEFAULT_AXIS,
                 hosts: int = 1) -> None:
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {axis!r} "
                             f"(axes: {mesh.axis_names})")
        n = int(mesh.shape[axis])
        if hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {hosts}")
        if n % hosts:
            raise ValueError(f"hosts={hosts} does not divide the "
                             f"{n}-device {axis!r} axis: fault domains "
                             f"must be equal-width")
        self.mesh = mesh
        self.axis = axis
        self.hosts = hosts
        self.members = mesh.members(axis)

    @property
    def n_devices(self) -> int:
        """Members on the sharded axis (= members doing stripe work)."""
        return int(self.mesh.shape[self.axis])

    @property
    def devices_per_host(self) -> int:
        """Sharded-axis members each host fault domain contributes."""
        return self.n_devices // self.hosts

    @property
    def kind(self) -> str:
        """The members' device type ("cuda" or "cpu")."""
        return self.members[0].type

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"DataPlane(axis={self.axis!r}, "
                f"shape={self.mesh.shape}, hosts={self.hosts})")


_lock = make_lock("parallel.plane._lock")
_active: Optional[DataPlane] = None
_env_resolved = False


class _Depth(threading.local):
    depth = 0           # a class default: no AttributeError on a new thread


_tls = _Depth()


@contextmanager
def single_device():
    """Inside a mesh-tier body the per-member compute must select the
    SINGLE-device tier (a nested shard would be wrong math and wrong
    topology).  ``utils/shard.py::shard_batch`` runs each member's body
    under this; it is thread-local."""
    _tls.depth += 1
    try:
        yield
    finally:
        _tls.depth -= 1


def tuned_fanout() -> Optional[int]:
    """The autotuner's shard fan-out seam: the tuned width of an
    AUTO-activated plane from the installed best-config table (kind
    ``mesh-fanout``), or None (every visible member).  An explicit
    ``activate(N)`` / ``CEPH_TPU_MESH=N`` always wins — tuning narrows
    the default, it never overrides an operator."""
    from ..tune.table import consult
    cfg = consult("mesh-fanout", engine="mesh")
    if cfg:
        v = cfg.get("n_devices")
        if isinstance(v, int) and not isinstance(v, bool) and v >= 1:
            return v
    return None


def _process_count() -> int:
    """The ``torch.distributed`` group's world size, 1 without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def _resolve_hosts(n: int, hosts: Optional[int]) -> int:
    """The plane's host-domain count: an explicit ``hosts`` argument
    wins; otherwise ``CEPH_TPU_HOSTS`` (see module docstring).  Always
    clamped into ``[1, n]``."""
    if hosts is None:
        env = os.environ.get("CEPH_TPU_HOSTS", "").strip().lower()
        if env in ("", "0", "off", "no", "none", "1"):
            hosts = 1
        elif env in ("auto", "on"):
            hosts = _process_count()
        else:
            try:
                hosts = int(env)
            except ValueError:
                _degrade(f"unparseable CEPH_TPU_HOSTS={env!r}")
                hosts = 1
    return max(1, min(int(hosts), n))


def _build_plane(n_devices: Optional[int], hosts: Optional[int] = None,
                 kind: Optional[str] = None) -> Optional[DataPlane]:
    """A tp=1 (pure-dp) plane over the first n visible members of
    ``kind`` partitioned into ``hosts`` equal fault domains, or None
    when a plane cannot form — the degrade-to-single-device path,
    logged and counted, never silent."""
    from .mesh import make_mesh, visible_devices
    if n_devices is None:
        n_devices = tuned_fanout()
    try:
        devices = visible_devices(kind)
    except NoDeviceError as e:
        _degrade(f"no usable device ({e})")
        return None
    avail = len(devices)
    n = avail if n_devices is None else min(n_devices, avail)
    h = _resolve_hosts(max(n, 1), hosts)
    if n % h:
        # equal-width fault domains: clamp the plane down to the
        # largest host-divisible width (never silently reshape h)
        n = h * (n // h)
    if n < 2:
        _degrade(f"{n} device(s) visible; mesh tier needs >= 2")
        return None
    return DataPlane(make_mesh(n, tp=1, devices=devices), hosts=h)


def _degrade(reason: str) -> None:
    """Degrade to the single-device tier through the supervisor's shared
    quarantine bookkeeping (ops/supervisor.py::plane_degraded), so
    activation-time degradation and a mid-run reshrink emit the same
    ``engine_mesh_degraded`` counter, event and flight note.  The helper
    is lock-free on the supervisor side (telemetry locks only, ranks
    300+): this may run with ``parallel.plane._lock`` (rank 240) held."""
    dout("ec", 1, f"data plane degraded to single-device: {reason}")
    from ..ops.supervisor import plane_degraded
    plane_degraded(reason, seam="parallel.plane.activate")


def _resolve_env() -> Optional[DataPlane]:
    global _active, _env_resolved
    with _lock:
        if not _env_resolved:
            _env_resolved = True
            env = os.environ.get("CEPH_TPU_MESH", "").strip().lower()
            if env in ("", "0", "off", "no", "none"):
                pass
            elif env in ("auto", "on"):
                _active = _build_plane(None)
            else:
                try:
                    n = int(env)
                except ValueError:
                    _degrade(f"unparseable CEPH_TPU_MESH={env!r}")
                else:
                    _active = _build_plane(n)
        return _active


def data_plane() -> Optional[DataPlane]:
    """The active plane, or None (single-device engine).  Resolves the
    ``CEPH_TPU_MESH`` env default on first call; always None inside a
    :func:`single_device` region.  Once resolved it reads the module
    global and takes no lock (every matrix apply asks)."""
    if _tls.depth:
        return None
    if _env_resolved:
        return _active
    return _resolve_env()


def activate(n_devices: Optional[int] = None,
             hosts: Optional[int] = None,
             kind: Optional[str] = None) -> Optional[DataPlane]:
    """Activate a plane over (the first n of) the visible members of
    ``kind`` (default: the card when torch sees one, else the CPU),
    partitioned into ``hosts`` fault domains (None = CEPH_TPU_HOSTS).
    Returns the plane, or None when one cannot form (degrade policy
    above); the previous plane, if any, is replaced."""
    global _active, _env_resolved
    plane = _build_plane(n_devices, hosts, kind)
    with _lock:
        _env_resolved = True
        _active = plane
    return plane


def deactivate() -> Optional[DataPlane]:
    """Drop back to the single-device engine; returns the old plane."""
    return set_data_plane(None)


def set_data_plane(plane: Optional[DataPlane]) -> Optional[DataPlane]:
    """Swap the process plane (tests); returns the previous one."""
    global _active, _env_resolved
    with _lock:
        prev = _active
        _active = plane
        _env_resolved = True
        return prev


def resolve_plane(mesh) -> Optional[DataPlane]:
    """Resolve a dispatcher's ``mesh`` argument to a DataPlane:

    - ``None``       -> the active plane (or None — single-device);
    - a DataPlane    -> itself;
    - a Mesh         -> wrapped, first axis as the batch axis;
    - falsy (0/False)-> None (mesh tier explicitly disabled).
    """
    if mesh is None:
        return data_plane()
    if isinstance(mesh, DataPlane):
        return mesh
    if not mesh:
        return None
    return DataPlane(mesh, axis=mesh.axis_names[0])


def plane_for(mesh, device) -> Optional[DataPlane]:
    """The plane work on ``device`` shards over, or None: ``mesh`` as
    :func:`resolve_plane` reads it, kept only with two or more members
    of ``device``'s kind (None is the CPU): a CPU tensor never moves
    onto a card plane, nor a card tensor onto a CPU one."""
    plane = resolve_plane(mesh)
    if plane is None or plane.n_devices < 2:
        return None
    kind = "cpu" if device is None else torch.device(device).type
    return plane if plane.kind == kind else None


@contextmanager
def mesh_plane(n_devices: Optional[int] = None,
               hosts: Optional[int] = None, kind: Optional[str] = None):
    """Activate a plane for the duration of a block (bench workloads,
    tests); restores whatever was active before, including "nothing"."""
    global _active, _env_resolved
    with _lock:
        prev, prev_resolved = _active, _env_resolved
    plane = activate(n_devices, hosts, kind)
    try:
        yield plane
    finally:
        with _lock:
            _active, _env_resolved = prev, prev_resolved


def shard_count(default: int = 1) -> int:
    """Stripe-work shards on the active data plane (``default`` when
    none is active)."""
    plane = data_plane()
    return plane.n_devices if plane is not None else default


def plane_topology(plane: Optional[DataPlane] = None) -> Optional[list]:
    """[dp, tp]-style mesh shape for bench metadata, or None."""
    if plane is None:
        plane = data_plane()
    if plane is None:
        return None
    return [int(plane.mesh.shape[a]) for a in plane.mesh.axis_names]


def host_plane_topology(
        plane: Optional[DataPlane] = None) -> Optional[dict]:
    """The active plane's host partition for reports and bench metadata:
    ``{"hosts": H, "devices_per_host": D}``, or None (no plane)."""
    if plane is None:
        plane = data_plane()
    if plane is None:
        return None
    return {"hosts": int(plane.hosts),
            "devices_per_host": int(plane.devices_per_host)}


def init_distributed() -> bool:
    """Bootstrap a real multi-process fleet, env-gated so the simulated
    mode never depends on it: when ``CEPH_TPU_DIST_COORD`` (an address
    such as ``tcp://localhost:29500``), ``CEPH_TPU_DIST_PROCS`` and
    ``CEPH_TPU_DIST_ID`` are all set, calls
    ``torch.distributed.init_process_group`` once (nccl with a card,
    gloo without) and returns True.  Unset (or already initialized):
    returns False and touches nothing."""
    coord = os.environ.get("CEPH_TPU_DIST_COORD", "").strip()
    procs = os.environ.get("CEPH_TPU_DIST_PROCS", "").strip()
    pid = os.environ.get("CEPH_TPU_DIST_ID", "").strip()
    if not (coord and procs and pid):
        return False
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        dout("ec", 1, "torch.distributed already initialized")
        return False
    dist.init_process_group(
        backend="nccl" if torch.cuda.is_available() else "gloo",
        init_method=coord, world_size=int(procs), rank=int(pid))
    return True


__all__ = ["DEFAULT_AXIS", "DataPlane", "activate", "data_plane",
           "deactivate", "host_plane_topology", "init_distributed",
           "mesh_plane", "plane_for", "plane_topology", "resolve_plane",
           "set_data_plane", "shard_count", "single_device",
           "tuned_fanout"]
