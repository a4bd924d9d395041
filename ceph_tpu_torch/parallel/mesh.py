"""Device meshes over torch devices — the port of
``ceph_tpu/parallel/mesh.py``.

A :class:`Mesh` is a ``(dp, tp)`` grid of ``torch.device`` members with
named axes: the reference's ``jax.sharding.Mesh`` reduced to what the
data plane reads (the grid, its axis names and shape).

``CEPH_TPU_TORCH_VIRTUAL_DEVICES=N`` is the counterpart of the
reference's ``--xla_force_host_platform_device_count=N``: when it is
set, :func:`visible_devices` lists N members over the one physical
device of the kind asked for (``cpu`` N times, or ``cuda:0`` N times),
so a plane of N members forms on one CPU or one card.  Unset, the list
is the real devices: every card torch sees, or the one CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.errors import NoDeviceError

VIRTUAL_DEVICES_ENV = "CEPH_TPU_TORCH_VIRTUAL_DEVICES"


def default_kind() -> str:
    """The device kind a plane forms over when none is named: the card
    when torch sees one, else the CPU."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def visible_devices(kind: Optional[str] = None) -> list:
    """The members a mesh may draw from: with ``CEPH_TPU_TORCH_VIRTUAL_
    DEVICES=N`` set, N members over the one physical device of ``kind``;
    else every card (``kind="cuda"``) or the one CPU.  Raises
    NoDeviceError for ``cuda`` without a card."""
    kind = kind or default_kind()
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"device kind {kind!r} is neither cuda nor cpu")
    if kind == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError("no CUDA device: a cuda mesh cannot form")
    env = os.environ.get(VIRTUAL_DEVICES_ENV, "").strip()
    if env:
        n = int(env)
        if n < 1:
            raise ValueError(f"{VIRTUAL_DEVICES_ENV}={env} must be >= 1")
        one = torch.device("cuda", 0) if kind == "cuda" \
            else torch.device("cpu")
        return [one] * n
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


class Mesh:
    """A grid of torch devices with named axes (the reference's
    ``jax.sharding.Mesh``): ``devices`` an object array, ``axis_names``
    one name per grid axis, ``shape`` {name: size}."""

    def __init__(self, devices, axis_names: Sequence[str]) -> None:
        src = np.asarray(devices, dtype=object)
        grid = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(src[idx])
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-d device grid for axes "
                             f"{tuple(axis_names)}")
        self.devices = grid
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def members(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis`` (index 0 on every other axis): the
        members a batch sharded over ``axis`` lands on, each shard's
        compute replicated over the other axes as shard_map does."""
        i = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for j in range(self.devices.shape[i]):
            idx[i] = j
            out.append(self.devices[tuple(idx)])
        return tuple(out)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Mesh(shape={self.shape})"


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None,
              axis_names: Tuple[str, str] = ("stripe", "chunk"),
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a 2-D (stripe=dp, chunk=tp) mesh over the first n devices
    (of ``devices``, default :func:`visible_devices`).

    tp defaults to the largest power of two <= 4 dividing both n_devices
    and 8 (the chunk axis shards k data chunks; k is 8 in the flagship
    config). tp=1 degrades to pure data parallelism."""
    devices = list(devices) if devices is not None else visible_devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"asked for {n_devices} devices, "
                         f"have {len(devices)}")
    if tp is None:
        tp = 1
        for cand in (2, 4):
            if n_devices % cand == 0:
                tp = cand
    if n_devices % tp:
        raise ValueError(f"tp={tp} does not divide n_devices={n_devices}")
    dp = n_devices // tp
    grid = np.empty((dp, tp), dtype=object)
    for i, d in enumerate(devices[:n_devices]):
        grid[i // tp, i % tp] = d
    return Mesh(grid, axis_names)


__all__ = ["Mesh", "VIRTUAL_DEVICES_ENV", "default_kind", "make_mesh",
           "visible_devices"]
