"""Stripe-batch sharding over a data plane's members — the port's
counterpart of ``ceph_tpu/utils/shard.py`` (``batch_spec`` +
``shard_map_compat``): the reference shards axis 0 of every operand over
one mesh axis and runs the body once per device; here
:func:`shard_batch` does the same eagerly over ``torch.device`` members.

Outputs are gathered on the caller's device, not left sharded: the
member partition of the last call is kept for reports
(:func:`last_partition`).  Members are issued in order on the current
stream of each; overlapping them on separate streams is later
performance work.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Sequence

import torch


class _Last(threading.local):
    partition: List[int] = []


_last = _Last()


def last_partition() -> List[int]:
    """Rows per member (pad rows included) of this thread's last
    :func:`shard_batch` call: the reference's addressable-shard rows."""
    return list(_last.partition)


def record_partition(rows: List[int]) -> None:
    """Set this thread's :func:`last_partition` (a sharded path that
    cuts its batch itself, parallel/sharded_codes.py)."""
    _last.partition = list(rows)


def pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``x`` with ``pad`` zero rows appended on axis 0 (uint32 through
    an int32 view)."""
    if not pad:
        return x
    if x.dtype == torch.uint32:
        return pad_rows(x.view(torch.int32), pad).view(torch.uint32)
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)


def cat_rows(parts: List[torch.Tensor]) -> torch.Tensor:
    """torch.cat on axis 0; uint32 through an int32 view (the packed
    layout's words), which every backend concatenates."""
    if parts[0].dtype == torch.uint32:
        return torch.cat([p.view(torch.int32) for p in parts],
                         dim=0).view(torch.uint32)
    return torch.cat(parts, dim=0)


def shard_batch(body: Callable, plane, args: Sequence[torch.Tensor],
                n_out: int = 1):
    """``body(*args)`` with the leading (stripe or page) axis of every
    argument sharded over ``plane.members``: each argument is
    zero-padded to a multiple of the member count (GF region math is
    row-local, so pad rows never mix into real ones, and a pad page's
    zero mask makes it dead), cut into equal shards, each shard moved to
    its member (a no-op for repeated members) and run under
    ``plane.single_device()``, so its engine selection picks the
    single-device tier; the outputs are concatenated on the first
    argument's device and the pad rows dropped.  ``n_out``: the number
    of tensors ``body`` returns (a tuple when more than one)."""
    from ..parallel.plane import single_device
    members = plane.members
    n = len(members)
    home = args[0].device
    b = int(args[0].shape[0])
    pad = (-b) % n
    padded = [pad_rows(a, pad) for a in args]
    rows = (b + pad) // n
    outs = []
    with single_device():
        for i, member in enumerate(members):
            cut = slice(i * rows, (i + 1) * rows)
            local = [a[cut].to(member, non_blocking=True) for a in padded]
            outs.append(body(*local))
    record_partition([rows] * n)

    def gather(parts):
        return cat_rows([p.to(home, non_blocking=True) for p in parts])[:b]

    if n_out == 1:
        return gather(outs)
    return tuple(gather([o[j] for o in outs]) for j in range(n_out))


__all__ = ["cat_rows", "last_partition", "pad_rows", "record_partition",
           "shard_batch"]
