"""Sharded bulk CRUSH evaluation over a device mesh — the port of
``ceph_tpu/parallel/sharded_crush.py``.

Placement evaluation is embarrassingly parallel over the input x (the
pg seed), so the multi-device form is pure data parallelism: each
member evaluates its shard of every x block with the compiled map's
tables, and the results gather on the map's device.  The sharded path
lives in ``crush/bulk.py`` (``bulk_do_rule(mesh=...)`` / the active data
plane): the same rung ladder, blocked dispatch and exact host residue,
so results are always identical to mapper.py on any mesh.  This module
keeps the mesh-first surface.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence


def sharded_bulk_do_rule(mesh, cmap, ruleno: int, xs, result_max: int,
                         weight: Optional[Sequence[int]] = None,
                         bulk_tries: Optional[int] = None,
                         choose_args: Optional[Dict] = None,
                         axis: Optional[str] = None, device=None):
    """bulk_do_rule with the x sweep sharded over ``mesh`` (its first
    axis unless ``axis`` names another).  ``device``: the map's device,
    as bulk_do_rule takes it (default the card).  Returns (results
    (N, result_max) int32, counts (N,))."""
    from ..crush import bulk
    from .plane import DataPlane

    plane = DataPlane(mesh, axis=axis or mesh.axis_names[0])
    return bulk.bulk_do_rule(cmap, ruleno, xs, result_max,
                             weight=weight, bulk_tries=bulk_tries,
                             choose_args=choose_args, device=device,
                             mesh=plane)


def default_crush_mesh(axis: str = "x", kind: Optional[str] = None):
    """Every visible member of ``kind`` (default: the card when torch
    sees one, else the CPU) on one data-parallel axis."""
    from .mesh import Mesh, visible_devices
    import numpy as np
    devs = visible_devices(kind)
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid, (axis,))


__all__ = ["default_crush_mesh", "sharded_bulk_do_rule"]
