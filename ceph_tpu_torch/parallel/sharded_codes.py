"""Sharded erasure-code compute over a device mesh — the port of
``ceph_tpu/parallel/sharded_codes.py``.

Encode runs dp (stripe batch) x tp (chunk) sharded: each (stripe,
chunk) member computes the partial parity of its local data chunks with
its column slice of the coding matrix, on the single-device best tier
(``apply_matrix_best`` under ``single_device()``: on the card the dense
kernel), and the tp partials XOR-reduce on the stripe row's first member
(GF(2^8) addition is XOR; the reference all-gathers the partials and
XORs them outside any kernel).  The stripe rows' parities gather on the
caller's device.

Decode runs stripe-sharded: the survivors through the engine's mesh
tier (``apply_matrix_best`` with the plane flattened to one stripe
axis), zero cross-member traffic beyond the scatter and the gather.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh
from .plane import DataPlane, single_device


def _flat(mesh: Mesh) -> Mesh:
    """Every member of ``mesh`` on one stripe axis (tp=1)."""
    return Mesh(mesh.devices.reshape(-1, 1), ("stripe", "chunk"))


def _static(matrix) -> tuple:
    return tuple(tuple(int(v) for v in row) for row in np.asarray(matrix))


def sharded_encode(mesh: Mesh, data, matrix) -> torch.Tensor:
    """(B, k, C) uint8 sharded (stripe, chunk) -> (B, m, C) parity on
    ``data``'s device (numpy input: the first member's).

    Member (i, t) encodes stripe shard i's chunk slice t with columns
    ``t*k/tp .. (t+1)*k/tp`` of ``matrix``; the tp partials of a stripe
    row are XORed on its first member.  The stripe batch zero-pads to a
    multiple of dp (pad rows dropped)."""
    from ..ops.gf_kernels import apply_matrix_best
    from ..utils.shard import cat_rows, pad_rows, record_partition
    grid = mesh.devices
    dp, tp = mesh.shape["stripe"], mesh.shape["chunk"]
    mat = np.asarray(matrix, dtype=np.int64)
    m, k = mat.shape
    if k % tp:
        raise ValueError(f"tp={tp} does not divide k={k}")
    kl = k // tp
    slices = [_static(mat[:, t * kl:(t + 1) * kl]) for t in range(tp)]
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.ascontiguousarray(data)).to(grid[0, 0])
    home = data.device
    b = int(data.shape[0])
    x = pad_rows(data, (-b) % dp)
    rows = x.shape[0] // dp
    parts = []
    with single_device():
        for i in range(dp):
            stripes = x[i * rows:(i + 1) * rows]
            acc = None
            for t in range(tp):
                local = stripes[:, t * kl:(t + 1) * kl].to(grid[i, t])
                p = apply_matrix_best(local, slices[t], 8)
                p = p.to(grid[i, 0])
                acc = p if acc is None else acc ^ p
            parts.append(acc.to(home))
    record_partition([rows] * dp)
    return cat_rows(parts)[:b]


def sharded_roundtrip_step(mesh: Mesh, data, m: int = 3):
    """Full framework step: sharded encode, erase the first m data
    chunks, sharded decode from the k survivors.  Returns
    (decoded_data, parity) on ``data``'s device; decoded must equal
    data."""
    from ..matrices.jerasure import reed_sol_vandermonde_coding_matrix
    from ..ops.gf_kernels import apply_matrix_best
    from ..ops.regionops import matrix_decode_matrix

    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.ascontiguousarray(data)).to(
            mesh.devices[0, 0])
    b, k, c = data.shape
    matrix = reed_sol_vandermonde_coding_matrix(k, m, 8)
    parity = sharded_encode(mesh, data, matrix)
    survivors_ids = list(range(m, k + m))
    dm = matrix_decode_matrix(matrix, k, survivors_ids, list(range(m)), 8)
    surv = torch.cat([data[:, m:, :], parity], dim=1)
    erased = apply_matrix_best(surv, _static(dm), 8,
                               mesh=DataPlane(_flat(mesh)))
    decoded = torch.cat([erased, data[:, m:, :]], dim=1)
    return decoded, parity


def sharded_single_erasure_repair(mesh: Mesh, plugin: str, profile, data,
                                  device=None):
    """Sharded recovery math: encode a stripe batch host-side, erase
    chunk 0, compute the plugin's minimum read set (shec: < k chunks;
    clay: d helpers with sub-chunk ranges), then decode through the
    engine's cached serve-decode callable (codes/engine.py::
    serve_dispatch_call) built as its mesh variant: the stripe batch
    sharded over every mesh member in one supervised dispatch.  The
    code lives on ``device`` (default: the members' device).

    Returns (repaired (B, 1, C) numpy, n_read, n_chunks)."""
    from ..codes.engine import serve_dispatch_call
    from ..codes.registry import ErasureCodePluginRegistry

    flat = _flat(mesh)
    dev = device if device is not None else flat.devices[0, 0]
    ec = ErasureCodePluginRegistry.instance().factory(
        plugin, dict(profile), device=dev)
    n = ec.get_chunk_count()
    parity = np.asarray(ec.encode_chunks_batch(data))
    allchunks = np.concatenate([data, parity], axis=1)
    erased = (0,)
    minimum = ec.minimum_to_decode({0}, set(range(1, n)))
    positions = tuple(sorted(minimum))
    surv = np.ascontiguousarray(allchunks[:, positions, :])
    fn = serve_dispatch_call(ec, "decode", positions, erased,
                             mesh=DataPlane(flat))
    out = fn(torch.from_numpy(surv).to(ec.device))
    return out.cpu().numpy(), len(positions), n


__all__ = ["sharded_encode", "sharded_roundtrip_step",
           "sharded_single_erasure_repair"]
