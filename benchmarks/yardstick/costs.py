"""The yardstick's cost arithmetic: the H100's published peaks and the
least bytes and operations of the work the cells time.

Frozen copies of ``ceph_tpu_torch/telemetry/profiler.py`` (the byte
model of a GF word kernel: each input chunk read once, each output chunk
written once; the roofline as the larger of bytes over the memory rate
and operations over the INT32 rate) and of ``ceph_tpu_torch/ops/gf_kernels.py::sm90_op_floor``
(the least INT32 instructions per 32-bit word position of a GF(2^8)
matrix apply on sm_90).  Later changes to the program leave these
numbers as they are.
"""

from __future__ import annotations

import numpy as np

# NVIDIA's data sheet, H100 SXM5 80 GB: HBM3 at 3.35 TB/s
HBM_BYTES_PER_S = 3350e9
# 132 SMs x 64 INT32 lanes x 1.98 GHz boost
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# sm_90 instructions of one SWAR xtime per 32-bit word (w=8): AND with
# the top bits, IMAD.HI for the reduction term, SHL, LOP3
SM90_XT_COST = 4


def gf_op_floor(matrix) -> int:
    """INT32 instructions per word position of out = M * in over
    GF(2^8): the cheaper of a doubling chain per input column and one
    per output row (Horner), each row's set coefficient bits folded two
    per three-input XOR."""
    mat = np.asarray(matrix, dtype=np.int64)
    rows, cols = mat.shape
    per_col = 0
    for j in range(cols):
        top = max(int(mat[i, j]).bit_length() for i in range(rows))
        if top > 1:
            per_col += SM90_XT_COST * (top - 1)
    for i in range(rows):
        per_col += sum(int(c).bit_count() for c in mat[i]) // 2
    per_row = 0
    for i in range(rows):
        top = max(int(c).bit_length() for c in mat[i])
        if top > 1:
            per_row += SM90_XT_COST * (top - 1)
        per_row += sum(int(c).bit_count() for c in mat[i]) // 2
    return min(per_col, per_row)


def gf_apply_cost(stripes: int, reads: int, writes: int,
                  chunk_bytes: int, matrix=None) -> dict:
    """Bytes and INT32 operations of a GF(2^8) matrix apply over
    ``stripes`` stripes that reads ``reads`` chunks and writes
    ``writes``: each byte moved once; the operations from the matrix's
    op floor where the matrix is known, else none counted."""
    ops = 0.0
    if matrix is not None:
        ops = float(gf_op_floor(matrix)) * stripes * chunk_bytes / 4
    return {"bytes": float(stripes) * (reads + writes) * chunk_bytes,
            "ops": ops}


def roofline_s(cost: dict) -> tuple:
    """(the least seconds the card could take, "bytes" or "operations",
    whichever bounds it)."""
    t_mem = cost["bytes"] / HBM_BYTES_PER_S
    t_ops = cost["ops"] / INT32_OPS_PER_S
    return (t_ops, "operations") if t_ops > t_mem else (t_mem, "bytes")


def min_reads(profile: dict, lost: tuple) -> int:
    """The fewest chunks a decode of the data chunks ``lost`` must read:
    k for an MDS code (jerasure); for shec with one lost data chunk, the
    narrowest shingle window that covers it (its parity and the window's
    other data chunks)."""
    k = int(profile["k"])
    if profile["plugin"] == "jerasure":
        return k
    if profile["plugin"] == "shec" and len(lost) == 1:
        from .gf256 import shec_matrix
        mat = shec_matrix(k, int(profile["m"]), int(profile["c"]))
        return min(int(np.count_nonzero(row)) for row in mat
                   if row[lost[0]])
    raise ValueError(f"no read count for {profile} losing {lost}")


__all__ = ["HBM_BYTES_PER_S", "INT32_OPS_PER_S", "gf_apply_cost",
           "gf_op_floor", "min_reads", "roofline_s"]
