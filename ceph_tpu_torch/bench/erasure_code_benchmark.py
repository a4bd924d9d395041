"""The chained benchmark harness of ``ceph_tpu/bench/
erasure_code_benchmark.py``: :func:`build_chain`, shared by the bench
path and ``ceph_tpu_torch/tools/roofline.py``'s kernel and harness
probes, so that the roofline numbers and the bench numbers are the same
computation by construction.

The reference scans S slabs inside one jitted program and XOR-folds
each step's output into a carry.  Here the chain is a Python loop over
the slabs with the carry a tensor: PyTorch runs eagerly, so there is no
dead-code elimination, and the "slice" chain runs the full op on every
step exactly as the reference's Pallas call does.  Not ported yet: the
benchmark CLI (``ErasureCodeBench``).
"""

from __future__ import annotations

import torch


def _xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ^ b on tensors of one integer dtype; uint32 through an int32
    view, which every backend can XOR."""
    if a.dtype == torch.uint32:
        return (a.view(torch.int32) ^ b.view(torch.int32)).view(torch.uint32)
    return a ^ b


def build_chain(op, chain: str, packed: bool, full_init_of, reps: int):
    """The ONE chained harness shared by the encode path, the decode
    path and the roofline tool's kernel/harness probes.

    op: slab -> output (encode or decode step).
    chain='carry': XOR-fold full outputs into the carry
    (full_init_of(slabs) supplies the zero carry) — adds 3 output-sized
    memory streams per step.  chain='slice': carry one element (outputs
    4-dim when packed, 3-dim otherwise), so the chain's traffic is the
    op's own read + write.

    Returns ``chained(slabs)``: ``reps`` passes over the leading axis of
    ``slabs``, each step ``carry ^= f(op(slab))``; returns the carry."""
    if chain not in ("slice", "carry"):
        raise ValueError(f"chain {chain!r} must be slice or carry")

    def chained(slabs: torch.Tensor) -> torch.Tensor:
        if chain == "slice":
            carry = torch.zeros((), dtype=slabs.dtype, device=slabs.device)
        else:
            carry = full_init_of(slabs)
        for _ in range(reps):
            for slab in slabs:
                out = op(slab)
                if chain == "slice":
                    out = (out[:1, :1, :1, :1] if packed
                           else out[:1, :1, :1]).reshape(())
                carry = _xor(carry, out)
        return carry

    return chained


__all__ = ["build_chain"]
