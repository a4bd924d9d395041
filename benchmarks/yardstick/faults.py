"""The controls and planted faults that show the comparison can fail.

``run.py --inject NAME`` puts one of these in the timed path; the
benchmark's own runs never do.  A control is the plain reference put in
the program's place with one stated guarantee broken; a fault breaks
the program's own answer where it is produced.

EC cells (entry(tensor, available, lost) -> out):
- ``control``: the reference encode or decode, one byte of each request
  flipped (parity or rebuilt chunks no longer byte-identical);
- ``alter``: the program's answer with one byte of each request flipped;
- ``half``: the program run over the first half of the stripes, the
  rest of the answer zero.

Remap cells (apply(osdmap, incremental); evaluate(osdmap) -> up, primary):
- ``control``: up sets read before the epoch's incremental is applied,
  so one epoch stale (the pipelining a faster loop would be tempted by);
- ``unchanged``: the incremental leaves the map as it was;
- ``half``: the second half of the placement groups left unmapped;
- ``alter``: every 64th placement group's up set rotated by one place.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gf256

EC_FAULTS = ("control", "alter", "half")
REMAP_FAULTS = ("control", "unchanged", "half", "alter")


def _flip(out: torch.Tensor) -> torch.Tensor:
    out.view(-1)[:1] ^= 1
    return out


def ec_entry(name: str, entry, op: str, matrix: np.ndarray):
    """``entry`` with the fault ``name`` planted (``None``: as it is)."""
    if name is None:
        return entry
    if name == "control":
        def control(x, available, lost):
            if op == "encode":
                return _flip(gf256.encode(x, matrix))
            return _flip(gf256.decode(x, matrix, available, lost))
        return control
    if name == "alter":
        return lambda x, available, lost: _flip(entry(x, available, lost))
    if name == "half":
        def half(x, available, lost):
            out = entry(x[:x.shape[0] // 2], available, lost)
            rest = torch.zeros((x.shape[0] - out.shape[0],) + out.shape[1:],
                               dtype=out.dtype, device=out.device)
            return torch.cat([out, rest])
        return half
    raise ValueError(f"unknown EC fault {name!r}; one of {EC_FAULTS}")


def remap_steps(name: str, apply, evaluate, none: int):
    """(apply, evaluate, stale) with the fault ``name`` planted; ``stale``
    says the loop evaluates before it applies."""
    if name is None:
        return apply, evaluate, False
    if name == "control":
        return apply, evaluate, True
    if name == "unchanged":
        def unchanged(m, inc):
            m.epoch = inc.epoch
        return unchanged, evaluate, False
    if name == "half":
        def half(m):
            up, primary = evaluate(m)
            up, primary = up.copy(), primary.copy()
            up[len(up) // 2:] = none
            primary[len(up) // 2:] = -1
            return up, primary
        return apply, half, False
    if name == "alter":
        def alter(m):
            up, primary = evaluate(m)
            up = up.copy()
            up[::64] = np.roll(up[::64], 1, axis=1)
            return up, primary
        return apply, alter, False
    raise ValueError(f"unknown remap fault {name!r}; one of {REMAP_FAULTS}")


__all__ = ["EC_FAULTS", "REMAP_FAULTS", "ec_entry", "remap_steps"]
