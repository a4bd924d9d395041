"""Frozen copy of the project's ``ceph_tpu/crush/ln.py``, the benchmark's
plain reference; it imports nothing but numpy and its siblings.

crush_ln — 16.48 fixed-point log2 lookup — src/crush/crush_ln_table.h +
src/crush/mapper.c -> crush_ln.

crush_ln(u) ~= 2^44 * log2(u + 1) for u in [0, 0xffff], computed with two
integer lookup tables exactly as the reference does:

- __RH_LH_tbl: 129 interleaved pairs for even index1 in [256, 512]:
  RH = ceil(2^56 / index1), LH = round(2^48 * log2(index1 / 256)).
  RH must round *up*: RH*x >> 48 then lands in [2^15, 2^15 + 2^8) for
  every normalized x, which is what makes index2 = (RH*x >> 48) & 0xff a
  valid fraction index (a floor'd RH undershoots to 2^15 - 1 whenever
  index1 divides x*2^8, corrupting index2 to 255).
- __LL_tbl: 256 entries LL[i] = round(2^48 * log2(1 + i / 2^15)).

The tables are *generated* here (35-digit decimal precision, round half
away from zero) rather than copied: the reference header was not
readable when they were written.  The generator formula reproduces
the two table entries known independently (RH(258) = 0xfe03f80fe040,
LH(258) = 0x2dfca16dde1); if the reference tables ever differ in a last
bit, regenerate the diff with scripts and amend — straw2 selection only
changes where two draws collide within 1 ulp.

Vectorized over numpy uint32/int64 arrays (branch-free CLZ-style
normalization), so the same function serves scalar and batched
callers.
"""

from __future__ import annotations

from decimal import Decimal, getcontext

import numpy as np

__all__ = ["RH_LH_TBL", "LL_TBL", "crush_ln"]


def _generate_tables():
    getcontext().prec = 50
    ln2 = Decimal(2).ln()

    def log2d(x: Decimal) -> Decimal:
        return x.ln() / ln2

    def rnd(x: Decimal) -> int:
        return int(x.to_integral_value(rounding="ROUND_HALF_UP"))

    rh_lh = []
    for index1 in range(256, 513, 2):
        rh = -((1 << 56) // -index1)  # exact integer ceiling
        lh = rnd(Decimal(1 << 48) * log2d(Decimal(index1) / 256))
        rh_lh.extend((rh, lh))
    ll = [rnd(Decimal(1 << 48) * log2d(1 + Decimal(i) / (1 << 15)))
          for i in range(256)]
    return (np.array(rh_lh, dtype=np.int64), np.array(ll, dtype=np.int64))


RH_LH_TBL, LL_TBL = _generate_tables()


def crush_ln(xin, xp=np):
    """mapper.c -> crush_ln: 2^44 * log2(xin + 1), exact table arithmetic.

    ``xin``: uint32/int array (or scalar) in [0, 0xffff].
    ``xp``: the array module (numpy).
    Returns int64.
    """
    with np.errstate(over="ignore"):
        return _crush_ln(xin, xp)


def _crush_ln(xin, xp):
    x = xp.asarray(xin, dtype=xp.int64) + 1

    # normalize x into [2^15, 2^16] (mapper.c does this with clz; here a
    # branch-free halving ladder so it vectorizes/jits)
    shift = xp.zeros_like(x)
    v = x
    for s in (8, 4, 2, 1):
        cond = v < (1 << (16 - s))
        v = xp.where(cond, v << s, v)
        shift = shift + xp.where(cond, s, 0)
    iexpon = 15 - shift

    index1 = (v >> 8) << 1
    rh = xp.take(xp.asarray(RH_LH_TBL), index1 - 256)
    lh = xp.take(xp.asarray(RH_LH_TBL), index1 + 1 - 256)

    # RH * x ~ 2^48 * (2^15 + xf), xf < 2^8 (the C code does this in u64).
    # v*rh can reach 2^63 exactly (v = 2^16, RH = 2^47): int64 wraparound
    # preserves the low-64 bit pattern and index2 only reads bits 48..55
    # of the product, so the masked result still matches the u64 math.
    xl64 = (v * rh) >> 48
    index2 = xl64 & 0xFF
    ll = xp.take(xp.asarray(LL_TBL), index2)

    result = iexpon << (12 + 32)
    result = result + ((lh + ll) >> (48 - 12 - 32))
    return result
