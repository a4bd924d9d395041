"""rjenkins1 32-bit hash — src/crush/hash.{h,c}; a copy of
``ceph_tpu.crush.hash`` with torch twins for the bulk evaluator.

All CRUSH placement randomness flows through crush_hash32_* (hash.c ->
crush_hash32_rjenkins1_*).  The numpy functions work over uint32 arrays,
scalar (0-d) or batched; every operation keeps uint32 dtype, and
wraparound is the semantics, not an accident.  The host mapper uses
them.

torch has no uint32 arithmetic (``-``, ``>>`` and ``<<`` are not
implemented for ``torch.uint32``), so the torch twins
(``hash32_{2,3,4}_torch``) carry each uint32 as the int32 of the same
bits: ``+``, ``-``, ``^`` and ``<<`` give the same low 32 bits in two's
complement, and a logical right shift is the arithmetic one masked to
its ``32 - n`` low bits.  ``as_hash_input`` turns int64 values (x,
bucket ids, r) into that form; a negative id is its uint32 bits, as in
C.  The twins return the hash as int32 bits; ``& 0xFFFF`` reads its low
16 bits, ``.long() & 0xFFFFFFFF`` its unsigned value.
"""

from __future__ import annotations

import numpy as np

CRUSH_HASH_SEED = 1315423911  # hash.c -> crush_hash_seed
CRUSH_HASH_RJENKINS1 = 0      # hash.h -> CRUSH_HASH_RJENKINS1

_SEED = np.uint32(CRUSH_HASH_SEED)
_X = np.uint32(231232)
_Y = np.uint32(1232)


def _u32(x):
    """Coerce python ints to 0-d uint32 arrays; pass arrays through."""
    if isinstance(x, (int, np.integer)):
        return np.asarray(x & 0xFFFFFFFF, dtype=np.uint32)
    return x


def _quiet(fn):
    """Run fn with numpy overflow warnings suppressed (uint32 wraparound
    is the defined semantics of this hash)."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args):
        with np.errstate(over="ignore"):
            return fn(*args)
    return wrapper


def _mix(a, b, c):
    """hash.h -> crush_hashmix (9-step Jenkins mix), uint32 wraparound.

    numpy turns 0-d array ops into scalars, whose overflow (our intended
    wraparound) raises RuntimeWarning under strict filters — silence it
    locally; vectorized paths never warn."""
    u = np.uint32
    a = a - b
    a = a - c
    a = a ^ (c >> u(13))
    b = b - c
    b = b - a
    b = b ^ (a << u(8))
    c = c - a
    c = c - b
    c = c ^ (b >> u(13))
    a = a - b
    a = a - c
    a = a ^ (c >> u(12))
    b = b - c
    b = b - a
    b = b ^ (a << u(16))
    c = c - a
    c = c - b
    c = c ^ (b >> u(5))
    a = a - b
    a = a - c
    a = a ^ (c >> u(3))
    b = b - c
    b = b - a
    b = b ^ (a << u(10))
    c = c - a
    c = c - b
    c = c ^ (b >> u(15))
    return a, b, c


@_quiet
def crush_hash32(a):
    """hash.c -> crush_hash32_rjenkins1."""
    a = _u32(a)
    h = _SEED ^ a
    b = a
    # crush_hashmix is an in-place macro upstream: x and y are MUTATED
    # by each mix and the mutated values feed later mixes.  Thread them
    # through exactly (pinned against the independent C reference,
    # tests/test_crush_kat.py).
    x, y = _X, _Y
    b, x, h = _mix(b, x, h)
    y, a, h = _mix(y, a, h)
    return h


@_quiet
def crush_hash32_2(a, b):
    """hash.c -> crush_hash32_rjenkins1_2."""
    a, b = _u32(a), _u32(b)
    h = _SEED ^ a ^ b
    x, y = _X, _Y
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


@_quiet
def crush_hash32_3(a, b, c):
    """hash.c -> crush_hash32_rjenkins1_3."""
    a, b, c = _u32(a), _u32(b), _u32(c)
    h = _SEED ^ a ^ b ^ c
    x, y = _X, _Y
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)  # x as mutated by the second mix
    y, c, h = _mix(y, c, h)  # y as mutated by the third mix
    return h


@_quiet
def crush_hash32_4(a, b, c, d):
    """hash.c -> crush_hash32_rjenkins1_4."""
    a, b, c, d = _u32(a), _u32(b), _u32(c), _u32(d)
    h = _SEED ^ a ^ b ^ c ^ d
    x, y = _X, _Y
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)  # x as mutated above
    y, d, h = _mix(y, d, h)  # y as mutated above
    return h


@_quiet
def crush_hash32_5(a, b, c, d, e):
    """hash.c -> crush_hash32_rjenkins1_5."""
    a, b, c, d, e = _u32(a), _u32(b), _u32(c), _u32(d), _u32(e)
    h = _SEED ^ a ^ b ^ c ^ d ^ e
    x, y = _X, _Y
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    e, x, h = _mix(e, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)  # x as mutated above
    y, c, h = _mix(y, c, h)  # y as mutated above
    d, x, h = _mix(d, x, h)
    return h


# -- torch twins over int32 bits (the bulk evaluator) -------------------------

_SRL_MASK = {n: (1 << (32 - n)) - 1 for n in (3, 5, 12, 13, 15)}


def as_hash_input(v):
    """int64 (or int32) tensor -> the int32 whose bits are ``v``'s low 32
    bits (the uint32 the C hash reads)."""
    import torch
    if v.dtype == torch.int32:
        return v
    v = v.long()
    return (((v & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _srl(v, n: int):
    """Logical right shift of int32 bits."""
    return (v >> n) & _SRL_MASK[n]


def _mix_t(a, b, c):
    """crush_hashmix over int32 bits (see the module docstring)."""
    a = (a - b - c) ^ _srl(c, 13)
    b = (b - c - a) ^ (a << 8)
    c = (c - a - b) ^ _srl(b, 13)
    a = (a - b - c) ^ _srl(c, 12)
    b = (b - c - a) ^ (a << 16)
    c = (c - a - b) ^ _srl(b, 5)
    a = (a - b - c) ^ _srl(c, 3)
    b = (b - c - a) ^ (a << 10)
    c = (c - a - b) ^ _srl(b, 15)
    return a, b, c


def hash32_2_torch(a, b):
    """crush_hash32_rjenkins1_2 over int32 bits; broadcasts."""
    h = (a ^ b) ^ CRUSH_HASH_SEED
    x, y = 231232, 1232
    a, b, h = _mix_t(a, b, h)
    x, a, h = _mix_t(x, a, h)
    b, y, h = _mix_t(b, y, h)
    return h


def hash32_3_torch(a, b, c):
    """crush_hash32_rjenkins1_3 over int32 bits; broadcasts."""
    h = (a ^ b ^ c) ^ CRUSH_HASH_SEED
    x, y = 231232, 1232
    a, b, h = _mix_t(a, b, h)
    c, x, h = _mix_t(c, x, h)
    y, a, h = _mix_t(y, a, h)
    b, x, h = _mix_t(b, x, h)
    y, c, h = _mix_t(y, c, h)
    return h


def hash32_4_torch(a, b, c, d):
    """crush_hash32_rjenkins1_4 over int32 bits; broadcasts."""
    h = (a ^ b ^ c ^ d) ^ CRUSH_HASH_SEED
    x, y = 231232, 1232
    a, b, h = _mix_t(a, b, h)
    c, d, h = _mix_t(c, d, h)
    a, x, h = _mix_t(a, x, h)
    y, b, h = _mix_t(y, b, h)
    c, x, h = _mix_t(c, x, h)
    y, d, h = _mix_t(y, d, h)
    return h
