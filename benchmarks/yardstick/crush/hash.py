"""Frozen copy of the project's ``ceph_tpu/crush/hash.py``, the benchmark's
plain reference; it imports nothing but numpy and its siblings.

rjenkins1 32-bit hash — src/crush/hash.{h,c}.

All CRUSH placement randomness flows through crush_hash32_* (hash.c ->
crush_hash32_rjenkins1_*).  Implemented over uint32 arrays so the SAME
code runs scalar (0-d numpy) and batched (numpy arrays).  Every
operation keeps uint32 dtype; wraparound is the semantics, not an
accident.
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
