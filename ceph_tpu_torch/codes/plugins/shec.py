"""shec-equivalent plugin — Shingled Erasure Code (locally repairable).

Mirrors src/erasure-code/shec/ErasureCodeShec.{h,cc} +
ErasureCodeShecTableCache.{h,cc} + ErasureCodePluginShec.cc, as
``ceph_tpu.codes.plugins.shec`` does:
- class ErasureCodeShec / ErasureCodeShecReedSolomonVandermonde
  (technique=single|multiple), profile k, m, c, w in {8, 16, 32}.
- shec_reedsolomon_coding_matrix -> _shec_coding_matrix: an (m, k)
  GF(2^w) matrix where parity i covers only a shingled window of
  l = ceil(k*c/m) data chunks (stride floor(i*k/m), wrapping mod k), so
  every data chunk is covered by >= c parities; coefficients come from
  the Vandermonde RS matrix restricted to the window.
- shec_minimum_to_decode / shec_make_decoding_matrix -> the generic
  minimum-read search over parity subsets in ``codes/linear.py``,
  composed into ONE matrix apply per pattern.

Encode runs through ``MatrixCodeMixin``; every decode goes through the
minimum-read plan (the mixin's survivor-submatrix inversion is singular
for shec patterns), and the plan's matrix through the engine table: the
XOR-schedule kernel for the plans whose schedule the probe prefers
(single erasures whose plan is a row of 1s), the dense kernel for the
rest.  The plan caches are two-level, as in the reference: a
per-instance dict in front of the process-wide ``engine.PatternCache``.
The paged serving pool decodes through the same plans
(``decode_chunks_ragged_torch``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...matrices.jerasure import reed_sol_vandermonde_coding_matrix
from ...ops.gf_kernels import apply_matrix_best, apply_matrix_best_ragged, \
    apply_matrix_packed_best
from ...ops.torch_ops import matrix_to_static, torch_bytes_view, \
    torch_words_view
from ...telemetry import spans
from ..base import ErasureCode
from ..engine import global_pattern_cache, pattern_key
from ..linear import DecodePlan, decode_plan
from ..registry import ERASURE_CODE_VERSION, ErasureCodePlugin
from ..techniques import MatrixCodeMixin

__erasure_code_version__ = ERASURE_CODE_VERSION

LARGEST_VECTOR_WORDSIZE = 16
SIZEOF_INT = 4


@functools.lru_cache(maxsize=64)
def _shec_coding_matrix(k: int, m: int, c: int, w: int) -> np.ndarray:
    """(m, k) shingled coding matrix (shec_reedsolomon_coding_matrix).

    Parity row i keeps the Vandermonde coefficients on its shingle window
    {(floor(i*k/m) + t) mod k : t < ceil(k*c/m)} and is zero elsewhere.
    m == c degenerates to the dense MDS matrix (every window is all of
    [0, k), matching upstream's "replicated" corner).
    """
    base = reed_sol_vandermonde_coding_matrix(k, m, w)
    if m == 1 or c == m:
        return base
    l = -(-k * c // m)  # ceil(k*c/m): shingle width
    mat = np.zeros_like(base)
    for i in range(m):
        start = (i * k) // m
        for t in range(l):
            j = (start + t) % k
            mat[i, j] = base[i, j]
    return mat


@functools.lru_cache(maxsize=256)
def _index_on(index: tuple, device: torch.device) -> torch.Tensor:
    """A plan's chunk index as a tensor on ``device``, copied there once:
    indexing with a list would copy it to the card on every call, and
    the copy synchronizes with the host."""
    return torch.tensor(index, dtype=torch.long, device=device)


def _take(x: torch.Tensor, index: list) -> torch.Tensor:
    """x[:, index] (``index_select`` over a cached index tensor); uint32
    tensors (the packed layout) through an int32 view, which torch can
    index on the card."""
    idx = _index_on(tuple(index), x.device)
    if x.dtype == torch.uint32:
        return x.view(torch.int32).index_select(1, idx).view(torch.uint32)
    return x.index_select(1, idx)


class ErasureCodeShecTableCache:
    """ErasureCodeShecTableCache.{h,cc} — decode-plan cache per pattern:
    the minimum-read plan search and its composed decode matrix, keyed by
    (available, want).  A per-instance dict in front of the process-wide
    ``engine.PatternCache`` (``owner`` supplies the profile key), so
    fresh instances with the same profile skip the search."""

    def __init__(self, owner=None) -> None:
        self._plans: dict = {}
        self._owner = owner

    def get_plan(self, matrix: np.ndarray, k: int, w: int,
                 available: frozenset, want: frozenset) -> DecodePlan:
        key = (available, want)
        plan = self._plans.get(key)
        if plan is None:
            if self._owner is not None:
                plan = global_pattern_cache().get_or_build(
                    pattern_key(self._owner, "shec-plan",
                                tuple(sorted(available)),
                                tuple(sorted(want))),
                    lambda: decode_plan(matrix, k, w, available, want))
            else:
                plan = decode_plan(matrix, k, w, available, want)
            self._plans[key] = plan
        return plan


class ErasureCodeShec(MatrixCodeMixin, ErasureCode):
    """ErasureCodeShec.{h,cc} — base shec semantics."""

    DEFAULT_K = "4"
    DEFAULT_M = "3"
    DEFAULT_C = "2"
    DEFAULT_W = 8

    def __init__(self, technique: str = "multiple", device=None) -> None:
        super().__init__(device)
        self.technique = technique
        self.c = 0
        self.w = self.DEFAULT_W

    def parse(self, profile) -> None:
        """ErasureCodeShec::parse: k/m/c required relations, w gate."""
        self.k = self.to_int("k", profile, self.DEFAULT_K)
        self.m = self.to_int("m", profile, self.DEFAULT_M)
        self.c = self.to_int("c", profile, self.DEFAULT_C)
        self.w = self.to_int("w", profile, str(self.DEFAULT_W))
        self.sanity_check_k_m(self.k, self.m)
        if self.c < 1:
            raise ValueError(f"c={self.c} must be >= 1")
        if self.c > self.m:
            raise ValueError(f"c={self.c} must be <= m={self.m}")
        if self.m > self.k:
            raise ValueError(f"m={self.m} must be <= k={self.k}")
        if self.w not in (8, 16, 32):
            raise ValueError(f"w={self.w} must be one of 8, 16, 32")
        if self.k + self.m > (1 << self.w):
            raise ValueError(
                f"k+m={self.k + self.m} must be <= 2^w={1 << self.w}")

    def _install_matrix(self, matrix) -> None:
        """The coding matrix, and the plan caches and windows drawn from
        it (so ``techniques.load_reference_matrix`` resets them too)."""
        super()._install_matrix(matrix)
        self.tcache = ErasureCodeShecTableCache(self)
        self._windows = [frozenset(int(j) for j in np.nonzero(
            self.matrix[i])[0]) for i in range(self.m)]

    def build_matrix(self) -> np.ndarray:
        return _shec_coding_matrix(self.k, self.m, self.c, self.w)

    def get_alignment(self) -> int:
        """ErasureCodeShec::get_alignment (vandermonde-style padding)."""
        alignment = self.k * self.w * SIZEOF_INT
        if (self.w * SIZEOF_INT) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * LARGEST_VECTOR_WORDSIZE
        return alignment

    def get_chunk_size(self, stripe_width: int) -> int:
        alignment = self.get_alignment()
        tail = stripe_width % alignment
        padded = stripe_width + (alignment - tail if tail else 0)
        assert padded % self.k == 0
        return padded // self.k

    # -- recovery (ErasureCodeShec::shec_minimum_to_decode / decode) --------

    def _plan(self, available, want) -> DecodePlan:
        return self.tcache.get_plan(self.matrix, self.k, self.w,
                                    frozenset(available), frozenset(want))

    def minimum_to_decode(self, want_to_read: set, available: set):
        plan = self._plan(available, want_to_read)
        return {c: [(0, 1)] for c in plan.reads}

    def decode(self, want_to_read: set, chunks, chunk_size: int):
        """Plan-driven decode: one matrix apply over the minimum read set
        (upstream zero-fills and runs the jerasure decode; the bytes
        produced are the same solved linear system)."""
        available = frozenset(chunks)
        want = frozenset(want_to_read)
        if want <= available:
            return {i: chunks[i] for i in sorted(want)}
        plan = self._plan(available, want)
        stack = np.stack([np.frombuffer(chunks[c], dtype=np.uint8)
                          for c in plan.reads])
        out = self._apply_plan(plan, stack[None])[0]
        return {c: out[t].tobytes() for t, c in enumerate(plan.want_order)}

    def decode_chunks(self, want_to_read: set, chunks, decoded):
        out = self.decode(set(want_to_read), dict(chunks),
                          len(next(iter(chunks.values()))))
        decoded.update(out)
        return decoded

    def _plan_static(self, plan: DecodePlan):
        """(matrix, static) of a plan, cached per instance and process."""
        key = (plan.reads, plan.want_order)
        hit = self._decode_cache.get(key)
        if hit is None:
            hit = global_pattern_cache().get_or_build(
                pattern_key(self, "shec-plan-static", plan.reads,
                            plan.want_order),
                lambda: (plan.matrix, matrix_to_static(plan.matrix)))
            self._decode_cache[key] = hit
        return hit

    def _apply_plan(self, plan: DecodePlan, stack: np.ndarray) -> np.ndarray:
        dm, dm_static = self._plan_static(plan)
        return self._apply(stack, dm, dm_static)

    def _plan_indices(self, available: tuple, erased: tuple):
        """(plan, positions of its reads in ``available``, positions of
        ``erased`` in its output rows)."""
        plan = self._plan(available, erased)
        aidx = {c: t for t, c in enumerate(available)}
        worder = {c: t for t, c in enumerate(plan.want_order)}
        return (plan, [aidx[c] for c in plan.reads],
                [worder[c] for c in erased])

    def decode_chunks_batch(self, chunks: np.ndarray, available: tuple,
                            erased: tuple) -> np.ndarray:
        """(batch, len(available), C) -> (batch, len(erased), C)."""
        plan, sel, keep = self._plan_indices(tuple(available), tuple(erased))
        out = self._apply_plan(plan, np.ascontiguousarray(chunks[:, sel, :]))
        return np.ascontiguousarray(out[:, keep, :])

    # -- device-resident paths (tensor in, tensor out; no host copy) ------

    def decode_chunks_torch(self, chunks: torch.Tensor, available: tuple,
                            erased: tuple) -> torch.Tensor:
        """(batch, len(available), C) tensor -> (batch, len(erased), C) on
        the code's device: the plan's reads selected by index, one apply
        of its matrix through the engine table; one armed root span
        ``codec.decode`` (telemetry/spans.py) a call."""
        with spans.root("codec.decode"):
            self._check_device(chunks)
            plan, sel, keep = self._plan_indices(tuple(available),
                                                 tuple(erased))
            dm_static = self._plan_static(plan)[1]
            words = torch_words_view(_take(chunks, sel), self.w)
            out = torch_bytes_view(apply_matrix_best(words, dm_static,
                                                     self.w))
            return _take(out, keep)

    def decode_chunks_ragged_torch(self, pool: torch.Tensor,
                                   mask: torch.Tensor, available: tuple,
                                   erased: tuple) -> torch.Tensor:
        """Page-pool minimum-read decode: (P, n_avail, page) survivors +
        (P,) activity mask -> (P, n_erased, page), dead pages zero.
        Overrides the mixin's ragged path, as the reference does: the
        plain decode-matrix inversion there is singular for shec
        survivor patterns, so every shec decode, ragged included, goes
        through the minimum-read plan."""
        self._check_device(pool)
        plan, sel, keep = self._plan_indices(tuple(available), tuple(erased))
        dm_static = self._plan_static(plan)[1]
        words = torch_words_view(_take(pool, sel), self.w)
        out = torch_bytes_view(apply_matrix_best_ragged(words, dm_static,
                                                        mask, self.w))
        return _take(out, keep)

    def decode_chunks_packed_torch(self, words: torch.Tensor,
                                   available: tuple,
                                   erased: tuple) -> torch.Tensor:
        """Packed-layout minimum-read decode: (batch, n_avail, R, 128)
        uint32 -> (batch, len(erased), R, 128).  w=8 only."""
        if self.w != 8:
            raise ValueError("packed layout is w=8 only")
        self._check_device(words)
        plan, sel, keep = self._plan_indices(tuple(available), tuple(erased))
        dm_static = self._plan_static(plan)[1]
        out = apply_matrix_packed_best(_take(words, sel), dm_static)
        return _take(out, keep)


class ErasureCodeShecReedSolomonVandermonde(ErasureCodeShec):
    """Named to mirror the reference's single concrete technique class."""


class ErasureCodePluginShec(ErasureCodePlugin):
    """ErasureCodePluginShec.cc -> factory (technique single|multiple)."""

    def factory(self, profile, directory=None, device=None):
        technique = profile.get("technique", "multiple")
        if technique not in ("single", "multiple"):
            raise ValueError(
                f"technique={technique} must be single or multiple")
        interface = ErasureCodeShecReedSolomonVandermonde(technique, device)
        interface.init(profile)
        return interface


def __erasure_code_init__(plugin_name: str, registry) -> None:
    registry.add(plugin_name, ErasureCodePluginShec())
