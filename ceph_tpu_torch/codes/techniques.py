"""Shared compute machinery for matrix / bitmatrix erasure codes.

Counterpart of ``ceph_tpu/codes/techniques.py``:

- ``MatrixCodeMixin`` — GF(2^w)-element matrix codes (jerasure
  reed_sol_van / reed_sol_r6_op, isa reed_sol_van / cauchy): encode and
  decode are a word-wise GF(2^w) matrix apply
  (jerasure_matrix_encode/decode semantics), through
  ``ops.gf_kernels.apply_matrix_best``.
- ``BitmatrixCodeMixin`` — GF(2) bitmatrix codes in jerasure packet
  layout (cauchy_orig, cauchy_good, liberation, blaum_roth,
  liber8tion), through ``ops.gf_kernels.apply_bitmatrix_best``: the CSE
  schedule when it pays, the plain packet product otherwise.

Surfaces of both:

- ``encode_chunks_batch`` / ``decode_chunks_batch``: numpy in, numpy
  out.  Below ``min_xla_bytes`` (the reference's host rule, kept under
  its name) the host tier runs: for a matrix code
  ``xor_schedule.host_matrix_apply`` (the XOR schedule the device runs
  when the probe prefers one, the regionops ground truth otherwise), for
  a bitmatrix code the regionops packet product; above it the chunks go
  to the code's device and through the dispatch.  Both paths are
  counted in the perf counters (``ec_host_*`` / ``ec_device_*``) and
  timed in the metrics plane (``ec_apply{path=host|device}``); with
  ``CEPH_TPU_VERIFY=1`` a device result is re-checked against the
  regionops ground truth (``utils.debug``).
- ``encode_chunks_torch`` / ``decode_chunks_torch``: a tensor on the
  code's device in, a tensor on that device out (the counterparts of
  ``*_jax``).
- ``encode_chunks_packed_torch`` / ``decode_chunks_packed_torch``
  (matrix codes): the packed (..., R, 128) uint32 layout, w=8 only.
- ``page_unit`` and ``encode_chunks_ragged_torch`` /
  ``decode_chunks_ragged_torch``: the paged serving pool (serve/pool.py)
  — a (P, rows, page) pool and a (P,) activity mask on the code's
  device, dead pages zero.  Matrix codes run the ragged kernel family
  (``gf_kernels.apply_matrix_best_ragged``); bitmatrix codes zero the
  dead pages (``mask_pages``) and run the packet kernels.

The decode caches are two-level, as in the reference: a per-instance
dict (reset by prepare()) in front of the process-wide
``engine.PatternCache``, keyed by profile and pattern, so a fresh
instance with a known profile builds nothing.  A bitmatrix code's entry
also holds the pattern's schedule, so the greedy CSE runs once per
pattern and process.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import regionops
from ..ops.fallback import global_policy
from ..ops.gf_kernels import apply_bitmatrix_best, apply_matrix_best, \
    apply_matrix_best_ragged, apply_matrix_packed_best
from ..ops.torch_ops import bitmatrix_to_static, mask_pages, \
    matrix_to_static, torch_bytes_view, torch_words_view
from ..ops.xor_schedule import host_matrix_apply, \
    probe_bitmatrix_schedule
from ..telemetry.metrics import record_dispatch
from ..utils.debug import DeviceVerificationError, verification_enabled
from ..utils.perf import global_perf
from .engine import global_pattern_cache, pattern_key


def _numpy_tier(device=None) -> bool:
    """True when the fallback policy runs the numpy ground truth for
    tensors on ``device``: inside the supervisor's ``numpy_tier()``
    (self-verify and host-twin completions, which must never dispatch
    through the backend being verified), or, for a CPU code, at its
    live numpy floor or forced (``CEPH_TPU_ENGINE=numpy``: a forced
    numpy tier raises for a card code, which the live tier never
    moves).  The batch surfaces then never
    dispatch at any size."""
    return global_policy().engine(device) == "numpy"


class _DeviceCode:
    """A code whose tensors live on ``self.device``."""

    def _check_device(self, x: torch.Tensor) -> None:
        if x.device.type != self.device.type:
            raise ValueError(f"tensor on {x.device}, but this code runs "
                             f"on {self.device}")


class MatrixCodeMixin(_DeviceCode):
    """Compute paths for GF(2^w)-element matrix codes.

    Requires: self.k, self.m, self.w, self.device, and build_matrix() ->
    (m, k) matrix.
    """

    min_xla_bytes = 1 << 20

    def build_matrix(self) -> np.ndarray:
        raise NotImplementedError

    def prepare(self) -> None:
        self._install_matrix(self.build_matrix())

    def _install_matrix(self, matrix) -> None:
        self.matrix = np.asarray(matrix, dtype=np.int64)
        self._matrix_static = matrix_to_static(self.matrix)
        self._decode_cache: dict = {}

    def _apply(self, chunks: np.ndarray, matrix: np.ndarray,
               matrix_static) -> np.ndarray:
        perf = global_perf()
        chunks = np.ascontiguousarray(chunks)
        words = regionops.words_view(chunks, self.w)
        if chunks.nbytes < self.min_xla_bytes or _numpy_tier(self.device):
            perf.inc("ec_host_calls")
            perf.inc("ec_host_bytes", chunks.nbytes)
            with record_dispatch("ec_apply", path="host"):
                # the XOR schedule the device runs when the probe prefers
                # one, the regionops ground truth otherwise
                return host_matrix_apply(chunks, matrix, matrix_static,
                                         self.w)
        perf.inc("ec_device_calls")
        perf.inc("ec_device_bytes", chunks.nbytes)
        with perf.timed("ec_device_time"), \
                record_dispatch("ec_apply", path="device"):
            out = apply_matrix_best(torch.from_numpy(words).to(self.device),
                                    matrix_static, self.w)
            out = out.cpu().numpy().view(np.uint8)
        if verification_enabled():
            ref = regionops.matrix_encode(words, matrix,
                                          self.w).view(np.uint8)
            if not np.array_equal(out, ref):
                raise DeviceVerificationError(
                    "device matrix path diverged from host ground truth "
                    f"(w={self.w}, shape={chunks.shape})")
        return out

    def encode_chunks_batch(self, data: np.ndarray) -> np.ndarray:
        return self._apply(data, self.matrix, self._matrix_static)

    def _decode_matrix(self, available: tuple, erased: tuple):
        key = (available, erased)
        hit = self._decode_cache.get(key)
        if hit is None:
            def build():
                survivors = list(available[:self.k])
                dm = regionops.matrix_decode_matrix(
                    self.matrix, self.k, survivors, list(erased), self.w)
                return (dm, matrix_to_static(dm), len(survivors))

            hit = global_pattern_cache().get_or_build(
                pattern_key(self, "matrix-decode", available, erased),
                build)
            self._decode_cache[key] = hit
        return hit

    def decode_chunks_batch(self, chunks: np.ndarray, available: tuple,
                            erased: tuple) -> np.ndarray:
        if len(available) < self.k:
            raise IOError(f"need {self.k} chunks, have {len(available)}")
        dm, dm_static, ns = self._decode_matrix(tuple(available),
                                                tuple(erased))
        return self._apply(chunks[..., :ns, :], dm, dm_static)

    # -- device-resident paths (tensor in, tensor out; no host copy) ----

    def encode_chunks_torch(self, data: torch.Tensor) -> torch.Tensor:
        """(batch, k, C) uint8 tensor -> (batch, m, C) parity, on the
        code's device."""
        self._check_device(data)
        words = torch_words_view(data, self.w)
        return torch_bytes_view(
            apply_matrix_best(words, self._matrix_static, self.w))

    def decode_chunks_torch(self, chunks: torch.Tensor, available: tuple,
                            erased: tuple) -> torch.Tensor:
        """(batch, len(available), C) tensor -> (batch, len(erased), C)."""
        if len(available) < self.k:
            raise IOError(f"need {self.k} chunks, have {len(available)}")
        self._check_device(chunks)
        _, dm_static, ns = self._decode_matrix(tuple(available),
                                               tuple(erased))
        words = torch_words_view(chunks[..., :ns, :], self.w)
        return torch_bytes_view(apply_matrix_best(words, dm_static, self.w))

    # -- ragged paged surfaces (serve/pool.py page pools) ----------------

    def page_unit(self) -> int:
        """Page-size quantum for the paged serving pool: pages hold
        whole GF(2^w) field elements, so the word views stay free."""
        return max(1, self.w // 8)

    def encode_chunks_ragged_torch(self, pool: torch.Tensor,
                                   mask: torch.Tensor) -> torch.Tensor:
        """Page-pool encode: (P, k, page) uint8 pool + (P,) {0,1}
        activity mask on the code's device -> (P, m, page) parity, dead
        pages zero — the ragged kernel family, one build for every
        occupancy."""
        self._check_device(pool)
        words = torch_words_view(pool, self.w)
        return torch_bytes_view(apply_matrix_best_ragged(
            words, self._matrix_static, mask, self.w))

    def decode_chunks_ragged_torch(self, pool: torch.Tensor,
                                   mask: torch.Tensor, available: tuple,
                                   erased: tuple) -> torch.Tensor:
        """Page-pool decode: (P, n_avail, page) survivors + mask ->
        (P, n_erased, page), dead pages zero."""
        if len(available) < self.k:
            raise IOError(f"need {self.k} chunks, have {len(available)}")
        self._check_device(pool)
        _, dm_static, ns = self._decode_matrix(tuple(available),
                                               tuple(erased))
        words = torch_words_view(pool[:, :ns, :], self.w)
        return torch_bytes_view(apply_matrix_best_ragged(
            words, dm_static, mask, self.w))

    # -- packed resident layout (ops/gf_kernels.py pack_chunks form) ----

    def encode_chunks_packed_torch(self, words: torch.Tensor) -> torch.Tensor:
        """(batch, k, R, 128) uint32 packed tensor -> packed parity
        (batch, m, R, 128).  w=8 only."""
        if self.w != 8:
            raise ValueError("packed layout is w=8 only")
        self._check_device(words)
        return apply_matrix_packed_best(words, self._matrix_static)

    def decode_chunks_packed_torch(self, words: torch.Tensor,
                                   available: tuple,
                                   erased: tuple) -> torch.Tensor:
        """Packed-layout decode: (batch, n_avail, R, 128) uint32 ->
        (batch, len(erased), R, 128)."""
        if self.w != 8:
            raise ValueError("packed layout is w=8 only")
        if len(available) < self.k:
            raise IOError(f"need {self.k} chunks, have {len(available)}")
        self._check_device(words)
        _, dm_static, ns = self._decode_matrix(tuple(available),
                                               tuple(erased))
        return apply_matrix_packed_best(words[..., :ns, :, :], dm_static)


class BitmatrixCodeMixin(_DeviceCode):
    """Compute paths for GF(2) bitmatrix codes in jerasure packet layout.

    Requires: self.k, self.m, self.w, self.packetsize, self.device, and
    build_bitmatrix() -> (m*w, k*w) 0/1 matrix.
    """

    min_xla_bytes = 1 << 20

    def build_bitmatrix(self) -> np.ndarray:
        raise NotImplementedError

    def prepare(self) -> None:
        self.bitmatrix = self.build_bitmatrix()
        self._bitmatrix_static = bitmatrix_to_static(self.bitmatrix)
        self._encode_sched = probe_bitmatrix_schedule(
            self._bitmatrix_static, self.w)
        self._decode_cache: dict = {}

    def _apply(self, chunks: np.ndarray, bitmatrix: np.ndarray,
               bitmatrix_static, sched) -> np.ndarray:
        perf = global_perf()
        chunks = np.ascontiguousarray(chunks)
        if chunks.nbytes < self.min_xla_bytes or _numpy_tier(self.device):
            perf.inc("ec_host_calls")
            perf.inc("ec_host_bytes", chunks.nbytes)
            with record_dispatch("ec_apply", path="host"):
                return regionops.bitmatrix_encode(chunks, bitmatrix, self.w,
                                                  self.packetsize)
        perf.inc("ec_device_calls")
        perf.inc("ec_device_bytes", chunks.nbytes)
        with perf.timed("ec_device_time"), \
                record_dispatch("ec_apply", path="device"):
            out = apply_bitmatrix_best(
                torch.from_numpy(chunks).to(self.device), bitmatrix_static,
                self.w, self.packetsize, sched).cpu().numpy()
        if verification_enabled():
            ref = regionops.bitmatrix_encode(chunks, bitmatrix, self.w,
                                             self.packetsize)
            if not np.array_equal(out, ref):
                raise DeviceVerificationError(
                    "device bitmatrix path diverged from host ground "
                    f"truth (w={self.w}, shape={chunks.shape})")
        return out

    def encode_chunks_batch(self, data: np.ndarray) -> np.ndarray:
        return self._apply(data, self.bitmatrix, self._bitmatrix_static,
                           self._encode_sched)

    def _decode_bitmatrix(self, available: tuple, erased: tuple):
        """(decode bitmatrix, its row masks, survivors used, schedule or
        None) of one erasure pattern, cached per instance and process."""
        key = (available, erased)
        hit = self._decode_cache.get(key)
        if hit is None:
            def build():
                survivors = list(available[:self.k])
                dm = regionops.bitmatrix_decode_matrix(
                    self.bitmatrix, self.k, self.w, survivors, list(erased))
                dm_static = bitmatrix_to_static(dm)
                return (dm, dm_static, len(survivors),
                        probe_bitmatrix_schedule(dm_static, self.w))

            hit = global_pattern_cache().get_or_build(
                pattern_key(self, "bitmatrix-decode", available, erased),
                build)
            self._decode_cache[key] = hit
        return hit

    def decode_chunks_batch(self, chunks: np.ndarray, available: tuple,
                            erased: tuple) -> np.ndarray:
        if len(available) < self.k:
            raise IOError(f"need {self.k} chunks, have {len(available)}")
        dm, dm_static, ns, sched = self._decode_bitmatrix(tuple(available),
                                                          tuple(erased))
        return self._apply(chunks[..., :ns, :], dm, dm_static, sched)

    # -- device-resident paths (tensor in, tensor out; no host copy) ----

    def encode_chunks_torch(self, data: torch.Tensor) -> torch.Tensor:
        """(batch, k, C) uint8 tensor -> (batch, m, C) parity, on the
        code's device."""
        self._check_device(data)
        return apply_bitmatrix_best(data, self._bitmatrix_static, self.w,
                                    self.packetsize, self._encode_sched)

    def decode_chunks_torch(self, chunks: torch.Tensor, available: tuple,
                            erased: tuple) -> torch.Tensor:
        """(batch, len(available), C) tensor -> (batch, len(erased), C)."""
        if len(available) < self.k:
            raise IOError(f"need {self.k} chunks, have {len(available)}")
        self._check_device(chunks)
        _, dm_static, ns, sched = self._decode_bitmatrix(tuple(available),
                                                         tuple(erased))
        return apply_bitmatrix_best(chunks[..., :ns, :], dm_static, self.w,
                                    self.packetsize, sched)

    # -- ragged paged surfaces -------------------------------------------

    def page_unit(self) -> int:
        """Bitmatrix codes mix across the w packets of one
        w*packetsize block but never across blocks: every pool page
        holds whole blocks."""
        return self.w * self.packetsize

    def encode_chunks_ragged_torch(self, pool: torch.Tensor,
                                   mask: torch.Tensor) -> torch.Tensor:
        """Page-pool bitmatrix encode: zero the dead pages
        (``mask_pages``) and run the packet kernels on the page batch —
        dead pages zero by XOR linearity."""
        self._check_device(pool)
        return apply_bitmatrix_best(mask_pages(pool, mask),
                                    self._bitmatrix_static, self.w,
                                    self.packetsize, self._encode_sched)

    def decode_chunks_ragged_torch(self, pool: torch.Tensor,
                                   mask: torch.Tensor, available: tuple,
                                   erased: tuple) -> torch.Tensor:
        """Page-pool bitmatrix decode, dead pages zero."""
        if len(available) < self.k:
            raise IOError(f"need {self.k} chunks, have {len(available)}")
        self._check_device(pool)
        _, dm_static, ns, sched = self._decode_bitmatrix(tuple(available),
                                                         tuple(erased))
        return apply_bitmatrix_best(mask_pages(pool[:, :ns, :], mask),
                                    dm_static, self.w, self.packetsize,
                                    sched)


def load_reference_matrix(ec, matrix: np.ndarray, pattern=None) -> None:
    """Install a matrix given as numpy into a port code: the coding
    matrix (``pattern=None``; e.g. the JAX package's ``ec.matrix``), or
    the decode matrix of one erasure pattern (``pattern=(available,
    erased)``), which then serves that pattern's decodes."""
    mat = np.asarray(matrix, dtype=np.int64)
    if mat.ndim != 2 or mat.min(initial=0) < 0 \
            or mat.max(initial=0) >= (1 << ec.w):
        raise ValueError(f"not a GF(2^{ec.w}) matrix: shape {mat.shape}")
    if pattern is None:
        if mat.shape != (ec.m, ec.k):
            raise ValueError(f"coding matrix must be ({ec.m}, {ec.k}), "
                             f"got {mat.shape}")
        ec._install_matrix(mat)
        return
    available, erased = (tuple(p) for p in pattern)
    if mat.shape != (len(erased), ec.k):
        raise ValueError(f"decode matrix must be ({len(erased)}, {ec.k}), "
                         f"got {mat.shape}")
    ec._decode_cache[(available, erased)] = (mat, matrix_to_static(mat),
                                             ec.k)
