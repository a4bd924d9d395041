"""jerasure-equivalent plugin: all seven techniques.

Mirrors src/erasure-code/jerasure/ErasureCodeJerasure.{h,cc} +
ErasureCodePluginJerasure.cc, as ``ceph_tpu.codes.plugins.jerasure``
does:
- class ErasureCodeJerasure               -> ErasureCodeJerasure
- ...ReedSolomonVandermonde (reed_sol_van) — GF(2^w) matrix technique
- ...ReedSolomonRAID6 (reed_sol_r6_op)     — P/Q matrix technique
- ...CauchyOrig / ...CauchyGood            — bitmatrix techniques
- ...Liberation / ...BlaumRoth / ...Liber8tion — minimal-density bitmatrix
- ErasureCodePluginJerasure::factory       -> ErasureCodePluginJerasure

Profile parameters (ErasureCodeJerasure::parse): k, m, w, technique,
packetsize, jerasure-per-chunk-alignment. Defaults k=2 m=1 w=8
technique=reed_sol_van packetsize=2048 (DEFAULT_* constants).

Compute: the matrix techniques through ``MatrixCodeMixin`` (GF(2^w)
matrix kernels, w in 8, 16, 32), the bitmatrix techniques through
``BitmatrixCodeMixin`` (the packet-layout kernels), on the code's
device; byte-identical to the reference on every path.
"""

from __future__ import annotations

import math

import numpy as np

from ...gf.bitmatrix import matrix_to_bitmatrix
from ...matrices.jerasure import (
    blaum_roth_coding_bitmatrix,
    cauchy_good_general_coding_matrix,
    cauchy_original_coding_matrix,
    liber8tion_coding_bitmatrix,
    liberation_coding_bitmatrix,
    reed_sol_r6_coding_matrix,
    reed_sol_vandermonde_coding_matrix,
)
from ..base import ErasureCode
from ..techniques import BitmatrixCodeMixin, MatrixCodeMixin
from ..registry import ERASURE_CODE_VERSION, ErasureCodePlugin

__erasure_code_version__ = ERASURE_CODE_VERSION

LARGEST_VECTOR_WORDSIZE = 16  # ErasureCodeJerasure.cc
SIZEOF_INT = 4


def _is_prime(n: int) -> bool:
    """ErasureCodeJerasure.cc -> is_prime (table up to 257 upstream)."""
    return n >= 2 and all(n % p for p in range(2, math.isqrt(n) + 1))


class ErasureCodeJerasure(ErasureCode):
    """Base of all jerasure techniques (ErasureCodeJerasure.{h,cc})."""

    DEFAULT_K = "2"
    DEFAULT_M = "1"
    DEFAULT_W = "8"
    technique = "?"

    def __init__(self, device=None) -> None:
        super().__init__(device)
        self.w = 8
        self.per_chunk_alignment = False

    def parse(self, profile) -> None:
        self.k = self.to_int("k", profile, self.DEFAULT_K)
        self.m = self.to_int("m", profile, self.DEFAULT_M)
        self.w = self.to_int("w", profile, self.DEFAULT_W)
        self.sanity_check_k_m(self.k, self.m)
        self.per_chunk_alignment = self.to_bool(
            "jerasure-per-chunk-alignment", profile, "false")
        self.check_technique()

    def check_technique(self) -> None:
        """Per-technique w/k/m validation (subclass parse tail)."""

    def get_alignment(self) -> int:
        raise NotImplementedError

    def get_chunk_size(self, stripe_width: int) -> int:
        """ErasureCodeJerasure::get_chunk_size: pad object (or chunk, in
        per-chunk-alignment mode) to the technique's alignment."""
        alignment = self.get_alignment()
        if self.per_chunk_alignment:
            chunk_size = -(-stripe_width // self.k)
            modulo = chunk_size % alignment
            if modulo:
                chunk_size += alignment - modulo
            return chunk_size
        tail = stripe_width % alignment
        padded = stripe_width + (alignment - tail if tail else 0)
        assert padded % self.k == 0
        return padded // self.k


class _MatrixTechnique(MatrixCodeMixin, ErasureCodeJerasure):
    """GF(2^w)-element matrix techniques (reed_sol_van / reed_sol_r6_op)."""

    def get_alignment(self) -> int:
        """ErasureCodeJerasureReedSolomonVandermonde::get_alignment."""
        if self.per_chunk_alignment:
            return self.w * LARGEST_VECTOR_WORDSIZE
        alignment = self.k * self.w * SIZEOF_INT
        if (self.w * SIZEOF_INT) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * LARGEST_VECTOR_WORDSIZE
        return alignment


class _BitmatrixTechnique(BitmatrixCodeMixin, ErasureCodeJerasure):
    """Bitmatrix techniques in jerasure packet layout (cauchy/liberation...)."""

    DEFAULT_PACKETSIZE = "2048"

    def __init__(self, device=None) -> None:
        super().__init__(device)
        self.packetsize = 2048

    def parse(self, profile) -> None:
        super().parse(profile)
        self.packetsize = self.to_int("packetsize", profile,
                                      self.DEFAULT_PACKETSIZE)
        if self.packetsize < 1:
            raise ValueError(f"packetsize={self.packetsize} must be >= 1")

    def get_alignment(self) -> int:
        """ErasureCodeJerasureCauchy/Liberation::get_alignment."""
        if self.per_chunk_alignment:
            alignment = self.w * self.packetsize
            if alignment % LARGEST_VECTOR_WORDSIZE:
                # keep the result a multiple of w*packetsize (the packet
                # layout requires it), like the non-per-chunk branch below
                alignment *= LARGEST_VECTOR_WORDSIZE
            return alignment
        alignment = self.k * self.w * self.packetsize * SIZEOF_INT
        if (self.w * self.packetsize * SIZEOF_INT) % LARGEST_VECTOR_WORDSIZE:
            alignment = (self.k * self.w * self.packetsize
                         * LARGEST_VECTOR_WORDSIZE)
        return alignment


class ErasureCodeJerasureReedSolomonVandermonde(_MatrixTechnique):
    """technique=reed_sol_van (jerasure reed_sol_vandermonde_coding_matrix)."""

    technique = "reed_sol_van"

    def check_technique(self) -> None:
        if self.w not in (8, 16, 32):
            raise ValueError(
                f"reed_sol_van: w={self.w} must be one of 8, 16, 32")
        if self.k + self.m > (1 << self.w):
            raise ValueError(
                f"reed_sol_van: k+m={self.k + self.m} must be <= 2^w={1 << self.w}")

    def build_matrix(self) -> np.ndarray:
        return reed_sol_vandermonde_coding_matrix(self.k, self.m, self.w)


class ErasureCodeJerasureReedSolomonRAID6(_MatrixTechnique):
    """technique=reed_sol_r6_op (m forced to 2; P = XOR, Q = 2^j)."""

    technique = "reed_sol_r6_op"
    DEFAULT_M = "2"

    def parse(self, profile) -> None:
        super().parse(profile)
        self.m = 2  # ErasureCodeJerasureReedSolomonRAID6::parse forces m=2

    def check_technique(self) -> None:
        if self.w not in (8, 16, 32):
            raise ValueError(
                f"reed_sol_r6_op: w={self.w} must be one of 8, 16, 32")

    def build_matrix(self) -> np.ndarray:
        return reed_sol_r6_coding_matrix(self.k, self.w)


class ErasureCodeJerasureCauchyOrig(_BitmatrixTechnique):
    """technique=cauchy_orig (cauchy_original_coding_matrix -> bitmatrix)."""

    technique = "cauchy_orig"

    def build_bitmatrix(self) -> np.ndarray:
        mat = cauchy_original_coding_matrix(self.k, self.m, self.w)
        return matrix_to_bitmatrix(self.k, self.m, self.w, mat)


class ErasureCodeJerasureCauchyGood(_BitmatrixTechnique):
    """technique=cauchy_good (cauchy_good_general_coding_matrix -> bitmatrix)."""

    technique = "cauchy_good"

    def build_bitmatrix(self) -> np.ndarray:
        mat = cauchy_good_general_coding_matrix(self.k, self.m, self.w)
        return matrix_to_bitmatrix(self.k, self.m, self.w, mat)


class ErasureCodeJerasureLiberation(_BitmatrixTechnique):
    """technique=liberation (w prime, k <= w, m = 2)."""

    technique = "liberation"
    DEFAULT_M = "2"
    DEFAULT_W = "7"
    DEFAULT_PACKETSIZE = "8"

    def parse(self, profile) -> None:
        super().parse(profile)
        self.m = 2

    def check_technique(self) -> None:
        # ErasureCodeJerasureLiberation::check_kw + check_w
        if self.k > self.w:
            raise ValueError(f"liberation: k={self.k} must be <= w={self.w}")
        if not _is_prime(self.w) or self.w <= 2:
            raise ValueError(f"liberation: w={self.w} must be an odd prime")

    def build_bitmatrix(self) -> np.ndarray:
        return liberation_coding_bitmatrix(self.k, self.w)


class ErasureCodeJerasureBlaumRoth(ErasureCodeJerasureLiberation):
    """technique=blaum_roth (w + 1 prime, k <= w, m = 2)."""

    technique = "blaum_roth"

    def check_technique(self) -> None:
        if self.k > self.w:
            raise ValueError(f"blaum_roth: k={self.k} must be <= w={self.w}")
        if not _is_prime(self.w + 1):
            raise ValueError(f"blaum_roth: w+1={self.w + 1} must be prime")

    def build_bitmatrix(self) -> np.ndarray:
        return blaum_roth_coding_bitmatrix(self.k, self.w)


class ErasureCodeJerasureLiber8tion(ErasureCodeJerasureLiberation):
    """technique=liber8tion (w = 8, m = 2, k <= 8)."""

    technique = "liber8tion"
    DEFAULT_K = "2"
    DEFAULT_W = "8"

    def parse(self, profile) -> None:
        # ErasureCodeJerasureLiber8tion::parse: w and m are not profile-tunable
        super().parse(profile)
        self.m = 2
        self.w = 8

    def check_technique(self) -> None:
        if self.k > 8:
            raise ValueError(f"liber8tion: k={self.k} must be <= 8")

    def build_bitmatrix(self) -> np.ndarray:
        return liber8tion_coding_bitmatrix(self.k)


TECHNIQUES = {
    cls.technique: cls
    for cls in (
        ErasureCodeJerasureReedSolomonVandermonde,
        ErasureCodeJerasureReedSolomonRAID6,
        ErasureCodeJerasureCauchyOrig,
        ErasureCodeJerasureCauchyGood,
        ErasureCodeJerasureLiberation,
        ErasureCodeJerasureBlaumRoth,
        ErasureCodeJerasureLiber8tion,
    )
}


class ErasureCodePluginJerasure(ErasureCodePlugin):
    """ErasureCodePluginJerasure.cc -> factory dispatch on technique."""

    def factory(self, profile, directory=None, device=None):
        technique = profile.get("technique", "reed_sol_van")
        cls = TECHNIQUES.get(technique)
        if cls is None:
            raise ValueError(
                f"technique={technique} is not a valid coding technique. "
                f"Choose one of the following: "
                f"{', '.join(sorted(TECHNIQUES))}")
        interface = cls(device)
        interface.init(profile)
        return interface


def __erasure_code_init__(plugin_name: str, registry) -> None:
    """Entry point (ErasureCodePluginJerasure.cc -> __erasure_code_init)."""
    registry.add(plugin_name, ErasureCodePluginJerasure())
