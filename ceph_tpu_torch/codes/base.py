"""ErasureCode base class — shared padding/decode logic.

Mirrors src/erasure-code/ErasureCode.{h,cc} -> class ErasureCode, as
``ceph_tpu.codes.base`` does:
- encode_prepare: pad input to k * chunk_size with zeros, carve k chunks.
- encode: prepare + encode_chunks + filter to want_to_encode.
- _minimum_to_decode: want if all available, else first k available in
  index order.
- _decode: pass-through if everything wanted is available, else zero-fill
  missing chunk buffers and call decode_chunks.
- profile helpers: to_int / to_bool / to_string, sanity_check_k_m.

Every code instance has a ``device``: the card unless the caller asks
for the CPU (``device="cpu"``); asking for the card on a host without
one raises (ops/fallback.py::resolve_device).  ``create_rule`` emits
the code's CRUSH placement rule through the port's ``crush.builder``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .interface import ErasureCodeInterface, ErasureCodeProfile
from ..ops.fallback import resolve_device


class ErasureCode(ErasureCodeInterface):
    """Base class with the reference's default behaviors."""

    def __init__(self, device=None) -> None:
        self._profile: ErasureCodeProfile = {}
        self.k = 0
        self.m = 0
        self.device = resolve_device(device)

    # -- profile plumbing (ErasureCode.cc -> parse/to_int/to_bool) ----------

    def init(self, profile: ErasureCodeProfile) -> None:
        self.parse(profile)
        self._profile = dict(profile)
        self.prepare()

    def parse(self, profile: ErasureCodeProfile) -> None:
        """Subclasses parse k/m/technique/...; raise ValueError on bad input."""
        raise NotImplementedError

    def prepare(self) -> None:
        """Subclasses build matrices/tables after parse."""
        raise NotImplementedError

    def get_profile(self) -> ErasureCodeProfile:
        return self._profile

    # -- placement rule (ErasureCode.cc -> create_ruleset default) ----------

    def create_rule(self, builder, rule_id=None, name: str = ""):
        """ErasureCode.cc -> ErasureCode::create_ruleset (default):
        emit the canonical erasure rule for this profile into
        ``builder`` (CrushBuilder, the CrushWrapper analog) and return
        its id — set_chooseleaf_tries 5, set_choose_tries 100, take
        crush-root[~crush-device-class], chooseleaf indep 0 over
        crush-failure-domain, emit (the well-known EC rule shape
        CrushWrapper::add_simple_rule produces for mode "indep").
        Plugins with their own placement geometry override this (lrc's
        locality rule)."""
        from ..crush.types import step_chooseleaf_indep
        profile = self._profile
        fd = profile.get("crush-failure-domain", "host")
        try:
            fd_type = builder.type_id(fd)
        except KeyError:
            raise ValueError(
                f"crush-failure-domain type {fd!r} not in map") from None
        return builder.add_erasure_rule(
            profile.get("crush-root", "default"),
            [step_chooseleaf_indep(0, fd_type)],
            rule_id=rule_id, name=name,
            device_class=profile.get("crush-device-class", ""))

    @staticmethod
    def to_int(name: str, profile: ErasureCodeProfile, default: str) -> int:
        """ErasureCode.cc -> ErasureCode::to_int: '' or missing -> default."""
        s = profile.get(name, default)
        if s == "":
            s = default
        try:
            return int(s)
        except ValueError:
            raise ValueError(
                f"could not convert {name}={s!r} to int") from None

    @staticmethod
    def to_bool(name: str, profile: ErasureCodeProfile, default: str) -> bool:
        s = profile.get(name, default)
        if s == "":
            s = default
        return str(s).lower() in ("yes", "true", "1")

    @staticmethod
    def to_string(name: str, profile: ErasureCodeProfile, default: str) -> str:
        s = profile.get(name, default)
        return s if s != "" else default

    def sanity_check_k_m(self, k: int, m: int) -> None:
        """ErasureCode.cc -> sanity_check_k_m: k >= 2, m >= 1."""
        if k < 2:
            raise ValueError(f"k={k} must be >= 2")
        if m < 1:
            raise ValueError(f"m={m} must be >= 1")

    # -- counts -------------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    # -- paged serving layout (serve/pool.py) -------------------------------

    def page_unit(self) -> int:
        """Page-size quantum for the paged serving pool: every pool
        page size must be a multiple of this, so that each page is a
        valid standalone chunk for this code's column-local region
        math.  Codes whose mixing spans a wider column group override
        (matrix codes: the field-element width; bitmatrix codes: one
        w*packetsize packet block)."""
        return 1

    def page_interleave(self) -> int:
        """Column-interleave factor Q for page split/join
        (serve/pool.py::split_pages): a chunk is viewed as (Q, C/Q)
        and pages take column slices of every group, so codes whose
        region math spans all Q groups at one intra-group byte offset
        (clay's sub-chunk coupling) still see valid mini-chunks.
        Q=1 (default) is a contiguous column split."""
        return 1

    # -- encode path (ErasureCode.cc -> encode/encode_prepare) --------------

    def encode_prepare(self, data: bytes) -> Dict[int, bytes]:
        """Pad to k * chunk_size and carve k data chunks."""
        k = self.get_data_chunk_count()
        chunk_size = self.get_chunk_size(len(data))
        padded = data + b"\x00" * (k * chunk_size - len(data))
        return {i: padded[i * chunk_size:(i + 1) * chunk_size]
                for i in range(k)}

    def encode(self, want_to_encode: set, data: bytes) -> Dict[int, bytes]:
        chunks = self.encode_prepare(data)
        encoded = self.encode_chunks(set(range(self.get_chunk_count())),
                                     chunks)
        return {i: encoded[i] for i in want_to_encode}

    def encode_chunks(self, want_to_encode: set,
                      chunks: Dict[int, bytes]) -> Dict[int, bytes]:
        """Compute coding chunks from the k data chunks (array fast path)."""
        k = self.get_data_chunk_count()
        data = np.stack([np.frombuffer(chunks[i], dtype=np.uint8)
                         for i in range(k)])
        coded = self.encode_chunks_batch(data[None])[0]
        out = dict(chunks)
        for i in range(self.m):
            out[k + i] = coded[i].tobytes()
        return out

    def encode_chunks_batch(self, data: np.ndarray) -> np.ndarray:
        """(batch, k, chunk_size) uint8 -> (batch, m, chunk_size) parity."""
        raise NotImplementedError

    # -- decode path (ErasureCode.cc -> decode/_decode) ----------------------

    def _minimum_to_decode(self, want_to_read: set, available: set) -> set:
        if want_to_read <= available:
            return set(want_to_read)
        k = self.get_data_chunk_count()
        if len(available) < k:
            raise IOError(
                f"cannot decode: {len(available)} chunks available, need {k}")
        return set(sorted(available)[:k])

    def minimum_to_decode(
        self, want_to_read: set, available: set,
    ) -> Dict[int, List[Tuple[int, int]]]:
        chosen = self._minimum_to_decode(want_to_read, available)
        return {c: [(0, self.get_sub_chunk_count())] for c in chosen}

    def decode(self, want_to_read: set, chunks: Dict[int, bytes],
               chunk_size: int) -> Dict[int, bytes]:
        if want_to_read <= set(chunks):
            return {i: chunks[i] for i in want_to_read}
        n = self.get_chunk_count()
        decoded = {}
        for i in range(n):
            if i in chunks:
                decoded[i] = chunks[i]
            else:
                decoded[i] = b"\x00" * chunk_size
        decoded = self.decode_chunks(want_to_read, chunks, decoded)
        return {i: decoded[i] for i in want_to_read}

    def decode_chunks(self, want_to_read: set, chunks: Dict[int, bytes],
                      decoded: Dict[int, bytes]) -> Dict[int, bytes]:
        """Reconstruct erased chunks (array fast path)."""
        available = sorted(chunks)
        erased = [i for i in range(self.get_chunk_count()) if i not in chunks]
        if not erased:
            return decoded
        stack = np.stack([np.frombuffer(chunks[i], dtype=np.uint8)
                          for i in available])
        rec = self.decode_chunks_batch(stack[None], tuple(available),
                                       tuple(erased))[0]
        for idx, chunk_id in enumerate(erased):
            decoded[chunk_id] = rec[idx].tobytes()
        return decoded

    def decode_chunks_batch(self, chunks: np.ndarray, available: tuple,
                            erased: tuple) -> np.ndarray:
        """(batch, len(available), C) -> (batch, len(erased), C)."""
        raise NotImplementedError
