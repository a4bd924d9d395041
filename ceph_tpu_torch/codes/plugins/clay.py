"""Clay (coupled-layer) MSR regenerating-code plugin.

Mirrors src/erasure-code/clay/ErasureCodeClay.{h,cc} +
ErasureCodePluginClay.cc, as ``ceph_tpu.codes.plugins.clay`` does:

- profile k, m, d (k <= d <= k+m-1, default k+m-1), scalar_mds
  (jerasure|isa), technique (reed_sol_van; cauchy for isa); shec is
  refused loudly.
- geometry: q = d-k+1; nu virtual (zero) data chunks pad k+m to a
  multiple of q; t = (k+m+nu)/q columns; sub_chunk_count = q^t.
- node grid, pairwise coupling transform (the RS(2,2) coding matrix as
  the pair transform), the layered decode in increasing erased-dot
  intersection order, encode as the layered decode of the m coding
  nodes, and single-chunk repair from the q^(t-1) repair planes of d
  helpers (is_repair / minimum_to_decode with sub-chunk runs).

Every fixed (erasure pattern, geometry) transform is GF(2^8)-linear and
byte-position-independent, so the layered pipeline is probed once with
impulse inputs into a composite (out_subchunks x in_subchunks) GF(2^8)
matrix, cached per profile and pattern in ``engine.PatternCache``; the
batched and device paths run ONE matrix apply over (batch, chunks *
sub, chunk / sub).  On the card the engine table sends the large
composites (MXU_MATRIX_MIN nonzeros or more: the k=8 m=4 d=11 encode
and every decode but the four parity repairs) to the sparse
column-walk kernel (``gf_kernels.apply_matrix_mxu_cuda``) and the rest to the
dense GF(2^8) kernel, as the reference's table does.

Device surfaces (the reference's ``*_jax``): ``encode_chunks_torch``,
``decode_chunks_torch``, the packed ``*_packed_torch`` and the page
pool's ``*_ragged_torch``.  ``decode_chunks_torch(..., chunk_size=C)``
also takes Ceph's repair branch on the card: the d helpers' repair
sub-chunks, as ``minimum_to_decode``'s runs deliver them, rebuild one
lost chunk through the probed (sub, d * sub / q) repair composite, one
apply.  ``encode_chunks_batch`` /
``decode_chunks_batch`` take numpy and follow the matrix codes' host
rule: the host tier below ``min_xla_bytes``, the code's device above.
The dict API (``decode`` and the sub-chunk repair) runs the layered
decode on the host, as the reference does.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

import torch

from ...gf.gf8 import gf_inv
from ...gf.matrix import gf_invert_matrix
from ...matrices.isal import gf_gen_cauchy1_matrix, gf_gen_rs_matrix, \
    isa_coding_rows
from ...matrices.jerasure import reed_sol_vandermonde_coding_matrix
from ...ops import regionops
from ...ops.gf_kernels import apply_matrix_best, apply_matrix_best_ragged, \
    apply_matrix_packed_best
from ...ops.torch_ops import matrix_to_static
from ..base import ErasureCode
from ..engine import global_pattern_cache, pattern_key
from ..interface import ErasureCodeProfile
from ..registry import ERASURE_CODE_VERSION, ErasureCodePlugin
from ..techniques import MatrixCodeMixin, _DeviceCode
from ...telemetry import spans

__erasure_code_version__ = ERASURE_CODE_VERSION

W = 8  # clay is GF(2^8)-only in the reference (ErasureCodeClay.cc -> w=8)


def _mul(c: int, region: np.ndarray) -> np.ndarray:
    return regionops.mul_const_region(int(c), region, W)


class ErasureCodeClay(_DeviceCode, ErasureCode):
    """ErasureCodeClay.{h,cc} — coupled-layer MSR code."""

    DEFAULT_K = "4"
    DEFAULT_M = "2"
    # the host rule of encode/decode_chunks_batch (the matrix codes'
    # min_xla_bytes): below it the host tier runs
    min_xla_bytes = 1 << 20

    def __init__(self, device=None) -> None:
        super().__init__(device)
        self.d = 0
        self.q = 0
        self.t = 0
        self.nu = 0
        self.sub_chunk_no = 1
        self.scalar_mds = "jerasure"
        self.technique = "reed_sol_van"

    # -- profile (ErasureCodeClay.cc -> parse) ------------------------------

    def parse(self, profile: ErasureCodeProfile) -> None:
        self.k = self.to_int("k", profile, self.DEFAULT_K)
        self.m = self.to_int("m", profile, self.DEFAULT_M)
        self.w = W
        self.sanity_check_k_m(self.k, self.m)
        self.d = self.to_int("d", profile, str(self.k + self.m - 1))
        if not (self.k <= self.d <= self.k + self.m - 1):
            raise ValueError(
                f"d={self.d} must be within [k={self.k}, k+m-1="
                f"{self.k + self.m - 1}]")
        self.scalar_mds = self.to_string("scalar_mds", profile, "jerasure")
        self.technique = self.to_string("technique", profile, "reed_sol_van")
        if self.scalar_mds == "isa":
            allowed = ("reed_sol_van", "cauchy")
        elif self.scalar_mds == "jerasure":
            # bitmatrix techniques use the packet layout, which is
            # incompatible with clay's byte-granular sub-chunk coupling;
            # the reference gates clay to matrix techniques the same way
            # (ErasureCodePluginClay.cc -> parse technique check).
            allowed = ("reed_sol_van",)
        elif self.scalar_mds == "shec":
            # Ceph accepts scalar_mds=shec (ErasureCodeClay.cc ->
            # parse) and routes plane math through the shec plugin's
            # shingled, NON-MDS construction, which clay's coupling
            # math here does not model: reject loudly instead of
            # producing plausible but divergent parity.
            raise ValueError(
                "scalar_mds=shec is not supported: clay's coupling math "
                "here assumes an MDS scalar code; use scalar_mds="
                "jerasure or isa")
        else:
            raise ValueError(
                f"scalar_mds={self.scalar_mds!r} must be jerasure or "
                f"isa (shec: unsupported, see parse())")
        if self.technique not in allowed:
            raise ValueError(
                f"technique={self.technique!r} not supported with "
                f"scalar_mds={self.scalar_mds} (allowed: {allowed})")
        if self.k + self.m > 254:
            raise ValueError(f"k+m={self.k + self.m} must be <= 254")

    # -- geometry (ErasureCodeClay.cc -> prepare) ---------------------------

    def prepare(self) -> None:
        k, m = self.k, self.m
        self.q = self.d - k + 1
        rem = (k + m) % self.q
        self.nu = (self.q - rem) % self.q
        self.t = (k + m + self.nu) // self.q
        self.sub_chunk_no = self.q ** self.t
        self.n_nodes = self.q * self.t  # == k + nu + m
        # scalar MDS code over nodes: k+nu data, m coding.  Ceph
        # instantiates the sub-plugin through the registry; the per-plane
        # math only needs its (m, k+nu) coding matrix, built here with the
        # same generators (jerasure reed_sol.c / ISA-L ec_base.c).
        kk = k + self.nu
        if self.scalar_mds == "isa":
            if self.technique == "cauchy":
                full = gf_gen_cauchy1_matrix(m + kk, kk)
            else:
                full = gf_gen_rs_matrix(m + kk, kk)
            self.mds_matrix = isa_coding_rows(full, kk)
        else:
            self.mds_matrix = reed_sol_vandermonde_coding_matrix(kk, m, W)
        # pairwise coupling transform: RS(2,2) coding matrix
        # (ErasureCodeClay.cc -> pft, jerasure reed_sol_van k=2 m=2)
        self.pft = np.asarray(reed_sol_vandermonde_coding_matrix(2, 2, W),
                              dtype=np.int64)
        self.pft_inv = gf_invert_matrix(self.pft, W)
        self._plane_decode_cache: Dict[tuple, np.ndarray] = {}
        self._linear_cache: Dict[tuple, np.ndarray] = {}
        self._powq = [self.q ** y for y in range(self.t)]
        # ErasureCodeClay::get_chunk_size asks the scalar MDS sub-code for
        # its 1-byte-stripe chunk size (its SIMD alignment analog); Ceph
        # instantiates the sub-plugin through the registry, so this does
        # too (lazily, to keep plugin imports acyclic).  The sub-code only
        # answers that question, so it lives on the CPU.
        from ..registry import ErasureCodePluginRegistry
        sub_profile = {"k": str(k + self.nu), "m": str(m), "w": str(W),
                       "technique": self.technique}
        sub = ErasureCodePluginRegistry.instance().factory(
            self.scalar_mds, sub_profile, device="cpu")
        self._scalar_align = sub.get_chunk_size(1)

    # -- counts / sizes -----------------------------------------------------

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_no

    def get_chunk_size(self, stripe_width: int) -> int:
        """ErasureCodeClay.cc -> get_chunk_size: round the stripe up to
        sub_chunk_no * k * <scalar-code 1-byte chunk size>, then divide
        by k — every chunk splits into sub_chunk_no equal sub-chunks,
        each aligned for the scalar MDS sub-code."""
        alignment = self.sub_chunk_no * self.k * self._scalar_align
        padded = (stripe_width + alignment - 1) // alignment * alignment
        return padded // self.k

    # -- node / vertex geometry --------------------------------------------

    def _node(self, chunk_id: int) -> int:
        """Chunk index -> node index (virtual nodes sit at k..k+nu-1)."""
        return chunk_id if chunk_id < self.k else chunk_id + self.nu

    def _chunk(self, node: int) -> int | None:
        """Node index -> chunk index (None for virtual nodes)."""
        if node < self.k:
            return node
        if node < self.k + self.nu:
            return None
        return node - self.nu

    def _digit(self, z: int, y: int) -> int:
        return (z // self._powq[y]) % self.q

    def _pair(self, node: int, z: int) -> Tuple[int, int] | None:
        """Paired (node, plane) of vertex (node, z); None for dots."""
        x, y = node % self.q, node // self.q
        xp = self._digit(z, y)
        if xp == x:
            return None
        return y * self.q + xp, z + (x - xp) * self._powq[y]

    # -- coupling transform -------------------------------------------------

    def _slots(self, node: int, sw: int) -> Tuple[int, int]:
        """Pair slot of ``node`` and of ``sw`` (slot 0 = smaller x)."""
        s = 0 if (node % self.q) < (sw % self.q) else 1
        return s, 1 - s

    def _uncouple(self, c_self: np.ndarray, c_pair: np.ndarray,
                  node: int, sw: int) -> np.ndarray:
        """U of ``node``'s vertex from both coupled values."""
        s, _ = self._slots(node, sw)
        c0, c1 = (c_self, c_pair) if s == 0 else (c_pair, c_self)
        return _mul(self.pft_inv[s, 0], c0) ^ _mul(self.pft_inv[s, 1], c1)

    def _type1(self, c_self: np.ndarray, u_pair: np.ndarray,
               node: int, sw: int) -> np.ndarray:
        """U of ``node``'s vertex from its own C and the pair's U
        (ErasureCodeClay.cc -> recover_type1_erasure)."""
        s, sp = self._slots(node, sw)
        num = c_self ^ _mul(self.pft[s, sp], u_pair)
        return _mul(gf_inv(int(self.pft[s, s]), W), num)

    def _couple(self, u_self: np.ndarray, u_pair: np.ndarray,
                node: int, sw: int) -> np.ndarray:
        """C of ``node``'s vertex from both uncoupled values."""
        s, _ = self._slots(node, sw)
        u0, u1 = (u_self, u_pair) if s == 0 else (u_pair, u_self)
        return _mul(self.pft[s, 0], u0) ^ _mul(self.pft[s, 1], u1)

    # -- layered decode core ------------------------------------------------

    def _plane_decode_matrix(self, erased: Tuple[int, ...]) -> np.ndarray:
        """(len(erased), k+nu) matrix: survivors' U -> erased nodes' U."""
        dm = self._plane_decode_cache.get(erased)
        if dm is None:
            kk = self.k + self.nu
            survivors = [n for n in range(self.n_nodes) if n not in erased]
            dm = regionops.matrix_decode_matrix(
                self.mds_matrix, kk, survivors, list(erased), W)
            self._plane_decode_cache[erased] = dm
        return dm

    def _compute_u_plane(self, C: np.ndarray, U: np.ndarray,
                         u_known: np.ndarray, c_known: np.ndarray,
                         z: int, mds_erased: frozenset) -> None:
        """Fill U[node, z] for every node outside ``mds_erased``."""
        for node in range(self.n_nodes):
            if node in mds_erased:
                continue
            pr = self._pair(node, z)
            if pr is None:
                U[node, z] = C[node, z]
            else:
                sw, z_sw = pr
                if c_known[sw, z_sw]:
                    U[node, z] = self._uncouple(C[node, z], C[sw, z_sw],
                                                node, sw)
                elif u_known[sw, z_sw]:
                    U[node, z] = self._type1(C[node, z], U[sw, z_sw],
                                             node, sw)
                else:
                    raise RuntimeError(
                        f"plane ordering bug: vertex ({node},{z}) pair "
                        f"({sw},{z_sw}) has neither C nor U known")
            u_known[node, z] = True

    def _plane_orders(self, erased: frozenset) -> List[int]:
        """order[z] = number of erased 'dot' vertices in plane z
        (ErasureCodeClay.cc -> set_planes_sequential_decoding_order)."""
        orders = []
        for z in range(self.sub_chunk_no):
            n = 0
            for node in erased:
                x, y = node % self.q, node // self.q
                if self._digit(z, y) == x:
                    n += 1
            orders.append(n)
        return orders

    def _decode_layered(self, C: np.ndarray, c_known: np.ndarray,
                        erased_nodes: set) -> None:
        """Recover C[node] for every node in ``erased_nodes`` in place.

        C: (n_nodes, sub_chunk_no, sc) uint8; c_known: (n_nodes, sub) bool.
        ErasureCodeClay.cc -> decode_layered.
        """
        erased = set(erased_nodes)
        if len(erased) > self.m:
            raise IOError(
                f"cannot decode: {len(erased)} erasures > m={self.m}")
        # pad pseudo-erasures up to m with coding nodes so every plane's
        # MDS solve has a fixed pattern (ErasureCodeClay.cc ->
        # decode_layered erasure padding)
        for node in range(self.k + self.nu, self.n_nodes):
            if len(erased) >= self.m:
                break
            if node not in erased:
                erased.add(node)
                c_known[node, :] = False
        er = tuple(sorted(erased))
        erased_f = frozenset(erased)
        dm = self._plane_decode_matrix(er)
        survivors = [n for n in range(self.n_nodes) if n not in erased_f]
        orders = self._plane_orders(erased_f)
        U = np.zeros_like(C)
        u_known = np.zeros(C.shape[:2], dtype=bool)
        for iscore in range(max(orders) + 1):
            for z in range(self.sub_chunk_no):
                if orders[z] != iscore:
                    continue
                self._compute_u_plane(C, U, u_known, c_known, z, erased_f)
                solved = regionops.matrix_encode(
                    U[survivors, z], dm, W)
                for i, node in enumerate(er):
                    U[node, z] = solved[i]
                    u_known[node, z] = True
        # recouple erased nodes (ErasureCodeClay.cc -> decode_layered tail)
        for node in er:
            for z in range(self.sub_chunk_no):
                pr = self._pair(node, z)
                if pr is None:
                    C[node, z] = U[node, z]
                else:
                    sw, z_sw = pr
                    C[node, z] = self._couple(U[node, z], U[sw, z_sw],
                                              node, sw)
                c_known[node, z] = True

    # -- encode (ErasureCodeClay.cc -> encode_chunks via decode_layered) ----

    def encode_chunks(self, want_to_encode: set,
                      chunks: Dict[int, bytes]) -> Dict[int, bytes]:
        k = self.k
        chunk_size = len(chunks[0])
        sc = chunk_size // self.sub_chunk_no
        C = np.zeros((self.n_nodes, self.sub_chunk_no, sc), dtype=np.uint8)
        c_known = np.zeros((self.n_nodes, self.sub_chunk_no), dtype=bool)
        for i in range(k):
            C[i] = np.frombuffer(chunks[i], dtype=np.uint8).reshape(
                self.sub_chunk_no, sc)
            c_known[i, :] = True
        c_known[k:k + self.nu, :] = True  # virtual zero chunks
        coding = set(range(self.k + self.nu, self.n_nodes))
        self._decode_layered(C, c_known, coding)
        out = dict(chunks)
        for j in range(self.m):
            out[k + j] = C[k + self.nu + j].tobytes()
        return out

    # the matrix codes' host rule: the host tier (the identical XOR
    # schedule when the probe prefers one) below min_xla_bytes or under a
    # forced numpy tier, the engine table on the code's device above
    _apply = MatrixCodeMixin._apply

    def encode_chunks_batch(self, data: np.ndarray) -> np.ndarray:
        """(batch, k, chunk) -> (batch, m, chunk) via the probed composite
        encode matrix (one GF(2^8) matrix application)."""
        M, ms = self._encode_composite()
        b, k, chunk = data.shape
        sub = self.sub_chunk_no
        sc = chunk // sub
        x = np.ascontiguousarray(data).reshape(b, k * sub, sc)
        y = self._apply(x, M, ms)
        return y.reshape(b, self.m, chunk)

    # -- minimum_to_decode (ErasureCodeClay.cc -> minimum_to_decode) --------

    def is_repair(self, want_to_read: set, available: set) -> bool:
        """Single-chunk repair eligibility (ErasureCodeClay.cc ->
        is_repair): one lost chunk, its whole column otherwise available,
        and >= d helpers."""
        if self.q < 2:
            return False
        # the reference requires a single wanted chunk (not merely a single
        # erased one): multi-chunk wants take the full-decode path so every
        # wanted chunk comes back whole (ErasureCodeClay.cc -> is_repair)
        if len(set(want_to_read)) != 1:
            return False
        want = set(want_to_read) - set(available)
        if len(want) != 1:
            return False
        lost = self._node(next(iter(want)))
        y0 = lost // self.q
        for x in range(self.q):
            node = y0 * self.q + x
            if node == lost:
                continue
            c = self._chunk(node)
            if c is not None and c not in available:
                return False
        avail_real = [c for c in available
                      if c != self._chunk(lost)]
        return len(avail_real) >= self.d

    def _repair_planes(self, lost_node: int) -> List[int]:
        x0, y0 = lost_node % self.q, lost_node // self.q
        return [z for z in range(self.sub_chunk_no)
                if self._digit(z, y0) == x0]

    @staticmethod
    def _runs(indices: List[int]) -> List[Tuple[int, int]]:
        """Sorted indices -> contiguous (offset, length) runs."""
        runs: List[Tuple[int, int]] = []
        for i in indices:
            if runs and runs[-1][0] + runs[-1][1] == i:
                runs[-1] = (runs[-1][0], runs[-1][1] + 1)
            else:
                runs.append((i, 1))
        return runs

    def _pick_helpers(self, lost_node: int, available: set) -> List[int]:
        """Exactly d helper chunk ids: the lost column first, then lowest
        chunk ids (ErasureCodeClay.cc -> minimum_to_decode helper pick)."""
        y0 = lost_node // self.q
        column = []
        for x in range(self.q):
            node = y0 * self.q + x
            c = self._chunk(node)
            if node != lost_node and c is not None and c in available:
                column.append(c)
        rest = [c for c in sorted(available)
                if c not in column and c != self._chunk(lost_node)]
        helpers = column + rest
        return sorted(helpers[:self.d]) if len(helpers) >= self.d else helpers

    def minimum_to_decode(
        self, want_to_read: set, available: set,
    ) -> Dict[int, List[Tuple[int, int]]]:
        if set(want_to_read) <= set(available):
            return {c: [(0, self.sub_chunk_no)] for c in want_to_read}
        if self.is_repair(want_to_read, available):
            lost = self._node(next(iter(set(want_to_read) - set(available))))
            runs = self._runs(self._repair_planes(lost))
            helpers = self._pick_helpers(lost, set(available))
            return {c: list(runs) for c in helpers}
        chosen = self._minimum_to_decode(set(want_to_read), set(available))
        return {c: [(0, self.sub_chunk_no)] for c in chosen}

    # -- decode -------------------------------------------------------------

    def decode(self, want_to_read: set, chunks: Dict[int, bytes],
               chunk_size: int) -> Dict[int, bytes]:
        want = set(want_to_read)
        available = set(chunks)
        if want <= available:
            return {i: chunks[i] for i in sorted(want)}
        if self.is_repair(want, available):
            return self._repair(want, chunks, chunk_size)
        return self._decode_full(want, chunks, chunk_size)

    def _decode_full(self, want: set, chunks: Dict[int, bytes],
                     chunk_size: int) -> Dict[int, bytes]:
        sub = self.sub_chunk_no
        sc = chunk_size // sub
        C = np.zeros((self.n_nodes, sub, sc), dtype=np.uint8)
        c_known = np.zeros((self.n_nodes, sub), dtype=bool)
        c_known[self.k:self.k + self.nu, :] = True
        for c, buf in chunks.items():
            node = self._node(c)
            C[node] = np.frombuffer(buf, dtype=np.uint8).reshape(sub, sc)
            c_known[node, :] = True
        erased = {self._node(c) for c in range(self.k + self.m)
                  if c not in chunks}
        self._decode_layered(C, c_known, erased)
        return {c: (chunks[c] if c in chunks
                    else C[self._node(c)].tobytes())
                for c in want}

    def decode_chunks(self, want_to_read: set, chunks: Dict[int, bytes],
                      decoded: Dict[int, bytes]) -> Dict[int, bytes]:
        """Full-chunk decode entry: every buffer must be a whole chunk.

        Sub-chunk partial reads (as requested by the repair branch of
        minimum_to_decode) must go through decode(), whose explicit
        chunk_size argument disambiguates partial helper buffers."""
        sizes = {len(b) for b in chunks.values()}
        if len(sizes) != 1:
            raise IOError(
                f"decode_chunks requires equal full-size chunk buffers, "
                f"got sizes {sorted(sizes)}; use decode(chunk_size=...) "
                f"for sub-chunk repair reads")
        chunk_size = len(next(iter(chunks.values())))
        out = self.decode(set(range(self.k + self.m)) - set(chunks)
                          | set(want_to_read), dict(chunks), chunk_size)
        decoded.update(out)
        return decoded

    def decode_chunks_batch(self, chunks: np.ndarray, available: tuple,
                            erased: tuple) -> np.ndarray:
        """(batch, len(available), chunk) -> (batch, len(erased), chunk)
        via a probed per-pattern composite decode matrix."""
        M, ms = self._decode_composite(tuple(available), tuple(erased))
        b, na, chunk = chunks.shape
        sub = self.sub_chunk_no
        sc = chunk // sub
        x = np.ascontiguousarray(chunks).reshape(b, na * sub, sc)
        y = self._apply(x, M, ms)
        return y.reshape(b, len(erased), chunk)

    # -- repair (ErasureCodeClay.cc -> repair / repair_one_lost_chunk) ------

    def _repair(self, want: set, chunks: Dict[int, bytes],
                chunk_size: int) -> Dict[int, bytes]:
        lost_chunk = next(iter(want - set(chunks)))
        lost = self._node(lost_chunk)
        sc = chunk_size // self.sub_chunk_no
        helpers = self._pick_helpers(lost, set(chunks))
        repaired = self._repair_lost(
            lost, helpers,
            {h: np.frombuffer(chunks[h], dtype=np.uint8) for h in helpers},
            sc)
        out = {lost_chunk: repaired.tobytes()}
        for c in want & set(chunks):
            out[c] = chunks[c]
        return out

    def _repair_lost(self, lost: int, helpers: List[int],
                     helper_bufs: Dict[int, np.ndarray],
                     sc: int) -> np.ndarray:
        """Repair node ``lost`` from helper sub-chunks; each helper buffer
        is either the full chunk or just the repair planes concatenated.
        Returns the (sub_chunk_no, sc) repaired chunk."""
        q, sub = self.q, self.sub_chunk_no
        x0, y0 = lost % q, lost // q
        planes = self._repair_planes(lost)
        n_rp = len(planes)
        helper_nodes = {self._node(h) for h in helpers}
        aloof = {n for n in range(self.n_nodes)
                 if self._chunk(n) is not None
                 and n != lost and n not in helper_nodes
                 and self._chunk(n) not in helpers}
        C = np.zeros((self.n_nodes, sub, sc), dtype=np.uint8)
        c_known = np.zeros((self.n_nodes, sub), dtype=bool)
        # virtual chunks: zero everywhere, known everywhere
        for n in range(self.k, self.k + self.nu):
            c_known[n, :] = True
        for h in helpers:
            node = self._node(h)
            buf = helper_bufs[h]
            if buf.size == sub * sc:  # full chunk passed: slice planes
                arr = buf.reshape(sub, sc)[planes]
            elif buf.size == n_rp * sc:
                arr = buf.reshape(n_rp, sc)
            else:
                raise IOError(
                    f"repair helper chunk {h} has {buf.size} bytes; "
                    f"expected a full chunk ({sub * sc}) or the "
                    f"{n_rp} repair sub-chunks ({n_rp * sc}) for "
                    f"chunk_size {sub * sc}")
            C[node, planes] = arr
            c_known[node, planes] = True
        # per-plane MDS erasures: lost + aloof + rest of the lost column
        col = {y0 * q + x for x in range(q)} - {lost}
        mds_erased = frozenset({lost} | aloof | col)
        if len(mds_erased) != self.m:
            raise IOError(
                f"repair infeasible: {len(mds_erased)} unknowns per plane "
                f"!= m={self.m} (helpers={helpers})")
        er = tuple(sorted(mds_erased))
        dm = self._plane_decode_matrix(er)
        survivors = [n for n in range(self.n_nodes) if n not in mds_erased]
        # order repair planes by aloof-dot intersection score
        U = np.zeros_like(C)
        u_known = np.zeros((self.n_nodes, sub), dtype=bool)
        orders = {z: sum(1 for n in sorted(aloof)
                         if self._digit(z, n // q) == n % q)
                  for z in planes}
        for iscore in range(max(orders.values()) + 1 if planes else 0):
            for z in planes:
                if orders[z] != iscore:
                    continue
                self._compute_u_plane(C, U, u_known, c_known, z, mds_erased)
                solved = regionops.matrix_encode(U[survivors, z], dm, W)
                for i, node in enumerate(er):
                    U[node, z] = solved[i]
                    u_known[node, z] = True
        # lost chunk: repair planes are dots (C == U); other planes couple
        # with a lost-column vertex solved above
        out = np.zeros((sub, sc), dtype=np.uint8)
        for z in range(sub):
            xp = self._digit(z, y0)
            if xp == x0:
                out[z] = U[lost, z]
                continue
            u_node = y0 * q + xp
            z_rp = z + (x0 - xp) * self._powq[y0]  # the paired repair plane
            # C(v2) = pft[s2,0] U_slot0 + pft[s2,1] U_slot1 with
            # v2 = (u_node, z_rp), v1 = (lost, z); U(v2) known, solve
            # U(v1) then couple to get C(v1).
            s1, s2 = self._slots(lost, u_node)
            num = C[u_node, z_rp] ^ _mul(self.pft[s2, s2], U[u_node, z_rp])
            u_lost = _mul(gf_inv(int(self.pft[s2, s1]), W), num)
            u0, u1 = ((u_lost, U[u_node, z_rp]) if s1 == 0
                      else (U[u_node, z_rp], u_lost))
            out[z] = _mul(self.pft[s1, 0], u0) ^ _mul(self.pft[s1, 1], u1)
        return out

    # -- device-resident paths (tensor in, tensor out; no host copy) ------

    def _composite_rows(self, x: torch.Tensor, chunks: int) -> torch.Tensor:
        """(batch, chunks, C) -> (batch, chunks * sub, C / sub): every
        sub-chunk a composite input row (a view of a contiguous
        tensor)."""
        b, n, chunk = x.shape
        if n != chunks or chunk % self.sub_chunk_no:
            raise ValueError(
                f"need (batch, {chunks}, C) chunks with C a multiple of "
                f"{self.sub_chunk_no} sub-chunks, got {tuple(x.shape)}")
        return x.reshape(b, n * self.sub_chunk_no, chunk // self.sub_chunk_no)

    def encode_chunks_torch(self, data: torch.Tensor) -> torch.Tensor:
        """(batch, k, chunk) uint8 tensor -> (batch, m, chunk) parity on
        the code's device: ONE composite-matrix apply through the engine
        table (the column-walk kernel on the card for the large
        composites, the dense kernel otherwise); one armed root span
        ``codec.encode`` a call."""
        with spans.root("codec.encode"):
            self._check_device(data)
            _, ms = self._encode_composite()
            y = apply_matrix_best(self._composite_rows(data, self.k), ms, W)
            return y.reshape(data.shape[0], self.m, data.shape[-1])

    def decode_chunks_torch(self, chunks: torch.Tensor, available: tuple,
                            erased: tuple,
                            chunk_size: int | None = None) -> torch.Tensor:
        """(batch, len(available), chunk) tensor -> (batch, len(erased),
        chunk): the pattern's composite decode matrix, one apply.

        With ``chunk_size`` and buffers shorter than it (Ceph's
        ``decode(want, chunks, chunk_size)``): the single-chunk repair.
        ``available`` is exactly the d helpers ``minimum_to_decode``
        names for the one chunk in ``erased``, and ``chunks`` is
        (batch, d, sub / q * chunk_size / sub): each helper's repair
        sub-chunks concatenated in plane order.  Returns (batch, 1,
        chunk_size) from one apply of the repair composite over the
        helpers' sub-chunks as they lie.  One armed root span
        ``codec.decode`` (telemetry/spans.py) a call; the repair's plan
        is its child ``clay.repair_plan``, and its count
        ``repair_read_bytes`` the helper bytes the apply reads."""
        with spans.root("codec.decode"):
            self._check_device(chunks)
            if chunk_size is not None and chunks.shape[-1] != chunk_size:
                return self._repair_chunks_torch(chunks, tuple(available),
                                                 tuple(erased),
                                                 int(chunk_size))
            _, ms = self._decode_composite(tuple(available), tuple(erased))
            y = apply_matrix_best(
                self._composite_rows(chunks, len(available)), ms, W)
            return y.reshape(chunks.shape[0], len(erased), chunks.shape[-1])

    def _repair_chunks_torch(self, chunks: torch.Tensor, available: tuple,
                             erased: tuple,
                             chunk_size: int) -> torch.Tensor:
        with spans.child("clay.repair_plan"):
            ms, n_rp = self._repair_plan(tuple(chunks.shape), available,
                                         erased, chunk_size)
        b, d, _ = chunks.shape
        sc = chunk_size // self.sub_chunk_no
        spans.note("repair_read_bytes", b * d * n_rp * sc)
        y = apply_matrix_best(chunks.reshape(b, d * n_rp, sc), ms, W)
        return y.reshape(b, 1, chunk_size)

    def _repair_plan(self, shape: tuple, available: tuple, erased: tuple,
                     chunk_size: int):
        """(the repair composite's static form, repair sub-chunks a
        helper) of a partial-buffer call, or ValueError naming the input
        the repair branch takes."""
        ms = self._linear_cache.get(("repair", available, erased))
        if ms is None:
            lost = erased[0] if len(erased) == 1 else None
            if lost is None or not self.is_repair({lost}, set(available)) \
                    or self._pick_helpers(self._node(lost), set(available)) \
                    != sorted(available):
                raise ValueError(
                    f"partial chunks (chunk_size {chunk_size}, buffers of "
                    f"{shape[-1]} bytes) take the single-chunk repair: "
                    f"one erased chunk and available exactly the "
                    f"{self.d} helpers minimum_to_decode names for it; "
                    f"got available {available}, erased {erased}")
            ms = self._repair_composite(available, lost)[1]
            self._linear_cache[("repair", available, erased)] = ms
        sub = self.sub_chunk_no
        n_rp = sub // self.q
        if chunk_size % sub or len(shape) != 3 \
                or tuple(shape[1:]) != (self.d, n_rp * chunk_size // sub):
            raise ValueError(
                f"the repair of chunk {erased[0]} takes (batch, {self.d}, "
                f"{n_rp} * chunk_size / {sub}) helper sub-chunks with "
                f"chunk_size a multiple of {sub}; got {shape} for "
                f"chunk_size {chunk_size}")
        return ms, n_rp

    # -- ragged paged surfaces (serve/pool.py page pools) -----------------
    #
    # Clay's coupling spans ALL sub_chunk_no sub-chunks of a chunk at
    # one intra-sub-chunk byte offset, so a contiguous column split
    # would cut codewords apart.  page_interleave() makes the pool's
    # split take column slices of EVERY sub-chunk (serve/pool.py::
    # split_pages views the chunk as (sub, sc)), so each page IS a
    # valid clay chunk of size page_size — and the composite-matrix
    # surfaces below run the ragged dispatch on the page batch, dead
    # pages zero.

    def page_unit(self) -> int:
        return self.sub_chunk_no

    def page_interleave(self) -> int:
        return self.sub_chunk_no

    def encode_chunks_ragged_torch(self, pool: torch.Tensor,
                                   mask: torch.Tensor) -> torch.Tensor:
        """(P, k, page_size) pool + (P,) mask -> (P, m, page_size)
        parity, dead pages zero (composite matrix, ragged dispatch)."""
        self._check_device(pool)
        _, ms = self._encode_composite()
        y = apply_matrix_best_ragged(self._composite_rows(pool, self.k), ms,
                                     mask, W)
        return y.reshape(pool.shape[0], self.m, pool.shape[-1])

    def decode_chunks_ragged_torch(self, pool: torch.Tensor,
                                   mask: torch.Tensor, available: tuple,
                                   erased: tuple) -> torch.Tensor:
        """(P, n_avail, page_size) pool + (P,) mask ->
        (P, n_erased, page_size), dead pages zero."""
        self._check_device(pool)
        _, ms = self._decode_composite(tuple(available), tuple(erased))
        y = apply_matrix_best_ragged(
            self._composite_rows(pool, len(available)), ms, mask, W)
        return y.reshape(pool.shape[0], len(erased), pool.shape[-1])

    # -- packed resident layout (ops/gf_kernels.py pack_chunks form) ------

    def _packed_subsplit(self, rows: int) -> int:
        """Packed rows per sub-chunk; every sub-chunk must own whole
        uint32 rows for the packed reshape to be a free view."""
        sub = self.sub_chunk_no
        if rows % sub:
            raise ValueError(
                f"packed clay layout needs sub-chunk-aligned rows: "
                f"{rows} uint32 rows % {sub} sub-chunks != 0 (chunk "
                f"must be a multiple of {sub * 512} bytes)")
        return rows // sub

    def encode_chunks_packed_torch(self, words: torch.Tensor) -> torch.Tensor:
        """(batch, k, R, 128) uint32 packed -> (batch, m, R, 128)
        packed parity: sub-chunk rows split off as composite input
        rows, then ONE packed dispatch."""
        self._check_device(words)
        _, ms = self._encode_composite()
        b, k, rows, lane = words.shape
        sr = self._packed_subsplit(rows)
        x = words.reshape(b, k * self.sub_chunk_no, sr, lane)
        y = apply_matrix_packed_best(x, ms)
        return y.reshape(b, self.m, rows, lane)

    def decode_chunks_packed_torch(self, words: torch.Tensor,
                                   available: tuple,
                                   erased: tuple) -> torch.Tensor:
        """Packed-layout composite decode/repair: (batch, n_avail, R,
        128) uint32 -> (batch, len(erased), R, 128), one packed
        dispatch."""
        self._check_device(words)
        _, ms = self._decode_composite(tuple(available), tuple(erased))
        b, na, rows, lane = words.shape
        sr = self._packed_subsplit(rows)
        x = words.reshape(b, na * self.sub_chunk_no, sr, lane)
        y = apply_matrix_packed_best(x, ms)
        return y.reshape(b, len(erased), rows, lane)

    # -- probed composite matrices (the batched and device paths) -----------
    #
    # Cached (M, static) pairs, cross-instance through the engine
    # pattern cache: the impulse probe runs the layered decode over a
    # (k*sub)-wide identity payload — tenths of a second of host work
    # per pattern for the k=8,m=4,d=11 geometry — and the static tuple
    # keys the kernels' data caches, so a fresh factory() with the same
    # profile reuses both.

    def _encode_composite(self):
        hit = self._linear_cache.get(("encode",))
        if hit is None:
            def build():
                k, sub = self.k, self.sub_chunk_no
                width = k * sub
                C = np.zeros((self.n_nodes, sub, width), dtype=np.uint8)
                c_known = np.zeros((self.n_nodes, sub), dtype=bool)
                for i in range(k):
                    for s in range(sub):
                        C[i, s, i * sub + s] = 1
                    c_known[i, :] = True
                c_known[k:k + self.nu, :] = True
                coding = set(range(self.k + self.nu, self.n_nodes))
                self._decode_layered(C, c_known, coding)
                M = np.concatenate(
                    [C[self.k + self.nu + j] for j in range(self.m)],
                    axis=0).astype(np.int64)
                return (M, matrix_to_static(M))

            hit = global_pattern_cache().get_or_build(
                pattern_key(self, "clay-composite-encode", (), ()),
                build)
            self._linear_cache[("encode",)] = hit
        return hit

    def _probe_encode_matrix(self) -> np.ndarray:
        """(m*sub, k*sub) composite encode matrix via impulse probing."""
        return self._encode_composite()[0]

    def _decode_composite(self, available: Tuple[int, ...],
                          erased: Tuple[int, ...]):
        key = ("decode", available, erased)
        hit = self._linear_cache.get(key)
        if hit is None:
            def build():
                sub = self.sub_chunk_no
                width = len(available) * sub
                chunks = {}
                for t, c in enumerate(available):
                    arr = np.zeros((sub, width), dtype=np.uint8)
                    for s in range(sub):
                        arr[s, t * sub + s] = 1
                    chunks[c] = arr.tobytes()
                out = self._decode_full(set(erased), chunks, sub * width)
                M = np.concatenate(
                    [np.frombuffer(out[c], dtype=np.uint8).reshape(
                        sub, width)
                     for c in erased], axis=0).astype(np.int64)
                return (M, matrix_to_static(M))

            hit = global_pattern_cache().get_or_build(
                pattern_key(self, "clay-composite-decode", available,
                            erased), build)
            self._linear_cache[key] = hit
        return hit

    def _probe_decode_matrix(self, available: Tuple[int, ...],
                             erased: Tuple[int, ...]) -> np.ndarray:
        """(len(erased)*sub, len(available)*sub) composite decode matrix."""
        return self._decode_composite(available, erased)[0]

    def _repair_composite(self, available: Tuple[int, ...], lost: int):
        """(M, static) of the single-chunk repair of ``lost`` from the
        helpers ``available``: (sub, len(available) * sub / q), column
        t * (sub / q) + p the p-th repair sub-chunk of helper
        available[t], probed through ``_repair_lost``."""
        def build():
            node = self._node(lost)
            n_rp = len(self._repair_planes(node))
            width = len(available) * n_rp
            bufs = {}
            for t, h in enumerate(available):
                arr = np.zeros((n_rp, width), dtype=np.uint8)
                arr[np.arange(n_rp), t * n_rp + np.arange(n_rp)] = 1
                bufs[h] = arr.reshape(-1)
            M = self._repair_lost(node, list(available), bufs,
                                  width).astype(np.int64)
            return (M, matrix_to_static(M))

        return global_pattern_cache().get_or_build(
            pattern_key(self, "clay-composite-repair", available, (lost,)),
            build)


class ErasureCodePluginClay(ErasureCodePlugin):
    """ErasureCodePluginClay.cc -> factory."""

    def factory(self, profile: ErasureCodeProfile, directory=None,
                device=None) -> ErasureCodeClay:
        interface = ErasureCodeClay(device)
        interface.init(profile)
        return interface


def __erasure_code_init__(plugin_name: str, registry) -> None:
    registry.add(plugin_name, ErasureCodePluginClay())
