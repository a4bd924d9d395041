"""LRC — layered locally-repairable code plugin.

Mirrors src/erasure-code/lrc/ErasureCodeLrc.{h,cc} + ErasureCodePluginLrc.cc:

- low-level profile: ``mapping`` (string over {D, _}; D = data position)
  plus ``layers`` (JSON list of [layer_mapping, layer_profile] pairs).
  Each layer string marks, per global chunk position, D (data input of
  this layer), c (coding output of this layer) or _ (not in this layer);
  the layer runs its own sub-code (default jerasure reed_sol_van) over
  its D/c positions, data indices in D-appearance order then coding in
  c-appearance order (ErasureCodeLrc.cc -> layers_parse / layers_init).
- simple profile k/m/l (ErasureCodeLrc.cc -> parse_kml): requires
  (k+m) % l == 0; generates one global layer computing the m global
  parities plus (k+m)/l local layers, one local parity per group of l
  consecutive chunks.  Generated layout per group:
  ``_`` (local parity) + ``_`` * (m/groups) (global parities) +
  ``D`` * (l - m/groups), mapping string e.g. k=4 m=2 l=3 ->
  "__DD__DD" with layers ["_cDD_cDD", "cDDD____", "____cDDD"]
  (doc/erasure-code-lrc.rst example).
- ``crush-locality`` / ``crush-failure-domain`` / ``crush-root`` /
  ``crush-device-class`` / ``crush-steps`` are parsed and stored for the
  placement side; the coding math ignores them, as upstream does.
  ``create_rule`` emits the CRUSH rule they describe.
- minimum_to_decode prefers the smallest layer that covers the erasure
  (single-chunk repairs read l chunks instead of k); decode iterates
  layers to a fixpoint, repairing whatever each layer can with the
  chunks known so far (ErasureCodeLrc.cc -> minimum_to_decode / decode).

Addition of the JAX package, kept: the whole layered encode and every
fixed-pattern decode are GF(2^8)-linear over whole chunks, so they are
probed once into composite matrices (the decode composites cached per
instance and in the process-wide ``engine.PatternCache``), and the
batched and device paths run ONE matrix apply: ``*_batch`` through
``xor_schedule.host_matrix_apply`` on the host, ``*_torch`` and
``*_packed_torch`` through the engine table — the XOR-schedule kernel for
a composite whose schedule the probe prefers (a local repair is a row of
three 1s), the dense kernel otherwise.  Each layer's inner code is made
by the registry on the lrc code's device.

A port of ``ceph_tpu.codes.plugins.lrc``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...ops.gf_kernels import apply_matrix_best, apply_matrix_packed_best
from ...ops.torch_ops import matrix_to_static
from ...ops.xor_schedule import host_matrix_apply
from ..base import ErasureCode
from ..engine import global_pattern_cache, pattern_key
from ..interface import SIMD_ALIGN, ErasureCodeProfile
from ..registry import ERASURE_CODE_VERSION, ErasureCodePlugin
from ..techniques import _DeviceCode

__erasure_code_version__ = ERASURE_CODE_VERSION

W = 8


class _Layer:
    """One parsed layer: sub-code over its D/c positions."""

    __slots__ = ("mapping", "data_pos", "coding_pos", "code", "positions")

    def __init__(self, mapping: str, data_pos: List[int],
                 coding_pos: List[int], code) -> None:
        self.mapping = mapping
        self.data_pos = data_pos      # global positions, D-appearance order
        self.coding_pos = coding_pos  # global positions, c-appearance order
        self.code = code              # sub ErasureCodeInterface
        self.positions = data_pos + coding_pos


class ErasureCodeLrc(_DeviceCode, ErasureCode):
    """ErasureCodeLrc.{h,cc} — layered LRC."""

    def __init__(self, device=None) -> None:
        super().__init__(device)
        self.mapping = ""
        self.layers: List[_Layer] = []
        self.w = W

    # -- profile ------------------------------------------------------------

    def parse(self, profile: ErasureCodeProfile) -> None:
        has_kml = any(x in profile for x in ("k", "m", "l"))
        has_low = "mapping" in profile or "layers" in profile
        if has_kml and has_low:
            raise ValueError(
                "profile must use either k/m/l or mapping/layers, not both "
                "(ERROR_LRC_ALL_OR_NOTHING)")
        if has_kml:
            mapping, layers = self._generate_kml(profile)
        else:
            if "mapping" not in profile or "layers" not in profile:
                raise ValueError(
                    "profile requires both mapping and layers "
                    "(ERROR_LRC_MAPPING / ERROR_LRC_LAYERS_COUNT)")
            mapping = profile["mapping"]
            layers = self._parse_layers_json(profile["layers"])
        self._validate(mapping, layers)
        self._mapping_str = mapping
        self._layer_specs = layers
        self.k = mapping.count("D")
        self.m = len(mapping) - self.k
        self._parse_ruleset(profile, mapping,
                            int(profile["l"]) if has_kml else None)

    def _parse_ruleset(self, profile: ErasureCodeProfile, mapping: str,
                       l: Optional[int]) -> None:
        """ErasureCodeLrc.cc -> parse_ruleset / parse_kml's rule-step
        derivation: store the crush-* placement keys and the rule-step
        program create_rule() will emit.

        - default: one chooseleaf indep 0 over crush-failure-domain;
        - kml + crush-locality: choose indep <groups> over the locality
          type, then chooseleaf indep <l+1> (each group's chunk count:
          l data/global slots + 1 local parity) over the failure
          domain — single-chunk repair reads then stay inside one
          locality bucket;
        - explicit "crush-steps" JSON [[op, type, n], ...] overrides.
        """
        self.rule_root = profile.get("crush-root", "default")
        self.rule_device_class = profile.get("crush-device-class", "")
        fd = profile.get("crush-failure-domain", "host")
        self.rule_failure_domain = fd
        self.rule_locality = profile.get("crush-locality", "")
        if "crush-steps" in profile:
            try:
                raw = json.loads(profile["crush-steps"])
                steps = [(str(op), str(t), int(n)) for op, t, n in raw]
            except (ValueError, TypeError) as e:
                raise ValueError(f"bad crush-steps: {e} "
                                 f"(ERROR_LRC_RULESET_STEP)") from None
            for op, _t, _n in steps:
                if op not in ("choose", "chooseleaf"):
                    raise ValueError(
                        f"crush-steps op {op!r} must be choose or "
                        f"chooseleaf (ERROR_LRC_RULESET_OP)")
            self.rule_steps = steps
        elif self.rule_locality and l is not None:
            groups = len(mapping) // (l + 1)
            self.rule_steps = [("choose", self.rule_locality, groups),
                               ("chooseleaf", fd, l + 1)]
        else:
            self.rule_steps = [("chooseleaf", fd, 0)]

    def create_rule(self, builder, rule_id: Optional[int] = None,
                    name: str = "") -> int:
        """ErasureCodeLrc.cc -> create_ruleset: emit the CRUSH rule the
        stored crush-* keys describe into ``builder`` (CrushBuilder, the
        CrushWrapper analog) and return its id.

        Shape matches the reference: set_chooseleaf_tries 5,
        set_choose_tries 100, take <crush-root[~class]>, then one
        choose/chooseleaf INDEP step per rule step (erasure rules place
        positionally), emit."""
        from ...crush.types import step_choose_indep, step_chooseleaf_indep
        choose_steps = []
        for op, type_name, n in self.rule_steps:
            try:
                t = builder.type_id(type_name)
            except KeyError:
                raise ValueError(
                    f"bucket type {type_name!r} not in map "
                    f"(ERROR_LRC_RULESET_TYPE)") from None
            choose_steps.append(step_choose_indep(n, t) if op == "choose"
                                else step_chooseleaf_indep(n, t))
        return builder.add_erasure_rule(
            self.rule_root, choose_steps, rule_id=rule_id,
            name=name or "lrc", device_class=self.rule_device_class)

    @staticmethod
    def _parse_layers_json(text: str) -> List[Tuple[str, str]]:
        try:
            raw = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"layers is not valid JSON: {e} "
                             f"(ERROR_LRC_PARSE_JSON)") from None
        if not isinstance(raw, list) or not raw:
            raise ValueError("layers must be a non-empty JSON list "
                             "(ERROR_LRC_ARRAY)")
        out = []
        for entry in raw:
            if (not isinstance(entry, list) or not entry
                    or not isinstance(entry[0], str)):
                raise ValueError(f"bad layer entry {entry!r} "
                                 f"(ERROR_LRC_STR)")
            prof = entry[1] if len(entry) > 1 else ""
            if not isinstance(prof, str):
                raise ValueError(f"layer profile must be a string, got "
                                 f"{prof!r} (ERROR_LRC_CONFIG_OPTIONS)")
            out.append((entry[0], prof))
        return out

    @staticmethod
    def _generate_kml(profile: ErasureCodeProfile) -> Tuple[str, list]:
        """ErasureCodeLrc.cc -> parse_kml."""
        for key in ("k", "m", "l"):
            if key not in profile:
                raise ValueError(
                    f"k, m, l must all be set (missing {key}) "
                    f"(ERROR_LRC_ALL_OR_NOTHING)")
        k = int(profile["k"])
        m = int(profile["m"])
        l = int(profile["l"])
        if k < 1 or m < 1 or l < 1:
            raise ValueError(f"k={k}, m={m}, l={l} must all be >= 1")
        if (k + m) % l != 0:
            raise ValueError(
                f"(k + m) % l = ({k} + {m}) % {l} must be 0 "
                f"(ERROR_LRC_K_M_MODULO)")
        groups = (k + m) // l
        if m % groups != 0:
            raise ValueError(
                f"m={m} must be a multiple of (k+m)/l={groups} "
                f"(ERROR_LRC_K_M_MODULO)")
        gm = m // groups  # global parities per group
        mapping = ""
        glayer = ""
        for _ in range(groups):
            mapping += "_" + "_" * gm + "D" * (l - gm)
            glayer += "_" + "c" * gm + "D" * (l - gm)
        layers = [(glayer, "")]
        width = groups * (l + 1)
        for g in range(groups):
            start = g * (l + 1)
            local = ("_" * start + "c" + "D" * l
                     + "_" * (width - start - l - 1))
            layers.append((local, ""))
        return mapping, layers

    @staticmethod
    def _validate(mapping: str, layers: List[Tuple[str, str]]) -> None:
        n = len(mapping)
        if n == 0 or any(ch not in "D_" for ch in mapping):
            raise ValueError(f"bad mapping {mapping!r}: must be non-empty "
                             f"over {{D, _}} (ERROR_LRC_MAPPING)")
        covered = [False] * n
        for lm, _prof in layers:
            if len(lm) != n:
                raise ValueError(
                    f"layer {lm!r} length {len(lm)} != mapping length {n} "
                    f"(ERROR_LRC_MAPPING_SIZE)")
            if any(ch not in "Dc_" for ch in lm):
                raise ValueError(f"bad layer {lm!r}: must be over "
                                 f"{{D, c, _}} (ERROR_LRC_LAYER)")
            if "c" not in lm or "D" not in lm:
                raise ValueError(f"layer {lm!r} needs at least one D and "
                                 f"one c (ERROR_LRC_LAYER)")
            for i, ch in enumerate(lm):
                if ch == "c":
                    covered[i] = True
        for i, ch in enumerate(mapping):
            if ch == "_" and not covered[i]:
                raise ValueError(
                    f"parity position {i} is not the coding chunk of any "
                    f"layer (ERROR_LRC_MAPPING)")
            if ch == "D" and covered[i]:
                raise ValueError(
                    f"data position {i} is the coding chunk of a layer "
                    f"(ERROR_LRC_MAPPING)")

    def prepare(self) -> None:
        from ..registry import ErasureCodePluginRegistry
        registry = ErasureCodePluginRegistry.instance()
        self.mapping = self._mapping_str
        self.layers = []
        for lm, prof_str in self._layer_specs:
            data_pos = [i for i, ch in enumerate(lm) if ch == "D"]
            coding_pos = [i for i, ch in enumerate(lm) if ch == "c"]
            sub_profile = {"plugin": "jerasure",
                           "technique": "reed_sol_van", "w": str(W)}
            for token in prof_str.split():
                if "=" not in token:
                    raise ValueError(f"bad layer profile token {token!r} "
                                     f"(ERROR_LRC_CONFIG_OPTIONS)")
                key, value = token.split("=", 1)
                sub_profile[key] = value
            sub_profile["k"] = str(len(data_pos))
            sub_profile["m"] = str(len(coding_pos))
            if int(sub_profile.get("w", W) or W) != W:
                raise ValueError(
                    f"layer {lm!r}: w={sub_profile['w']} unsupported — "
                    f"the whole-chunk linear composite (and batch/device "
                    f"paths) are GF(2^8) only")
            plugin = sub_profile.pop("plugin")
            code = registry.factory(plugin, sub_profile, device=self.device)
            self.layers.append(_Layer(lm, data_pos, coding_pos, code))
        self.data_positions = [i for i, ch in enumerate(self.mapping)
                               if ch == "D"]
        self._linear_cache: Dict[tuple, object] = {}

    # -- counts / sizes -----------------------------------------------------

    def get_chunk_count(self) -> int:
        return len(self.mapping)

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_chunk_size(self, stripe_width: int) -> int:
        chunk = (stripe_width + self.k - 1) // self.k
        return (chunk + SIMD_ALIGN - 1) // SIMD_ALIGN * SIMD_ALIGN

    def get_chunk_mapping(self) -> List[int]:
        """Data chunk i lives at global position data_positions[i]."""
        return list(self.data_positions)

    # -- encode -------------------------------------------------------------

    def encode_prepare(self, data: bytes) -> Dict[int, bytes]:
        """Pad + carve k chunks, placed at the D positions in order."""
        chunk_size = self.get_chunk_size(len(data))
        padded = data + b"\x00" * (self.k * chunk_size - len(data))
        return {pos: padded[i * chunk_size:(i + 1) * chunk_size]
                for i, pos in enumerate(self.data_positions)}

    def encode_chunks(self, want_to_encode: set,
                      chunks: Dict[int, bytes]) -> Dict[int, bytes]:
        out = dict(chunks)
        for layer in self.layers:
            missing = [p for p in layer.data_pos if p not in out]
            if missing:
                raise ValueError(
                    f"layer {layer.mapping!r} needs positions {missing} "
                    f"which no earlier layer produced")
            sub_in = {i: out[p] for i, p in enumerate(layer.data_pos)}
            nk = len(layer.data_pos)
            sub_out = layer.code.encode_chunks(
                set(range(nk + len(layer.coding_pos))), sub_in)
            for j, p in enumerate(layer.coding_pos):
                out[p] = sub_out[nk + j]
        return out

    def decode_concat(self, chunks: Dict[int, bytes]) -> bytes:
        chunk_size = len(next(iter(chunks.values())))
        decoded = self.decode(set(self.data_positions), dict(chunks),
                              chunk_size)
        return b"".join(decoded[p] for p in self.data_positions)

    # -- recovery -----------------------------------------------------------

    def minimum_to_decode(
        self, want_to_read: set, available: set,
    ) -> Dict[int, List[Tuple[int, int]]]:
        reads = self._plan_reads(frozenset(want_to_read),
                                 frozenset(available))
        return {c: [(0, 1)] for c in reads}

    def _plan_reads(self, want: frozenset, available: frozenset) -> set:
        """Greedy layer walk, smallest layer first (ErasureCodeLrc.cc ->
        minimum_to_decode).

        Note this is NOT expressible over the probed composite (m, k)
        matrix with linear.decode_plan (as shec does): local parities
        cover *other parities*, and expressing them in terms of data
        chunks alone makes their rows dense, losing exactly the locality
        the layer walk exploits."""
        key = ("plan", want, available)
        hit = self._linear_cache.get(key)
        if hit is not None:
            return set(hit)
        known = set(available)
        reads = set(want & available)
        missing = set(want) - known
        layers = sorted(self.layers, key=lambda L: len(L.positions))
        n = len(self.mapping)
        expanded = False
        progress = True
        while missing and progress:
            progress = False
            for layer in layers:
                fixable = missing & set(layer.positions)
                if not fixable:
                    continue
                in_layer_known = [p for p in layer.positions if p in known]
                if len(in_layer_known) < len(layer.data_pos):
                    continue
                # the sub-code needs its first-k equivalent: delegate the
                # feasibility test to the sub-code's minimum_to_decode
                lidx = {p: i for i, p in enumerate(layer.positions)}
                try:
                    sub_min = layer.code.minimum_to_decode(
                        {lidx[p] for p in fixable},
                        {lidx[p] for p in in_layer_known})
                except IOError:
                    continue
                # only chunks physically present go in the read plan;
                # chunks an earlier layer reconstructed are free (decode
                # rebuilds them from the same reads)
                reads |= ({layer.positions[i] for i in sub_min}
                          & set(available))
                known |= fixable
                missing -= fixable
                progress = True
            if not progress and not expanded:
                # a wanted chunk may only be reachable through an
                # intermediate erased chunk no layer can yet rebuild from
                # `known`; widen the walk to every erasure so cascades
                # (local rebuild -> global rebuild) are planned too,
                # as ErasureCodeLrc::minimum_to_decode walks all erasures
                expanded = True
                extra = {p for p in range(n)
                         if p not in known and p not in missing}
                if extra:
                    missing |= extra
                    progress = True
        missing &= set(want)  # only wanted chunks must actually land
        if missing:
            raise IOError(
                f"cannot read {sorted(missing)} from available "
                f"{sorted(available)} with layers "
                f"{[L.mapping for L in self.layers]}")
        self._linear_cache[key] = frozenset(reads)
        return reads

    def decode(self, want_to_read: set, chunks: Dict[int, bytes],
               chunk_size: int) -> Dict[int, bytes]:
        want = set(want_to_read)
        known = dict(chunks)
        if want <= set(known):
            return {i: known[i] for i in sorted(want)}
        layers = sorted(self.layers, key=lambda L: len(L.positions))
        progress = True
        while (want - set(known)) and progress:
            progress = False
            for layer in layers:
                erased = [p for p in layer.positions if p not in known]
                if not erased:
                    continue
                avail = {p for p in layer.positions if p in known}
                if len(avail) < len(layer.data_pos):
                    continue
                lidx = {p: i for i, p in enumerate(layer.positions)}
                try:
                    sub_out = layer.code.decode(
                        {lidx[p] for p in erased},
                        {lidx[p]: known[p] for p in sorted(avail)},
                        chunk_size)
                except IOError:
                    continue
                for p in erased:
                    known[p] = sub_out[lidx[p]]
                progress = True
        if want - set(known):
            raise IOError(
                f"cannot decode {sorted(want - set(known))} from "
                f"available {sorted(chunks)}")
        return {i: known[i] for i in sorted(want)}

    def decode_chunks(self, want_to_read: set, chunks: Dict[int, bytes],
                      decoded: Dict[int, bytes]) -> Dict[int, bytes]:
        chunk_size = len(next(iter(chunks.values())))
        out = self.decode(set(want_to_read), dict(chunks), chunk_size)
        decoded.update(out)
        return decoded

    # -- probed composite matrices (the batch and device paths) -------------

    def _probe_encode_matrix(self) -> Tuple[np.ndarray, List[int]]:
        """((n-k, k) composite matrix, parity position order): every
        parity position expressed over the k data positions."""
        hit = self._linear_cache.get(("encode",))
        if hit is None:
            n, k = len(self.mapping), self.k
            chunks = {}
            for i, pos in enumerate(self.data_positions):
                arr = np.zeros(k, dtype=np.uint8)
                arr[i] = 1
                chunks[pos] = arr.tobytes()
            out = self.encode_chunks(set(range(n)), chunks)
            parity_pos = [p for p in range(n) if p not in chunks]
            M = np.stack([np.frombuffer(out[p], dtype=np.uint8)
                          for p in parity_pos]).astype(np.int64)
            hit = (M, parity_pos)
            self._linear_cache[("encode",)] = hit
        return hit

    def encode_chunks_batch(self, data: np.ndarray) -> np.ndarray:
        """(batch, k, C) -> (batch, n-k, C) parity in position order
        (host tier: the identical XOR schedule when the probe prefers
        one — ops/xor_schedule.py)."""
        M, _ = self._probe_encode_matrix()
        return host_matrix_apply(np.ascontiguousarray(data), M,
                                 self._encode_static(), W)

    def _decode_composite(self, available: tuple, erased: tuple):
        """(M, static) for the probed per-pattern composite decode
        matrix — the layer walk collapsed to ONE (len(erased),
        len(available)) GF(2^8) map, cached per instance and process."""
        key = ("decode", available, erased)
        hit = self._linear_cache.get(key)
        if hit is None:
            def build():
                na = len(available)
                chunks = {}
                for t, c in enumerate(available):
                    arr = np.zeros(na, dtype=np.uint8)
                    arr[t] = 1
                    chunks[c] = arr.tobytes()
                out = self.decode(set(erased), chunks, na)
                M = np.stack([np.frombuffer(out[c], dtype=np.uint8)
                              for c in erased]).astype(np.int64)
                return (M, matrix_to_static(M))

            hit = global_pattern_cache().get_or_build(
                pattern_key(self, "lrc-composite-decode", available,
                            erased), build)
            self._linear_cache[key] = hit
        return hit

    def _probe_decode_matrix(self, available: tuple, erased: tuple):
        """(len(erased), len(available)) composite decode matrix."""
        return self._decode_composite(available, erased)[0]

    def decode_chunks_batch(self, chunks: np.ndarray, available: tuple,
                            erased: tuple) -> np.ndarray:
        M, ms = self._decode_composite(tuple(available), tuple(erased))
        return host_matrix_apply(np.ascontiguousarray(chunks), M, ms, W)

    # -- device-resident paths ----------------------------------------------

    def _encode_static(self):
        ms = self._linear_cache.get(("encode_static",))
        if ms is None:
            M, _ = self._probe_encode_matrix()
            ms = matrix_to_static(M)
            self._linear_cache[("encode_static",)] = ms
        return ms

    def encode_chunks_torch(self, data: torch.Tensor) -> torch.Tensor:
        """(batch, k, C) uint8 tensor -> (batch, n-k, C) parity in
        position order, on the code's device: the probed composite
        through the engine table."""
        self._check_device(data)
        return apply_matrix_best(data, self._encode_static(), W)

    def decode_chunks_torch(self, chunks: torch.Tensor, available: tuple,
                            erased: tuple) -> torch.Tensor:
        """(batch, n_avail, C) tensor -> (batch, n_erased, C) via the
        per-pattern composite, dispatched like encode_chunks_torch."""
        self._check_device(chunks)
        _, ms = self._decode_composite(tuple(available), tuple(erased))
        return apply_matrix_best(chunks, ms, W)

    # -- packed resident layout (ops/gf_kernels.py pack_chunks form) -----

    def encode_chunks_packed_torch(self, words: torch.Tensor
                                   ) -> torch.Tensor:
        """(batch, k, R, 128) uint32 packed -> (batch, n-k, R, 128)
        packed parity through the composite packed dispatch."""
        self._check_device(words)
        return apply_matrix_packed_best(words, self._encode_static())

    def decode_chunks_packed_torch(self, words: torch.Tensor,
                                   available: tuple,
                                   erased: tuple) -> torch.Tensor:
        """Packed-layout composite decode: (batch, n_avail, R, 128)
        uint32 -> (batch, len(erased), R, 128)."""
        self._check_device(words)
        _, ms = self._decode_composite(tuple(available), tuple(erased))
        return apply_matrix_packed_best(words, ms)


class ErasureCodePluginLrc(ErasureCodePlugin):
    """ErasureCodePluginLrc.cc -> factory."""

    def factory(self, profile: ErasureCodeProfile, directory=None,
                device=None) -> ErasureCodeLrc:
        interface = ErasureCodeLrc(device)
        interface.init(profile)
        return interface


def __erasure_code_init__(plugin_name: str, registry) -> None:
    registry.add(plugin_name, ErasureCodePluginLrc())
