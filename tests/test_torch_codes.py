"""Port parity, the slice as a whole: registry -> jerasure / isa matrix
codes (MatrixCodeMixin) and jerasure bitmatrix codes
(BitmatrixCodeMixin) -> engine table -> torch tier, against ceph_tpu's
plugins on the same seeded inputs.  Exact byte equality (GF math is
integer).  Chunks are small (4 KiB, or a few packet blocks) so the CPU
run stays short; ``min_xla_bytes = 0`` on the port sends even these
through the device path (the torch tier on the CPU)."""

import itertools
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.codes.registry import ErasureCodePluginRegistry as RefRegistry
from ceph_tpu.ops.pallas_gf import pack_chunks as ref_pack_chunks
from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.codes.techniques import load_reference_matrix
from ceph_tpu_torch.ops import fallback, regionops
from ceph_tpu_torch.ops.gf_kernels import pack_chunks, unpack_chunks
from ceph_tpu_torch.utils.errors import NoDeviceError
from ceph_tpu_torch.utils.perf import global_perf

CPU = torch.device("cpu")

PROFILES = [
    ("jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"}),
    ("jerasure", {"technique": "reed_sol_r6_op", "k": "6"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2",
                  "w": "16"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "3", "m": "2",
                  "w": "32"}),
    ("isa", {"technique": "reed_sol_van", "k": "8", "m": "3"}),
    ("isa", {"technique": "reed_sol_van", "k": "4", "m": "2"}),
    ("isa", {"technique": "cauchy", "k": "6", "m": "3"}),
    ("jerasure", {"technique": "cauchy_good", "k": "8", "m": "3",
                  "packetsize": "32"}),
    ("jerasure", {"technique": "cauchy_orig", "k": "4", "m": "2",
                  "packetsize": "64"}),
    ("jerasure", {"technique": "liberation", "k": "7", "w": "7"}),
    ("jerasure", {"technique": "blaum_roth", "k": "6", "w": "6",
                  "packetsize": "32"}),
    ("jerasure", {"technique": "liber8tion", "k": "8", "packetsize": "16"}),
]


def _pair(plugin, profile, min_bytes=0):
    ours = ErasureCodePluginRegistry.instance().factory(
        plugin, dict(profile), device="cpu")
    ours.min_xla_bytes = min_bytes
    ref = RefRegistry.instance().factory(plugin, dict(profile))
    return ours, ref


def _data(seed, k, c=4096, batch=2):
    return np.random.default_rng(seed).integers(0, 256, (batch, k, c),
                                                dtype=np.uint8)


def _chunk(ec):
    """4 KiB for matrix codes; four packet blocks for bitmatrix codes."""
    return ec.w * ec.packetsize * 4 if hasattr(ec, "packetsize") else 4096


def _coding(ec):
    return ec.bitmatrix if hasattr(ec, "bitmatrix") else ec.matrix


@pytest.mark.parametrize("plugin,profile", PROFILES,
                         ids=[f"{p}-{d['technique']}-k{d['k']}-"
                              f"w{d.get('w', 8)}" for p, d in PROFILES])
def test_encode_matches_reference(plugin, profile):
    ours, ref = _pair(plugin, profile)
    assert np.array_equal(_coding(ours), _coding(ref))
    data = _data(ours.k, ours.k, c=_chunk(ours))
    want = ref.encode_chunks_batch(data)
    assert np.array_equal(ours.encode_chunks_batch(data), want)
    assert np.array_equal(
        np.asarray(ref.encode_chunks_jax(jnp.asarray(data))), want)
    got = ours.encode_chunks_torch(torch.from_numpy(data))
    assert got.device == CPU and np.array_equal(got.numpy(), want)
    # the host rule: below min_xla_bytes the numpy ground truth runs
    ours.min_xla_bytes = 1 << 20
    assert np.array_equal(ours.encode_chunks_batch(data), want)


def test_host_rule_is_counted():
    ours, _ = _pair(*PROFILES[1])
    perf = global_perf()
    data = _data(1, 4)
    h0, d0 = perf.get("ec_host_calls"), perf.get("ec_device_calls")
    ours.encode_chunks_batch(data)
    assert perf.get("ec_device_calls") == d0 + 1
    ours.min_xla_bytes = data.nbytes + 1
    ours.encode_chunks_batch(data)
    assert perf.get("ec_host_calls") == h0 + 1


def _patterns(n, m):
    for e in range(1, m + 1):
        yield from itertools.combinations(range(n), e)


def test_every_k8_m3_erasure_pattern_decodes_like_reference():
    ours, ref = _pair(*PROFILES[0])
    k, n = 8, 11
    data = _data(83, k, c=1024)
    full = np.concatenate([data, ref.encode_chunks_batch(data)], axis=1)
    tfull = torch.from_numpy(full)
    count = 0
    for erased in _patterns(n, 3):
        avail = tuple(i for i in range(n) if i not in erased)
        chunks = full[:, list(avail)]
        want = ref.decode_chunks_batch(chunks, avail, erased)
        assert np.array_equal(want, full[:, list(erased)])
        assert np.array_equal(ours.decode_chunks_batch(chunks, avail,
                                                       erased), want)
        got = ours.decode_chunks_torch(tfull[:, list(avail)], avail, erased)
        assert np.array_equal(got.numpy(), want)
        count += 1
    assert count == 11 + 55 + 165


def test_every_cauchy_good_k8_m3_erasure_pattern_decodes_like_reference():
    """cauchy_good k=8 m=3 (packetsize 32): all 231 1/2/3-erasure
    patterns, through decode_chunks_batch and decode_chunks_torch (the
    plain packet product for the 9 single data erasures, a CSE schedule
    for the rest), byte-identical to the reference."""
    ours, ref = _pair(*PROFILES[8])
    k, n = 8, 11
    data = _data(84, k, c=8 * 32 * 2)
    full = np.concatenate([data, ref.encode_chunks_batch(data)], axis=1)
    tfull = torch.from_numpy(full)
    count = 0
    for erased in _patterns(n, 3):
        avail = tuple(i for i in range(n) if i not in erased)
        chunks = full[:, list(avail)]
        want = ref.decode_chunks_batch(chunks, avail, erased)
        assert np.array_equal(want, full[:, list(erased)])
        assert np.array_equal(ours.decode_chunks_batch(chunks, avail,
                                                       erased), want)
        got = ours.decode_chunks_torch(tfull[:, list(avail)], avail, erased)
        assert np.array_equal(got.numpy(), want)
        count += 1
    assert count == 231
    assert len(ours._decode_cache) == 231     # each pattern's CSE ran once


def test_bitmatrix_dict_api_round_trips():
    ours, ref = _pair("jerasure", {"technique": "cauchy_good", "k": "4",
                                   "m": "2", "packetsize": "32"})
    payload = bytes(np.random.default_rng(10).integers(
        0, 256, 10_001, dtype=np.uint8))
    enc = ours.encode(set(range(6)), payload)
    assert enc == ref.encode(set(range(6)), payload)
    assert ours.get_chunk_size(len(payload)) == ref.get_chunk_size(
        len(payload))
    for avail in ({0, 2, 4, 5}, {2, 3, 4, 5}):
        need = ours.minimum_to_decode({0, 1, 2, 3}, avail)
        assert need == ref.minimum_to_decode({0, 1, 2, 3}, avail)
        dec = ours.decode({0, 1, 2, 3}, {i: enc[i] for i in need},
                          len(enc[0]))
        assert b"".join(dec[i] for i in range(4))[:len(payload)] == payload


@pytest.mark.parametrize("profile,want", [
    ({"technique": "cauchy_good", "k": "4", "m": "2"}, (4, 2, 8, 2048)),
    ({"technique": "liberation", "k": "5"}, (5, 2, 7, 8)),
    ({"technique": "liber8tion", "k": "6", "m": "4", "w": "16"},
     (6, 2, 8, 8)),
    ({"technique": "blaum_roth", "k": "4", "w": "4", "packetsize": "8"},
     (4, 2, 4, 8))])
def test_bitmatrix_profiles_parse_like_reference(profile, want):
    ours, ref = _pair("jerasure", profile)
    got = (ours.k, ours.m, ours.w, ours.packetsize)
    assert got == want == (ref.k, ref.m, ref.w, ref.packetsize)
    assert ours.get_alignment() == ref.get_alignment()
    for width in (1, 4096, 123_457):
        assert ours.get_chunk_size(width) == ref.get_chunk_size(width)


@pytest.mark.parametrize("profile", [
    {"technique": "liberation", "k": "7", "w": "6"},
    {"technique": "liberation", "k": "8", "w": "7"},
    {"technique": "blaum_roth", "k": "4", "w": "7"},
    {"technique": "liber8tion", "k": "9"}])
def test_bitmatrix_profiles_refused_like_reference(profile):
    with pytest.raises(ValueError):
        RefRegistry.instance().factory("jerasure", dict(profile))
    with pytest.raises(ValueError):
        ErasureCodePluginRegistry.instance().factory(
            "jerasure", dict(profile), device="cpu")


def test_packed_entries_match_reference():
    ours, ref = _pair(*PROFILES[0])
    data = _data(5, 8, c=8192)
    parity = ref.encode_chunks_batch(data)
    ref_words = np.asarray(ref.encode_chunks_packed_jax(
        jnp.asarray(ref_pack_chunks(data))))
    got = ours.encode_chunks_packed_torch(pack_chunks(torch.from_numpy(data)))
    assert got.dtype == torch.uint32
    assert np.array_equal(got.numpy(), ref_words)
    assert np.array_equal(unpack_chunks(got).numpy(), parity)
    full = np.concatenate([data, parity], axis=1)
    avail, erased = (0, 2, 3, 4, 6, 7, 8, 10), (1, 5, 9)
    words = pack_chunks(torch.from_numpy(full[:, list(avail)]))
    dec = ours.decode_chunks_packed_torch(words, avail, erased)
    assert np.array_equal(unpack_chunks(dec).numpy(),
                          full[:, list(erased)])


@pytest.mark.parametrize("plugin", ["jerasure", "isa"])
def test_dict_api_round_trips(plugin):
    ours, ref = _pair(plugin, {"technique": "reed_sol_van", "k": "4",
                               "m": "2"})
    payload = bytes(np.random.default_rng(9).integers(
        0, 256, 10_000, dtype=np.uint8))
    enc = ours.encode(set(range(6)), payload)
    assert enc == ref.encode(set(range(6)), payload)
    avail = {0, 2, 4, 5}
    need = ours.minimum_to_decode({0, 1, 2, 3}, avail)
    assert need == ref.minimum_to_decode({0, 1, 2, 3}, avail)
    chunks = {i: enc[i] for i in need}
    dec = ours.decode({0, 1, 2, 3}, chunks, len(enc[0]))
    assert b"".join(dec[i] for i in range(4))[:len(payload)] == payload
    assert ours.decode_concat({i: enc[i] for i in (1, 2, 3, 5)})[
        :len(payload)] == payload


def test_load_reference_matrix_installs_reference_state():
    ours, ref = _pair(*PROFILES[0])
    assert np.array_equal(ours.build_matrix(), ref.matrix)
    load_reference_matrix(ours, ref.matrix)
    assert np.array_equal(ours.matrix, ref.matrix)
    avail, erased = (0, 1, 2, 4, 5, 7, 9, 10), (3, 6, 8)
    dm = regionops.matrix_decode_matrix(ref.matrix, 8, list(avail),
                                        list(erased))
    ref_dm = ref._decode_matrix(avail, erased)[0]
    assert np.array_equal(dm, ref_dm)
    load_reference_matrix(ours, ref_dm, pattern=(avail, erased))
    assert np.array_equal(ours._decode_matrix(avail, erased)[0], ref_dm)
    data = _data(11, 8)
    full = np.concatenate([data, ref.encode_chunks_batch(data)], axis=1)
    got = ours.decode_chunks_batch(full[:, list(avail)], avail, erased)
    assert np.array_equal(got, full[:, list(erased)])
    with pytest.raises(ValueError):
        load_reference_matrix(ours, ref.matrix[:2])
    with pytest.raises(ValueError):
        load_reference_matrix(ours, np.full((3, 8), 256))


def test_example_plugin_and_registry_errors():
    reg = ErasureCodePluginRegistry.instance()
    ex = reg.factory("example", {}, device="cpu")
    payload = b"hello, erasure world!"
    enc = ex.encode({0, 1, 2}, payload)
    dec = ex.decode({0, 1}, {1: enc[1], 2: enc[2]}, len(enc[0]))
    assert (dec[0] + dec[1])[:len(payload)] == payload
    with pytest.raises(IOError):
        reg.factory("no_such_plugin", {}, device="cpu")
    # clay, the last plugin of the reference to be ported, constructs
    clay = reg.factory("clay", {"k": "4", "m": "2", "d": "5"}, device="cpu")
    assert (clay.k, clay.m, clay.d, clay.get_sub_chunk_count()) == \
        (4, 2, 5, 8)
    assert reg.factory("jerasure", {"technique": "cauchy_good"},
                       device="cpu").technique == "cauchy_good"
    with pytest.raises(ValueError):
        reg.factory("jerasure", {"technique": "bogus"}, device="cpu")
    with pytest.raises(ValueError):
        reg.factory("jerasure", {"k": "1"}, device="cpu")


def test_device_defaults_to_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = ErasureCodePluginRegistry.instance()
    with pytest.raises(NoDeviceError):
        reg.factory("jerasure", {"k": "4", "m": "2"})
    with pytest.raises(NoDeviceError):
        reg.factory("isa", {"k": "4", "m": "2"}, device="cuda")
    ours = reg.factory("jerasure", {"k": "4", "m": "2"}, device="cpu")
    assert ours.device == CPU


def test_tensor_on_wrong_device_is_refused():
    ours, _ = _pair(*PROFILES[1])
    ours.device = torch.device("cuda")      # as if built on the card
    with pytest.raises(ValueError):
        ours.encode_chunks_torch(torch.zeros(1, 4, 64, dtype=torch.uint8))


def test_forced_numpy_tier_runs_host_ground_truth():
    ours, ref = _pair(*PROFILES[0])
    data = _data(3, 8)
    perf = global_perf()
    prev = fallback.set_global_policy(fallback.FallbackPolicy("numpy"))
    try:
        h0 = perf.get("ec_host_calls")
        assert np.array_equal(ours.encode_chunks_batch(data),
                              ref.encode_chunks_batch(data))
        assert perf.get("ec_host_calls") == h0 + 1
        got = ours.encode_chunks_torch(torch.from_numpy(data))
        assert np.array_equal(got.numpy(), ref.encode_chunks_batch(data))
    finally:
        fallback.set_global_policy(prev)


# -- the committed non-regression corpus ---------------------------------------

CORPUS = Path(__file__).resolve().parent / "corpus"
PORTED_TECHNIQUES = {"jerasure": {"reed_sol_van", "reed_sol_r6_op",
                                  "cauchy_orig", "cauchy_good",
                                  "liberation", "blaum_roth", "liber8tion"},
                     "isa": {"reed_sol_van", "cauchy"}, "example": None,
                     "shec": None, "lrc": None, "clay": None}


def _ported_corpus_dirs():
    out = []
    for d in sorted(CORPUS.iterdir()):
        man = d / "manifest.json"
        if not man.is_file():
            continue
        meta = json.loads(man.read_text())
        plugin = meta["plugin"]
        if plugin not in PORTED_TECHNIQUES:
            continue
        techs = PORTED_TECHNIQUES[plugin]
        if techs is None or meta["profile"].get(
                "technique", "reed_sol_van") in techs:
            out.append(d.name)
    return out


@pytest.mark.parametrize("name", _ported_corpus_dirs())
@pytest.mark.parametrize("min_bytes", [0, 1 << 20],
                         ids=["torch-tier", "host-rule"])
def test_corpus_profile_reencodes_and_decodes(name, min_bytes):
    """Every matrix and bitmatrix profile the committed corpus pins
    re-encodes to the stored bytes through the port, and its stored
    chunks decode under every single and double erasure."""
    d = CORPUS / name
    meta = json.loads((d / "manifest.json").read_text())
    ec = ErasureCodePluginRegistry.instance().factory(
        meta["plugin"], dict(meta["profile"]), device="cpu")
    ec.min_xla_bytes = min_bytes
    payload = (d / "content").read_bytes()
    n = ec.get_chunk_count()
    stored = {i: (d / str(i)).read_bytes() for i in range(n)}
    assert ec.encode(set(range(n)), payload) == stored
    patterns = [(i,) for i in range(n)]
    if ec.get_coding_chunk_count() >= 2:
        patterns += list(itertools.combinations(range(n), 2))
    for erased in patterns:
        avail = {i: stored[i] for i in range(n) if i not in erased}
        need = ec.minimum_to_decode(set(erased), set(avail))
        dec = ec.decode(set(erased), {i: avail[i] for i in need},
                        len(stored[0]))
        assert all(dec[c] == stored[c] for c in erased), erased


def test_registry_version_gate(monkeypatch):
    """A plugin module whose __erasure_code_version__ differs from this
    build's is refused at load time, as are modules missing the
    version or the init entry point."""
    import sys
    import types
    pkg = types.ModuleType("fake_ec_plugins")
    pkg.__path__ = []
    monkeypatch.setitem(sys.modules, "fake_ec_plugins", pkg)
    bad = types.ModuleType("fake_ec_plugins.stale")
    bad.__erasure_code_version__ = "ceph_tpu 0.1"
    bad.__erasure_code_init__ = lambda name, reg: None
    monkeypatch.setitem(sys.modules, "fake_ec_plugins.stale", bad)
    bare = types.ModuleType("fake_ec_plugins.bare")
    monkeypatch.setitem(sys.modules, "fake_ec_plugins.bare", bare)
    reg = ErasureCodePluginRegistry()
    with pytest.raises(IOError, match="plugin version"):
        reg.load("stale", directory="fake_ec_plugins")
    with pytest.raises(IOError, match="__erasure_code_version__"):
        reg.load("bare", directory="fake_ec_plugins")
    assert reg.get("stale") is None
