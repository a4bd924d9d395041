"""Port parity, the composite codecs: shec (minimum-read plans,
``codes/linear.py``) and lrc (layers, kml, probed composites) through the
registry, against ceph_tpu's plugins on the same seeded inputs: encode,
``minimum_to_decode``, every 1- and 2-erasure decode (and 3 for shec
m=3) through ``decode_chunks_batch``, ``decode_chunks_torch`` and
``decode_chunks_packed_torch``, the dict API, the profile errors, and
which patterns the engine table sends to the XOR-schedule kernel.  Exact
byte equality (GF(2^8) math is integer); chunks are 1 KiB so the CPU run
stays short."""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.codes.registry import ErasureCodePluginRegistry as RefRegistry
from ceph_tpu.ops.pallas_gf import select_matrix_engine as ref_select
from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.codes.techniques import load_reference_matrix
from ceph_tpu_torch.ops.gf_kernels import (pack_chunks, select_matrix_engine,
                                           unpack_chunks)

LRC_LAYERS = '[["_cDD_cDD",""],["cDDD____",""],["____cDDD",""]]'
PROFILES = [
    ("shec", {"k": "4", "m": "3", "c": "2"}),
    ("shec", {"k": "6", "m": "3", "c": "2"}),
    ("shec", {"k": "8", "m": "4", "c": "3"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("lrc", {"mapping": "__DD__DD", "layers": LRC_LAYERS}),
    ("lrc", {"k": "8", "m": "4", "l": "3"}),
]
IDS = ["shec-k4-m3-c2", "shec-k6-m3-c2", "shec-k8-m4-c3", "lrc-k4-m2-l3",
       "lrc-layers", "lrc-k8-m4-l3"]


def _pair(plugin, profile):
    ours = ErasureCodePluginRegistry.instance().factory(
        plugin, dict(profile), device="cpu")
    ref = RefRegistry.instance().factory(plugin, dict(profile))
    return ours, ref


def _stripes(ref, seed, c=1024, batch=2):
    """(data, full): seeded data chunks and the reference's whole stripe,
    chunk i at position i."""
    k, n = ref.get_data_chunk_count(), ref.get_chunk_count()
    data = np.random.default_rng(seed).integers(0, 256, (batch, k, c),
                                                dtype=np.uint8)
    parity = ref.encode_chunks_batch(data)
    dpos = list(getattr(ref, "data_positions", range(k)))
    ppos = [p for p in range(n) if p not in dpos]
    full = np.zeros((batch, n, c), dtype=np.uint8)
    full[:, dpos] = data
    full[:, ppos] = parity
    return data, full


def _patterns(ec):
    n, m = ec.get_chunk_count(), ec.get_coding_chunk_count()
    most = 3 if (getattr(ec, "c", 0) and m == 3) else 2
    for e in range(1, most + 1):
        yield from itertools.combinations(range(n), e)


@pytest.mark.parametrize("plugin,profile", PROFILES, ids=IDS)
def test_encode_matches_reference(plugin, profile):
    ours, ref = _pair(plugin, profile)
    if plugin == "shec":
        assert np.array_equal(ours.matrix, ref.matrix)
        ours.min_xla_bytes = 0           # the torch tier, not the host rule
    else:
        assert ours.mapping == ref.mapping and [
            L.mapping for L in ours.layers] == [L.mapping for L in ref.layers]
        assert np.array_equal(ours._probe_encode_matrix()[0],
                              ref._probe_encode_matrix()[0])
    data, full = _stripes(ref, 1)
    want = ref.encode_chunks_batch(data)
    assert np.array_equal(ours.encode_chunks_batch(data), want)
    got = ours.encode_chunks_torch(torch.from_numpy(data))
    assert got.device.type == "cpu" and np.array_equal(got.numpy(), want)
    got = ours.encode_chunks_packed_torch(pack_chunks(torch.from_numpy(data)))
    assert got.dtype == torch.uint32
    assert np.array_equal(unpack_chunks(got).numpy(), want)


@pytest.mark.parametrize("plugin,profile", PROFILES, ids=IDS)
def test_minimum_to_decode_matches_reference(plugin, profile):
    """Equal read sets for every erasure pattern, wanting the erased
    chunks or every data chunk; IOError exactly where the reference
    raises it."""
    ours, ref = _pair(plugin, profile)
    n, k = ref.get_chunk_count(), ref.get_data_chunk_count()
    data_pos = set(getattr(ref, "data_positions", range(k)))
    for erased in _patterns(ref):
        avail = set(range(n)) - set(erased)
        for want in (set(erased), data_pos):
            try:
                theirs = ref.minimum_to_decode(want, avail)
            except IOError:
                with pytest.raises(IOError):
                    ours.minimum_to_decode(want, avail)
                continue
            assert ours.minimum_to_decode(want, avail) == theirs, erased


@pytest.mark.parametrize("plugin,profile", PROFILES, ids=IDS)
def test_every_pattern_decodes_like_reference(plugin, profile):
    """decode_chunks_batch (host rule and torch tier), decode_chunks_torch
    and decode_chunks_packed_torch equal the reference's
    decode_chunks_batch for every pattern it decodes, and raise where it
    raises."""
    ours, ref = _pair(plugin, profile)
    n = ref.get_chunk_count()
    _, full = _stripes(ref, 2)
    tfull = torch.from_numpy(full)
    done = refused = 0
    for erased in _patterns(ref):
        avail = tuple(i for i in range(n) if i not in erased)
        chunks = np.ascontiguousarray(full[:, list(avail)])
        try:
            want = ref.decode_chunks_batch(chunks, avail, erased)
        except IOError:
            with pytest.raises(IOError):
                ours.decode_chunks_batch(chunks, avail, erased)
            refused += 1
            continue
        assert np.array_equal(want, full[:, list(erased)])
        assert np.array_equal(ours.decode_chunks_batch(chunks, avail,
                                                       erased), want)
        if plugin == "shec":
            ours.min_xla_bytes = 0
            assert np.array_equal(ours.decode_chunks_batch(chunks, avail,
                                                           erased), want)
            ours.min_xla_bytes = 1 << 20
        surv = tfull[:, list(avail)]
        got = ours.decode_chunks_torch(surv, avail, erased)
        assert np.array_equal(got.numpy(), want), erased
        got = ours.decode_chunks_packed_torch(pack_chunks(surv), avail,
                                              erased)
        assert np.array_equal(unpack_chunks(got).numpy(), want), erased
        done += 1
    assert done > 0
    if plugin == "lrc":
        assert refused == 0


@pytest.mark.parametrize("profile", [
    {"k": "4", "m": "2", "l": "3"},
    {"mapping": "__DD__DD", "layers": LRC_LAYERS}], ids=["k4m2l3", "layers"])
def test_lrc_probe_decode_matrix_matches_reference(profile):
    """lrc's ``_probe_decode_matrix`` exists and equals the reference's
    for the two lrc corpus profiles, every 1- and 2-erasure pattern it
    can decode (the encode probe beside it)."""
    ours, ref = _pair("lrc", profile)
    assert np.array_equal(ours._probe_encode_matrix()[0],
                          ref._probe_encode_matrix()[0])
    n = ref.get_chunk_count()
    decoded = 0
    for erased in _patterns(ref):
        avail = tuple(i for i in range(n) if i not in erased)
        try:
            want = ref._probe_decode_matrix(avail, erased)
        except IOError:
            with pytest.raises(IOError):
                ours._probe_decode_matrix(avail, erased)
            continue
        assert np.array_equal(ours._probe_decode_matrix(avail, erased),
                              want), erased
        decoded += 1
    assert decoded > n


@pytest.mark.parametrize("plugin,profile", PROFILES, ids=IDS)
def test_dict_api_round_trips(plugin, profile):
    ours, ref = _pair(plugin, profile)
    n, k = ref.get_chunk_count(), ref.get_data_chunk_count()
    payload = bytes(np.random.default_rng(12).integers(0, 256, 10_001,
                                                       dtype=np.uint8))
    enc = ours.encode(set(range(n)), payload)
    assert enc == ref.encode(set(range(n)), payload)
    assert ours.get_chunk_size(len(payload)) == ref.get_chunk_size(
        len(payload))
    assert ours.get_chunk_mapping() == ref.get_chunk_mapping()
    data_pos = list(getattr(ref, "data_positions", range(k)))
    for lost in ((data_pos[0],), (data_pos[0], n - 1)):
        avail = set(range(n)) - set(lost)
        need = ours.minimum_to_decode(set(lost), avail)
        assert need == ref.minimum_to_decode(set(lost), avail)
        dec = ours.decode(set(lost), {i: enc[i] for i in need},
                          len(enc[0]))
        assert all(dec[c] == enc[c] for c in lost)
        assert dec == ref.decode(set(lost), {i: enc[i] for i in need},
                                 len(enc[0]))
    rest = {i: enc[i] for i in range(n) if i != data_pos[0]}
    assert ours.decode_concat(rest)[:len(payload)] == payload


@pytest.mark.parametrize("plugin,profile", [
    ("lrc", {"k": "4", "m": "2"}),                              # no l
    ("lrc", {"k": "4", "m": "2", "l": "4"}),                    # K_M_MODULO
    ("lrc", {"k": "5", "m": "3", "l": "4"}),                    # m % groups
    ("lrc", {"k": "4", "m": "2", "l": "3", "mapping": "__DD__DD"}),
    ("lrc", {"mapping": "__DD__DD"}),                           # no layers
    ("lrc", {"mapping": "__DD__DD", "layers": "[not json"}),
    ("lrc", {"mapping": "__DD__DD", "layers": "[]"}),
    ("lrc", {"mapping": "__DD__DD", "layers": '[[1, ""]]'}),
    ("lrc", {"mapping": "__DD__DD", "layers": '[["_cDD_cDD", 3]]'}),
    ("lrc", {"mapping": "__DX__DD", "layers": LRC_LAYERS}),
    ("lrc", {"mapping": "__DD__DD", "layers": '[["_cDD_cD",""]]'}),
    ("lrc", {"mapping": "__DD__DD", "layers": '[["_cDD_cDX",""]]'}),
    ("lrc", {"mapping": "__DD__DD", "layers": '[["_DDD_DDD",""]]'}),
    ("lrc", {"mapping": "__DD__DD", "layers": '[["_cDD____",""]]'}),
    ("lrc", {"mapping": "__DD__DD", "layers": '[["_cDc_cDD",""]]'}),
    ("lrc", {"mapping": "__DD__DD",
             "layers": '[["_cDD_cDD","w=16"]]'}),
    ("lrc", {"mapping": "__DD__DD",
             "layers": '[["_cDD_cDD","bogus"]]'}),
    ("lrc", {"k": "4", "m": "2", "l": "3", "crush-steps": "[[1, 2]]"}),
    ("lrc", {"k": "4", "m": "2", "l": "3",
             "crush-steps": '[["take", "host", 0]]'}),
    ("shec", {"k": "4", "m": "3", "c": "4"}),
    ("shec", {"k": "4", "m": "3", "c": "0"}),
    ("shec", {"k": "3", "m": "4", "c": "2"}),
    ("shec", {"k": "4", "m": "3", "c": "2", "w": "7"}),
    ("shec", {"k": "1", "m": "1", "c": "1"}),
    ("shec", {"k": "4", "m": "3", "c": "2", "technique": "bogus"}),
    ("shec", {"k": "x"}),
])
def test_profile_errors_match_reference(plugin, profile):
    """The reference's parse errors (ERROR_LRC_* for lrc), with the same
    messages."""
    with pytest.raises(ValueError) as theirs:
        RefRegistry.instance().factory(plugin, dict(profile))
    with pytest.raises(ValueError) as mine:
        ErasureCodePluginRegistry.instance().factory(plugin, dict(profile),
                                                     device="cpu")
    assert str(mine.value) == str(theirs.value)


def test_lrc_profile_parse_matches_reference():
    ours, ref = _pair("lrc", {"k": "4", "m": "2", "l": "3",
                              "crush-locality": "rack",
                              "crush-failure-domain": "host"})
    assert (ours.k, ours.m, ours.mapping) == (ref.k, ref.m, ref.mapping) == (
        4, 4, "__DD__DD")
    assert ours.rule_steps == ref.rule_steps == [("choose", "rack", 2),
                                                 ("chooseleaf", "host", 4)]
    assert ours.data_positions == ref.data_positions == [2, 3, 6, 7]
    # each layer's inner code is made on the lrc code's device
    assert all(L.code.device == ours.device for L in ours.layers)
    for width in (1, 4096, 123_457):
        assert ours.get_chunk_size(width) == ref.get_chunk_size(width)


def test_shec_profile_parse_matches_reference():
    ours, ref = _pair("shec", {})
    assert (ours.k, ours.m, ours.c, ours.w, ours.technique) == (
        ref.k, ref.m, ref.c, ref.w, ref.technique) == (4, 3, 2, 8,
                                                       "multiple")
    assert ours.get_alignment() == ref.get_alignment()
    for width in (1, 4096, 123_457):
        assert ours.get_chunk_size(width) == ref.get_chunk_size(width)


def test_load_reference_matrix_installs_shec_state():
    """The reference shec's coding matrix, installed into a port shec
    code, decodes like the reference (the plan caches start over)."""
    ours, ref = _pair("shec", {"k": "6", "m": "3", "c": "2"})
    _, full = _stripes(ref, 4)
    avail, erased = (0, 2, 3, 4, 6, 7, 8), (1, 5)
    chunks = np.ascontiguousarray(full[:, list(avail)])
    ours.decode_chunks_batch(chunks, avail, erased)
    assert ours.tcache._plans and ours._decode_cache
    load_reference_matrix(ours, ref.matrix)
    assert np.array_equal(ours.matrix, ref.matrix)
    assert not ours.tcache._plans and not ours._decode_cache
    assert ours._windows == ref._windows
    for e in ((1,), (1, 5), (0, 4, 8)):
        av = tuple(i for i in range(9) if i not in e)
        ch = np.ascontiguousarray(full[:, list(av)])
        assert np.array_equal(ours.decode_chunks_batch(ch, av, e),
                              ref.decode_chunks_batch(ch, av, e))
    with pytest.raises(ValueError):
        load_reference_matrix(ours, ref.matrix[:2])


@pytest.mark.parametrize("plugin,profile,want", [
    ("lrc", {"k": "4", "m": "2", "l": "3"}, (29, 36)),
    ("lrc", {"k": "8", "m": "4", "l": "3"}, (121, 136)),
    ("shec", {"k": "4", "m": "3", "c": "2"}, (4, 28)),
    ("shec", {"k": "8", "m": "4", "c": "3"}, (0, 78)),
])
def test_composite_routing_matches_reference(plugin, profile, want):
    """Of every 1- and 2-erasure decode, the port's table sends to the
    XOR-schedule kernel exactly the composites the reference sends to
    "xor" (lrc's local repairs, shec's single-erasure rows of 1s); the
    encode composite takes the dense kernel in both."""
    ours, ref = _pair(plugin, profile)
    n = ref.get_chunk_count()
    scheduled = total = 0
    for e in range(1, 3):
        for erased in itertools.combinations(range(n), e):
            avail = tuple(i for i in range(n) if i not in erased)
            if plugin == "lrc":
                ms = ours._decode_composite(avail, erased)[1]
                assert ms == ref._decode_composite(avail, erased)[1]
            else:
                try:
                    plan = ours._plan(avail, erased)
                except IOError:
                    continue
                ms = ours._plan_static(plan)[1]
            shape = (64, len(ms[0]), 4096)
            theirs = ref_select(shape, ms, 8, engine="pallas", mesh=0)
            mine = select_matrix_engine(8, torch.device("cuda"),
                                        shape=shape, matrix_t=ms)
            assert mine == {"xor": "xor", "pallas": "cuda"}[theirs]
            scheduled += mine == "xor"
            total += 1
    assert (scheduled, total) == want
    enc = (ours._encode_static() if plugin == "lrc"
           else ours._matrix_static)
    assert select_matrix_engine(8, torch.device("cuda"),
                                shape=(64, len(enc[0]), 4096),
                                matrix_t=enc) == "cuda"


def test_shec_decode_reads_only_the_plan():
    """A single data erasure of shec k=4 m=3 c=2 reads 3 chunks, and its
    plan matrix is a row of 1s that the XOR schedule runs."""
    ours, _ = _pair("shec", {"k": "4", "m": "3", "c": "2"})
    avail = (1, 2, 3, 4, 5, 6)
    need = ours.minimum_to_decode({0}, set(avail))
    assert len(need) == 3
    plan = ours._plan(avail, (0,))
    assert ours._plan_static(plan)[1] == ((1, 1, 1),)


def test_wrong_device_tensors_are_refused():
    for plugin, profile in (PROFILES[0], PROFILES[3]):
        ours, _ = _pair(plugin, profile)
        ours.device = torch.device("cuda")          # as if built on the card
        x = torch.zeros(1, ours.get_data_chunk_count(), 64, dtype=torch.uint8)
        with pytest.raises(ValueError):
            ours.encode_chunks_torch(x)
