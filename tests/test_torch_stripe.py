"""The port's stripe layer (``ceph_tpu_torch.codes.stripe``, the ECUtil
analog) against the reference's ``ceph_tpu.codes.stripe``, byte for byte:
crc32c on seeded buffers, HashInfo, stripe_info_t's offsets, batched
whole-object encode/decode, reconstructing reads, RMW overwrites and the
recovery walkthrough.  The port's codes run on the CPU here
(``device="cpu"``)."""

import numpy as np
import pytest

import ceph_tpu.codes.stripe as ref
import ceph_tpu_torch.codes.stripe as port
from ceph_tpu.codes.registry import \
    ErasureCodePluginRegistry as RefRegistry
from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry


def make_ecs(plugin="jerasure", **profile):
    """(port code on the CPU, reference code) of one profile."""
    prof = {str(k): str(v) for k, v in profile.items()}
    return (ErasureCodePluginRegistry.instance().factory(
                plugin, dict(prof), device="cpu"),
            RefRegistry.instance().factory(plugin, dict(prof)))


RS42 = dict(k=4, m=2, technique="reed_sol_van")


# -- crc32c --------------------------------------------------------------

def test_crc32c_known_answer():
    # standard CRC-32C check value: seed -1, final inversion
    assert port.ceph_crc32c(0xFFFFFFFF, b"123456789") ^ 0xFFFFFFFF \
        == 0xE3069283


@pytest.mark.parametrize("size", [0, 1, 100, 8192, 12345, 4096 * 3 + 17,
                                  65536 + 5])
def test_crc32c_equals_the_reference(size):
    """Scalar and block-parallel sizes, seeded buffers and seeds."""
    rng = np.random.default_rng(size)
    data = rng.integers(0, 256, size=size, dtype=np.uint8)
    for seed in (0, 0xFFFFFFFF, 0x1234ABCD):
        got = port.ceph_crc32c(seed, data.tobytes())
        assert got == ref.ceph_crc32c(seed, data.tobytes())
        assert got == port._crc_scalar(seed, data)


@pytest.mark.parametrize("rows,length", [(3, 100), (5, 8192), (4, 12345)])
def test_crc32c_batch_equals_the_reference(rows, length):
    rng = np.random.default_rng(rows * length)
    bufs = rng.integers(0, 256, size=(rows, length), dtype=np.uint8)
    seeds = rng.integers(0, 1 << 32, size=rows, dtype=np.uint64)
    got = port.ceph_crc32c_batch(seeds, bufs)
    assert got.dtype == np.uint32
    assert np.array_equal(got, ref.ceph_crc32c_batch(seeds, bufs))
    assert [int(c) for c in got] == [
        port.ceph_crc32c(int(s), b.tobytes()) for s, b in zip(seeds, bufs)]
    with pytest.raises(ValueError):
        port.ceph_crc32c_batch(seeds[:1], bufs)


def test_crc32c_incremental_matches_whole():
    data = bytes(range(256)) * 3
    whole = port.ceph_crc32c(0xFFFFFFFF, data)
    inc = 0xFFFFFFFF
    for i in range(0, len(data), 100):
        inc = port.ceph_crc32c(inc, data[i:i + 100])
    assert inc == whole == ref.ceph_crc32c(0xFFFFFFFF, data)


def test_hash_info_append_tracks_shards():
    shards = [{0: b"aaaa", 1: b"bbbb", 2: b"cccc"},
              {0: b"dddd", 1: b"eeee", 2: b"ffff"}]
    hashes = []
    for mod in (port, ref):
        h = mod.HashInfo(3)
        h.append(0, shards[0])
        h.append(4, shards[1])
        assert h.total_chunk_size == 8
        hashes.append(h.cumulative_shard_hashes)
        with pytest.raises(ValueError):
            h.append(4, {0: b"x" * 4})          # wrong offset
        with pytest.raises(ValueError):
            h.append(8, {0: b"x", 1: b"xy"})    # uneven
    assert hashes[0] == hashes[1]
    assert hashes[0][0] == port.ceph_crc32c(
        port.ceph_crc32c(0xFFFFFFFF, b"aaaa"), b"dddd")


# -- stripe_info_t math --------------------------------------------------

def test_stripe_info_offset_math():
    a, b = port.StripeInfo(4, 4096), ref.StripeInfo(4, 4096)
    assert a.chunk_size == b.chunk_size == 1024
    for off in (0, 1, 4095, 4096, 8192, 10000, 123457):
        for name in ("logical_to_prev_chunk_offset",
                     "logical_to_next_chunk_offset",
                     "logical_to_prev_stripe_offset",
                     "logical_to_next_stripe_offset"):
            assert getattr(a, name)(off) == getattr(b, name)(off)
        for length in (0, 1, 3000, 4096):
            assert a.offset_len_to_stripe_bounds(off, length) == \
                b.offset_len_to_stripe_bounds(off, length)
    assert a.aligned_logical_offset_to_chunk_offset(8192) == 2048
    assert a.aligned_chunk_offset_to_logical_offset(2048) == 8192
    assert a.aligned_offset_len_to_chunk(8192, 4096) == \
        b.aligned_offset_len_to_chunk(8192, 4096)
    assert a.offset_len_to_stripe_bounds(10000, 3000) == (8192, 8192)
    with pytest.raises(ValueError):
        port.StripeInfo(3, 4096)                 # width not divisible


# -- batched ECUtil::encode / decode -------------------------------------

@pytest.mark.parametrize("plugin,profile", [
    ("jerasure", RS42),
    ("isa", dict(k=4, m=2, technique="cauchy")),
    ("shec", dict(k=4, m=3, c=2)),
    ("lrc", dict(k=4, m=2, l=3)),
])
def test_encode_decode_roundtrip_multi_stripe(plugin, profile):
    ec, rec = make_ecs(plugin, **profile)
    k = ec.get_data_chunk_count()
    n = ec.get_chunk_count()
    width = k * ec.get_chunk_size(k * 1024)
    sinfo = port.StripeInfo(k, width)
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, size=width * 5, dtype=np.uint8).tobytes()
    shards = port.encode(sinfo, ec, data)
    assert shards == ref.encode(ref.StripeInfo(k, width), rec, data)
    assert set(shards) == set(range(n))
    # lose two shards, decode them back
    lost = sorted(shards)[1], sorted(shards)[-1]
    survivors = {s: b for s, b in shards.items() if s not in lost}
    out = port.decode(sinfo, ec, survivors, set(lost))
    assert all(out[s] == shards[s] for s in lost)
    assert out == ref.decode(ref.StripeInfo(k, width), rec, survivors,
                             set(lost))


def test_encode_rejects_unaligned_and_mismatched():
    ec, _ = make_ecs("jerasure", **RS42)
    width = 4 * ec.get_chunk_size(4 * 1024)
    sinfo = port.StripeInfo(4, width)
    with pytest.raises(ValueError):
        port.encode(sinfo, ec, b"x" * (width + 1))
    with pytest.raises(ValueError):
        port.encode(port.StripeInfo(2, 2 * sinfo.chunk_size), ec, b"")


def test_encode_want_filters_shards():
    ec, rec = make_ecs("jerasure", **RS42)
    width = 4 * ec.get_chunk_size(4 * 1024)
    data = bytes(range(256)) * (width // 256)
    shards = port.encode(port.StripeInfo(4, width), ec, data, want={4, 5})
    assert set(shards) == {4, 5}
    assert shards == ref.encode(ref.StripeInfo(4, width), rec, data,
                                want={4, 5})


@pytest.mark.parametrize("off,length", [
    (0, 100), (5000, 3000), (4096 * 4, 4096 * 4),
    (4096 * 4 * 5 - 7, 7), (0, 0),
])
def test_reconstructing_read(off, length):
    """ECBackend::objects_read_async math: logical range reads from
    surviving shards, with and without erased data shards, equal to the
    object and to the reference's read."""
    ec, rec = make_ecs("jerasure", **RS42)
    width = 4 * ec.get_chunk_size(4 * 4096)
    sinfo, rinfo = port.StripeInfo(4, width), ref.StripeInfo(4, width)
    rng = np.random.default_rng(13)
    obj = rng.integers(0, 256, size=width * 5, dtype=np.uint8).tobytes()
    shards = port.encode(sinfo, ec, obj)
    for lost in ((), (0, 2), (5,)):
        survivors = {s: b for s, b in shards.items() if s not in lost}
        got = port.read(sinfo, ec, survivors, off, length)
        assert got == obj[off:off + length]
        assert got == ref.read(rinfo, rec, survivors, off, length)


def test_read_bounds_check():
    ec, _ = make_ecs("jerasure", **RS42)
    width = 4 * ec.get_chunk_size(4 * 4096)
    sinfo = port.StripeInfo(4, width)
    shards = port.encode(sinfo, ec, bytes(width))
    with pytest.raises(ValueError):
        port.read(sinfo, ec, shards, width - 2, 4)
    with pytest.raises(ValueError):
        port.read(sinfo, ec, shards, -4096, 100)   # negative offset
    with pytest.raises(ValueError):
        port.overwrite(sinfo, ec, shards, -4096, b"x" * 100)


@pytest.mark.parametrize("off,length", [
    (0, 100),            # head, sub-stripe
    (5000, 3000),        # unaligned middle span
    (4096 * 4, 4096 * 4),  # exactly one stripe
    (4096 * 4 * 5 - 7, 7),  # tail
])
def test_overwrite_rmw_matches_full_reencode(off, length):
    """ECBackend RMW path: splice-overwrite == encode of the mutated
    object, byte for byte, equal to the reference's overwrite, and
    untouched shard extents are unchanged."""
    ec, rec = make_ecs("jerasure", **RS42)
    width = 4 * ec.get_chunk_size(4 * 4096)
    sinfo = port.StripeInfo(4, width)
    rng = np.random.default_rng(3)
    obj = bytearray(rng.integers(0, 256, size=width * 5,
                                 dtype=np.uint8).tobytes())
    shards = port.encode(sinfo, ec, bytes(obj))
    patch = rng.integers(0, 256, size=length, dtype=np.uint8).tobytes()

    new_shards = port.overwrite(sinfo, ec, shards, off, patch)
    assert new_shards == ref.overwrite(ref.StripeInfo(4, width), rec,
                                       shards, off, patch)
    obj[off:off + length] = patch
    assert new_shards == port.encode(sinfo, ec, bytes(obj))
    start, span = sinfo.offset_len_to_stripe_bounds(off, length)
    c0 = sinfo.logical_to_prev_chunk_offset(start)
    c1 = c0 + (span // sinfo.stripe_width) * sinfo.chunk_size
    for s in range(6):
        assert new_shards[s][:c0] == shards[s][:c0]
        assert new_shards[s][c1:] == shards[s][c1:]


def test_overwrite_rejects_past_end():
    ec, _ = make_ecs("jerasure", **RS42)
    width = 4 * ec.get_chunk_size(4 * 4096)
    sinfo = port.StripeInfo(4, width)
    shards = port.encode(sinfo, ec, bytes(width))
    with pytest.raises(ValueError):
        port.overwrite(sinfo, ec, shards, width - 3, b"xxxx")


def test_recovery_op_walkthrough():
    """ECBackend::continue_recovery_op math: a shard dies; the primary
    reads minimum_to_decode from survivors, reconstructs the lost shard,
    and the recovered bytes hash-verify against the HashInfo recorded at
    write time — the same bytes and hashes as the reference's."""
    ec, rec = make_ecs("jerasure", **RS42)
    width = 4 * ec.get_chunk_size(4 * 1024)
    sinfo = port.StripeInfo(4, width)
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, size=width * 8, dtype=np.uint8).tobytes()

    shards = port.encode(sinfo, ec, data)
    hinfo = port.HashInfo(6)
    hinfo.append(0, shards)
    rhinfo = ref.HashInfo(6)
    rhinfo.append(0, ref.encode(ref.StripeInfo(4, width), rec, data))
    assert hinfo.cumulative_shard_hashes == rhinfo.cumulative_shard_hashes

    lost = 2
    available = {s for s in range(6) if s != lost}
    plan = ec.minimum_to_decode({lost}, available)
    assert plan == rec.minimum_to_decode({lost}, available)
    assert set(plan) <= available and len(plan) == 4
    reads = {s: shards[s] for s in plan}
    recovered = port.decode(sinfo, ec, reads, {lost})[lost]
    assert recovered == shards[lost]
    assert port.ceph_crc32c(0xFFFFFFFF, recovered) == \
        hinfo.get_chunk_hash(lost)


def test_chunk_mapping_equals_the_reference():
    for plugin, profile in (("jerasure", RS42), ("lrc", dict(k=4, m=2, l=3)),
                            ("lrc", {"mapping": "__DD__DD", "layers":
                                     '[["_cDD_cDD",""],["cDDD____",""],'
                                     '["____cDDD",""]]'})):
        ec, rec = make_ecs(plugin, **profile)
        assert port._chunk_mapping(ec) == ref._chunk_mapping(rec)
