"""The clay plugin of the port (``ceph_tpu_torch.codes.plugins.clay``),
the MXU row of its routing and the plain bit-plane product, held to
``ceph_tpu`` on the CPU.

Clay k=4 m=2 d=5 and k=8 m=4 d=11 (the reference's serving mix): the
profile geometry and its validation, the composite matrices, encode
through every host and torch surface, all 1- and 2-erasure decodes,
``minimum_to_decode`` with its sub-chunk runs, the single-chunk repair
from d helpers' partial reads, the isa scalar MDS; the plain bit-plane
product (``torch_ops.apply_matrix_mxu_torch``) against the reference's
``apply_matrix_mxu``; the engine table against the reference's
``select_matrix_engine(..., engine="pallas", mesh=0)`` for the encode
and all 78 decodes; the dense kernel's capacity rule on every matrix
routed to it; ``default_spec``.

Only the reference's host surfaces run here (its numpy tier, its
composites, its routing table): jitting the reference's SWAR apply on a
clay-sized matrix takes about a minute.  Comparisons are exact.
"""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.codes.registry import ErasureCodePluginRegistry as RefRegistry
from ceph_tpu.ops.pallas_gf import select_matrix_engine as ref_select
from ceph_tpu.ops.xla_ops import apply_matrix_mxu as ref_apply_mxu
from ceph_tpu.serve import run_serving_scenario as ref_run
from ceph_tpu.serve.loadgen import TrafficSpec as RefTrafficSpec
from ceph_tpu.serve.loadgen import default_spec as ref_default_spec
from ceph_tpu.serve.loadgen import \
    throughput_service_model as ref_service_model
from ceph_tpu.utils.retry import FakeClock as RefFakeClock

from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.gf.bitmatrix import matrix_to_bitmatrix
from ceph_tpu_torch.ops import gf_kernels, regionops
from ceph_tpu_torch.ops.gf_kernels import (
    BY_VALUE_MAX_COEF, matrix_kernel_fits, pack_chunks,
    select_matrix_engine, unpack_chunks)
from ceph_tpu_torch.ops.torch_ops import (apply_matrix_mxu_torch,
                                          matrix_to_static, mxu_bitmatrix)
from ceph_tpu_torch.serve import (CodecSpec, default_spec,
                                  run_serving_scenario,
                                  throughput_service_model, verify_results)
from ceph_tpu_torch.utils.retry import FakeClock

CPU = torch.device("cpu")
CUDA = torch.device("cuda")
K4 = {"k": "4", "m": "2", "d": "5"}
K8 = {"k": "8", "m": "4", "d": "11"}
PROFILES = [K4, K8]
IDS = ["k4m2d5", "k8m4d11"]
# the reference's row names in the port's words
REF_TO_PORT = {"mxu": "mxu", "pallas": "cuda", "xor": "xor"}


def _pair(profile):
    ours = ErasureCodePluginRegistry.instance().factory(
        "clay", dict(profile), device="cpu")
    ref = RefRegistry.instance().factory("clay", dict(profile))
    return ours, ref


def _patterns(n):
    return [e for t in (1, 2) for e in itertools.combinations(range(n), t)]


def _avail(n, erased):
    return tuple(i for i in range(n) if i not in erased)


def _stripes(ec, batch, sc, seed):
    """(batch, k, chunk) random data and its (batch, k+m, chunk) stripe,
    chunk = sub_chunk_no * sc; the parity from the reference's host
    path is the caller's to compare."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (batch, ec.k, ec.sub_chunk_no * sc),
                        dtype=np.uint8)


# -- profile --------------------------------------------------------------------

@pytest.mark.parametrize("profile", PROFILES + [
    {"k": "4", "m": "2"}, {"k": "6", "m": "3", "d": "6"},
    {"k": "4", "m": "3", "d": "5"}], ids=IDS + ["default-d", "d=k",
                                                 "nu=1"])
def test_geometry_matches_reference(profile):
    ours, ref = _pair(profile)
    for attr in ("k", "m", "d", "q", "t", "nu", "sub_chunk_no",
                 "n_nodes", "_scalar_align"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    assert np.array_equal(np.asarray(ours.mds_matrix),
                          np.asarray(ref.mds_matrix))
    assert np.array_equal(ours.pft, ref.pft)
    assert np.array_equal(ours.pft_inv, ref.pft_inv)
    for width in (1, 4096, 1 << 20, 3 * 1000 + 7):
        assert ours.get_chunk_size(width) == ref.get_chunk_size(width)


@pytest.mark.parametrize("profile", [
    {"k": "4", "m": "2", "d": "5", "scalar_mds": "shec"},
    {"k": "4", "m": "2", "d": "3"},
    {"k": "4", "m": "2", "d": "6"},
    {"k": "4", "m": "2", "scalar_mds": "bogus"},
    {"k": "4", "m": "2", "technique": "cauchy_good"},
    {"k": "4", "m": "2", "scalar_mds": "isa", "technique": "liberation"},
    {"k": "200", "m": "60", "d": "259"},
    {"k": "1", "m": "2"},
], ids=["shec", "d<k", "d>k+m-1", "unknown-mds", "bitmatrix-technique",
        "isa-technique", "k+m>254", "k=1"])
def test_profile_validation_matches_reference(profile):
    """Every rejected profile raises the reference's exception with the
    reference's message; scalar_mds=shec is refused loudly."""
    with pytest.raises(Exception) as ref_exc:
        RefRegistry.instance().factory("clay", dict(profile))
    with pytest.raises(type(ref_exc.value)) as ours_exc:
        ErasureCodePluginRegistry.instance().factory(
            "clay", dict(profile), device="cpu")
    assert str(ours_exc.value) == str(ref_exc.value)
    if profile.get("scalar_mds") == "shec":
        assert "not supported" in str(ours_exc.value)


@pytest.mark.parametrize("technique", ["reed_sol_van", "cauchy"])
def test_isa_scalar_mds_matches_reference(technique):
    profile = dict(K4, scalar_mds="isa", technique=technique)
    ours, ref = _pair(profile)
    assert np.array_equal(np.asarray(ours.mds_matrix),
                          np.asarray(ref.mds_matrix))
    assert ours._scalar_align == ref._scalar_align
    data = _stripes(ours, 2, 64, 5)
    want = ref.encode_chunks_batch(data)
    assert np.array_equal(ours.encode_chunks_batch(data), want)
    assert np.array_equal(
        ours.encode_chunks_torch(torch.from_numpy(data)).numpy(), want)
    full = np.concatenate([data, want], axis=1)
    for erased in ((0,), (1, 5)):
        avail = _avail(6, erased)
        got = ours.decode_chunks_batch(full[:, list(avail)], avail, erased)
        assert np.array_equal(got, full[:, list(erased)])


# -- encode ---------------------------------------------------------------------

@pytest.mark.parametrize("profile", PROFILES, ids=IDS)
def test_encode_matches_reference(profile):
    """encode_chunks_batch (host rule and torch tier), encode_chunks_torch,
    the packed entry and the dict API give the reference's bytes."""
    ours, ref = _pair(profile)
    data = _stripes(ours, 2, 512, 11)
    want = ref.encode_chunks_batch(data)
    assert np.array_equal(ours.encode_chunks_batch(data), want)
    ours.min_xla_bytes = 0                  # the torch tier
    assert np.array_equal(ours.encode_chunks_batch(data), want)
    x = torch.from_numpy(data)
    assert np.array_equal(ours.encode_chunks_torch(x).numpy(), want)
    packed = ours.encode_chunks_packed_torch(pack_chunks(x))
    assert np.array_equal(unpack_chunks(packed).numpy(), want)
    n = ours.k + ours.m
    chunk = data.shape[-1]
    payload = data[0].tobytes()
    enc = ours.encode(set(range(n)), payload)
    assert enc == ref.encode(set(range(n)), payload)
    assert [enc[ours.k + j] for j in range(ours.m)] == \
        [want[0, j].tobytes() for j in range(ours.m)]
    assert all(len(v) == chunk for v in enc.values())


@pytest.mark.parametrize("profile", PROFILES, ids=IDS)
def test_composites_match_reference(profile):
    """The probed encode composite and every 1- and 2-erasure decode
    composite equal the reference's, matrix and static tuple."""
    ours, ref = _pair(profile)
    m_o, s_o = ours._encode_composite()
    m_r, s_r = ref._encode_composite()
    assert np.array_equal(m_o, m_r) and s_o == s_r
    n = ours.k + ours.m
    for erased in _patterns(n):
        avail = _avail(n, erased)
        m_o, s_o = ours._decode_composite(avail, erased)
        m_r, s_r = ref._decode_composite(avail, erased)
        assert np.array_equal(m_o, m_r) and s_o == s_r, erased


# -- decode ---------------------------------------------------------------------

@pytest.mark.parametrize("profile", PROFILES, ids=IDS)
def test_every_decode_matches_reference(profile):
    """All 1- and 2-erasure patterns: decode_chunks_batch (host rule)
    gives the erased chunks of a stripe the reference encoded, as the
    reference's decode_chunks_batch does, and so does decode_chunks_torch
    (the torch tier) on every single erasure and every third double.
    The reference runs on every fifth pattern: at k=8 its host tier
    costs a tenth of a second a pattern, the torch tier three."""
    ours, ref = _pair(profile)
    data = _stripes(ours, 2, 64, 13)
    full = np.concatenate([data, ref.encode_chunks_batch(data)], axis=1)
    n = ours.k + ours.m
    for i, erased in enumerate(_patterns(n)):
        avail = _avail(n, erased)
        surv = np.ascontiguousarray(full[:, list(avail)])
        want = full[:, list(erased)]
        if i % 5 == 0:
            assert np.array_equal(
                ref.decode_chunks_batch(surv, avail, erased), want)
        assert np.array_equal(
            ours.decode_chunks_batch(surv, avail, erased), want), erased
        if len(erased) == 1 or i % 3 == 0:
            got = ours.decode_chunks_torch(torch.from_numpy(surv), avail,
                                           erased)
            assert np.array_equal(got.numpy(), want), erased


@pytest.mark.parametrize("profile", PROFILES, ids=IDS)
def test_packed_decode_matches_reference(profile):
    """The packed layout at a chunk of one 512-byte row per sub-chunk:
    every single erasure and a few doubles."""
    ours, ref = _pair(profile)
    data = _stripes(ours, 1, 512, 17)
    full = np.concatenate([data, ref.encode_chunks_batch(data)], axis=1)
    n = ours.k + ours.m
    for erased in [(e,) for e in range(n)] + [(0, 1), (1, n - 1),
                                              (n - 2, n - 1)]:
        avail = _avail(n, erased)
        surv = torch.from_numpy(np.ascontiguousarray(full[:, list(avail)]))
        got = ours.decode_chunks_packed_torch(pack_chunks(surv), avail,
                                              erased)
        assert np.array_equal(unpack_chunks(got).numpy(),
                              full[:, list(erased)]), erased
    with pytest.raises(ValueError, match="sub-chunk-aligned"):
        ours.encode_chunks_packed_torch(torch.zeros(
            (1, ours.k, ours.sub_chunk_no + 1, 128), dtype=torch.uint32))


@pytest.mark.parametrize("profile", PROFILES, ids=IDS)
def test_minimum_to_decode_matches_reference(profile):
    """Every want/available split of one or two lost chunks, and the
    multi-chunk wants: the same chunks and the same sub-chunk runs."""
    ours, ref = _pair(profile)
    n = ours.k + ours.m
    for erased in _patterns(n):
        avail = set(_avail(n, erased))
        for want in ({erased[0]}, set(erased), {erased[0], min(avail)}):
            assert ours.is_repair(want, avail) == ref.is_repair(want, avail)
            assert ours.minimum_to_decode(want, avail) == \
                ref.minimum_to_decode(want, avail), (want, avail)
    # the repair reads sub_chunk_no / q sub-chunks from exactly d helpers
    need = ours.minimum_to_decode({0}, set(range(1, n)))
    assert len(need) == ours.d
    assert all(sum(ln for _, ln in runs) == ours.sub_chunk_no // ours.q
               for runs in need.values())


@pytest.mark.parametrize("profile", PROFILES, ids=IDS)
def test_dict_repair_from_partial_reads(profile):
    """Each lost chunk comes back from the d helpers' sub-chunk runs
    only (the repair branch), byte for byte as the reference's; a double
    erasure takes the full layered decode."""
    ours, ref = _pair(profile)
    n = ours.k + ours.m
    sc = 16
    data = _stripes(ours, 1, sc, 19)
    full = np.concatenate([data, ref.encode_chunks_batch(data)], axis=1)[0]
    chunk = full.shape[-1]
    for lost in range(n):
        avail = set(range(n)) - {lost}
        need = ours.minimum_to_decode({lost}, avail)
        reads = {c: b"".join(full[c, off * sc:(off + ln) * sc].tobytes()
                             for off, ln in runs)
                 for c, runs in need.items()}
        assert all(len(b) < chunk for b in reads.values())
        got = ours.decode({lost}, reads, chunk)
        assert got == ref.decode({lost}, dict(reads), chunk)
        assert got[lost] == full[lost].tobytes(), lost
    erased = (0, n - 1)
    chunks = {c: full[c].tobytes() for c in _avail(n, erased)}
    got = ours.decode(set(erased), chunks, chunk)
    assert got == ref.decode(set(erased), dict(chunks), chunk)
    assert all(got[c] == full[c].tobytes() for c in erased)
    decoded = ours.decode_chunks(set(erased), dict(chunks), {})
    assert all(decoded[c] == full[c].tobytes() for c in erased)


@pytest.mark.parametrize("profile", PROFILES, ids=IDS)
def test_ragged_surfaces_equal_the_dense_product(profile):
    """encode/decode_chunks_ragged_torch on a page pool: live pages as
    the reference's host encode/decode, dead pages zero."""
    ours, ref = _pair(profile)
    assert (ours.page_unit(), ours.page_interleave()) == \
        (ref.page_unit(), ref.page_interleave())
    data = _stripes(ours, 4, 8, 23)
    parity = ref.encode_chunks_batch(data)
    mask = torch.tensor([1, 0, 1, 0], dtype=torch.uint8)
    live = mask.numpy().astype(bool)[:, None, None]
    got = ours.encode_chunks_ragged_torch(torch.from_numpy(data), mask)
    assert np.array_equal(got.numpy(), np.where(live, parity, 0))
    full = np.concatenate([data, parity], axis=1)
    erased = (1,)
    avail = _avail(ours.k + ours.m, erased)
    got = ours.decode_chunks_ragged_torch(
        torch.from_numpy(np.ascontiguousarray(full[:, list(avail)])), mask,
        avail, erased)
    assert np.array_equal(got.numpy(), np.where(live, full[:, [1]], 0))


# -- the plain bit-plane product ---------------------------------------------------

@pytest.mark.parametrize("r,s,c,seed", [(3, 8, 256, 1), (16, 48, 128, 2),
                                        (64, 176, 512, 3)])
def test_mxu_plain_matches_reference(r, s, c, seed):
    """apply_matrix_mxu_torch == the reference's apply_matrix_mxu at the
    sizes of tests/test_mxu.py (composite-like sparsity), bytes and
    packed, and the port's bitmatrix layout is gf.bitmatrix's."""
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, 256, (r, s), dtype=np.int64)
    mat[rng.random((r, s)) < 0.7] = 0
    ms = matrix_to_static(mat)
    data = rng.integers(0, 256, (2, s, c), dtype=np.uint8)
    want = np.asarray(ref_apply_mxu(data, ms, 8))
    got = apply_matrix_mxu_torch(torch.from_numpy(data), ms)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want[0], regionops.matrix_encode(data[0], mat, 8))
    assert np.array_equal(mxu_bitmatrix(ms), np.asarray(
        matrix_to_bitmatrix(s, r, 8, mat.tolist()), dtype=np.uint8))
    if c % 512 == 0:
        gotp = gf_kernels.apply_matrix_mxu_cuda_packed(
            pack_chunks(torch.from_numpy(data)), ms)
        assert np.array_equal(unpack_chunks(gotp).numpy(), want)


def test_mxu_plain_on_the_clay_repair_matrix():
    """The (64, 704) single-erasure composite of clay k=8 m=4 d=11
    through the plain bit-plane product equals the reference's
    decode_chunks_batch and the erased chunk."""
    ours, ref = _pair(K8)
    data = _stripes(ours, 2, 32, 29)
    full = np.concatenate([data, ref.encode_chunks_batch(data)], axis=1)
    avail = _avail(12, (0,))
    _, ms = ours._decode_composite(avail, (0,))
    assert (len(ms), len(ms[0])) == (64, 704)
    surv = np.ascontiguousarray(full[:, list(avail)])
    x = torch.from_numpy(surv).reshape(2, 704, 32)
    got = apply_matrix_mxu_torch(x, ms).reshape(2, 1, -1).numpy()
    assert np.array_equal(got, ref.decode_chunks_batch(surv, avail, (0,)))
    assert np.array_equal(got, full[:, [0]])


def test_mxu_plain_refuses_what_it_cannot_take():
    ms = matrix_to_static(np.ones((2, 3), dtype=np.int64))
    with pytest.raises(ValueError):
        apply_matrix_mxu_torch(torch.zeros((4, 8), dtype=torch.uint8), ms)
    with pytest.raises(ValueError):
        apply_matrix_mxu_torch(torch.zeros((3, 8), dtype=torch.int32), ms)


# -- routing and the dense kernel's capacity --------------------------------------

def _clay_matrices(ec):
    """[(label, static)] of the encode composite and every 1- and
    2-erasure decode composite."""
    out = [("encode", ec._encode_composite()[1])]
    n = ec.k + ec.m
    out += [(e, ec._decode_composite(_avail(n, e), e)[1])
            for e in _patterns(n)]
    return out


@pytest.mark.parametrize("packed", [False, True], ids=["bytes", "packed"])
@pytest.mark.parametrize("profile", PROFILES, ids=IDS)
def test_routing_matches_reference(profile, packed):
    """For clay's encode and every decode composite the port's table on
    a card tensor equals the reference's forced to "pallas" on a
    one-device plane ("pallas" is the port's "cuda"), and a CPU tensor
    takes the torch tier as the reference's takes "xla"."""
    ours, _ = _pair(profile)
    sc = 2048
    routes = {}
    for label, ms in _clay_matrices(ours):
        shape = (4, len(ms[0]), sc // 512, 128) if packed \
            else (4, len(ms[0]), sc)
        want = REF_TO_PORT[ref_select(shape, ms, 8, engine="pallas",
                                      mesh=0, packed=packed)]
        got = select_matrix_engine(8, CUDA, shape=shape, matrix_t=ms,
                                   packed=packed)
        assert got == want, label
        assert select_matrix_engine(8, CPU, shape=shape, matrix_t=ms,
                                    packed=packed) == "torch"
        routes[got] = routes.get(got, 0) + 1
    if profile == K8:
        # the encode and 74 decodes on the bit-plane kernel, the four
        # parity repairs on the dense kernel
        assert routes == {"mxu": 75, "cuda": 4}


def test_dense_kernel_capacity_takes_every_matrix_routed_to_it():
    """The fault: clay k=8 m=4 d=11's four parity repairs are (64, 704)
    tables, 45056 coefficients, which the reference routes to its dense
    kernel ("pallas") but which the by-value kernel argument (2048 w=8
    coefficients) cannot hold.  The repair: the wrapper's capacity rule
    accepts every matrix the table routes to "cuda"."""
    routed = []
    for profile in PROFILES:
        ours, _ = _pair(profile)
        for label, ms in _clay_matrices(ours):
            if select_matrix_engine(8, CUDA, shape=(4, len(ms[0]), 2048),
                                    matrix_t=ms) == "cuda":
                routed.append((profile["k"], label, len(ms), len(ms[0])))
    rs = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"},
        device="cpu")
    routed.append(("rs", "encode", 3, 8))
    assert rs.matrix.shape == (3, 8)
    repairs = [t for t in routed if t[0] == "8"]
    assert sorted(t[1] for t in repairs) == [(8,), (9,), (10,), (11,)]
    for _, _, r, s in repairs:
        assert (r, s) == (64, 704)
        assert r * s > BY_VALUE_MAX_COEF[8]       # the fault
    for _, label, r, s in routed:
        assert matrix_kernel_fits(r, s, 8), label   # the repair
    assert not matrix_kernel_fits(0, 8) and not matrix_kernel_fits(8, 8, 7)


class _FakeLib:
    """Stands in for the built gf8_matrix library: records each launch's
    arguments and accepts it."""

    def __init__(self):
        self.calls = []

    def gf8_matrix_apply(self, *args):
        self.calls.append(args)
        return 0

    def gf8_error_string(self, err):
        return b"fake"


@pytest.mark.parametrize("r,s", [(3, 8), (64, 704), (256, 512)])
def test_launch_passes_a_table_above_the_by_value_limit(monkeypatch, r, s):
    """``gf_kernels._launch`` hands a matrix above BY_VALUE_MAX_COEF to
    the kernel's table variant through a cached device buffer (uploaded
    once per matrix) and a smaller one by value; the kernel library is a
    fake here, so only the wrapper's side runs."""
    fake = _FakeLib()
    uploads = []

    def device_table(coef, device):
        uploads.append(coef)
        return torch.frombuffer(bytearray(coef), dtype=torch.uint8)

    monkeypatch.setattr(gf_kernels, "_lib", lambda: (fake, 8))
    monkeypatch.setattr(gf_kernels, "_device_table", device_table)
    monkeypatch.setattr(gf_kernels, "device_and_stream", lambda x: (0, 0))
    rng = np.random.default_rng(r * s)
    ms = matrix_to_static(rng.integers(0, 256, (r, s)))
    _, _, coef = gf_kernels._matrix_info(ms)
    x = torch.zeros((1, s, 64), dtype=torch.uint8)
    out = torch.empty((1, r, 64), dtype=torch.uint8)
    gf_kernels._launch(x, out, 1, 64, (s * 64, 64), (r * 64, 64), r, s, coef)
    (call,) = fake.calls
    table = call[11]
    if r * s > BY_VALUE_MAX_COEF[8]:
        assert table is not None and uploads == [coef]
        assert len(coef) == r * s
    else:
        assert table is None and uploads == []


# -- serving -----------------------------------------------------------------------

def test_default_spec_matches_reference():
    for kw in ({}, {"seed": 7, "n_requests": 32, "stripe_size": 1 << 20,
                    "arrival": "open", "erasures": 2}):
        assert default_spec(**kw).to_dict() == ref_default_spec(**kw).to_dict()
    names = [(c.plugin, c.weight) for c in default_spec().codecs]
    assert names == [("jerasure", 3.0), ("shec", 2.0), ("clay", 1.0)]


def _serving_spec(paged):
    """default_spec's mix cut to a FakeClock run: RS and shec at 4 KiB,
    clay k=4 m=2 d=5 at 4 KiB and, dense, k=8 m=4 d=11 at 64 KiB."""
    spec = default_spec(seed=11, n_requests=24, stripe_size=4096,
                        concurrency=16, ladder=(1, 2, 4, 8), paged=paged,
                        **({"page_size": 4096, "pool_pages": 64}
                           if paged else {}))
    spec.codecs = [c for c in spec.codecs if c.plugin != "clay"] + [
        CodecSpec("clay_k4_m2_d5", "clay", dict(K4), 4096)]
    if not paged:
        spec.codecs.append(CodecSpec("clay_k8_m4_d11", "clay", dict(K8),
                                     1 << 16))
    return spec


def _outputs(results):
    return {res.request.req_id: (
        tuple(np.asarray(x).tobytes() for x in res.output)
        if isinstance(res.output, tuple) else
        np.asarray(res.output).tobytes()) for res in results}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_serving_with_clay_equals_reference(paged):
    """The serving plane with clay in the mix: the host executor's
    dispatch log, SLO report and outputs equal the reference's letter
    for letter; the device executor on the CPU verifies against the
    generator's ground truth and gives the same outputs."""
    spec = _serving_spec(paged)
    ours = run_serving_scenario(spec, clock=FakeClock(), executor="host",
                                service_model=throughput_service_model())
    ref = ref_run(RefTrafficSpec.from_dict(spec.to_dict()),
                  clock=RefFakeClock(), executor="host",
                  service_model=ref_service_model())
    assert len(ours.results) == 24
    assert verify_results(ours.results) == []
    assert ours.batcher.dispatch_log == ref.batcher.dispatch_log
    assert ours.report == ref.report
    assert _outputs(ours.results) == _outputs(ref.results)
    dev = run_serving_scenario(spec, clock=FakeClock(), executor="device",
                               device="cpu",
                               service_model=throughput_service_model())
    assert verify_results(dev.results) == []
    assert _outputs(dev.results) == _outputs(ours.results)
    assert dev.report["stream_compiles"] == 0
