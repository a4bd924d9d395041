"""The hand-written CUDA kernels against their plain torch versions, on
the card: the GF(2^8) matrix kernel (bytes, packed and the two ragged
wrappers, its table variant above the by-value limit, and a small
serving stream through them), the w=16/32 word kernel, the two
packet-layout bitmatrix kernels (plain and scheduled), the XOR-schedule
kernel (bytes and packed wrappers; the shec, lrc and reed_sol_r6_op
paths that take it), the GF(2) bit-plane kernel (bytes and packed; the
clay paths that take it) and the roofline tool's copy and fold
kernels.  Every test here
is marked ``cuda`` and skips (with a reason) where no CUDA device is
present: a CUDA kernel has no CPU mode.

The file imports neither jax nor ceph_tpu (the machine with the card
need not have them); the numpy ground truth is the port's own copy.
On that machine:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py

Comparisons are exact (``torch.equal``): GF(2^w) and GF(2) math is
integer.
"""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ops import fallback, regionops
from ceph_tpu_torch.ops import gf_kernels
from ceph_tpu_torch.ops.gf_kernels import (
    apply_bitmatrix_cuda, apply_bitmatrix_xor_cuda, apply_matrix_best,
    apply_matrix_cuda, apply_matrix_cuda_packed, apply_matrix_cuda_words,
    apply_matrix_xor_cuda, apply_matrix_xor_cuda_packed, pack_chunks,
    select_matrix_engine, unpack_chunks)
from ceph_tpu_torch.ops.probe_kernels import (
    copy_slab_cuda, copy_slab_torch, fold_slab_cuda, fold_slab_torch)
from ceph_tpu_torch.ops.torch_ops import (
    WORD_DTYPE, apply_bitmatrix_torch, apply_bitmatrix_xor_torch,
    apply_matrix_mxu_torch, apply_matrix_packed_ragged_torch,
    apply_matrix_ragged_torch, apply_matrix_torch, apply_matrix_xor_torch,
    bitmatrix_to_static, mask_pages, matrix_to_static)
from ceph_tpu_torch.ops.xor_schedule import (
    build_schedule, preferred_schedule, probe_bitmatrix_schedule)
from ceph_tpu_torch.utils.errors import KernelLaunchError

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(seed, s, r, c, lead):
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, 256, (r, s))
    mat[0, 0] = 0
    data = rng.integers(0, 256, lead + (s, c), dtype=np.uint8)
    return mat, data


@pytest.mark.parametrize("s,r,C,lead", [(8, 3, 131072, (4,)),
                                        (8, 11, 4096 + 4, (2,)),
                                        (3, 1, 4097, ()),
                                        (5, 8, 65536, (2, 3)),
                                        (11, 16, 512, (7,))])
def test_kernel_matches_plain_on_card(cuda_device, s, r, C, lead):
    mat, data = _case(C + r, s, r, C, lead)
    ms = matrix_to_static(mat)
    x = torch.from_numpy(data).to(cuda_device)
    before = apply_matrix_cuda.launches
    got = apply_matrix_cuda(x, ms)
    torch.cuda.synchronize()
    assert apply_matrix_cuda.launches > before
    assert torch.equal(got, apply_matrix_torch(x, ms, 8))
    assert np.array_equal(got.cpu().numpy(),
                          regionops.matrix_encode(data, mat, 8))
    if C % 512 == 0:
        before = apply_matrix_cuda_packed.launches
        gotp = apply_matrix_cuda_packed(pack_chunks(x), ms)
        torch.cuda.synchronize()
        assert apply_matrix_cuda_packed.launches > before
        assert torch.equal(unpack_chunks(gotp), got)


def test_strided_survivor_slice_on_card(cuda_device):
    mat, data = _case(77, 8, 3, 8192, (3,))
    ms = matrix_to_static(mat)
    x = torch.from_numpy(data).to(cuda_device)
    wide = torch.cat([x, x[:, :3]], dim=1)
    assert torch.equal(apply_matrix_cuda(wide[:, :8, :], ms),
                       apply_matrix_torch(x, ms, 8))
    wide_words = pack_chunks(wide)
    assert torch.equal(
        unpack_chunks(apply_matrix_cuda_packed(wide_words[:, :8], ms)),
        apply_matrix_torch(x, ms, 8))


def test_unmergeable_batch_is_refused(cuda_device):
    x = torch.zeros(4, 6, 3, 256, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        apply_matrix_cuda(x.transpose(0, 1), ((1, 2, 3),))


def test_code_on_card_round_trips(cuda_device):
    ec = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"})
    assert ec.device.type == "cuda"
    data = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 8, 16384), dtype=np.uint8)).to(cuda_device)
    parity = ec.encode_chunks_torch(data)
    assert parity.device.type == "cuda"
    assert np.array_equal(parity.cpu().numpy(), regionops.matrix_encode(
        data.cpu().numpy(), ec.matrix, 8))
    full = torch.cat([data, parity], dim=1)
    avail, erased = (1, 2, 3, 5, 6, 7, 9, 10), (0, 4, 8)
    rec = ec.decode_chunks_torch(full[:, list(avail)], avail, erased)
    assert torch.equal(rec, full[:, list(erased)])


@pytest.mark.parametrize("force", ["torch", "numpy"])
def test_forced_plain_tier_refuses_card_tensor(cuda_device, monkeypatch,
                                               force):
    monkeypatch.setenv("CEPH_TPU_ENGINE", force)
    prev = fallback.set_global_policy(None)
    try:
        x = torch.zeros(2, 3, 512, dtype=torch.uint8, device=cuda_device)
        before = apply_matrix_cuda.launches
        with pytest.raises(ValueError, match="CPU tensors"):
            apply_matrix_best(x, ((1, 2, 3),))
        assert apply_matrix_cuda.launches == before
    finally:
        fallback.set_global_policy(prev)


def test_launch_keeps_the_current_device(cuda_device):
    x = torch.zeros(2, 3, 512, dtype=torch.uint8, device=cuda_device)
    cur = torch.cuda.current_device()
    apply_matrix_cuda(x, ((1, 2, 3),))
    assert torch.cuda.current_device() == cur


# -- the w=16/32 word kernel ----------------------------------------------------

@pytest.mark.parametrize("w", [16, 32])
@pytest.mark.parametrize("s,r,nbytes,lead", [(8, 3, 65536, (4,)),
                                             (5, 9, 4096 + 4, (2,)),
                                             (3, 2, 1028, ())])
def test_word_kernel_matches_plain_on_card(cuda_device, w, s, r, nbytes,
                                           lead):
    rng = np.random.default_rng(w + s + r)
    mat = rng.integers(0, 1 << w, (r, s), dtype=np.uint64)
    mat[0, 0] = 0
    ms = matrix_to_static(mat)
    data = rng.integers(0, 256, lead + (s + 1, nbytes), dtype=np.uint8)
    x = torch.from_numpy(data).to(cuda_device).view(WORD_DTYPE[w])
    view = x[..., :s, :]                          # a strided survivor slice
    before = apply_matrix_cuda_words.launches
    got = apply_matrix_cuda_words(view, ms, w)
    torch.cuda.synchronize()
    assert apply_matrix_cuda_words.launches > before
    assert got.dtype == WORD_DTYPE[w]
    assert torch.equal(got, apply_matrix_torch(view.contiguous(), ms, w))
    words = regionops.words_view(data[..., :s, :], w)
    assert np.array_equal(got.cpu().numpy(),
                          regionops.matrix_encode(words, mat, w))
    assert select_matrix_engine(w, cuda_device) == "cuda"
    assert torch.equal(apply_matrix_best(view, ms, w), got)


# -- the packet-layout bitmatrix kernels ----------------------------------------

def _bitmatrix(rng, r, s, w):
    bm = (rng.random((r * w, s * w)) < 0.4).astype(np.uint8)
    bm[0] = 0
    return bm


@pytest.mark.parametrize("w", [6, 7, 8])
@pytest.mark.parametrize("ps", [8, 32, 2048, 12])
@pytest.mark.parametrize("lead", [(3,), ()])
def test_bitmatrix_kernel_matches_plain_on_card(cuda_device, w, ps, lead):
    rng = np.random.default_rng(w * 7 + ps)
    s, r = 5, 2
    bm = _bitmatrix(rng, r, s, w)
    rows = bitmatrix_to_static(bm)
    data = rng.integers(0, 256, lead + (s + 2, 2 * w * ps), dtype=np.uint8)
    x = torch.from_numpy(data).to(cuda_device)
    view = x[..., :s, :]
    before = apply_bitmatrix_cuda.launches
    got = apply_bitmatrix_cuda(view, rows, w, ps)
    torch.cuda.synchronize()
    assert apply_bitmatrix_cuda.launches == before + 1
    assert torch.equal(got, apply_bitmatrix_torch(view, rows, w, ps))
    assert np.array_equal(got.cpu().numpy(), regionops.bitmatrix_encode(
        data[..., :s, :], bm, w, ps))


def _code(profile):
    return ErasureCodePluginRegistry.instance().factory("jerasure",
                                                        dict(profile))


@pytest.mark.parametrize("profile,ps", [
    ({"technique": "cauchy_good", "k": "8", "m": "3"}, 2048),
    ({"technique": "cauchy_good", "k": "8", "m": "3"}, 32),
    ({"technique": "cauchy_orig", "k": "4", "m": "2"}, 8),
    ({"technique": "blaum_roth", "k": "6", "w": "6"}, 12),
    ({"technique": "liber8tion", "k": "8"}, 32)])
def test_schedule_kernel_matches_plain_on_card(cuda_device, profile, ps):
    ec = _code(profile)
    k, n, w = ec.k, ec.k + ec.m, ec.w
    rng = np.random.default_rng(k + ps)
    data = rng.integers(0, 256, (3, n, 2 * w * ps), dtype=np.uint8)
    x = torch.from_numpy(data).to(cuda_device)
    mats = [ec.bitmatrix]
    for erased in ((0, n - 1), tuple(range(ec.m))):
        avail = [i for i in range(n) if i not in erased][:k]
        mats.append(regionops.bitmatrix_decode_matrix(
            ec.bitmatrix, k, w, avail, list(erased)))
    for bm in mats:
        sched = probe_bitmatrix_schedule(bitmatrix_to_static(bm), w)
        assert sched is not None
        view = x[:, :k, :]
        before = apply_bitmatrix_xor_cuda.launches
        got = apply_bitmatrix_xor_cuda(view, sched.static, w, ps)
        torch.cuda.synchronize()
        assert apply_bitmatrix_xor_cuda.launches == before + 1
        assert torch.equal(got, apply_bitmatrix_xor_torch(
            view, sched.static, w, ps))
        assert np.array_equal(got.cpu().numpy(), regionops.bitmatrix_encode(
            data[:, :k], bm, w, ps))


@pytest.mark.parametrize("profile", [
    {"technique": "cauchy_good", "k": "8", "m": "3", "packetsize": "2048"},
    {"technique": "liberation", "k": "7", "w": "7"},
    {"technique": "reed_sol_van", "k": "8", "m": "3", "w": "16"},
    {"technique": "reed_sol_van", "k": "8", "m": "3", "w": "32"}])
def test_bitmatrix_and_word_codes_round_trip_on_card(cuda_device, profile):
    ec = _code(profile)
    assert ec.device.type == "cuda"
    k, n = ec.k, ec.k + ec.m
    c = ec.get_chunk_size(k * 65536)
    data = torch.from_numpy(np.random.default_rng(k).integers(
        0, 256, (2, k, c), dtype=np.uint8)).to(cuda_device)
    parity = ec.encode_chunks_torch(data)
    assert parity.device.type == "cuda" and parity.shape == (2, ec.m, c)
    host = data.cpu().numpy()
    assert np.array_equal(parity.cpu().numpy(),
                          ec.encode_chunks_batch(host))
    full = torch.cat([data, parity], dim=1)
    for e in range(1, ec.m + 1):
        for erased in itertools.islice(itertools.combinations(range(n), e),
                                       4):
            avail = tuple(i for i in range(n) if i not in erased)
            rec = ec.decode_chunks_torch(full[:, list(avail)], avail, erased)
            assert torch.equal(rec, full[:, list(erased)]), erased


# -- the XOR-schedule kernel ------------------------------------------------------

R6 = ((1,) * 8, tuple(1 << j for j in range(8)))
LRC_REPAIR = ("xorsched", 7, 1, (("xor", 0, 1), ("xor", 7, 2)), (8,))


def _xor_schedules():
    rng = np.random.default_rng(21)
    out = [("r6-encode", preferred_schedule(R6, 8).static, R6),
           ("lrc-repair", LRC_REPAIR, ((1, 1, 1, 0, 0, 0, 0),))]
    for kind in ("sparse", "monomial", "dense"):
        if kind == "sparse":
            m = rng.integers(0, 256, (3, 6)) * (rng.random((3, 6)) < 0.4)
        elif kind == "monomial":
            m = (1 << rng.integers(0, 8, (3, 6))) * (rng.random((3, 6)) < 0.7)
        else:
            m = rng.integers(0, 256, (2, 5))
        m[0, 0] = 1
        ms = matrix_to_static(m)
        out.append((kind, build_schedule(ms).static, ms))
    return out


@pytest.mark.parametrize("name,static,ms", _xor_schedules(),
                         ids=[c[0] for c in _xor_schedules()])
@pytest.mark.parametrize("C,lead", [(131072, (4,)), (4096 + 4, (3,)),
                                    (8192, ())])
def test_xor_kernel_matches_plain_on_card(cuda_device, name, static, ms, C,
                                          lead):
    """Both XOR wrappers against the plain schedule and the numpy ground
    truth: full width, C % 16 != 0 (4-byte units), no leading batch, and
    a survivor slice whose chunk axis is strided."""
    s = static[1]
    rng = np.random.default_rng(C + s)
    data = rng.integers(0, 256, lead + (s + 1, C), dtype=np.uint8)
    x = torch.from_numpy(data).to(cuda_device)
    view = x[..., :s, :]
    before = apply_matrix_xor_cuda.launches
    got = apply_matrix_xor_cuda(view, static)
    torch.cuda.synchronize()
    assert apply_matrix_xor_cuda.launches == before + 1
    assert torch.equal(got, apply_matrix_xor_torch(view.contiguous(),
                                                   static))
    assert np.array_equal(got.cpu().numpy(), regionops.matrix_encode(
        data[..., :s, :], np.array(ms, dtype=np.int64), 8))
    if C % 512 == 0:
        before = apply_matrix_xor_cuda_packed.launches
        gotp = apply_matrix_xor_cuda_packed(pack_chunks(x)[..., :s, :, :],
                                            static)
        torch.cuda.synchronize()
        assert apply_matrix_xor_cuda_packed.launches == before + 1
        assert torch.equal(unpack_chunks(gotp), got)


def test_xor_kernel_refuses_what_it_cannot_take(cuda_device):
    static = preferred_schedule(R6, 8).static
    buf = torch.zeros(2 * 8 * 512 + 2, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 4"):
        apply_matrix_xor_cuda(buf[2:].view(2, 8, 512), static)
    n = 800                        # 800 nodes live at once: past the budget

    def chain(first):
        ops = [("xor", 2, 3)]
        for j in range(4, n + 2):
            ops.append(("xor", first + len(ops) - 1, j))
        return ops

    first = 2 + n
    big = ("xorsched", 2, 2, tuple([("xor", 0, 1)] * n + chain(first)
                                   + chain(first + n - 1)),
           (first + n - 2, first + 2 * n - 3))
    before = apply_matrix_xor_cuda.launches
    with pytest.raises(KernelLaunchError):
        apply_matrix_xor_cuda(torch.zeros(1, 2, 64, dtype=torch.uint8,
                                          device=cuda_device), big)
    assert apply_matrix_xor_cuda.launches == before


@pytest.mark.parametrize("plugin,profile", [
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
    ("jerasure", {"technique": "reed_sol_r6_op", "k": "8", "m": "2"})])
def test_composite_codes_round_trip_on_card(cuda_device, plugin, profile):
    """Encode, then every 1- and 2-erasure decode the code can make, in
    both layouts; a decode runs the XOR-schedule kernel exactly where the
    engine table routes its matrix there."""
    ec = ErasureCodePluginRegistry.instance().factory(plugin, dict(profile))
    assert ec.device.type == "cuda"
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    data = torch.from_numpy(np.random.default_rng(n).integers(
        0, 256, (2, k, 65536), dtype=np.uint8)).to(cuda_device)
    parity = ec.encode_chunks_torch(data)
    assert torch.equal(unpack_chunks(ec.encode_chunks_packed_torch(
        pack_chunks(data))), parity)
    assert np.array_equal(parity.cpu().numpy(),
                          ec.encode_chunks_batch(data.cpu().numpy()))
    full = torch.empty((2, n, 65536), dtype=torch.uint8, device=cuda_device)
    dpos = list(getattr(ec, "data_positions", range(k)))
    full[:, dpos] = data
    full[:, [p for p in range(n) if p not in dpos]] = parity
    scheduled = 0
    for e in (1, 2):
        for erased in itertools.combinations(range(n), e):
            avail = tuple(i for i in range(n) if i not in erased)
            try:
                ec.minimum_to_decode(set(erased), set(avail))
            except IOError:
                continue
            surv = full[:, list(avail)]
            before = gf_kernels.launch_counts()
            rec = ec.decode_chunks_torch(surv, avail, erased)
            recp = ec.decode_chunks_packed_torch(pack_chunks(surv), avail,
                                                 erased)
            torch.cuda.synchronize()
            after = gf_kernels.launch_counts()
            assert torch.equal(rec, full[:, list(erased)]), erased
            assert torch.equal(unpack_chunks(recp), rec), erased
            ran_xor = after["apply_matrix_xor_cuda"] - before[
                "apply_matrix_xor_cuda"]
            assert ran_xor == after["apply_matrix_xor_cuda_packed"] - \
                before["apply_matrix_xor_cuda_packed"]
            scheduled += ran_xor
    assert scheduled == {"lrc": 29, "shec": 4, "jerasure": 2}[plugin]


# -- the ragged (paged) wrappers -----------------------------------------------

@pytest.mark.parametrize("r,s,p,page,kind", [
    (3, 8, 64, 4096, "scattered"), (11, 8, 16, 4096 + 4, "scattered"),
    (1, 5, 8, 1024, "dead"), (8, 6, 8, 2048, "live"),
    (3, 8, 1, 512, "live")])
def test_ragged_kernel_matches_plain_on_card(cuda_device, r, s, p, page,
                                             kind):
    """Both ragged wrappers against their plain versions and against the
    dense kernel on the masked pool; dead pages zero."""
    rng = np.random.default_rng(r * 1000 + p)
    mat = rng.integers(0, 256, (r, s))
    mat[0, 0] = 0
    ms = matrix_to_static(mat)
    pool = torch.from_numpy(rng.integers(0, 256, (p, s, page),
                                         dtype=np.uint8)).to(cuda_device)
    live = {"scattered": rng.random(p) < 0.5, "dead": np.zeros(p, bool),
            "live": np.ones(p, bool)}[kind]
    mask = torch.from_numpy(live.astype(np.uint8)).to(cuda_device)
    before = gf_kernels.apply_matrix_cuda_ragged.launches
    got = gf_kernels.apply_matrix_cuda_ragged(pool, ms, mask)
    torch.cuda.synchronize()
    assert gf_kernels.apply_matrix_cuda_ragged.launches > before
    assert torch.equal(got, apply_matrix_ragged_torch(pool, ms, mask))
    assert torch.equal(got, apply_matrix_cuda(mask_pages(pool, mask), ms))
    assert not got[~torch.from_numpy(live).to(cuda_device)].any()
    if page % 512 == 0:
        words = pack_chunks(pool)
        before = gf_kernels.apply_matrix_cuda_packed_ragged.launches
        gotp = gf_kernels.apply_matrix_cuda_packed_ragged(words, ms, mask)
        torch.cuda.synchronize()
        assert gf_kernels.apply_matrix_cuda_packed_ragged.launches > before
        assert torch.equal(gotp, apply_matrix_packed_ragged_torch(
            words, ms, mask))
        assert torch.equal(unpack_chunks(gotp), got)


def test_ragged_wrappers_refuse_a_mask_off_the_pool(cuda_device):
    pool = torch.zeros(4, 3, 512, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="device"):
        gf_kernels.apply_matrix_cuda_ragged(
            pool, ((1, 2, 3),), torch.ones(4, dtype=torch.uint8))
    with pytest.raises(ValueError, match="pool"):
        gf_kernels.apply_matrix_cuda_ragged(
            pool, ((1, 2, 3),),
            torch.ones(3, dtype=torch.uint8, device=cuda_device))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_serving_stream_on_card(cuda_device, paged):
    """A small mixed stream through the device executor on the card:
    verified against ground truth; the ragged kernel launches on the
    paged run only."""
    from ceph_tpu_torch.serve import (CodecSpec, TrafficSpec,
                                      run_serving_scenario, verify_results)
    codecs = [CodecSpec(f"rs_{s}", "jerasure",
                        {"technique": "reed_sol_van", "k": "4", "m": "2"}, s)
              for s in (4096, 16384)]
    spec = TrafficSpec(seed=5, n_requests=32, codecs=codecs,
                       ladder=(1, 4, 16), paged=paged, page_size=1024,
                       pool_pages=64)
    gf_kernels.reset_launch_counts()
    run = run_serving_scenario(spec)
    assert verify_results(run.results) == []
    ragged = gf_kernels.launch_counts()["apply_matrix_cuda_ragged"]
    assert (ragged > 0) == paged
    assert run.report["stream_compiles"] == 0


# -- the GF(2) bit-plane kernel and the dense kernel's table variant -----------

@pytest.mark.parametrize("r,s,C,lead,zeros", [
    (256, 512, 2048, (2,), 0.95), (64, 704, 2048, (3,), 0.95),
    (16, 48, 4096 + 4, (2,), 0.7), (64, 176, 1000, (), 0.7),
    (3, 8, 512, (2, 2), 0.0), (1, 5, 130, (), 0.0)])
def test_mxu_kernel_matches_plain_on_card(cuda_device, r, s, C, lead, zeros):
    """apply_matrix_mxu_cuda (and the packed wrapper where C is whole
    rows) equals its plain version, the dense kernel and numpy, on
    composite-like sparse matrices, tails off the tile, strided chunk
    slices and no batch dimension."""
    rng = np.random.default_rng(r * s + C)
    mat = rng.integers(0, 256, (r, s))
    mat[rng.random((r, s)) < zeros] = 0
    ms = matrix_to_static(mat)
    host = rng.integers(0, 256, lead + (s + 1, C), dtype=np.uint8)
    x = torch.from_numpy(host).to(cuda_device)[..., 1:, :]
    before = gf_kernels.apply_matrix_mxu_cuda.launches
    got = gf_kernels.apply_matrix_mxu_cuda(x, ms)
    torch.cuda.synchronize()
    assert gf_kernels.apply_matrix_mxu_cuda.launches == before + 1
    assert torch.equal(got, apply_matrix_mxu_torch(x, ms))
    assert torch.equal(got, apply_matrix_cuda(x, ms))
    flat = host[..., 1:, :].reshape((-1, s, C))[0]
    assert np.array_equal(got.reshape((-1, r, C))[0].cpu().numpy(),
                          regionops.matrix_encode(flat, mat, 8))
    if C % 512 == 0:
        before = gf_kernels.apply_matrix_mxu_cuda_packed.launches
        gotp = gf_kernels.apply_matrix_mxu_cuda_packed(pack_chunks(x), ms)
        torch.cuda.synchronize()
        assert gf_kernels.apply_matrix_mxu_cuda_packed.launches == before + 1
        assert torch.equal(unpack_chunks(gotp), got)


def test_mxu_kernel_refuses_what_it_cannot_take(cuda_device):
    ms = matrix_to_static(np.ones((2, 3), dtype=np.int64))
    x = torch.zeros((4, 3, 64), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        gf_kernels.apply_matrix_mxu_cuda(x[:, :2], ms)
    with pytest.raises(ValueError):
        gf_kernels.apply_matrix_mxu_cuda(x[..., ::2], ms)
    with pytest.raises(ValueError):
        gf_kernels.apply_matrix_mxu_cuda_packed(x, ms)


@pytest.mark.parametrize("r,s,C", [(64, 704, 2048), (9, 300, 4096 + 4),
                                   (256, 512, 512)])
def test_dense_kernel_table_variant_on_card(cuda_device, r, s, C):
    """A table above the by-value limit (2048 coefficients) goes through
    the device buffer: dense, packed and both ragged wrappers equal
    their plain versions."""
    assert r * s > gf_kernels.BY_VALUE_MAX_COEF[8]
    rng = np.random.default_rng(r + s + C)
    mat = rng.integers(0, 256, (r, s))
    mat[rng.random((r, s)) < 0.5] = 0
    ms = matrix_to_static(mat)
    x = torch.from_numpy(rng.integers(0, 256, (4, s, C),
                                      dtype=np.uint8)).to(cuda_device)
    got = apply_matrix_cuda(x, ms)
    assert torch.equal(got, apply_matrix_torch(x, ms, 8))
    mask = torch.tensor([1, 0, 1, 1], dtype=torch.uint8, device=cuda_device)
    assert torch.equal(gf_kernels.apply_matrix_cuda_ragged(x, ms, mask),
                       apply_matrix_ragged_torch(x, ms, mask))
    if C % 512 == 0:
        words = pack_chunks(x)
        assert torch.equal(unpack_chunks(apply_matrix_cuda_packed(words, ms)),
                           got)
        assert torch.equal(
            gf_kernels.apply_matrix_cuda_packed_ragged(words, ms, mask),
            apply_matrix_packed_ragged_torch(words, ms, mask))


@pytest.mark.parametrize("profile", [{"k": "4", "m": "2", "d": "5"},
                                     {"k": "8", "m": "4", "d": "11"}])
def test_clay_round_trips_on_card(cuda_device, profile):
    """Clay on the card: encode in both layouts, then every single
    erasure and a few doubles; at k=8 the encode and the data-chunk
    decodes take the bit-plane kernel, the parity repairs the dense
    kernel's table variant."""
    ec = ErasureCodePluginRegistry.instance().factory("clay", dict(profile))
    assert ec.device.type == "cuda"
    k, n = ec.k, ec.k + ec.m
    chunk = ec.sub_chunk_no * 512
    host = np.random.default_rng(n).integers(0, 256, (2, k, chunk),
                                             dtype=np.uint8)
    data = torch.from_numpy(host).to(cuda_device)
    before = gf_kernels.launch_counts()
    parity = ec.encode_chunks_torch(data)
    assert torch.equal(unpack_chunks(ec.encode_chunks_packed_torch(
        pack_chunks(data))), parity)
    ec.min_xla_bytes = 1 << 40                     # the host tier
    assert np.array_equal(parity.cpu().numpy(), ec.encode_chunks_batch(host))
    full = torch.cat([data, parity], dim=1)
    for erased in [(e,) for e in range(n)] + [(0, 1), (1, n - 1)]:
        avail = tuple(i for i in range(n) if i not in erased)
        surv = full[:, list(avail)]
        rec = ec.decode_chunks_torch(surv, avail, erased)
        recp = ec.decode_chunks_packed_torch(pack_chunks(surv), avail,
                                             erased)
        assert torch.equal(rec, full[:, list(erased)]), erased
        assert torch.equal(unpack_chunks(recp), rec), erased
    torch.cuda.synchronize()
    after = gf_kernels.launch_counts()
    ran = {name: after[name] - before[name] for name in after}
    if profile["k"] == "8":
        # encode (2 layouts) + 8 data singles + 2 doubles, both layouts
        assert ran["apply_matrix_mxu_cuda"] == 1 + 10
        assert ran["apply_matrix_mxu_cuda_packed"] == 1 + 10
        assert ran["apply_matrix_cuda"] >= 4
        assert ran["apply_matrix_cuda_packed"] >= 4
    else:
        assert ran["apply_matrix_mxu_cuda"] == 0


# -- the roofline tool's probe kernels ------------------------------------------

@pytest.mark.parametrize("b,s,rows", [(64, 8, 256), (3, 5, 7), (1, 1, 1)])
def test_probe_kernels_match_plain_on_card(cuda_device, b, s, rows):
    rng = np.random.default_rng(b + s + rows)
    host = rng.integers(0, 1 << 32, (b, s, rows, 128), dtype=np.uint32)
    x = torch.from_numpy(host).to(cuda_device)
    before = (copy_slab_cuda.launches, fold_slab_cuda.launches)
    got = copy_slab_cuda(x)
    fold = fold_slab_cuda(x)
    torch.cuda.synchronize()
    assert (copy_slab_cuda.launches, fold_slab_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got, copy_slab_torch(x))
    assert torch.equal(fold, fold_slab_torch(x))
    assert np.array_equal(fold.cpu().numpy(), np.bitwise_xor.reduce(
        host, axis=1, keepdims=True))
    strided = torch.zeros((2, 2, 2, 128), dtype=torch.uint32,
                          device=cuda_device)[:, ::2]
    for fn in (copy_slab_cuda, fold_slab_cuda):
        with pytest.raises(ValueError):
            fn(strided)


def test_roofline_tool_on_card(cuda_device):
    from ceph_tpu_torch.tools import roofline
    for name in roofline.PROBES:
        row = roofline.probe(name, 8, 4, "packed")
        assert row["input_gbps"] > 0 and row["device"] != "cpu"
        assert row["traffic_mult"] == roofline.traffic_mult(name)
