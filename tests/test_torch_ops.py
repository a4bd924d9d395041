"""Port parity, ops layer: the torch tier (``apply_matrix_torch``) and
the kernel wrappers' CPU path against ceph_tpu's XLA path, its Pallas
kernels in interpret mode, and the numpy ground truth.  Exact byte
equality throughout (GF math is integer).  The kernel itself is held
against the plain version on the card in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ops import regionops as ref_regionops
from ceph_tpu.ops import xla_ops as ref_xla
from ceph_tpu.ops import xor_schedule as ref_xor
from ceph_tpu.ops.pallas_gf import apply_matrix_pallas, \
    apply_matrix_pallas_packed, apply_matrix_pallas_words
from ceph_tpu.ops.pallas_gf import pack_chunks as ref_pack_chunks
from ceph_tpu_torch.ops import _build, fallback, gf_kernels, torch_ops
from ceph_tpu_torch.ops.gf_kernels import (
    apply_matrix_best, apply_matrix_cuda, apply_matrix_cuda_packed,
    apply_matrix_cuda_words, apply_matrix_packed_best, pack_chunks,
    select_matrix_engine, unpack_chunks)
from ceph_tpu_torch.ops.torch_ops import apply_matrix_torch, \
    matrix_to_static
from ceph_tpu_torch.utils.errors import KernelBuildError, NoDeviceError


def _case(seed, s, r, shape_c, lead=(3,)):
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, 256, (r, s))
    mat[0, 0] = 0                       # zero entries skip planes
    data = rng.integers(0, 256, lead + (s, shape_c), dtype=np.uint8)
    return mat, data


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("s,r,C", [(8, 3, 4096), (4, 2, 8192), (6, 3, 4096),
                                   (2, 1, 4096), (11, 8, 4096),
                                   (8, 11, 4096)])
def test_torch_tier_matches_pallas_xla_and_regionops(s, r, C):
    mat, data = _case(s * 100 + r, s, r, C)
    ms = matrix_to_static(mat)
    ref = ref_regionops.matrix_encode(data, mat, 8)
    ours = apply_matrix_torch(_t(data), ms, 8).numpy()
    assert np.array_equal(ours, ref)
    assert np.array_equal(ours, np.asarray(ref_xla.apply_matrix_xla(
        jnp.asarray(data), ref_xla.matrix_to_static(mat), 8)))
    assert np.array_equal(ours, np.asarray(apply_matrix_pallas(
        data, ref_xla.matrix_to_static(mat), True)))


def test_zero_rows_identity_and_no_batch_dim():
    mat = np.array([[1, 0, 0], [0, 0, 0], [0, 2, 0]])
    data = np.random.default_rng(0).integers(0, 256, (3, 4096),
                                             dtype=np.uint8)
    got = apply_matrix_torch(_t(data), matrix_to_static(mat), 8).numpy()
    assert got.shape == (3, 4096)
    assert np.array_equal(got[0], data[0])
    assert not got[1].any()
    assert np.array_equal(got, ref_regionops.matrix_encode(data, mat, 8))
    assert np.array_equal(got, np.asarray(apply_matrix_pallas(
        data, ref_xla.matrix_to_static(mat), True)))


@pytest.mark.parametrize("C", [4096 + 4, 4097, 4099, 1, 3, 4110])
def test_tail_chunk_sizes(C):
    mat, data = _case(C, 5, 3, C, lead=(2,))
    got = apply_matrix_torch(_t(data), matrix_to_static(mat), 8).numpy()
    assert np.array_equal(got, ref_regionops.matrix_encode(data, mat, 8))
    assert np.array_equal(got, np.asarray(ref_xla.apply_matrix_xla(
        jnp.asarray(data), ref_xla.matrix_to_static(mat), 8)))


def test_strided_survivor_slice_on_cpu():
    """A survivor slice (strided chunk axis) gives the same bytes as a
    contiguous copy, through the wrapper's CPU path."""
    mat, data = _case(31, 6, 2, 4100, lead=(2,))
    full = np.concatenate([data, data[:, :2]], axis=1)
    sl = _t(full)[:, :6, :]
    assert not sl.is_contiguous()
    got = apply_matrix_cuda(sl, matrix_to_static(mat)).numpy()
    assert np.array_equal(got, ref_regionops.matrix_encode(data, mat, 8))


@pytest.mark.parametrize("w", [16, 32])
def test_word_widths_match(w):
    rng = np.random.default_rng(w)
    mat = rng.integers(0, 1 << w, (3, 5), dtype=np.uint64)
    mat[1, 2] = 0
    data = rng.integers(0, 256, (2, 5, 4096 + w // 8), dtype=np.uint8)
    words = ref_regionops.words_view(data, w)
    ref = ref_regionops.matrix_encode(words, mat, w)
    got = apply_matrix_torch(_t(words), matrix_to_static(mat), w).numpy()
    assert got.dtype == ref.dtype
    assert np.array_equal(got, ref)
    assert np.array_equal(got, np.asarray(ref_xla.apply_matrix_xla(
        jnp.asarray(words), ref_xla.matrix_to_static(mat), w)))
    # the dispatcher sends the word paths to the word kernel on the card,
    # and its wrapper runs the plain version on a CPU tensor
    assert select_matrix_engine(w, torch.device("cuda")) == "cuda"
    assert select_matrix_engine(w, torch.device("cpu")) == "torch"
    assert np.array_equal(
        apply_matrix_best(_t(words), matrix_to_static(mat), w).numpy(), ref)
    got = apply_matrix_cuda_words(_t(words), matrix_to_static(mat), w)
    assert got.dtype == torch_ops.WORD_DTYPE[w]
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("w", [16, 32])
@pytest.mark.parametrize("lead", [(2,), ()])
def test_word_path_matches_pallas_words_interpret(w, lead):
    """The word kernel's plain version (and its wrapper's CPU path)
    against apply_matrix_pallas_words in interpret mode, byte for byte."""
    rng = np.random.default_rng(w + len(lead))
    mat = rng.integers(0, 1 << w, (3, 4), dtype=np.uint64)
    mat[2, 1] = 0
    data = rng.integers(0, 256, lead + (4, 8192), dtype=np.uint8)
    words = ref_regionops.words_view(data, w)
    want = np.asarray(apply_matrix_pallas_words(
        words, ref_xla.matrix_to_static(mat), w, True))
    assert np.array_equal(want, ref_regionops.matrix_encode(words, mat, w))
    ms = matrix_to_static(mat)
    assert np.array_equal(apply_matrix_torch(_t(words), ms, w).numpy(), want)
    assert np.array_equal(apply_matrix_cuda_words(_t(words), ms, w).numpy(),
                          want)


def test_word_wrapper_rejects_what_the_kernel_does_not_take():
    ms = ((1, 2),)
    with pytest.raises(ValueError):
        apply_matrix_cuda_words(torch.zeros(2, 32, dtype=torch.uint16), ms, 8)
    with pytest.raises(ValueError):
        apply_matrix_cuda_words(torch.zeros(2, 32, dtype=torch.uint32), ms,
                                16)
    with pytest.raises(ValueError):
        apply_matrix_cuda_words(torch.zeros(2, 32, dtype=torch.uint16),
                                ((1, 1 << 16),), 16)
    with pytest.raises(ValueError):
        apply_matrix_best(torch.zeros(2, 32, dtype=torch.uint8), ms, 7)


@pytest.mark.parametrize("w", [8, 16, 32])
def test_xtime_swar_matches_reference(w):
    vals = np.random.default_rng(w).integers(0, 1 << 32, 4096,
                                             dtype=np.uint64)
    vals = vals.astype(np.uint32)
    vals[:4] = [0, 0xFFFFFFFF, 0x80808080, 0x7F7F7F7F]
    ref = np.asarray(ref_xla.xtime_swar(jnp.asarray(vals), w))
    ours = torch_ops.xtime_swar(_t(vals.view(np.int32)), w)
    assert np.array_equal(ours.numpy().view(np.uint32), ref)


def test_packed_views_and_apply_match():
    rng = np.random.default_rng(17)
    mat = rng.integers(0, 256, (3, 8))
    data = rng.integers(0, 256, (2, 8, 8192), dtype=np.uint8)
    td = _t(data)
    words = pack_chunks(td)
    assert words.dtype == torch.uint32 and words.shape == (2, 8, 16, 128)
    assert words.data_ptr() == td.data_ptr()         # a free view
    assert np.array_equal(words.numpy(), ref_pack_chunks(data))
    assert torch.equal(unpack_chunks(words), td)
    ref = ref_regionops.matrix_encode(data, mat, 8)
    ref_packed = np.asarray(apply_matrix_pallas_packed(
        ref_pack_chunks(data), ref_xla.matrix_to_static(mat), True))
    for fn in (apply_matrix_cuda_packed, apply_matrix_packed_best):
        got = fn(words, matrix_to_static(mat))
        assert got.dtype == torch.uint32 and got.shape == (2, 3, 16, 128)
        assert np.array_equal(got.numpy(), ref_packed)
        assert np.array_equal(unpack_chunks(got).numpy(), ref)


def test_wrappers_on_cpu_take_plain_version_and_count_nothing():
    gf_kernels.reset_launch_counts()
    mat, data = _case(3, 8, 3, 4096, lead=(2,))
    got = apply_matrix_cuda(_t(data), matrix_to_static(mat)).numpy()
    assert np.array_equal(got, ref_regionops.matrix_encode(data, mat, 8))
    apply_matrix_cuda_packed(pack_chunks(_t(data)), matrix_to_static(mat))
    apply_matrix_cuda_words(_t(data).view(torch.uint16),
                            matrix_to_static(mat), 16)
    gf_kernels.apply_bitmatrix_cuda(_t(data[:, :1]), (0b11, 0b10), 2, 64)
    gf_kernels.apply_bitmatrix_xor_cuda(
        _t(data[:, :1]), ("xorsched", 2, 2, (("xor", 0, 1),), (2, 1)), 2,
        64)
    sched = ("xorsched", 8, 1, (("xor", 0, 1), ("shl", 8, 2)), (9,))
    gf_kernels.apply_matrix_xor_cuda(_t(data), sched)
    gf_kernels.apply_matrix_xor_cuda_packed(pack_chunks(_t(data)), sched)
    live = torch.tensor([1, 0], dtype=torch.uint8)
    gf_kernels.apply_matrix_cuda_ragged(_t(data), matrix_to_static(mat),
                                        live)
    gf_kernels.apply_matrix_cuda_packed_ragged(
        pack_chunks(_t(data)), matrix_to_static(mat), live)
    got = gf_kernels.apply_matrix_mxu_cuda(_t(data), matrix_to_static(mat))
    assert np.array_equal(got.numpy(),
                          ref_regionops.matrix_encode(data, mat, 8))
    gf_kernels.apply_matrix_mxu_cuda_packed(pack_chunks(_t(data)),
                                            matrix_to_static(mat))
    assert gf_kernels.launch_counts() == {
        "apply_matrix_cuda": 0, "apply_matrix_cuda_packed": 0,
        "apply_matrix_cuda_words": 0, "apply_bitmatrix_cuda": 0,
        "apply_bitmatrix_xor_cuda": 0, "apply_matrix_xor_cuda": 0,
        "apply_matrix_xor_cuda_packed": 0, "apply_matrix_cuda_ragged": 0,
        "apply_matrix_cuda_packed_ragged": 0, "apply_matrix_mxu_cuda": 0,
        "apply_matrix_mxu_cuda_packed": 0, "copy_slab_cuda": 0,
        "fold_slab_cuda": 0, "crush_rule_cuda": 0}


def test_one_launch_registry_reads_every_kernel_module():
    """ops/launches.py reads and resets the counts of every wrapper of
    every kernel module, whatever the caller imported."""
    from ceph_tpu_torch.ops import crush_kernels, launches, probe_kernels
    every = launches.wrappers()
    assert set(every) == set(gf_kernels.WRAPPERS) | set(
        probe_kernels.WRAPPERS) | set(crush_kernels.WRAPPERS)
    assert len(every) == len(gf_kernels.WRAPPERS) + len(
        probe_kernels.WRAPPERS) + len(crush_kernels.WRAPPERS) == 14
    assert gf_kernels.launch_counts is launches.launch_counts
    probe_kernels.fold_slab_cuda.launches = 3
    assert launches.launch_counts()["fold_slab_cuda"] == 3
    launches.reset_launch_counts()
    assert set(launches.launch_counts().values()) == {0}


def test_static_matrix_keeps_its_hash_and_equals_the_plain_table():
    """matrix_to_static's table hashes once and keys the same cache
    entries as the plain tuple of tuples."""
    mat = np.random.default_rng(5).integers(0, 256, (64, 704))
    ms = matrix_to_static(mat)
    plain = tuple(tuple(int(x) for x in row) for row in mat)
    assert ms == plain and hash(ms) == hash(plain)
    assert ms._hash == hash(plain)               # kept after the first hash
    assert gf_kernels._static(ms) is ms
    assert isinstance(gf_kernels._static(mat), torch_ops.StaticMatrix)
    assert gf_kernels._static(mat) == ms
    info = gf_kernels._matrix_info(ms)
    assert gf_kernels._matrix_info(plain) is info  # one cache entry


def test_wrappers_reject_what_the_kernel_does_not_take():
    ms = ((1, 2, 3),)
    with pytest.raises(ValueError):
        apply_matrix_cuda(torch.zeros(2, 4, 64, dtype=torch.uint8), ms)
    with pytest.raises(ValueError):
        apply_matrix_cuda(torch.zeros(2, 3, 64, dtype=torch.int32), ms)
    with pytest.raises(ValueError):
        apply_matrix_cuda_packed(torch.zeros(2, 3, 4, 64,
                                             dtype=torch.uint8), ms)
    with pytest.raises(ValueError):
        apply_matrix_cuda(torch.zeros(3, 64, dtype=torch.uint8),
                          ((1, 2, 300),))
    with pytest.raises(ValueError):
        pack_chunks(torch.zeros(3, 100, dtype=torch.uint8))


def test_engine_table_and_forced_tiers(monkeypatch):
    mat, data = _case(9, 4, 2, 2048, lead=(2,))
    ms = matrix_to_static(mat)
    ref = ref_regionops.matrix_encode(data, mat, 8)
    cpu = torch.device("cpu")
    assert select_matrix_engine(8, cpu) == "torch"
    assert select_matrix_engine(8, torch.device("cuda")) == "cuda"
    assert select_matrix_engine(8, cpu, engine="numpy") == "numpy"
    for force in fallback.ENGINES:
        monkeypatch.setenv("CEPH_TPU_ENGINE", force)
        prev = fallback.set_global_policy(None)
        try:
            assert fallback.global_policy().engine(cpu) == force
            got = apply_matrix_best(_t(data), ms, 8).numpy()
            assert np.array_equal(got, ref)
            got = apply_matrix_packed_best(pack_chunks(_t(data)), ms)
            assert np.array_equal(unpack_chunks(got).numpy(), ref)
        finally:
            fallback.set_global_policy(prev)
    monkeypatch.setenv("CEPH_TPU_ENGINE", "pallas")
    with pytest.raises(ValueError):
        fallback.FallbackPolicy()


@pytest.mark.parametrize("force", ["torch", "numpy"])
def test_forced_plain_tier_on_card_tensor_raises(monkeypatch, force):
    card = torch.device("cuda")
    # an inherited CEPH_TPU_ENGINE never takes a card tensor off the kernel
    monkeypatch.setenv("CEPH_TPU_ENGINE", force)
    with pytest.raises(ValueError, match="CPU tensors"):
        fallback.FallbackPolicy().engine(card)
    with pytest.raises(ValueError, match="CPU tensors"):
        select_matrix_engine(8, card, engine=force)
    prev = fallback.set_global_policy(None)
    try:
        with pytest.raises(ValueError, match="CPU tensors"):
            select_matrix_engine(8, card)
        assert select_matrix_engine(8, torch.device("cpu")) == force
    finally:
        fallback.set_global_policy(prev)
    monkeypatch.setenv("CEPH_TPU_ENGINE", "cuda")
    assert fallback.FallbackPolicy().engine(card) == "cuda"


def test_cuda_request_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        fallback.resolve_device(None)
    with pytest.raises(NoDeviceError):
        fallback.resolve_device("cuda")
    assert fallback.resolve_device("cpu").type == "cpu"


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp_ext
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(KernelBuildError):
        _build._nvcc()


def test_build_key_covers_shared_headers(tmp_path):
    """An edit to a shared csrc header rebuilds every source; the
    port's sources include the one header there."""
    src, header = tmp_path / "k.cu", tmp_path / "common.cuh"
    src.write_text('#include "common.cuh"\n')
    header.write_text("// one\n")
    first = _build._target(src)
    assert _build._target(src) == first
    header.write_text("// two\n")
    assert _build._target(src) != first
    assert sorted(p.name for p in _build.CSRC.glob("*.cuh")) == [
        "on_device.cuh"]
    for cu in _build.CSRC.glob("*.cu"):
        assert '#include "on_device.cuh"' in cu.read_text()


def test_racing_builds_write_their_own_temporary_files(monkeypatch,
                                                       tmp_path):
    """Two threads building one source at once each give nvcc a
    temporary file of their own, and both end with the one library (a
    stand-in nvcc writes its -o file after a pause)."""
    import threading
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// k\n")
    outs, nvcc = tmp_path / "outs", tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    f'echo "$2" >> {outs}\nsleep 0.3\necho lib > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    got, errs = [], []

    def run():
        try:
            got.append(_build.build(["k"])["k"])
        except Exception as e:  # noqa: BLE001 - asserted below
            errs.append(e)
    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and len(got) == 2 and got[0] == got[1]
    written = outs.read_text().split()
    assert len(written) == 2 and len(set(written)) == 2
    assert got[0].read_text() == "lib\n"
    assert not list(build.glob("*.tmp"))


def test_dense_op_count_matches_reference_model():
    from ceph_tpu_torch.matrices.jerasure import \
        reed_sol_vandermonde_coding_matrix
    mats = [reed_sol_vandermonde_coding_matrix(8, 3, 8),
            np.random.default_rng(1).integers(0, 256, (4, 6))]
    for mat in mats:
        ms = matrix_to_static(mat)
        assert gf_kernels.dense_op_count(ms) == ref_xor.dense_vpu_cost(ms)
    assert gf_kernels.dense_op_count(matrix_to_static(mats[0])) == 306


def test_sm90_op_count_counts_wide_fields():
    """w=16/32: the same count with that width's longer doubling chains
    and its own xtime cost (4 instructions at w=16, 3 at w=32)."""
    from ceph_tpu_torch.matrices.jerasure import \
        reed_sol_vandermonde_coding_matrix
    assert gf_kernels.SM90_XT_COST == {8: 4, 16: 4, 32: 3}
    for w, xt_cost, total in ((16, 4, 458), (32, 3, 703)):
        mat = reed_sol_vandermonde_coding_matrix(8, 3, w)
        ms = matrix_to_static(mat)
        xt = sum(xt_cost * (max(int(v).bit_length() for v in col) - 1)
                 for col in mat.T
                 if max(int(v).bit_length() for v in col) > 1)
        fold = sum(sum(int(v).bit_count() for v in row) // 2 for row in mat)
        assert gf_kernels.sm90_op_count(ms, w) == xt + fold == total
    assert gf_kernels.sm90_op_count(((1 << 31, 1),), 32) == 3 * 31 + 1
    assert gf_kernels.sm90_op_count(((1 << 15, 1),), 16) == 4 * 15 + 1
    with pytest.raises(KeyError):
        gf_kernels.sm90_op_count(((3, 1),), 7)


def test_sm90_op_count_folds_xors_and_xtimes():
    from ceph_tpu_torch.matrices.jerasure import \
        reed_sol_vandermonde_coding_matrix
    mat = reed_sol_vandermonde_coding_matrix(8, 3, 8)
    ms = matrix_to_static(mat)
    # 4 instructions per xtime up to each column's top bit, and each
    # row's n planes folded in ceil((n - 1) / 2) three-input XORs
    xt = sum(4 * (max(int(v).bit_length() for v in col) - 1)
             for col in mat.T if max(int(v).bit_length() for v in col) > 1)
    fold = sum(-(-(sum(int(v).bit_count() for v in row) - 1) // 2)
               for row in mat)
    assert gf_kernels.sm90_op_count(ms) == xt + fold == 225
    assert gf_kernels.sm90_op_count(ms, 8) == 225
    assert gf_kernels.sm90_op_count(((1,),)) == 0
    assert gf_kernels.sm90_op_count(((3, 1),)) == 4 + 1
    assert gf_kernels.sm90_op_count(ms) < gf_kernels.dense_op_count(ms)
