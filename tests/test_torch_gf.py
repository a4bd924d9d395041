"""Port parity, host layer: ceph_tpu_torch's copies of the GF core, the
generator matrices and the numpy ground truth against ceph_tpu's, on
seeded inputs.  Every comparison is exact (GF math is integer).  Also
the import-hygiene gate: the port imports neither jax nor ceph_tpu."""

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ceph_tpu.gf import bitmatrix as ref_bm
from ceph_tpu.gf import matrix as ref_matrix
from ceph_tpu.matrices import isal as ref_isal
from ceph_tpu.matrices import jerasure as ref_jer
from ceph_tpu.ops import regionops as ref_regionops
from ceph_tpu_torch.gf import bitmatrix, matrix
from ceph_tpu_torch.matrices import isal, jerasure
from ceph_tpu_torch.ops import regionops

# the gf packages export a function named gf8 over the module's name
ref_gf8 = importlib.import_module("ceph_tpu.gf.gf8")
gf8 = importlib.import_module("ceph_tpu_torch.gf.gf8")

ROOT = Path(__file__).resolve().parents[1]


def test_gf8_tables_match():
    a, b = gf8.gf8(), ref_gf8.gf8()
    for name in ("exp", "log", "mul_table", "inv_table"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_scalar_ops_match(w):
    rng = np.random.default_rng(w)
    for x, y in rng.integers(1, 1 << min(w, 31), (64, 2)):
        x, y = int(x), int(y)
        assert gf8.gf_mul(x, y, w) == ref_gf8.gf_mul(x, y, w)
        assert gf8.gf_div(x, y, w) == ref_gf8.gf_div(x, y, w)
        assert gf8.gf_inv(x, w) == ref_gf8.gf_inv(x, w)


@pytest.mark.parametrize("n,w", [(3, 8), (8, 8), (11, 8), (4, 16)])
def test_invert_and_matmul_match(n, w):
    rng = np.random.default_rng(100 + n)
    for _ in range(4):
        mat = rng.integers(0, 1 << w, (n, n))
        ours = matrix.gf_gaussian_inverse(mat, w)
        ref = ref_matrix.gf_gaussian_inverse(mat, w)
        assert (ours is None) == (ref is None)
        if ref is not None:
            assert np.array_equal(ours, ref)
            assert np.array_equal(matrix.gf_invert_matrix(mat, w),
                                  ref_matrix.gf_invert_matrix(mat, w))
        b = rng.integers(0, 1 << w, (n, 3))
        assert np.array_equal(matrix.gf_matmul(mat, b, w),
                              ref_matrix.gf_matmul(mat, b, w))
        assert matrix.gf_rank(mat, w) == ref_matrix.gf_rank(mat, w)


def test_bitmatrix_helpers_match():
    rng = np.random.default_rng(5)
    for e in rng.integers(0, 256, 16):
        assert np.array_equal(bitmatrix.value_to_bitmatrix(int(e)),
                              ref_bm.value_to_bitmatrix(int(e)))
        assert bitmatrix.cauchy_n_ones(int(e)) == ref_bm.cauchy_n_ones(int(e))
    mat = rng.integers(0, 256, (3, 5))
    assert np.array_equal(bitmatrix.matrix_to_bitmatrix(5, 3, 8, mat),
                          ref_bm.matrix_to_bitmatrix(5, 3, 8, mat))
    assert np.array_equal(bitmatrix.cauchy_n_ones_all(8),
                          ref_bm.cauchy_n_ones_all(8))
    for _ in range(4):
        sq = rng.integers(0, 2, (12, 12)).astype(np.uint8)
        ours, ref = bitmatrix.gf2_invert(sq), ref_bm.gf2_invert(sq)
        assert (ours is None) == (ref is None)
        if ref is not None:
            assert np.array_equal(ours, ref)
        assert bitmatrix.gf2_rank(sq) == ref_bm.gf2_rank(sq)


@pytest.mark.parametrize("k,m,w", [(8, 3, 8), (4, 2, 8), (6, 3, 16),
                                   (10, 4, 32), (2, 1, 8)])
def test_jerasure_matrices_match(k, m, w):
    assert np.array_equal(jerasure.reed_sol_vandermonde_coding_matrix(k, m, w),
                          ref_jer.reed_sol_vandermonde_coding_matrix(k, m, w))
    assert np.array_equal(jerasure.reed_sol_r6_coding_matrix(k, w),
                          ref_jer.reed_sol_r6_coding_matrix(k, w))
    assert np.array_equal(jerasure.cauchy_original_coding_matrix(k, m, w),
                          ref_jer.cauchy_original_coding_matrix(k, m, w))
    if w <= 16:
        assert np.array_equal(
            jerasure.cauchy_good_general_coding_matrix(k, m, w),
            ref_jer.cauchy_good_general_coding_matrix(k, m, w))


def test_minimal_density_bitmatrices_match():
    assert np.array_equal(jerasure.liberation_coding_bitmatrix(5, 7),
                          ref_jer.liberation_coding_bitmatrix(5, 7))
    assert np.array_equal(jerasure.blaum_roth_coding_bitmatrix(4, 6),
                          ref_jer.blaum_roth_coding_bitmatrix(4, 6))
    assert np.array_equal(jerasure.liber8tion_coding_bitmatrix(6),
                          ref_jer.liber8tion_coding_bitmatrix(6))


@pytest.mark.parametrize("k,m", [(8, 3), (4, 2), (10, 4)])
def test_isal_matrices_match(k, m):
    assert np.array_equal(isal.gf_gen_rs_matrix(k + m, k),
                          ref_isal.gf_gen_rs_matrix(k + m, k))
    assert np.array_equal(isal.gf_gen_cauchy1_matrix(k + m, k),
                          ref_isal.gf_gen_cauchy1_matrix(k + m, k))


@pytest.mark.parametrize("w", [8, 16, 32])
def test_regionops_encode_and_decode_matrix_match(w):
    rng = np.random.default_rng(w + 7)
    k, m = 6, 3
    mat = jerasure.reed_sol_vandermonde_coding_matrix(k, m, w)
    data = rng.integers(0, 256, (2, k, 4096), dtype=np.uint8)
    words = regionops.words_view(data, w)
    assert np.array_equal(regionops.matrix_encode(words, mat, w),
                          ref_regionops.matrix_encode(words, mat, w))
    survivors = [0, 2, 3, 5, 6, 8]
    want = [1, 4, 7]
    assert np.array_equal(
        regionops.matrix_decode_matrix(mat, k, survivors, want, w),
        ref_regionops.matrix_decode_matrix(mat, k, survivors, want, w))


def test_regionops_bitmatrix_match():
    rng = np.random.default_rng(23)
    bm = jerasure.liberation_coding_bitmatrix(3, 5)
    data = rng.integers(0, 256, (2, 3, 5 * 16 * 4), dtype=np.uint8)
    assert np.array_equal(regionops.bitmatrix_encode(data, bm, 5, 16),
                          ref_regionops.bitmatrix_encode(data, bm, 5, 16))
    assert np.array_equal(
        regionops.bitmatrix_decode_matrix(bm, 3, 5, [1, 2, 3], [0]),
        ref_regionops.bitmatrix_decode_matrix(bm, 3, 5, [1, 2, 3], [0]))


# -- import hygiene -----------------------------------------------------------

def _port_sources():
    return sorted((ROOT / "ceph_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_neither_jax_nor_ceph_tpu():
    bad = []
    for path in _port_sources():
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "ceph_tpu"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_importing_port_loads_no_jax_or_ceph_tpu_module():
    """Every module of the package (``pkgutil.walk_packages``: new ones
    are guarded without a list to keep), and ``chip_smoke.py`` (whose
    imports are card-free at module level), imports neither jax nor the
    JAX package, directly or through another module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import ceph_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    ceph_tpu_torch.__path__, 'ceph_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "assert len(names) > 100, names\n"
        "for must in ('ceph_tpu_torch.parallel.plane', "
        "'ceph_tpu_torch.scrub.deep_scrub', "
        "'ceph_tpu_torch.recovery.orchestrator', "
        "'ceph_tpu_torch.chaos.hosts', 'ceph_tpu_torch.ops.supervisor', "
        "'ceph_tpu_torch.ops.fallback', 'ceph_tpu_torch.utils.locks', "
        "'ceph_tpu_torch.utils.shard', 'ceph_tpu_torch.analysis.audit', "
        "'ceph_tpu_torch.tools.autotune', 'ceph_tpu_torch.tune.sweep', "
        "'ceph_tpu_torch.telemetry.profiler', "
        "'ceph_tpu_torch.utils.compile_cache'):\n"
        "    assert must in names, must\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ceph_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
