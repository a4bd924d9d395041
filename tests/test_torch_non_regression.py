"""The port's non-regression checker (``ceph_tpu_torch.bench.
non_regression``) over the committed corpus, held to the reference's
``ceph_tpu.bench.non_regression``: every entry checks clean with the
port's codes on the CPU, a tampered copy gives the reference's error
strings, the composite-decode cost guard gives the reference's lists,
and ``create`` writes byte-equal files."""

import json
import os
import shutil

import pytest

from ceph_tpu.bench import non_regression as ref
from ceph_tpu_torch.bench import non_regression as port

CORPUS = os.path.join(os.path.dirname(__file__), "corpus")
DIRS = port.corpus_dirs(CORPUS)


def test_corpus_and_matrix_equal_the_reference():
    assert port.corpus_dirs(CORPUS) == ref.corpus_dirs(CORPUS)
    assert len(DIRS) == 20
    assert port.STANDARD_MATRIX == ref.STANDARD_MATRIX
    assert (port.DEFAULT_SIZE, port.COMPOSITE_DECODE_MAX_RATIO,
            port.XOR_PLAN_MAX_OPS_PER_COL) == (
        ref.DEFAULT_SIZE, ref.COMPOSITE_DECODE_MAX_RATIO,
        ref.XOR_PLAN_MAX_OPS_PER_COL)
    for plugin, profile in port.STANDARD_MATRIX:
        assert port.profile_dir_name(plugin, profile) == \
            ref.profile_dir_name(plugin, profile)


@pytest.mark.parametrize("dirpath", DIRS,
                         ids=[os.path.basename(d) for d in DIRS])
def test_check_is_clean(dirpath):
    """All five sections, the port's codes on the CPU."""
    errors = port.check(dirpath, device="cpu")
    assert not errors, "\n".join(errors)


def _tamper(tmp_path, name, what):
    d = tmp_path / "tampered"
    shutil.copytree(os.path.join(CORPUS, name), d)
    with open(d / "manifest.json") as f:
        n_chunks = len(json.load(f)["chunk_sha256"])
    target = {"parity": d / str(n_chunks - 1), "data": d / "1",
              "content": d / "content"}[what]
    raw = bytearray(target.read_bytes())
    raw[7] ^= 0x5A
    target.write_bytes(bytes(raw))
    return str(d)


@pytest.mark.parametrize("name,what", [
    ("jerasure__k=4__m=2__technique=reed_sol_van", "parity"),
    ("jerasure__k=4__m=2__technique=reed_sol_van", "data"),
    ("jerasure__k=4__m=2__technique=reed_sol_van", "content"),
    ("shec__c=2__k=4__m=3", "parity"),
    ("clay__d=5__k=4__m=2", "data"),
    ("jerasure__k=8__m=3__packetsize=32__technique=cauchy_good", "parity"),
])
def test_tampered_copy_gives_the_reference_errors(tmp_path, name, what):
    """A flipped byte in a parity chunk, a data chunk or the payload
    turns the check red with the reference's error strings, line for
    line."""
    d = _tamper(tmp_path, name, what)
    got = port.check(d, device="cpu")
    assert got
    assert got == ref.check(d)
    if what == "parity":
        assert any("re-encode differs" in e for e in got)


@pytest.mark.parametrize("name", [
    "shec__c=2__k=4__m=3", "shec__c=2__k=6__m=3", "clay__d=5__k=4__m=2",
    "clay__d=11__k=8__m=4", "lrc__k=4__l=3__m=2"])
@pytest.mark.parametrize("ratio,ops", [(None, None), (0.5, 0.2)])
def test_composite_decode_guard_equals_the_reference(monkeypatch, name,
                                                     ratio, ops):
    """Section 5 as the reference computes it: clean at the committed
    ratchets, and the same error strings when both ratchets are
    tightened until they trip."""
    with open(os.path.join(CORPUS, name, "manifest.json")) as f:
        manifest = json.load(f)
    if ratio is not None:
        for mod in (port, ref):
            monkeypatch.setattr(mod, "COMPOSITE_DECODE_MAX_RATIO", ratio)
            monkeypatch.setattr(mod, "XOR_PLAN_MAX_OPS_PER_COL", ops)
    d = os.path.join(CORPUS, name)
    plugin, profile = manifest["plugin"], manifest["profile"]
    got = port.composite_decode_guard(
        d, plugin, port._factory(plugin, profile, device="cpu"))
    want = ref.composite_decode_guard(d, plugin,
                                      ref._factory(plugin, profile))
    assert got == want
    assert bool(got) == (ratio is not None)


@pytest.mark.parametrize("idx", range(len(ref.STANDARD_MATRIX)))
def test_create_writes_byte_equal_files(tmp_path, idx):
    plugin, profile = ref.STANDARD_MATRIX[idx]
    a = port.create(plugin, profile, str(tmp_path / "port"), device="cpu")
    b = ref.create(plugin, profile, str(tmp_path / "ref"))
    assert os.path.basename(a) == os.path.basename(b)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for f in names:
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f
    # and the committed corpus holds the same bytes
    committed = os.path.join(CORPUS, os.path.basename(a))
    for f in names:
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(committed, f), "rb") as fc:
            assert fa.read() == fc.read(), f


def test_cli_check_and_create(tmp_path, capsys):
    """--check over a copy of two entries (one tampered) and --create of
    one profile, through main with --device cpu."""
    base = tmp_path / "corpus"
    base.mkdir()
    for name in ("isa__k=4__m=2__technique=reed_sol_van", "example"):
        shutil.copytree(os.path.join(CORPUS, name), base / name)
    assert port.main(["--base-dir", str(base), "--check",
                      "--device", "cpu"]) == 0
    assert "ok example" in capsys.readouterr().out
    raw = bytearray((base / "example" / "0").read_bytes())
    raw[0] ^= 1
    (base / "example" / "0").write_bytes(bytes(raw))
    assert port.main(["--base-dir", str(base), "--check",
                      "--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert "FAIL example" in out.out and "example" in out.err
    new = tmp_path / "new"
    assert port.main(["--base-dir", str(new), "--create", "--plugin",
                      "jerasure", "-P", "technique=reed_sol_van", "-P",
                      "k=4", "-P", "m=2", "--device", "cpu"]) == 0
    name = "jerasure__k=4__m=2__technique=reed_sol_van"
    assert sorted(os.listdir(new / name)) == sorted(
        os.listdir(os.path.join(CORPUS, name)))
    with pytest.raises(SystemExit):
        port.main(["--base-dir", str(new)])
