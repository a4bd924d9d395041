"""plugin=cuda, the native bridge onto the port (ceph_tpu_torch/native),
on the CPU.

The port's builder (``python -m ceph_tpu_torch.native.build``, plain
``c++``) builds the registry, the AVX2 ``rs`` plugin, ``libec_cuda.so``
and the tools once for the session; an unmodified C++ consumer
(``ceph_erasure_code``, ``ceph_erasure_code_benchmark``, ``bridge_mt``)
then selects ``plugin=cuda`` by name with ``-P device=cpu``:

- corpus parity: the committed chunks of RS k=4 m=2, shec k=6 m=3 c=2
  and RS k=8 m=3, byte for byte;
- a seeded 1 MiB RS k=8 m=3 payload (the port's torch tier, not the
  host rule) against ``ceph_tpu``'s encode in-process, tolerance 0;
- decodes of 1- and 2-erasure patterns, data and parity, restore the
  content (every pattern in the ``slow`` sweep);
- ``bridge_mt``: init on the main thread, round trips from two more,
  under a timeout, and the port's counters read in the same process;
- ``CEPH_TPU_BRIDGE_STATS``: the plugin's own entry timing, per op,
  with a decode's first use of an erasure pattern counted apart;
- ``CEPH_TPU_PYROOT`` with quotes and spaces;
- no card: without ``device=cpu`` the tools exit non-zero naming
  ``NoDeviceError``; ``device=tpu`` fails with the ValueError text;
- no source under ceph_tpu_torch/native/ names jax or the JAX package;
- the bench line's baseline: the port's builder's AVX2 ``rs`` tool.
"""

import itertools
import json
import os
import re
import subprocess
import sysconfig
from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu_torch.native import build as native_build

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "tests" / "corpus"
RS83 = ["-P", "backend=jerasure", "-P", "technique=reed_sol_van",
        "-P", "k=8", "-P", "m=3"]
BRIDGE_CORPUS = [
    ("jerasure__k=4__m=2__technique=reed_sol_van", 6,
     ["-P", "backend=jerasure", "-P", "technique=reed_sol_van",
      "-P", "k=4", "-P", "m=2"]),
    ("shec__c=2__k=6__m=3", 9,
     ["-P", "backend=shec", "-P", "k=6", "-P", "m=3", "-P", "c=2"]),
    ("jerasure__k=8__m=3__technique=reed_sol_van", 11, RS83),
]
CPU = ["-P", "device=cpu"]


def _run(cmd, env=None, timeout=300):
    return subprocess.run([str(c) for c in cmd], capture_output=True,
                          text=True, timeout=timeout, env=env)


@pytest.fixture(scope="session")
def built():
    return native_build.build()


def _encode(built, params, content, outdir, env=None):
    r = _run([built["ceph_erasure_code"], "encode", "--plugin", "cuda",
              *params, "--input", content, "--output-dir", outdir,
              "-d", built["libec_cuda.so"].parent], env=env)
    assert r.returncode == 0, f"encode failed:\n{r.stdout}\n{r.stderr}"
    return r


def _decode(built, params, indir, out, size):
    return _run([built["ceph_erasure_code"], "decode", "--plugin", "cuda",
                 *params, "--input-dir", indir, "--output", out,
                 "--size", size, "-d", built["libec_cuda.so"].parent])


def _chunks(d, n):
    return [(Path(d) / f"chunk.{i}").read_bytes() for i in range(n)]


# ----------------------------------------------------------------------
# the build

def test_builder_makes_every_output(built):
    assert set(built) == set(native_build.OUTPUTS)
    for name, path in built.items():
        assert path.exists() and path.parent == native_build.BUILD_DIR, name
    assert (native_build.BUILD_DIR / ".stamp").read_text() \
        == native_build.source_hash()


def test_builder_reuses_an_up_to_date_build(built):
    before = {n: p.stat().st_mtime_ns for n, p in built.items()}
    again = native_build.build()
    assert {n: p.stat().st_mtime_ns for n, p in again.items()} == before


def test_builder_needs_a_shared_libpython(monkeypatch, tmp_path):
    real = sysconfig.get_config_var
    monkeypatch.setattr(sysconfig, "get_config_var", lambda k: str(
        tmp_path) if k in ("LIBDIR", "LIBPL") else real(k))
    with pytest.raises(native_build.NativeBuildError, match="libpython"):
        native_build.python_flags()


def test_plugin_keeps_the_native_abi_version(built):
    data = built["libec_cuda.so"].read_bytes()
    assert b"ceph_tpu 0.1\x00" in data
    assert b"ceph_tpu_torch 0.1" not in data


# ----------------------------------------------------------------------
# corpus parity and the reference's encode

@pytest.mark.parametrize("cdir,n,params", BRIDGE_CORPUS)
def test_bridge_chunks_match_corpus(built, tmp_path, cdir, n, params):
    src = CORPUS / cdir
    _encode(built, params + CPU, src / "content", tmp_path)
    for i, got in enumerate(_chunks(tmp_path, n)):
        assert got == (src / str(i)).read_bytes(), f"{cdir} chunk {i}"


def test_bridge_1mib_rs_encode_equals_reference(built, tmp_path):
    """A seeded 1 MiB stripe: chunks of 128 KiB, so the port's torch
    tier runs (min_xla_bytes), against ceph_tpu's encode."""
    from ceph_tpu.codes.registry import ErasureCodePluginRegistry

    payload = np.random.default_rng(17).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    content = tmp_path / "content"
    content.write_bytes(payload)
    out = tmp_path / "out"
    out.mkdir()
    r = _encode(built, RS83 + CPU, content, out)
    assert r.stdout.split()[0] == str(1 << 17)
    ref = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"})
    want = ref.encode(set(range(11)), payload)
    got = _chunks(out, 11)
    for i in range(11):
        assert got[i] == want[i], f"chunk {i}"


# ----------------------------------------------------------------------
# decode

def _stage(tmp_path, src, n, erased):
    d = tmp_path / "-".join(str(i) for i in sorted(erased))
    d.mkdir()
    for i in set(range(n)) - set(erased):
        (d / f"chunk.{i}").write_bytes((src / str(i)).read_bytes())
    return d


@pytest.mark.parametrize("erased", [(0,), (9,), (3, 10), (0, 7)])
def test_bridge_decode_restores_content(built, tmp_path, erased):
    src = CORPUS / "jerasure__k=8__m=3__technique=reed_sol_van"
    size = json.loads((src / "manifest.json").read_text())["size"]
    d = _stage(tmp_path, src, 11, erased)
    r = _decode(built, RS83 + CPU, d, d / "restored", size)
    assert r.returncode == 0, r.stderr
    assert (d / "restored").read_bytes() == (src / "content").read_bytes()


@pytest.mark.slow
@pytest.mark.parametrize("cdir,n,k,params,pyprofile", [
    ("jerasure__k=4__m=2__technique=reed_sol_van", 6, 4,
     BRIDGE_CORPUS[0][2], ("jerasure", {"technique": "reed_sol_van",
                                        "k": "4", "m": "2"})),
    ("shec__c=2__k=6__m=3", 9, 6, BRIDGE_CORPUS[1][2],
     ("shec", {"k": "6", "m": "3", "c": "2"})),
])
def test_bridge_exhaustive_erasures(built, tmp_path, cdir, n, k, params,
                                    pyprofile):
    """Every 1- and 2-erasure pattern through plugin=cuda (the port's
    counterpart of test_native.py's sweep through plugin=tpu); patterns
    the code cannot decode (shec) are skipped by its own
    minimum_to_decode."""
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry

    ec = ErasureCodePluginRegistry.instance().factory(
        pyprofile[0], dict(pyprofile[1]), device="cpu")
    src = CORPUS / cdir
    size = json.loads((src / "manifest.json").read_text())["size"]
    patterns = [c for e in (1, 2)
                for c in itertools.combinations(range(n), e)]
    ran = 0
    for pat in patterns:
        try:
            ec.minimum_to_decode(set(range(k)), set(range(n)) - set(pat))
        except IOError:
            continue
        d = _stage(tmp_path, src, n, pat)
        r = _decode(built, params + CPU, d, d / "restored", size)
        assert r.returncode == 0, f"{cdir} {pat}: {r.stderr}"
        assert (d / "restored").read_bytes() \
            == (src / "content").read_bytes(), f"{cdir} {pat}"
        ran += 1
    assert ran >= len(patterns) * 2 // 3, (ran, len(patterns))


# ----------------------------------------------------------------------
# threads, the interpreter's bootstrap, no card

def test_bridge_multithreaded_round_trip(built):
    """Init on the main thread, round trips from two others, then the
    init thread again (a GIL deadlock turns into the timeout); the
    counter line read through the plugin's interpreter shows the torch
    tier ran (1 MiB stripes), on the CPU without a kernel launch."""
    r = _run([built["bridge_mt"], built["bridge_mt"].parent, "cpu"],
             timeout=300)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    lines = r.stdout.strip().splitlines()
    assert lines[-2] == "bridge multithreaded round-trip OK"
    counters = json.loads(lines[-1])
    assert counters["ec_device_calls"] == 12       # 3 threads x 2 x 2
    assert counters["ec_host_calls"] == 0
    assert "apply_matrix_cuda" in counters["launches"]
    assert sum(counters["launches"].values()) == 0
    # the plugin's entry timing is off without CEPH_TPU_BRIDGE_STATS
    assert counters["bridge"]["encode"] == dict.fromkeys(
        ("calls", "first", "first_ns", "gil_ns", "in_ns", "call_ns",
         "out_ns"), 0)


@pytest.mark.parametrize("erasures", [["-e", "2"],
                                      ["--erased", "0", "--erased", "9"]])
def test_bridge_stats_time_each_entry(built, tmp_path, erasures):
    """With CEPH_TPU_BRIDGE_STATS the instance's destruction appends one
    line: the benchmark's decodes (and the one encode before them) with
    their GIL, copy-in, port-call and copy-out ns inside the tool's
    run, a fixed pattern's first use counted once, and the port's
    counters read in that process."""
    stats = tmp_path / "stats.jsonl"
    iters = 12
    r = _run([built["ceph_erasure_code_benchmark"], "-p", "cuda", *RS83,
              *CPU, "-s", str(1 << 20), "-w", "decode", *erasures,
              "-i", str(iters), "-d", built["libec_cuda.so"].parent],
             env=dict(os.environ, CEPH_TPU_BRIDGE_STATS=str(stats)))
    assert r.returncode == 0, r.stderr
    elapsed = float(r.stdout.split()[0])
    line = json.loads(stats.read_text())
    enc, dec = line["bridge"]["encode"], line["bridge"]["decode"]
    assert enc["calls"] == enc["first"] == 1
    assert dec["calls"] == iters
    patterns = 1 if "--erased" in erasures else None
    assert 1 <= dec["first"] <= (patterns or iters)
    segs = sum(dec[f"{s}_ns"] for s in ("gil", "in", "call", "out"))
    assert 0 < dec["first_ns"] <= segs <= elapsed * 1e9
    assert dec["call_ns"] > dec["in_ns"] > 0 and dec["out_ns"] > 0
    assert line["port"]["ec_device_calls"] == iters + 1
    assert line["port"]["ec_host_calls"] == 0
    assert line["port"]["kernel_setups"] == 0


def test_bridge_pyroot_with_quotes_and_spaces(built, tmp_path):
    weird = tmp_path / "py root's \" \\ ~ dir"
    weird.mkdir()
    os.symlink(ROOT / "ceph_tpu_torch", weird / "ceph_tpu_torch")
    env = dict(os.environ, CEPH_TPU_PYROOT=str(weird))
    src = CORPUS / "jerasure__k=4__m=2__technique=reed_sol_van"
    out = tmp_path / "out"
    out.mkdir()
    _encode(built, BRIDGE_CORPUS[0][2] + CPU, src / "content", out, env=env)
    assert (out / "chunk.4").read_bytes() == (src / "4").read_bytes()


def test_bridge_without_a_card_fails_loudly(built, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    src = CORPUS / "jerasure__k=4__m=2__technique=reed_sol_van"
    for tool in ("ceph_erasure_code", "ceph_erasure_code_benchmark"):
        cmd = [built[tool]]
        cmd += (["encode", "--plugin", "cuda", "--input", src / "content",
                 "--output-dir", tmp_path] if tool == "ceph_erasure_code"
                else ["-p", "cuda", "-s", "4096"])
        r = _run(cmd + ["-P", "k=4", "-P", "m=2",
                        "-d", built["libec_cuda.so"].parent])
        assert r.returncode != 0, tool
        assert "NoDeviceError" in r.stderr, r.stderr
    r = _run([built["bridge_mt"], built["bridge_mt"].parent, "cuda"])
    assert r.returncode != 0 and "NoDeviceError" in r.stderr


def test_bridge_rejects_an_unknown_device(built, tmp_path):
    src = CORPUS / "jerasure__k=4__m=2__technique=reed_sol_van"
    for dev in ("tpu", "cuda:x", "cuda:"):
        r = _run([built["ceph_erasure_code"], "encode", "--plugin", "cuda",
                  "-P", "k=4", "-P", "m=2", "-P", f"device={dev}",
                  "--input", src / "content", "--output-dir", tmp_path,
                  "-d", built["libec_cuda.so"].parent])
        assert r.returncode != 0
        assert f"ValueError: device {dev} is neither cuda nor cpu" \
            in r.stderr


def test_benchmark_tool_drives_the_bridge(built):
    """ceph_erasure_code_benchmark, unmodified, on plugin=cuda and
    plugin=rs at the north star's shape (one iteration each)."""
    for plugin, extra in (("cuda", RS83 + CPU), ("rs", ["-P", "k=8",
                                                      "-P", "m=3"])):
        for workload in (["-w", "encode"], ["-w", "decode", "-e", "2"]):
            r = _run([built["ceph_erasure_code_benchmark"], "-p", plugin,
                      *extra, *workload, "-s", str(1 << 20), "-i", "2",
                      "-d", built["libec_cuda.so"].parent])
            assert r.returncode == 0, r.stderr
            elapsed, kib = r.stdout.split()
            assert float(elapsed) > 0 and int(kib) == 2048


def test_native_sources_name_neither_jax_nor_the_jax_package():
    pattern = re.compile(r"\bjax\b|\bceph_tpu\.")
    files = [p for p in (ROOT / "ceph_tpu_torch" / "native").rglob("*")
             if p.suffix in (".cc", ".h", ".py")]
    assert len(files) >= 4
    for path in files:
        text = path.read_text()
        assert not pattern.search(text), path
    plugin = (ROOT / "ceph_tpu_torch/native/plugins/cuda.cc").read_text()
    assert 'PyImport_ImportModule("ceph_tpu_torch.codes.registry")' \
        in plugin


# ----------------------------------------------------------------------
# the bench line's baseline

def test_bench_line_baseline_is_the_port_build(built):
    from ceph_tpu_torch.bench import bench_line

    path, why = bench_line.baseline_bench()
    assert path == str(built["ceph_erasure_code_benchmark"]) and why == ""
    gbps, src = bench_line.native_baseline()
    assert gbps > 0
    assert src == ("cpp-rs-avx2 (measured live, ceph_tpu_torch/native/"
                   "build/ceph_erasure_code_benchmark)")


# ----------------------------------------------------------------------
# the launch counters under the bridge's threads

def _wrapper_call(name, ms):
    from ceph_tpu_torch.ops import gf_kernels as g
    meta = "meta"
    if name == "apply_matrix_cuda":
        return lambda: g.apply_matrix_cuda(
            torch.empty((4, 3, 64), dtype=torch.uint8, device=meta), ms)
    if name == "apply_matrix_cuda_packed":
        return lambda: g.apply_matrix_cuda_packed(torch.empty(
            (4, 3, 1, 128), dtype=torch.int32, device=meta).view(
                torch.uint32), ms)
    if name == "apply_matrix_cuda_words":
        return lambda: g.apply_matrix_cuda_words(
            torch.empty((4, 3, 64), dtype=torch.uint16, device=meta), ms, 16)
    mask = torch.ones(4, dtype=torch.bool, device=meta)
    if name == "apply_matrix_cuda_ragged":
        return lambda: g.apply_matrix_cuda_ragged(
            torch.empty((4, 3, 64), dtype=torch.uint8, device=meta), ms,
            mask)
    return lambda: g.apply_matrix_cuda_packed_ragged(torch.empty(
        (4, 3, 1, 128), dtype=torch.int32, device=meta).view(torch.uint32),
        ms, mask)


@pytest.mark.parametrize("name", [
    "apply_matrix_cuda", "apply_matrix_cuda_packed",
    "apply_matrix_cuda_words", "apply_matrix_cuda_ragged",
    "apply_matrix_cuda_packed_ragged"])
def test_launch_count_keeps_a_concurrent_launch(monkeypatch, name):
    """The kernel launch releases the GIL (ctypes); a launch another
    thread counts meanwhile must survive this wrapper's count (bridge_mt
    on the card lost 2 of 12 when the count was read before the
    launch).  Meta tensors stand in for CUDA tensors; the launch is
    faked."""
    from ceph_tpu_torch.ops import gf_kernels as g
    from ceph_tpu_torch.ops.torch_ops import matrix_to_static

    fn = getattr(g, name)

    def launch(*args, **kwargs):
        fn.launches += 1          # another thread's launch, counted
        return 1

    monkeypatch.setattr(g, "_check_cuda", lambda x: None)
    monkeypatch.setattr(g, "_launch", launch)
    monkeypatch.setattr(fn, "launches", 0)
    call = _wrapper_call(name, matrix_to_static(np.array([[1, 2, 3],
                                                          [4, 5, 6]])))
    call()
    assert fn.launches == 2
