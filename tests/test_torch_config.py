"""The port's typed options (``ceph_tpu_torch.utils.config``) against the
reference's (``ceph_tpu.utils.config``), and the kernel build cache
(``ceph_tpu_torch.utils.compile_cache`` with ``ops/_build.py``), on the
CPU.

- every option: the same name, type, default and bounds; the layering
  default < ``CEPH_TPU_<NAME>`` < explicit set gives the same values and
  the same errors in both packages; ``utils/log.py`` reads ``log_level``
  through it, as the reference's does;
- the build cache: ``CEPH_TPU_COMPILE_CACHE`` moves the build directory;
  a first build into it misses and runs nvcc (a stand-in script), a
  second build — another process's or another checkout's — hits and
  runs none; unset, the build stays in the package's ``ops/build/``.
"""

from __future__ import annotations

import pytest

from ceph_tpu.utils import config as ref_config
from ceph_tpu.utils import log as ref_log
from ceph_tpu_torch.utils import config as port_config
from ceph_tpu_torch.utils import log as port_log

NAMES = [o.name for o in ref_config.OPTIONS]

# per option: a valid env string, an out-of-range or unparseable one
VALUES = {
    "erasure_code_dir": ("/opt/ec", None),
    "ec_min_device_bytes": ("4096", "-1"),
    "crush_bulk_tries": ("16", "65"),
    "debug_verify": ("yes", "maybe"),
    "log_level": ("5", "21"),
    "compile_cache": ("/tmp/cache", None),
}


def test_options_are_the_reference_s():
    assert [o.name for o in port_config.OPTIONS] == NAMES
    for p, r in zip(port_config.OPTIONS, ref_config.OPTIONS):
        assert (p.type, p.default, p.minimum, p.maximum) == \
            (r.type, r.default, r.minimum, r.maximum), p.name
    desc = {o.name: o.desc for o in port_config.OPTIONS}
    assert "kernel build cache" in desc["compile_cache"]


@pytest.mark.parametrize("name", NAMES)
def test_layering_equals_the_reference(monkeypatch, name):
    """default < CEPH_TPU_<NAME> < explicit set, the same values and the
    same errors in both packages."""
    env = f"CEPH_TPU_{name.upper()}"
    good, bad = VALUES[name]
    monkeypatch.delenv(env, raising=False)
    cfgs = (port_config.Config(), ref_config.Config())
    default = cfgs[1].get(name)
    assert cfgs[0].get(name) == default
    monkeypatch.setenv(env, good)
    got = [c.get(name) for c in cfgs]
    assert got[0] == got[1] != default
    if bad is not None:
        monkeypatch.setenv(env, bad)
        errs = []
        for c in cfgs:
            with pytest.raises(ValueError) as e:
                c.get(name)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
        for c in cfgs:
            with pytest.raises(ValueError):
                c.set(name, bad)
    for c in cfgs:
        c.set(name, good)
    monkeypatch.setenv(env, bad if bad is not None else "/elsewhere")
    assert cfgs[0].get(name) == cfgs[1].get(name) == got[0]
    assert cfgs[0].dump() == cfgs[1].dump()
    for c in cfgs:
        with pytest.raises(KeyError):
            c.get("no_such_option")
        with pytest.raises(KeyError):
            c.set("no_such_option", 1)


def test_log_level_reads_the_option(monkeypatch):
    monkeypatch.delenv("CEPH_TPU_LOG_LEVEL", raising=False)
    assert port_log._default_level() == ref_log._default_level() == 1
    monkeypatch.setenv("CEPH_TPU_LOG_LEVEL", "7")
    assert port_log._default_level() == ref_log._default_level() == 7
    assert port_log.get_level("no-such-subsys") == 7
    assert isinstance(port_config.global_config(), port_config.Config)


# -- the kernel build cache -------------------------------------------------

@pytest.fixture
def fake_toolchain(monkeypatch, tmp_path):
    """One kernel source and a stand-in nvcc that logs each run and
    writes its -o file; the package's default build directory moved to
    a temporary one."""
    from ceph_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// k\n")
    runs, nvcc = tmp_path / "runs", tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    f'echo "$2" >> {runs}\necho lib > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "pkg_build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "build_log", {})

    def nvcc_runs() -> int:
        return len(runs.read_text().split()) if runs.exists() else 0
    return _build, nvcc_runs


def _counts():
    from ceph_tpu_torch.telemetry import metrics as tel
    from ceph_tpu_torch.utils import compile_cache as cc
    reg = tel.global_metrics()
    return reg.counter_value(cc.HITS), reg.counter_value(cc.MISSES)


def test_build_cache_dir_misses_then_hits(monkeypatch, tmp_path,
                                          fake_toolchain):
    from ceph_tpu_torch.utils import compile_cache as cc
    _build, nvcc_runs = fake_toolchain
    cache = tmp_path / "cache"
    monkeypatch.setenv(cc.ENV_KNOB, str(cache))
    assert cc.compile_cache_dir() == str(cache)
    assert cc.cache_entries() == 0
    h0, m0 = _counts()
    lib = _build.build(["k"])["k"]
    assert lib.parent == cache and lib.read_text() == "lib\n"
    assert nvcc_runs() == 1 and _counts() == (h0, m0 + 1)
    assert cc.cache_entries() == cc.cache_entries(str(cache)) == 1
    # a second process (a fresh build log) or a second checkout (another
    # package build directory) with the same sources: a hit, no nvcc
    monkeypatch.setattr(_build, "build_log", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "other_checkout")
    assert _build.build(["k"])["k"] == lib
    assert nvcc_runs() == 1 and _build.build_log == {}
    assert _counts() == (h0 + 1, m0 + 1)
    assert not (tmp_path / "other_checkout").exists()


def test_build_without_the_knob_stays_in_the_package(monkeypatch,
                                                     tmp_path,
                                                     fake_toolchain):
    from ceph_tpu_torch.utils import compile_cache as cc
    _build, nvcc_runs = fake_toolchain
    monkeypatch.delenv(cc.ENV_KNOB, raising=False)
    assert cc.compile_cache_dir() is None and cc.cache_entries() == 0
    lib = _build.build(["k"])["k"]
    assert lib.parent == tmp_path / "pkg_build" == _build.build_dir()
    # the option set in-process moves it too
    port_config.global_config().set("compile_cache", str(tmp_path / "opt"))
    try:
        assert _build.build_dir() == tmp_path / "opt"
        assert _build.build(["k"])["k"].parent == tmp_path / "opt"
        assert nvcc_runs() == 2
    finally:
        port_config.global_config()._values.pop("compile_cache")
    assert _build.build_dir() == tmp_path / "pkg_build"
