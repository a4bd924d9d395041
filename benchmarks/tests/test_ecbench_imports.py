"""The benchmark loads neither JAX nor the JAX package, refuses to run
without a card, and fails where the program is absent."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from yardstick import harness, spec

RUN_TINY = r"""
import sys, time, json
sys.path[:0] = [{root!r}, {here!r}, {tests!r}]
import torch
from conftest import shrink
from yardstick import harness, spec
for name in [w["name"] for w in spec.load_benchmark()["workloads"]]:
    harness.run_cell(shrink(spec.cell(name)), 5, 0.2, name.endswith("map"),
                     torch.device("cpu"), time.perf_counter())
print(json.dumps(harness.forbidden_modules()))
"""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ceph_tpu_torch_extra", sys)
    assert "ceph_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ceph_tpu.x", sys)
    assert "ceph_tpu" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    here = str(spec.HERE)
    code = RUN_TINY.format(root=str(spec.ROOT), here=here,
                           tests=os.path.join(here, "tests"))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card arm cannot run here")
    out = subprocess.run(
        [sys.executable, str(spec.HERE / "run.py"), "--workload",
         "rs_k8_m3.write_hbm", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=spec.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_a_run_fails(tmp_path, tiny):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("build_cache",
                                                  "__pycache__"))
    code = (
        "import sys, torch\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, "
        f"{str(tmp_path / 'benchmarks')!r}, "
        f"{str(tmp_path / 'benchmarks' / 'tests')!r}]\n"
        "from conftest import shrink\n"
        "from yardstick import harness, spec\n"
        "harness.run_cell(shrink(spec.cell('rs_k8_m3.write_hbm')), 1, 0.1,"
        " False, torch.device('cpu'), 0.0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and "ceph_tpu_torch" in out.stderr
    assert out.stdout == ""
