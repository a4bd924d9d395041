"""Every cell, configuration, traffic mix and metric resolves by name;
BENCHMARK.json keeps to the benchmark's contract; a new cell and a new
metric take new files and new entries alone."""

import json
import re
import shutil

import pytest
import torch

from yardstick import harness, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmarks"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries_keep_to_the_contract():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmarks/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.cell(name)
    assert cell.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert hasattr(spec.kind(cell.traffic), "run")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["end_to_end"]
                                  + BENCH["per_layer"]])
def test_metric_reader_resolves(name):
    assert callable(spec.reader(name))


def test_a_new_cell_takes_new_files_alone(tmp_path, tiny):
    """A throwaway cell, traffic mix and per-layer metric, made from files
    and entries alone, run on the CPU."""
    shutil.copytree(spec.HERE, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("build_cache", "tests",
                                                  "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "rs_k8_m3.write_small",
                               "config": "rs_k8_m3", "traffic": "small",
                               "chips": 1, "why": "a throwaway cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "write_gbps":
            m["workloads"].append("rs_k8_m3.write_small")
    bench["per_layer"].append({
        "name": "issue_share.write", "unit": "%", "better": "lower",
        "source": "host_clock", "layer": "codec entry",
        "moves": "write_gbps", "workloads": ["rs_k8_m3.write_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((spec.HERE / "traffic" / "write_hbm.json")
                         .read_text())
    traffic.update(in_flight=2, slabs=3)
    (tmp_path / "benchmarks" / "traffic" / "small.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmarks" / "metrics" / "issue_share.write.py"
     ).write_text(
        "def read(run):\n"
        "    return 100.0 * run.span_s('issue').sum() / (run.t1 - run.t0)\n")
    cell = tiny(spec.cell("rs_k8_m3.write_small", root=tmp_path,
                          here=tmp_path / "benchmarks"))
    cell.traffic["slabs"] = 3
    for trace in (False, True):
        _, line = harness.run_cell(cell, 3, 0.3, trace, torch.device("cpu"),
                                   0.0)
        assert line["correct"]
        want = {"issue_share.write"} if trace else \
            {"write_gbps", "setup_s"}
        assert want <= set(line["metrics"])
