"""The port's ``crushtool`` and ``osdmaptool`` CLIs
(``ceph_tpu_torch.bench``) against the reference's
(``ceph_tpu.bench``) on the same argv: the printed text, letter for
letter, and the files they write.  The port runs with ``--device cpu``,
the reference with its own default (its bulk engine is a jitted XLA
program on the CPU).  Only the timing figures are masked: the
mappings/s of ``TestResult.report`` and osdmaptool's "pgs in …s (…
pgs/s"; every count, mapping and upmap entry must be equal.  Without a
card, ``--device cuda`` (the default) raises NoDeviceError.
"""

from __future__ import annotations

import json
import re

import pytest
import torch

from ceph_tpu.bench import crushtool as ref_crushtool
from ceph_tpu.bench import osdmaptool as ref_osdmaptool
from ceph_tpu_torch.bench import crushtool, osdmaptool
from ceph_tpu_torch.utils.errors import NoDeviceError

from test_torch_crush import PORT, gen_map

_TIMING = [(re.compile(r"[\d,]+ mappings/s"), "N mappings/s"),
           (re.compile(r"pgs in [\d.]+s \(\d+ pgs/s"), "pgs in Ts (N pgs/s")]


def mask(text: str) -> str:
    for pat, rep in _TIMING:
        text = pat.sub(rep, text)
    return text


def run(capsys, tool, argv, files=()):
    """(stdout, the files' contents) of one CLI run."""
    capsys.readouterr()
    assert tool.main(argv) == 0
    out = capsys.readouterr().out
    return mask(out), [open(f, "rb").read() for f in files]


def same(capsys, port_tool, ref_tool, argv, files=(), device=True):
    """Run the reference, then the port (``--device cpu``) on ``argv``;
    the outputs and written files must be equal."""
    want = run(capsys, ref_tool, argv, files)
    got = run(capsys, port_tool, argv + (["--device", "cpu"] if device
                                         else []), files)
    assert got == want
    return got[0]


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    """A crushtool text map with choose_args and every algorithm."""
    d = tmp_path_factory.mktemp("maps")
    cmap, _, _, ca = gen_map(PORT, 3, bulk_ok=True)
    cmap.choose_args["bal"] = ca
    path = d / "gen3.txt"
    path.write_text(PORT.text_compiler.decompile_text(cmap))
    return {"gen3": str(path), "dir": d}


def test_crushtool_test_statistics_mappings_utilization(capsys):
    out = same(capsys, crushtool, ref_crushtool, [
        "--build-two-level", "8", "4", "--test", "--rule", "0",
        "--num-rep", "3", "--max-x", "511", "--show-statistics",
        "--show-mappings", "--show-utilization", "--weight", "3", "0.5",
        "--weight", "9", "0"])
    assert "CRUSH rule 0 x 511 [" in out and "bad mappings: 0" in out


def test_crushtool_ec_rule_and_choose_args(capsys, maps):
    same(capsys, crushtool, ref_crushtool, [
        "-i", maps["gen3"], "--test", "--rule", "5", "--num-rep", "6",
        "--max-x", "255", "--show-statistics", "--choose-args", "bal"])


def test_crushtool_host_engine(capsys, maps):
    same(capsys, crushtool, ref_crushtool, [
        "-i", maps["gen3"], "--test", "--rule", "3", "--num-rep", "4",
        "--min-x", "100", "--max-x", "227", "--show-mappings",
        "--engine", "host"])


@pytest.mark.parametrize("fmt", ["txt", "json", "bin"])
def test_crushtool_edits_and_forms(capsys, maps, fmt):
    out = str(maps["dir"] / f"edited.{fmt}")
    same(capsys, crushtool, ref_crushtool, [
        "-i", maps["gen3"], "--add-item", "99", "1.5", "osd.99", "--loc",
        "host", "bucket2", "--reweight-item", "osd.2", "0.25",
        "--remove-item", "osd.4", "-o", out], files=[out], device=False)
    same(capsys, crushtool, ref_crushtool, ["-d", out], device=False)


def test_crushtool_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--build-two-level", "4", "2", "--test", "--max-x", "9"]
    with pytest.raises(NoDeviceError):
        crushtool.main(argv)
    with pytest.raises(NoDeviceError):
        crushtool.main(argv + ["--device", "cuda"])
    assert crushtool.main(argv + ["--engine", "host"]) == 0


@pytest.fixture
def osdmap_file(tmp_path, capsys):
    """osdmaptool --createsimple 12, with override layers added."""
    path = tmp_path / "m.json"
    same(capsys, osdmaptool, ref_osdmaptool, [
        "--createsimple", "12", "-o", str(path), "--pg-num", "96"],
        files=[str(path)], device=False)
    spec = json.loads(path.read_text())
    spec["pools"].append({"pool_id": 2, "pg_num": 64, "size": 3,
                          "crush_rule": 0})
    spec.update({"osd_weight": {"3": 0.5}, "osd_down": [7],
                 "osd_out": [9], "primary_affinity": {"2": 0.25},
                 "pg_upmap_items": {"1.5": [[3, 10]]}})
    path.write_text(json.dumps(spec))
    return path


def test_osdmaptool_print_and_test_map_pgs(capsys, osdmap_file):
    out = same(capsys, osdmaptool, ref_osdmaptool, [
        str(osdmap_file), "--print", "--test-map-pgs"])
    assert "pool 2 'replicated'" in out and "engine=bulk" in out
    same(capsys, osdmaptool, ref_osdmaptool, [
        str(osdmap_file), "--test-map-pgs", "--pool", "2", "--engine",
        "host"])


def test_osdmaptool_upmap(capsys, osdmap_file):
    out_path = str(osdmap_file.parent / "upmap.txt")
    out = same(capsys, osdmaptool, ref_osdmaptool, [
        str(osdmap_file), "--upmap", out_path, "--upmap-max", "20",
        "--upmap-deviation", "0.5"], files=[out_path])
    assert "pg-upmap-items commands" in out


def test_osdmaptool_create_ec_pool(capsys, osdmap_file):
    out_path = str(osdmap_file.parent / "ec.json")
    argv = [str(osdmap_file), "--create-ec-pool", "ecp", "--pg-num", "32",
            "-o", out_path, "--print"]
    for kv in ("plugin=jerasure", "technique=reed_sol_van", "k=4", "m=2",
               "crush-failure-domain=host", "crush-root=root"):
        argv += ["--ec-profile", kv]
    same(capsys, osdmaptool, ref_osdmaptool, argv, files=[out_path])
    same(capsys, osdmaptool, ref_osdmaptool, [
        out_path, "--test-map-pgs", "--pool", "3", "--engine", "host"])


def test_osdmaptool_default_device_without_a_card_raises(
        monkeypatch, osdmap_file):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        osdmaptool.main([str(osdmap_file), "--test-map-pgs"])
    assert osdmaptool.main([str(osdmap_file), "--test-map-pgs",
                            "--device", "cpu"]) == 0
