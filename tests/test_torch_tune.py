"""The port's autotuner (``ceph_tpu_torch.tune``) against the reference's
(``ceph_tpu.tune``), on the CPU.

- the space: the reference's kinds, defaults and candidate order, minus
  ``row-tile``, with the port's tier names (``pallas`` -> ``cuda``,
  ``xla`` -> ``torch``), and the defaults equal to the live constants;
- the table: key, hash, digest and profile strings equal on seeded
  inputs; ``validate_table`` gives the same errors on the same
  documents; save/load, the staleness guard (torch / CUDA / card), the
  scoped install and the generation;
- the analytic sweep: the reference's entries and rows for seeds 0, 17
  and 42 on the CPU model (row-tile and the env stamps aside);
- the consultation seams: under one table each returns the tuned value
  in both packages, with identical bytes; without one, the defaults;
- the ``matrix-engine`` pin routes as the reference's under the tier map,
  on CPU tensors and with the card's tier forced;
- the timed sweep on a CPU device.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from ceph_tpu.tune import space as ref_space
from ceph_tpu.tune import sweep as ref_sweep
from ceph_tpu.tune import table as ref_table
from ceph_tpu_torch.tune import space as port_space
from ceph_tpu_torch.tune import sweep as port_sweep
from ceph_tpu_torch.tune import table as port_table

TIER = {"pallas": "cuda", "xla": "torch"}


def canon(x) -> str:
    return json.dumps(x, sort_keys=True)


def tiers(x):
    """A reference value with its tier names in the port's (as values
    and inside series names), tuples as lists."""
    return json.loads(json.dumps(x).replace('"pallas"', '"cuda"')
                      .replace('"xla"', '"torch"')
                      .replace("engine=pallas", "engine=cuda")
                      .replace("engine=xla", "engine=torch"))


@pytest.fixture(autouse=True)
def no_table():
    """Every case starts and ends with no table installed in either
    package."""
    port_table.install_table(None)
    ref_table.install_table(None)
    yield
    port_table.install_table(None)
    ref_table.install_table(None)


# -- the space -------------------------------------------------------------

def test_space_is_the_reference_minus_row_tile():
    assert port_space.kinds() == [k for k in ref_space.kinds()
                                  if k != "row-tile"]
    for kind in port_space.kinds():
        assert tiers(port_space.space(kind)) == \
            tiers(ref_space.space(kind))
        assert tiers(list(port_space.candidates(kind))) == \
            tiers(list(ref_space.candidates(kind)))
        assert port_space.n_candidates(kind) == ref_space.n_candidates(kind)
        assert port_space.default_config(kind) == \
            ref_space.default_config(kind)
    assert port_space.space("matrix-engine")["engine"] == (
        "xor", "mxu", "cuda", "torch")
    with pytest.raises(KeyError):
        port_space.space("row-tile")


def test_defaults_are_the_live_constants():
    from ceph_tpu_torch.ops import gf_kernels, xor_schedule
    from ceph_tpu_torch.serve import batcher, pool
    d = port_space.DEFAULTS
    assert d["engine-select"] == {
        "mxu_matrix_min": gf_kernels.MXU_MATRIX_MIN,
        "xor_cutover": xor_schedule.XOR_DENSE_CUTOVER}
    assert d["xor-schedule"]["cse_topk"] == xor_schedule.CSE_TOPK
    assert d["serve-ladder"]["ladder"] == batcher.LADDER
    assert d["stripe-pool"] == {"page_size": pool.DEFAULT_PAGE_SIZE,
                                "pool_pages": pool.DEFAULT_POOL_PAGES}
    assert d["ragged-cutover"]["min_pages"] == gf_kernels.RAGGED_MIN_PAGES


# -- the table -------------------------------------------------------------

def test_key_strings_equal_the_reference():
    rng = np.random.default_rng(3)
    for _ in range(20):
        args = ("jerasure:k=%d" % rng.integers(2, 9), "serve-encode",
                str(rng.choice(["*", "device"])), "bytes",
                int(rng.integers(1, 9)), int(rng.integers(0, 64)))
        pk, rk = port_table.tuning_key(*args), ref_table.tuning_key(*args)
        assert pk == rk
        assert port_table.key_str(pk) == ref_table.key_str(rk)
        assert port_table.key_hash(pk) == ref_table.key_hash(rk)
        assert port_table.parse_key(port_table.key_str(pk)) == pk
        m = tuple(tuple(int(v) for v in row)
                  for row in rng.integers(0, 256, (3, 5)))
        assert port_table.matrix_digest(m) == ref_table.matrix_digest(m)
        prof = {"k": str(rng.integers(2, 9)), "technique": "cauchy_good",
                "m": "2"}
        assert port_table.profile_str("jerasure", prof) == \
            ref_table.profile_str("jerasure", prof)
    with pytest.raises(ValueError):
        port_table.tuning_key()
    # a StaticMatrix digests as its tuple
    from ceph_tpu_torch.ops.torch_ops import matrix_to_static
    sm = matrix_to_static(np.arange(6).reshape(2, 3))
    assert port_table.matrix_digest(sm) == \
        ref_table.matrix_digest(((0, 1, 2), (3, 4, 5)))


def _docs():
    env = {f: 1 for f in set(port_table.ENV_FIELDS)
           | set(ref_table.ENV_FIELDS)}
    good = {"config": {"cse_topk": 64}, "env": env, "mode": "analytic"}
    k = "*|xor-schedule|*|*|1|0"
    return [
        [], "x", {}, {"table_schema_version": 2, "entries": {}},
        {"table_schema_version": 1, "entries": []},
        {"table_schema_version": 1, "entries": {k: good}},
        {"table_schema_version": 1, "entries": {"a|b": good}},
        {"table_schema_version": 1, "entries": {"a|b|c|d|x|0": good}},
        {"table_schema_version": 1, "entries": {k: 3}},
        {"table_schema_version": 1, "entries": {k: {**good, "config": 1}}},
        {"table_schema_version": 1, "entries": {k: {**good, "env": None}}},
        {"table_schema_version": 1, "entries": {k: {**good, "mode": "x"}}},
    ]


def test_validate_table_gives_the_reference_errors():
    for doc in _docs():
        assert port_table.validate_table(doc) == \
            ref_table.validate_table(doc), doc
    # a missing env field names the port's own fields
    doc = {"table_schema_version": 1, "entries": {
        "*|xor-schedule|*|*|1|0": {"config": {}, "env": {},
                                   "mode": "timed"}}}
    errs = port_table.validate_table(doc)
    assert [e.split("env missing ")[1] for e in errs] == \
        list(port_table.ENV_FIELDS)
    assert port_table.ENV_FIELDS == (
        "platform", "device_count", "torch_version", "cuda_version",
        "device_name", "table_schema_version")


def test_table_round_trip_staleness_scope_and_generation(tmp_path):
    from ceph_tpu_torch.telemetry import metrics as tel
    assert not torch.cuda.is_initialized() or torch.cuda.is_available()
    env = port_table.current_env()
    assert env["platform"] == "cpu" and env["device_name"] is None
    assert env["torch_version"] == torch.__version__
    assert env["cuda_version"] == torch.version.cuda
    t = port_table.BestConfigTable()
    key = port_table.tuning_key("*", "xor-schedule", "*", "*", 1, 0)
    t.set(key, {"cse_topk": 64}, mode="analytic", score=1.0,
          baseline_score=2.0, baseline_config={"cse_topk": 128})
    path = str(tmp_path / "t.json")
    t.save(path)
    back = port_table.BestConfigTable.load(path)
    assert back.to_json() == t.to_json()
    assert back.content_hash() == t.content_hash() is not None
    assert back.lookup(key) == {"cse_topk": 64}
    # another card: ignored, counted, evented once
    blob = t.to_dict()
    blob["entries"][port_table.key_str(key)]["env"]["device_name"] = "B"
    stale = port_table.BestConfigTable.from_dict(blob)
    before = tel.global_metrics().counter_value("tune_config_stale")
    assert stale.lookup(key) is None and stale.lookup(key) is None
    assert tel.global_metrics().counter_value("tune_config_stale") == \
        before + 2
    # scoped install, generation, restore
    g = port_table.generation()
    assert port_table.active_source() == ("default", None)
    with port_table.scoped_table(back):
        assert port_table.generation() == g + 1
        assert port_table.active_source() == ("tuned",
                                              back.content_hash())
        assert port_table.consult("xor-schedule") == {"cse_topk": 64}
    assert port_table.active_table() is None
    assert port_table.consult("xor-schedule") is None
    with pytest.raises(ValueError):
        port_table.BestConfigTable.from_dict({"entries": {}})


def test_env_knob_loads_a_table_in_a_child(tmp_path):
    """CEPH_TPU_TUNE_TABLE in a second process: the table is active and
    a seam consults it; a broken file is counted, and the defaults run."""
    import os
    import subprocess
    import sys
    rep = port_sweep.analytic_sweep(seed=0, platform="cpu",
                                    device_count=1)
    path = tmp_path / "t.json"
    rep.table.save(str(path))
    code = ("from ceph_tpu_torch.tune.table import active_source\n"
            "from ceph_tpu_torch.serve.batcher import tuned_ladder\n"
            "print(active_source()[0], tuned_ladder())\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root,
               CEPH_TPU_TUNE_TABLE=str(path))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    want = tuple(rep.table.entries["*|serve-ladder|*|*|1|0"]["config"][
        "ladder"])
    assert out.stdout.split("\n")[0] == f"tuned {want}", out.stderr
    (tmp_path / "bad.json").write_text("{")
    env["CEPH_TPU_TUNE_TABLE"] = str(tmp_path / "bad.json")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split("\n")[0] == "default (1, 4, 16, 64)"


# -- the analytic sweep ----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 17, 42])
def test_analytic_sweep_equals_the_reference(seed):
    port = port_sweep.analytic_sweep(seed=seed, platform="cpu",
                                     device_count=1).to_dict()
    ref = ref_sweep.analytic_sweep(seed=seed, platform="cpu",
                                   device_count=1).to_dict()

    def entries(d):
        out = {}
        for k, v in d["table"]["entries"].items():
            if "|row-tile|" not in k:
                out[k] = {f: x for f, x in v.items() if f != "env"}
        return out
    assert entries(port) == tiers(entries(ref))
    assert port["rows"] == tiers([r for r in ref["rows"]
                                  if r["kind"] != "row-tile"])
    assert sorted(port["attribution"], key=canon) == \
        sorted(tiers(ref["attribution"]), key=canon)
    assert port["tuned_keys"] == [k for k in ref["tuned_keys"]
                                  if "|row-tile|" not in k]
    assert port["table_valid"] and port["mode"] == "analytic"
    stamp = next(iter(port["table"]["entries"].values()))["env"]
    assert stamp["platform"] == "cpu" and "jax_version" not in stamp


def test_analytic_sweep_on_the_card_model():
    """The "cuda" model prices every tier the card runs at its kernel's
    measured share and stamps the card the model describes; the torch
    tier is not a candidate there."""
    rep = port_sweep.analytic_sweep(seed=0, platform="cuda",
                                    device_count=1)
    engines = {r["before"]["engine"] for r in rep.rows
               if r["kind"] == "matrix-engine"} | {
        r["after"]["engine"] for r in rep.rows
        if r["kind"] == "matrix-engine"}
    assert engines <= {"xor", "mxu", "cuda"} and "cuda" in engines
    for e in rep.table.entries.values():
        assert e["env"]["platform"] == "cuda"
        assert e["env"]["device_name"] == "NVIDIA H100 80GB HBM3"
    assert port_sweep.VPU_BYTE_GOPS["cpu"] == \
        ref_sweep.VPU_BYTE_GOPS["cpu"]
    assert port_sweep.MXU_BYTE_GOPS["cpu"] == \
        ref_sweep.MXU_BYTE_GOPS["cpu"]
    assert "tpu" not in port_sweep.VPU_BYTE_GOPS


def test_tune_sweep_selftest_equals_the_reference():
    port = port_sweep.tune_sweep_selftest()
    ref = ref_sweep.tune_sweep_selftest()
    assert port["rows"] == tiers([r for r in ref["rows"]
                                  if r["kind"] != "row-tile"])


# -- the consultation seams ------------------------------------------------

SEAM_CONFIGS = {
    "xor-schedule": {"cse_topk": 64},
    "engine-select": {"mxu_matrix_min": 1024, "xor_cutover": [7, 8]},
    "serve-ladder": {"ladder": [1, 8, 64]},
    "stripe-pool": {"page_size": 1024, "pool_pages": 32},
    "ragged-cutover": {"min_pages": 8},
}


def _install(mod, configs, device_count=1):
    t = mod.BestConfigTable()
    for kind, cfg in configs.items():
        t.set(mod.tuning_key("*", kind, "mesh" if kind == "mesh-fanout"
                             else "*", "*", device_count, 0),
              cfg, mode="analytic")
    return mod.scoped_table(t)


def _seam_values(ops, xs, batcher, pool, plane):
    return {"cse_topk": xs.tuned_cse_topk(),
            "xor_cutover": tuple(xs.tuned_xor_cutover()),
            "mxu_min": ops.mxu_matrix_min(),
            "ragged": ops.tuned_ragged_cutover(),
            "ladder": tuple(batcher.tuned_ladder()),
            "pool": tuple(pool.tuned_pool_config()),
            "fanout": plane.tuned_fanout()}


def test_seams_return_the_tuned_values_in_both_packages():
    from ceph_tpu.ops import pallas_gf as r_ops
    from ceph_tpu.ops import xor_schedule as r_xs
    from ceph_tpu.parallel import plane as r_plane
    from ceph_tpu.serve import batcher as r_batcher
    from ceph_tpu.serve import pool as r_pool
    from ceph_tpu_torch.ops import gf_kernels as p_ops
    from ceph_tpu_torch.ops import xor_schedule as p_xs
    from ceph_tpu_torch.parallel import plane as p_plane
    from ceph_tpu_torch.serve import batcher as p_batcher
    from ceph_tpu_torch.serve import pool as p_pool
    port_default = _seam_values(p_ops, p_xs, p_batcher, p_pool, p_plane)
    assert port_default == _seam_values(r_ops, r_xs, r_batcher, r_pool,
                                        r_plane)
    assert port_default == {"cse_topk": 128, "xor_cutover": (3, 4),
                            "mxu_min": 2048, "ragged": 2,
                            "ladder": (1, 4, 16, 64), "pool": (512, 64),
                            "fanout": None}
    ref_dc = ref_table.current_env()["device_count"]
    with _install(port_table, SEAM_CONFIGS), \
            _install(ref_table, SEAM_CONFIGS, ref_dc):
        got = _seam_values(p_ops, p_xs, p_batcher, p_pool, p_plane)
        assert got == _seam_values(r_ops, r_xs, r_batcher, r_pool,
                                   r_plane)
    assert got == {"cse_topk": 64, "xor_cutover": (7, 8), "mxu_min": 1024,
                   "ragged": 8, "ladder": (1, 8, 64), "pool": (1024, 32),
                   "fanout": None}
    with _install(port_table, {"mesh-fanout": {"n_devices": 2}}):
        assert p_plane.tuned_fanout() == 2
    # a batcher built under the table takes its ladder and pool
    from ceph_tpu_torch.serve.batcher import ContinuousBatcher
    with _install(port_table, SEAM_CONFIGS):
        b = ContinuousBatcher(executor="host", paged=True)
    assert b.ladder == (1, 8, 64) and (b.page_size, b.pool_pages) == (
        1024, 32)


def test_tuned_seams_keep_the_bytes():
    """A tuned CSE horizon and cutover change op counts and routes, never
    bytes: shec and lrc decodes under the table equal the defaults' and
    the reference's."""
    from ceph_tpu.codes.registry import \
        ErasureCodePluginRegistry as RefRegistry
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops import xor_schedule as p_xs
    cases = [("shec", {"k": "4", "m": "3", "c": "2"}, (0, 5)),
             ("lrc", {"k": "4", "m": "2", "l": "3"}, (1,))]
    rng = np.random.default_rng(9)
    for plugin, profile, erased in cases:
        pec = ErasureCodePluginRegistry.instance().factory(
            plugin, dict(profile), device="cpu")
        rec = RefRegistry.instance().factory(plugin, dict(profile))
        n = pec.get_chunk_count()
        avail = tuple(i for i in range(n) if i not in erased)
        surv = rng.integers(0, 256, (2, len(avail), 2048), dtype=np.uint8)
        default = pec.decode_chunks_torch(torch.from_numpy(surv), avail,
                                          erased)
        cfg = {"xor-schedule": {"cse_topk": 64},
               "engine-select": {"mxu_matrix_min": 1024,
                                 "xor_cutover": [7, 8]}}
        with _install(port_table, cfg), _install(
                ref_table, cfg, ref_table.current_env()["device_count"]):
            assert p_xs.tuned_cse_topk() == 64
            tuned = pec.decode_chunks_torch(torch.from_numpy(surv), avail,
                                            erased)
            ref = np.asarray(rec.decode_chunks_jax(surv, avail, erased))
        assert torch.equal(tuned, default)
        assert np.array_equal(tuned.numpy(), ref)


def _pin_cases():
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops.torch_ops import matrix_to_static
    reg = ErasureCodePluginRegistry.instance()
    rs = reg.factory("jerasure", {"technique": "reed_sol_van", "k": "4",
                                  "m": "2"}, device="cpu")
    r6 = reg.factory("jerasure", {"technique": "reed_sol_r6_op", "k": "8",
                                  "m": "2"}, device="cpu")
    shec = reg.factory("shec", {"k": "4", "m": "3", "c": "2"}, device="cpu")
    avail = (1, 2, 3, 4, 6)
    plan = shec.tcache.get_plan(shec.matrix, shec.k, shec.w,
                                frozenset(avail), frozenset((0, 5)))
    return [matrix_to_static(rs.matrix), matrix_to_static(r6.matrix),
            shec._plan_static(plan)[1]]


@pytest.mark.parametrize("pin", ["xor", "mxu", "pallas", "xla"])
@pytest.mark.parametrize("card", [False, True])
def test_matrix_engine_pin_routes_as_the_reference(pin, card):
    """A per-matrix pin in both packages' tables: the port's table routes
    as the reference's under the tier map, on CPU tensors (the
    reference's CPU backend) and with the card's tier forced (the
    reference's pallas tier); an undispatchable pin falls back to the
    heuristic rows.  One deliberate difference: the reference's XLA tier
    runs on its TPU, the port's torch tier never on the card, so there a
    ``torch`` pin routes as no pin does."""
    from ceph_tpu.ops import pallas_gf
    from ceph_tpu_torch.ops import gf_kernels
    for ms in _pin_cases():
        shape = (4, len(ms[0]), 4096)
        for mod, p in ((port_table, TIER.get(pin, pin)),
                       (ref_table, pin)):
            t = mod.BestConfigTable()
            t.set(mod.tuning_key("m:" + mod.matrix_digest(ms),
                                 "matrix-engine", "*", "bytes", 1, 0),
                  {"engine": p}, mode="timed")
            mod.install_table(t)
        got = gf_kernels.select_matrix_engine(
            8, None, "cuda" if card else None, shape=shape, matrix_t=ms,
            mesh=0)
        if card and pin == "xla":
            ref_table.install_table(None)
        want = pallas_gf.select_matrix_engine(
            shape, ms, 8, engine="pallas" if card else None, mesh=0)
        assert got == TIER.get(want, want), (pin, card, ms)
        port_table.install_table(None)
        ref_table.install_table(None)


def test_matrix_engine_pin_changes_no_byte():
    """Pinned to each tier the CPU can run, an apply's bytes stay the
    default's."""
    from ceph_tpu_torch.ops.gf_kernels import apply_matrix_best
    rng = np.random.default_rng(2)
    for ms in _pin_cases():
        x = torch.from_numpy(rng.integers(0, 256, (3, len(ms[0]), 1024),
                                          dtype=np.uint8))
        want = apply_matrix_best(x, ms)
        for pin in ("xor", "torch", "mxu", "cuda"):
            t = port_table.BestConfigTable()
            t.set(port_table.tuning_key(
                "m:" + port_table.matrix_digest(ms), "matrix-engine", "*",
                "bytes", 1, 0), {"engine": pin}, mode="timed")
            with port_table.scoped_table(t):
                assert torch.equal(apply_matrix_best(x, ms), want), pin


# -- the timed sweep -------------------------------------------------------

def test_timed_sweep_on_a_cpu_device():
    rep = port_sweep.timed_sweep(
        "jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"},
        size=8192, batch=2, repeats=2, device="cpu")
    assert rep.mode == "timed" and rep.platform == "cpu"
    assert [r["name"] for r in rep.rows] == [
        "jerasure.encode_chunks_jax", "jerasure.decode_chunks_jax"]
    for r in rep.rows:
        assert list(r["candidates_ms"]) == ["torch"]
        assert r["before"]["engine"] == r["after"]["engine"] == "torch"
    assert len(rep.table) == 0
    phases = {(a["name"], a["phase"]) for a in rep.attribution}
    assert ("jerasure.encode_chunks_jax", "before") in phases
    assert port_table.validate_table(rep.table.to_dict()) == []


def test_timed_sweep_needs_a_card_by_default():
    from ceph_tpu_torch.utils.errors import NoDeviceError
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(NoDeviceError):
        port_sweep.timed_sweep()


def test_timed_sweep_asserts_byte_identity(monkeypatch):
    """A candidate tier whose bytes differ from the default tier's fails
    the sweep: here the card's candidate list on CPU tensors, the xor
    tier's output corrupted."""
    from ceph_tpu_torch.ops import gf_kernels
    real = gf_kernels._run_matrix_bytes

    def run(chunks, matrix_t, w, eng, mesh=None):
        out = real(chunks, matrix_t, w, "torch")
        return out ^ 1 if eng == "xor" else out
    monkeypatch.setattr(gf_kernels, "_run_matrix_bytes", run)
    monkeypatch.setattr(port_sweep, "candidate_tiers",
                        lambda matrix, chunk, platform: ["torch", "xor"])
    with pytest.raises(AssertionError, match="diverged"):
        port_sweep.timed_sweep(
            "jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"},
            size=8192, batch=2, repeats=2, device="cpu")
