"""The CUDA CRUSH rule kernel's host side (ceph_tpu_torch/ops/crush_kernels.py
and ``CompiledCrushMap.kernel_tables``), on the CPU:

- the scope: straw2 maps with one take, one choose step of each form and
  an emit take the kernel; legacy bucket algorithms below the take,
  chained steps, a second take or emit, non-jewel tunables or rule steps,
  a result wider than a warp do not;
- the flattened tables against the compiled map's padded ones;
- the wrapper's rows on CPU tensors (the host mapper's answers in the
  kernel's result form: NONE padding, counts, nothing flagged) against
  the reference package's mapper (``ceph_tpu.crush.mapper``, over the
  map decoded from the port's binary encoding): chooseleaf / choose,
  indep / firstn, reweights and downs, NONE holes, weight ties,
  choose_args positions and ids, x near 2^32, a three-level map, the
  remap cell's map;
- ``bulk_do_rule``: a CPU map takes the eager tier (no tables, no
  launch, no count), and the kernel's first rung (forced onto the CPU,
  where the wrapper answers with the host mapper) gives the reference's
  answers and notes ``kernel_lanes`` under ``crush.rung``;
- importing the modules builds and loads nothing.

The kernel itself, held to the host mapper lane for lane, runs in
tests/test_torch_cuda.py and in chip_smoke.py's phase 6.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ceph_tpu.crush.binary as ref_binary
import ceph_tpu.crush.mapper as ref_mapper
import ceph_tpu.crush.types as ref_types
from ceph_tpu_torch.crush import binary as port_binary
from ceph_tpu_torch.crush import bulk
from ceph_tpu_torch.crush.builder import CrushBuilder
from ceph_tpu_torch.crush.types import (
    ChooseArg, Tunables, step_choose_firstn, step_choose_indep,
    step_chooseleaf_firstn, step_chooseleaf_indep, step_emit,
    step_set_choose_tries, step_set_chooseleaf_tries, step_take)
from ceph_tpu_torch.ops import crush_kernels as ck
from ceph_tpu_torch.telemetry import spans

ROOT = Path(__file__).resolve().parents[1]
NONE = 0x7FFFFFFF

STEPS = {
    "chooseleaf_indep": lambda root: [step_take(root),
                                      step_chooseleaf_indep(0, 1),
                                      step_emit()],
    "chooseleaf_firstn": lambda root: [step_take(root),
                                       step_chooseleaf_firstn(0, 1),
                                       step_emit()],
    "choose_indep": lambda root: [step_take(root), step_choose_indep(0, 1),
                                  step_emit()],
    "choose_firstn": lambda root: [step_take(root),
                                   step_choose_firstn(0, 1), step_emit()],
    "choose_indep_dev": lambda root: [step_take(root),
                                      step_choose_indep(0, 0), step_emit()],
    "choose_firstn_dev": lambda root: [step_take(root),
                                       step_choose_firstn(0, 0),
                                       step_emit()],
    "firstn_6_wide": lambda root: [step_take(root),
                                   step_chooseleaf_firstn(6, 1),
                                   step_emit()],
    "indep_6_wide": lambda root: [step_take(root),
                                  step_chooseleaf_indep(6, 1), step_emit()],
    "ec_canonical": lambda root: [step_set_chooseleaf_tries(5),
                                  step_set_choose_tries(100),
                                  step_take(root),
                                  step_chooseleaf_indep(0, 1), step_emit()],
}


def _map(hosts=6, devs=3, shape="chooseleaf_indep", alg="straw2",
         tunables=None):
    b = CrushBuilder(tunables=tunables)
    root = b.build_two_level(hosts, devs, alg=alg)
    b.add_rule(0, STEPS[shape](root))
    return b


def _three_level(seed: int):
    """root -> racks -> hosts -> osds, straw2, uneven sizes and weights
    (some 0); rule 0 chooseleaf_firstn 0 type host, rule 1 the EC rule
    over hosts, rule 2 choose_indep 0 type rack."""
    rng = np.random.default_rng(seed)
    b = CrushBuilder()
    b.add_type(1, "host")
    b.add_type(2, "rack")
    b.add_type(3, "root")
    dev, racks = 0, []
    for _ in range(3):
        hosts = []
        for _ in range(int(rng.integers(2, 5))):
            n = int(rng.integers(1, 5))
            w = [0 if rng.random() < 0.1 else int(rng.integers(0x4000,
                                                               0x30000))
                 for _ in range(n)]
            w[0] = w[0] or 0x10000
            hosts.append(b.add_bucket("straw2", "host",
                                      list(range(dev, dev + n)), w))
            dev += n
        racks.append(b.add_bucket("straw2", "rack", hosts))
    root = b.add_bucket("straw2", "root", racks)
    b.add_rule(0, [step_take(root), step_chooseleaf_firstn(0, 1),
                   step_emit()])
    b.add_rule(1, STEPS["ec_canonical"](root))
    b.add_rule(2, [step_take(root), step_choose_indep(0, 2), step_emit()])
    return b


def _weights(cmap, seed: int, downs: int = 2, reweights: int = 3):
    rng = np.random.default_rng(seed)
    w = cmap.device_weights()
    picks = rng.choice(len(w), min(len(w), downs + reweights),
                       replace=False)
    for o in picks[:downs]:
        w[o] = 0
    for o in picks[downs:]:
        w[o] = int(rng.integers(0x8000, 0x10000))
    return w


def _ref(cmap, rule, xs, rmax, weight=None, choose_args=None):
    """The reference package's rows (padded with NONE) and counts, over
    the map decoded from the port's binary encoding."""
    ref_map = ref_binary.decode_map(port_binary.encode_map(cmap))
    ref_args = None if choose_args is None else {
        bid: ref_types.ChooseArg(weight_set=a.weight_set, ids=a.ids)
        for bid, a in choose_args.items()}
    rows = [ref_mapper.crush_do_rule(ref_map, rule, int(x), rmax,
                                     weight=weight, choose_args=ref_args)
            for x in xs]
    return (np.asarray([r + [NONE] * (rmax - len(r)) for r in rows],
                       np.int32),
            np.asarray([len(r) for r in rows], np.int64))


def _wrapper(cm, rule, xs, rmax, weight):
    kr = ck.kernel_rule(cm, rule, rmax)
    assert kr is not None
    out, cnt, need = ck.crush_rule_cuda(
        cm.kernel_tables(), kr, torch.as_tensor(np.asarray(xs, np.int64)),
        torch.as_tensor(np.asarray(weight, np.int64)))
    assert out.dtype == torch.int32 and cnt.dtype == torch.int64
    assert not need.any()
    return out.numpy(), cnt.numpy()


# -- the scope ---------------------------------------------------------------

@pytest.mark.parametrize("shape,rmax,want", [
    ("chooseleaf_indep", 4, dict(recurse=True, firstn=False, type=1,
                                 numrep=4, slots=4, tries=51,
                                 leaf_tries=1)),
    ("chooseleaf_firstn", 3, dict(recurse=True, firstn=True, numrep=3,
                                  slots=3)),
    ("choose_indep", 5, dict(recurse=False, firstn=False, numrep=5)),
    ("choose_firstn", 2, dict(recurse=False, firstn=True)),
    ("choose_firstn_dev", 3, dict(type=0)),
    ("ec_canonical", 11, dict(tries=100, leaf_tries=5, numrep=11,
                              slots=11)),
    ("ec_canonical", 32, dict(slots=32)),
])
def test_scope_takes_straw2_maps(shape, rmax, want):
    b = _map(shape=shape)
    cm = bulk.CompiledCrushMap(b.map, device="cpu")
    kr = ck.kernel_rule(cm, 0, rmax)
    assert kr is not None
    assert kr.take_row == cm.row_of_id[min(b.map.buckets)]
    assert kr.max_devices == b.map.max_devices and kr.result_max == rmax
    for k, v in want.items():
        assert getattr(kr, k) == v, k
    assert ck.kernel_rule(cm, 0, rmax) is kr        # once per rule


def _refuse_alg(alg):
    return _map(alg=alg)


def _refuse_steps(steps):
    b = _map()
    root = min(b.map.buckets)
    b.map.rules[0].steps = steps(root, b)
    return b


def _refuse_bucket(field, value):
    b = _map()
    host = max(b.map.buckets)
    if field == "weight":
        b.map.buckets[host].item_weights[0] = value
    else:
        setattr(b.map.buckets[host], field, value)
    return b


REFUSED = {
    "weight_beyond_u32": lambda: _refuse_bucket("weight", 1 << 32),
    "bucket_of_type_0": lambda: _refuse_bucket("type", 0),
    "uniform": lambda: _refuse_alg("uniform"),
    "list": lambda: _refuse_alg("list"),
    "tree": lambda: _refuse_alg("tree"),
    "straw": lambda: _refuse_alg("straw"),
    "legacy_tunables": lambda: _map(tunables=Tunables.legacy()),
    "vary_r_0": lambda: _map(tunables=Tunables(chooseleaf_vary_r=0)),
    "stable_0": lambda: _map(tunables=Tunables(chooseleaf_stable=0)),
    "chained": lambda: _refuse_steps(lambda r, b: [
        step_take(r), step_choose_indep(2, 1),
        step_chooseleaf_indep(1, 0), step_emit()]),
    "two_takes": lambda: _refuse_steps(lambda r, b: [
        step_take(r), step_chooseleaf_indep(2, 1), step_emit(),
        step_take(r), step_chooseleaf_indep(2, 1), step_emit()]),
    "no_emit": lambda: _refuse_steps(lambda r, b: [
        step_take(r), step_chooseleaf_indep(2, 1)]),
    "device_take": lambda: _refuse_steps(lambda r, b: [
        step_take(0), step_choose_firstn(1, 0), step_emit()]),
    "local_tries_step": lambda: _refuse_steps(lambda r, b: [
        (10, 2, 0), step_take(r), step_chooseleaf_firstn(0, 1),
        step_emit()]),
    "vary_r_step": lambda: _refuse_steps(lambda r, b: [
        (12, 0, 0), step_take(r), step_chooseleaf_firstn(0, 1),
        step_emit()]),
    "numrep_below_zero": lambda: _refuse_steps(lambda r, b: [
        step_take(r), step_chooseleaf_indep(-40, 1), step_emit()]),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_scope_refuses_what_the_kernel_does_not_run(case):
    b = REFUSED[case]()
    cm = bulk.CompiledCrushMap(b.map, device="cpu")
    assert ck.kernel_rule(cm, 0, 6) is None


def test_scope_reads_only_the_takes_subtree():
    """A tree bucket beside the take's subtree keeps the kernel; one
    inside it does not; a result wider than a warp does not."""
    b = _map()
    b.add_bucket("tree", "host", [0, 1])
    cm = bulk.CompiledCrushMap(b.map, device="cpu")
    assert ck.kernel_rule(cm, 0, 6) is not None
    assert ck.kernel_rule(cm, 0, 33) is None
    b2 = CrushBuilder()
    b2.add_type(1, "host")
    b2.add_type(2, "root")
    hosts = [b2.add_bucket("straw2", "host", [0, 1]),
             b2.add_bucket("tree", "host", [2, 3])]
    root = b2.add_bucket("straw2", "root", hosts)
    b2.add_rule(0, STEPS["chooseleaf_indep"](root))
    assert ck.kernel_rule(bulk.CompiledCrushMap(b2.map, device="cpu"),
                          0, 2) is None


# -- the flattened tables ------------------------------------------------------

def _choose_args(cmap, seed, positions=2, ids=True):
    rng = np.random.default_rng(seed)
    args = {}
    for bid, bk in cmap.buckets.items():
        if rng.random() < 0.3:
            continue
        ws = [[int(w * rng.uniform(0.5, 1.5)) for w in bk.item_weights]
              for _ in range(int(rng.integers(1, positions + 1)))]
        args[bid] = ChooseArg(
            weight_set=ws,
            ids=[i + 1000 for i in bk.items] if ids and rng.random() < 0.5
            else None)
    return args


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_args", [False, True])
def test_kernel_tables_equal_the_compiled_maps(seed, with_args):
    b = _three_level(seed)
    args = _choose_args(b.map, seed, positions=3) if with_args else None
    cm = bulk.CompiledCrushMap(b.map, args, device="cpu")
    tabs = cm.kernel_tables()
    assert cm.kernel_tables() is tabs                 # once per map
    assert tabs.tab.dtype == torch.int32 and tabs.negln is cm.negln
    sec = tabs.sections()
    sizes = cm.sizes.numpy()
    hdr = sec["hdr"].numpy()
    assert tabs.rows == len(sizes) and tabs.positions == cm.n_positions
    assert tabs.items == sum(bk.size for bk in b.map.buckets.values())
    np.testing.assert_array_equal(hdr[:, 1], sizes)
    np.testing.assert_array_equal(hdr[:, 2], cm.types.numpy())
    np.testing.assert_array_equal(hdr[:, 0],
                                  np.cumsum(sizes) - sizes)
    np.testing.assert_array_equal(sec["id_row"].numpy(),
                                  cm.id_to_row.numpy())
    weights = sec["weights"].numpy().astype(np.int64) & 0xFFFFFFFF
    for row in range(tabs.rows):
        first, size = hdr[row, 0], hdr[row, 1]
        flat = slice(first, first + size)
        np.testing.assert_array_equal(sec["items"].numpy()[flat],
                                      cm.items.numpy()[row, :size])
        np.testing.assert_array_equal(sec["ids"].numpy()[flat],
                                      cm.hash_ids.numpy()[row, :size])
        np.testing.assert_array_equal(
            weights[:, flat], cm.pos_weights.numpy()[row, :, :size])


# -- the wrapper's rows against the reference mapper -------------------------

XS = np.concatenate([np.arange(24), (1 << 32) - 12 + np.arange(12),
                     [2 ** 31 - 1, 2 ** 31, 123456789]]).astype(np.int64)


@pytest.mark.parametrize("shape,hosts,devs,rmax", [
    ("chooseleaf_indep", 6, 3, 4),
    ("chooseleaf_firstn", 6, 3, 3),
    ("choose_indep", 6, 2, 5),
    ("choose_firstn", 5, 2, 3),
    ("choose_indep_dev", 4, 3, 5),
    ("choose_firstn_dev", 4, 3, 4),
    ("ec_canonical", 8, 4, 6),
    ("ec_canonical", 6, 2, 8),          # wider than the hosts: holes
    ("chooseleaf_firstn", 3, 2, 5),     # firstn short of its width
    ("firstn_6_wide", 6, 2, 3),         # numrep above result_max
    ("indep_6_wide", 6, 2, 3),
])
@pytest.mark.parametrize("reweight", [False, True])
def test_kernel_walk_equals_the_host_mapper(shape, hosts, devs, rmax,
                                            reweight):
    b = _map(hosts, devs, shape)
    w = _weights(b.map, hosts * devs) if reweight \
        else b.map.device_weights()
    cm = bulk.CompiledCrushMap(b.map, device="cpu")
    out, cnt = _wrapper(cm, 0, XS, rmax, w)
    want, want_n = _ref(b.map, 0, XS, rmax, w)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(cnt, want_n)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("rule,rmax", [(0, 3), (1, 6), (2, 3)])
def test_kernel_walk_on_three_levels_with_choose_args(seed, rule, rmax):
    b = _three_level(seed)
    args = _choose_args(b.map, seed)
    w = _weights(b.map, seed)
    cm = bulk.CompiledCrushMap(b.map, args, device="cpu")
    out, cnt = _wrapper(cm, rule, XS[:24], rmax, w)
    want, want_n = _ref(b.map, rule, XS[:24], rmax, w, args)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(cnt, want_n)


def test_kernel_walk_keeps_the_first_of_tied_draws():
    """Every draw of a bucket equal (choose_args ids alike, equal
    weights), then an all-zero weight set at the root: C keeps the first
    slot."""
    b = _map(4, 3, "chooseleaf_firstn")
    args = {bid: ChooseArg(weight_set=[[0x10000] * bk.size],
                           ids=[77] * bk.size)
            for bid, bk in b.map.buckets.items()}
    w = b.map.device_weights()
    for _ in range(2):
        cm = bulk.CompiledCrushMap(b.map, args, device="cpu")
        out, cnt = _wrapper(cm, 0, XS[:16], 3, w)
        want, want_n = _ref(b.map, 0, XS[:16], 3, w, args)
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(cnt, want_n)
        root = max(b.map.buckets, key=lambda bid: b.map.buckets[bid].type)
        args[root] = ChooseArg(weight_set=[[0] * 4])


def _cell_osdmap():
    sys.path.insert(0, str(ROOT / "benchmarks"))
    from yardstick.kinds.osdmap_churn import build
    with open(ROOT / "benchmarks" / "configs" / "rs_k8_m3.json") as f:
        config = json.load(f)
    return build(config, torch.device("cpu"))


def test_kernel_walk_on_the_remap_cells_map():
    """100 hosts x 12 OSDs, the EC rule 11 wide, 8 OSDs down and
    reweights in [0.5, 1.0], x the pool's pps seeds."""
    osdmap, pid = _cell_osdmap()
    pool = osdmap.pools[pid]
    w = _weights(osdmap.crush, 23, downs=8, reweights=40)
    cm = osdmap._compiled_map()
    xs = np.asarray(pool.pps_all(), np.int64)[::1024]
    out, cnt = _wrapper(cm, pool.crush_rule, xs, pool.size, w)
    want, want_n = _ref(osdmap.crush, pool.crush_rule, xs, pool.size, w)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(cnt, want_n)


# -- bulk_do_rule ----------------------------------------------------------------

def test_a_cpu_map_takes_the_eager_tier():
    b = _map(8, 4, "ec_canonical")
    cm = bulk.CompiledCrushMap(b.map, device="cpu")
    before = ck.crush_rule_cuda.launches
    tracer = spans.global_tracer()
    tracer.reset()
    with spans.armed(), spans.root("test.sweep"):
        out, cnt = bulk.bulk_do_rule(cm, 0, np.arange(64), 6)
    assert ck.crush_rule_cuda.launches == before
    assert "_kernel_tables" not in cm.__dict__
    assert bulk._rule_kernel(cm, 0, 6) is None
    counts = tracer.totals()["crush.rung"]["counts"]
    assert "kernel_lanes" not in counts
    want, want_n = _ref(b.map, 0, np.arange(64), 6)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(cnt, want_n)


@pytest.mark.parametrize("shape,rmax", [("ec_canonical", 6),
                                        ("chooseleaf_firstn", 3)])
def test_the_kernels_first_rung_gives_the_eager_tiers_answers(
        monkeypatch, shape, rmax):
    """The first rung through the kernel's wrapper (the host mapper, on
    the CPU): the reference's and the eager tier's mappings, no residue,
    and the lanes it placed noted under ``crush.rung``."""
    b = _map(8, 4, shape)
    w = _weights(b.map, 5)
    xs = np.arange(48) + (1 << 32) - 24
    eager = bulk.bulk_do_rule(b.map, 0, xs, rmax, weight=w, device="cpu")
    monkeypatch.setattr(bulk, "_rule_kernel", ck.kernel_rule)
    cm = bulk.CompiledCrushMap(b.map, device="cpu")
    tracer = spans.global_tracer()
    tracer.reset()
    with spans.armed(), spans.root("test.sweep"):
        out, cnt = bulk.bulk_do_rule(cm, 0, xs, rmax, weight=w)
    want, want_n = _ref(b.map, 0, xs, rmax, w)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(cnt, want_n)
    np.testing.assert_array_equal(out, eager[0])
    np.testing.assert_array_equal(cnt, eager[1])
    assert cm.last_residue.size == 0 and cm.last_flagged.size == 0
    assert "_kernel_tables" in cm.__dict__
    counts = tracer.totals()["crush.rung"]["counts"]
    assert counts["kernel_lanes"] == len(xs)
    assert counts["kernel_flagged"] == 0


def test_importing_builds_and_loads_nothing():
    code = (
        "import ceph_tpu_torch.crush.bulk, ceph_tpu_torch.crush.osdmap\n"
        "from ceph_tpu_torch.ops import _build, crush_kernels, launches\n"
        "assert _build._libs == {} and crush_kernels._lib_state is None\n"
        "assert launches.launch_counts()['crush_rule_cuda'] == 0\n"
        "assert _build._libs == {}\n"
        "print('OK')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr
