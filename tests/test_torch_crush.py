"""CRUSH host modules of the port (``ceph_tpu_torch.crush``) against the
reference (``ceph_tpu.crush``): the rjenkins hash (numpy copy and the
torch twins over int32 bits) and crush_ln over edge values, the host
mapper on every bucket algorithm and against the independent C
transcription (tests/kat/crush_mapper_ref.c, compiled here), the golden
mappings (tests/golden/*.json), and the interchange forms (crushtool
text, JSON, binary wire form) read across the two packages.  Every
comparison is exact.

``gen_map`` (a randomized 3-level map, rules, reweights and choose_args
built through either package) is shared with tests/test_torch_crush_bulk.py.
"""

from __future__ import annotations

import importlib
import json
import os
import pathlib
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ceph_tpu.crush.hash as ref_hash
import ceph_tpu.crush.ln as ref_ln
import ceph_tpu.crush.mapper as ref_mapper
from ceph_tpu_torch.crush import hash as port_hash
from ceph_tpu_torch.crush import ln as port_ln
from ceph_tpu_torch.crush import mapper as port_mapper

TESTS = pathlib.Path(__file__).parent
NONE = 0x7FFFFFFF


def pkg(name: str) -> SimpleNamespace:
    """The crush modules of ``ceph_tpu`` or ``ceph_tpu_torch``."""
    mods = ("builder", "types", "mapper", "compiler", "text_compiler",
            "binary")
    return SimpleNamespace(**{m: importlib.import_module(
        f"{name}.crush.{m}") for m in mods})


REF, PORT = pkg("ceph_tpu"), pkg("ceph_tpu_torch")

# -- the hash and crush_ln ---------------------------------------------------

EDGES = np.array([0, 1, 2, 0x7FFF, 0xFFFF, 0x10000, 2 ** 31 - 1, 2 ** 31,
                  2 ** 31 + 1, 2 ** 32 - 2, 2 ** 32 - 1], dtype=np.int64)
IDS = np.array([-1, -2, -5, -100, -1200, -(2 ** 31)], dtype=np.int64)


def _operands(seed: int, arity: int):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([EDGES, IDS & 0xFFFFFFFF,
                           rng.integers(0, 2 ** 32, 4000)])
    return [np.roll(vals, 7 * i) for i in range(arity)]


@pytest.mark.parametrize("arity", [1, 2, 3, 4, 5])
def test_numpy_hash_copy_equals_reference(arity):
    name = "crush_hash32" if arity == 1 else f"crush_hash32_{arity}"
    args = [v.astype(np.uint32) for v in _operands(arity, arity)]
    np.testing.assert_array_equal(getattr(port_hash, name)(*args),
                                  getattr(ref_hash, name)(*args))
    # python ints (the host mapper's scalar calls), negative ids included
    for x in (0, 2 ** 31, 2 ** 32 - 1, -1, -(2 ** 31)):
        sc = [x] + [int(v) for v in IDS[:arity - 1]]
        assert int(getattr(port_hash, name)(*sc)) == \
            int(getattr(ref_hash, name)(*sc))


@pytest.mark.parametrize("arity", [2, 3, 4])
def test_torch_hash_equals_reference(arity):
    """The int32-bits twins against the reference's uint32 hash: x = 0,
    2^31, 2^32 - 1, negative bucket ids, values above 2^32 (masked as C
    reads them), random operands, broadcast shapes."""
    vals = _operands(10 + arity, arity)
    vals[1] = np.concatenate([IDS, vals[1][IDS.size:]])  # ids as int64
    vals[0] = vals[0] + (np.arange(vals[0].size) % 3) * (1 << 32)
    want = getattr(ref_hash, f"crush_hash32_{arity}")(
        *[(v & 0xFFFFFFFF).astype(np.uint32) for v in vals])
    fn = getattr(port_hash, f"hash32_{arity}_torch")
    got = fn(*[port_hash.as_hash_input(torch.from_numpy(v)) for v in vals])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        (got.long() & 0xFFFFFFFF).numpy(), want.astype(np.int64))
    # broadcasting: (N, 1) lanes against (1, S) ids
    x = port_hash.as_hash_input(torch.from_numpy(EDGES))[:, None]
    ids = port_hash.as_hash_input(torch.from_numpy(IDS))[None, :]
    rest = [port_hash.as_hash_input(torch.tensor(3))] * (arity - 2)
    got = fn(x, ids, *rest)
    want = getattr(ref_hash, f"crush_hash32_{arity}")(
        EDGES.astype(np.uint32)[:, None],
        (IDS & 0xFFFFFFFF).astype(np.uint32)[None, :],
        *[np.uint32(3)] * (arity - 2))
    np.testing.assert_array_equal((got.long() & 0xFFFFFFFF).numpy(),
                                  want.astype(np.int64))


def test_as_hash_input_keeps_low_32_bits():
    v = torch.tensor([0, 2 ** 31, 2 ** 32 - 1, -1, -(2 ** 31), 2 ** 40 + 5])
    got = port_hash.as_hash_input(v)
    assert got.dtype == torch.int32
    assert ((got.long() & 0xFFFFFFFF) == (v & 0xFFFFFFFF)).all()


def test_crush_ln_tables_and_values_equal_reference():
    np.testing.assert_array_equal(port_ln.RH_LH_TBL, ref_ln.RH_LH_TBL)
    np.testing.assert_array_equal(port_ln.LL_TBL, ref_ln.LL_TBL)
    u = np.arange(0x10000)
    np.testing.assert_array_equal(port_ln.crush_ln(u), ref_ln.crush_ln(u))
    for x in (0, 1, 0x7FFF, 0xFFFF):
        assert int(port_ln.crush_ln(x)) == int(ref_ln.crush_ln(x))


# -- maps built through either package ----------------------------------------

ALG_NAMES = ["uniform", "list", "tree", "straw", "straw2"]


def alg_map(P, alg: str):
    """A two-level map of one bucket algorithm (tests/test_crush_golden.py's
    shape), rules 0 (chooseleaf firstn) and 1 (chooseleaf indep)."""
    T = P.types
    b = P.builder.CrushBuilder()
    b.add_type(1, "host")
    b.add_type(2, "root")
    hosts = []
    for h in range(4):
        devs = list(range(h * 3, h * 3 + 3))
        ws = [0x10000] * 3 if alg == "uniform" else \
            [0x8000 + 0x4000 * ((h + i) % 3) for i in range(3)]
        hosts.append(b.add_bucket(alg, "host", devs, ws))
    root = b.add_bucket(alg, "root", hosts)
    b.add_rule(0, [T.step_take(root), T.step_chooseleaf_firstn(0, 1),
                   T.step_emit()])
    b.add_rule(1, [T.step_take(root), T.step_chooseleaf_indep(0, 1),
                   T.step_emit()])
    return b


MAP_ALGS = ["straw2", "straw2", "straw2", "straw", "list", "tree", "uniform"]


def gen_map(P, seed: int, bulk_ok: bool):
    """A randomized 3-level map + rules + reweights (+ choose_args),
    built through package ``P`` — the generator of
    tests/test_crush_mapper_kat.py.  bulk_ok=True keeps within the bulk
    evaluator's envelope (jewel tunables, regular hierarchy, chained
    choose only with n=1); False adds legacy tunables, SET_* overrides,
    a device take and multi-emit rules."""
    T = P.types
    rng = np.random.default_rng(seed)
    if bulk_ok:
        tun = T.Tunables()
    else:
        tun = [T.Tunables.legacy(),
               T.Tunables(choose_local_tries=1,
                          choose_local_fallback_tries=3,
                          choose_total_tries=19, chooseleaf_descend_once=1,
                          chooseleaf_vary_r=1, chooseleaf_stable=0),
               T.Tunables(chooseleaf_vary_r=2, chooseleaf_stable=0),
               T.Tunables()][seed % 4]
    b = P.builder.CrushBuilder(tunables=tun)
    b.add_type(1, "host")
    b.add_type(2, "rack")
    b.add_type(3, "root")

    def weight():
        r = rng.random()
        if r < 0.1:
            return 0
        if r < 0.3:
            return 0x10000
        return int(rng.integers(0x4000, 0x40000))

    dev = 0
    racks = []
    for _ in range(int(rng.integers(2, 4))):
        hosts = []
        for _h in range(int(rng.integers(2, 5))):
            n_dev = int(rng.integers(1, 5))
            items = list(range(dev, dev + n_dev))
            dev += n_dev
            alg = MAP_ALGS[int(rng.integers(len(MAP_ALGS)))]
            if alg == "uniform":
                w = [0x10000 * int(rng.integers(1, 4))] * n_dev
            else:
                w = [weight() for _ in items]
                if sum(w) == 0:
                    w[0] = 0x10000
            hosts.append(b.add_bucket(alg, "host", items, w))
        alg = MAP_ALGS[int(rng.integers(len(MAP_ALGS)))]
        if alg == "uniform":
            racks.append(b.add_bucket(alg, "rack", hosts,
                                      [0x30000] * len(hosts)))
        else:
            racks.append(b.add_bucket(alg, "rack", hosts))
    if bulk_ok or rng.random() < 0.6:
        root = b.add_bucket("straw2", "root", racks)
    else:
        root = b.add_bucket("uniform", "root", racks,
                            [0x80000] * len(racks))
    host_t, rack_t = 1, 2
    n = int(rng.integers(2, 5))
    b.add_rule(0, [T.step_take(root), T.step_chooseleaf_firstn(n, host_t),
                   T.step_emit()])
    b.add_rule(1, [T.step_take(root), T.step_chooseleaf_indep(0, host_t),
                   T.step_emit()])
    b.add_rule(2, [T.step_take(root), T.step_choose_firstn(2, rack_t),
                   T.step_chooseleaf_firstn(1, host_t), T.step_emit()])
    b.add_rule(3, [T.step_take(root), T.step_choose_indep(2, rack_t),
                   T.step_chooseleaf_indep(1, host_t), T.step_emit()])
    b.add_rule(4, [T.step_take(racks[0]), T.step_choose_firstn(0, host_t),
                   T.step_emit()])
    rules = [0, 1, 2, 3, 4]
    if bulk_ok:
        b.add_rule(5, [T.step_set_chooseleaf_tries(5),
                       T.step_set_choose_tries(100), T.step_take(root),
                       T.step_chooseleaf_indep(0, host_t), T.step_emit()])
        rules.append(5)
    else:
        b.add_rule(5, [T.step_set_choose_tries(int(rng.integers(5, 60))),
                       T.step_set_chooseleaf_tries(int(rng.integers(1, 6))),
                       T.step_take(root),
                       T.step_chooseleaf_firstn(n, host_t), T.step_emit()])
        b.add_rule(6, [T.step_take(0), T.step_emit(), T.step_take(root),
                       T.step_chooseleaf_firstn(2, host_t), T.step_emit()])
        b.add_rule(7, [T.step_take(root), T.step_choose_firstn(0, 0),
                       T.step_emit()])
        rules += [5, 6, 7]
    weights = []
    for _ in range(b.map.max_devices):
        r = rng.random()
        weights.append(0 if r < 0.08 else
                       int(rng.integers(1, 0x10000)) if r < 0.25 else
                       0x10000)
    choose_args = None
    if bulk_ok and seed % 3 == 0:
        choose_args = {}
        for bid, bk in b.map.buckets.items():
            if bk.alg != 5 or rng.random() < 0.5:
                continue
            ws = [[max(0, int(w * rng.uniform(0.5, 1.5)))
                   for w in bk.item_weights]
                  for _ in range(int(rng.integers(1, 3)))]
            ids = ([int(i) + 1000 for i in bk.items]
                   if rng.random() < 0.3 else None)
            choose_args[bid] = T.ChooseArg(weight_set=ws, ids=ids)
        choose_args = choose_args or None
    return b.map, rules, weights, choose_args


# -- bulk-evaluator cases (shared with the bulk test files) ---------------

N = 1024


def host_rows(cmap, rule, xs, rmax, weight=None, choose_args=None):
    rows = [port_mapper.crush_do_rule(cmap, rule, int(x), rmax, weight=weight,
                          choose_args=choose_args) for x in xs]
    return np.asarray([r + [NONE] * (rmax - len(r)) for r in rows],
                      dtype=np.int32)


def pin(port_map, ref_map, rule, rmax, weight=None, choose_args=None,
        ref_choose_args=None, xs=None, against_ref=True, host_lanes=128,
        ref_bulk=None):
    """The port's bulk lanes (``device="cpu"``) equal the reference
    evaluator's ``ref_bulk`` (when given and ``against_ref``) and the host
    mapper's on ``host_lanes`` seeded lanes plus the lanes the port's
    first rung flagged."""
    from ceph_tpu_torch.crush import bulk
    xs = np.arange(N) if xs is None else np.asarray(xs)
    cm = bulk.CompiledCrushMap(port_map, choose_args, device="cpu")
    out, cnt = bulk.bulk_do_rule(cm, rule, xs, rmax, weight=weight)
    assert out.dtype == np.int32 and out.shape == (len(xs), rmax)
    if against_ref and ref_bulk is not None:
        r_out, r_cnt = ref_bulk(ref_map, rule, xs, rmax, weight=weight,
                                choose_args=ref_choose_args)
        np.testing.assert_array_equal(out, r_out)
        np.testing.assert_array_equal(cnt, r_cnt)
    rng = np.random.default_rng(rule)
    lanes = np.union1d(
        rng.choice(len(xs), min(host_lanes, len(xs)), replace=False),
        cm.last_flagged[:host_lanes])
    np.testing.assert_array_equal(
        out[lanes], host_rows(port_map, rule, xs[lanes], rmax, weight,
                          choose_args))
    return out, cnt


def two_level(P, hosts=4, devs=3, seed=None):
    b = P.builder.CrushBuilder()
    if seed is None:
        return b, b.build_two_level(hosts, devs)
    rng = np.random.default_rng(seed)
    b.add_type(1, "host")
    b.add_type(2, "root")
    hs, d = [], 0
    for _ in range(hosts):
        nd = int(rng.integers(1, devs + 1))
        ws = [int(w) for w in rng.integers(0x8000, 0x30000, nd)]
        hs.append(b.add_bucket("straw2", "host", list(range(d, d + nd)),
                               ws))
        d += nd
    return b, b.add_bucket("straw2", "root", hs)


def steps(P, shape, root):
    T = P.types
    return {
        "chooseleaf_firstn": [T.step_take(root),
                              T.step_chooseleaf_firstn(0, 1), T.step_emit()],
        "chooseleaf_indep": [T.step_take(root),
                             T.step_chooseleaf_indep(0, 1), T.step_emit()],
        "choose_firstn_dev": [T.step_take(root), T.step_choose_firstn(0, 0),
                              T.step_emit()],
        "choose_indep_dev": [T.step_take(root), T.step_choose_indep(0, 0),
                             T.step_emit()],
        "ec_canonical": [T.step_set_chooseleaf_tries(5),
                         T.step_set_choose_tries(100), T.step_take(root),
                         T.step_chooseleaf_indep(0, 1), T.step_emit()],
    }[shape]


# -- the host mapper -------------------------------------------------------------

@pytest.mark.parametrize("alg", ALG_NAMES)
@pytest.mark.parametrize("reweight", [False, True])
def test_host_mapper_equals_reference_per_algorithm(alg, reweight):
    port, ref = alg_map(PORT, alg), alg_map(REF, alg)
    w = None
    if reweight:
        w = port.map.device_weights()
        w[0], w[5], w[7] = 0, 0x8000, 0x3000
    for rule in (0, 1):
        for x in range(200):
            assert port_mapper.crush_do_rule(port.map, rule, x, 3,
                                             weight=w) == \
                ref_mapper.crush_do_rule(ref.map, rule, x, 3, weight=w)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 6, 9])
def test_host_mapper_equals_reference_randomized(seed):
    """Legacy tunables (local retries, exhaustive fallback), vary_r=2,
    SET_* steps, chained and multi-emit rules, reweights, choose_args."""
    bulk_ok = seed % 2 == 0 or seed % 3 == 0
    cp, rules, w, ca = gen_map(PORT, seed, bulk_ok)
    cr, _, _, ca_r = gen_map(REF, seed, bulk_ok)
    for rn in rules:
        for x in range(32):
            assert port_mapper.crush_do_rule(cp, rn, x, 6, weight=w,
                                             choose_args=ca) == \
                ref_mapper.crush_do_rule(cr, rn, x, 6, weight=w,
                                         choose_args=ca_r), (rn, x)


# -- the independent C transcription ---------------------------------------------

@pytest.fixture(scope="module")
def c_mapper(tmp_path_factory):
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler")
    exe = tmp_path_factory.mktemp("kat") / "crush_mapper_ref"
    subprocess.run([cc, "-O2", "-o", str(exe),
                    str(TESTS / "kat" / "crush_mapper_ref.c"), "-lm"],
                   check=True)
    return str(exe)


def serialize(cmap, weights, choose_args, queries) -> str:
    """The C program's stdin protocol (tests/test_crush_mapper_kat.py)."""
    t = cmap.tunables
    lines = [f"T {t.choose_total_tries} {t.choose_local_tries} "
             f"{t.choose_local_fallback_tries} {t.chooseleaf_descend_once} "
             f"{t.chooseleaf_vary_r} {t.chooseleaf_stable}",
             f"D {cmap.max_devices}",
             "W %d %s" % (len(weights), " ".join(map(str, weights)))]
    for bk in cmap.buckets.values():
        lines.append(f"B {bk.id} {bk.alg} {bk.type} {bk.size}")
        lines.append("I " + " ".join(map(str, bk.items)))
        lines.append("V " + " ".join(map(str, bk.item_weights)))
        if bk.alg == 2:
            lines.append("L " + " ".join(map(str, bk.sum_weights)))
        elif bk.alg == 3:
            lines.append(f"N {bk.num_nodes} "
                         + " ".join(map(str, bk.node_weights)))
        elif bk.alg == 4:
            lines.append("S " + " ".join(map(str, bk.straws)))
    for bid, arg in (choose_args or {}).items():
        ws = arg.weight_set or []
        parts = [f"A {bid} {len(ws)}"] + [" ".join(map(str, r)) for r in ws]
        ids = arg.ids or []
        parts.append(str(len(ids)))
        if ids:
            parts.append(" ".join(map(str, ids)))
        lines.append(" ".join(parts))
    for ruleno, rule in cmap.rules.items():
        lines.append(f"R {ruleno} {len(rule.steps)}")
        lines += [f"P {op} {a1} {a2}" for op, a1, a2 in rule.steps]
    lines += [f"Q {rn} {x} {rmax}" for rn, x, rmax in queries]
    return "\n".join(lines + ["E"]) + "\n"


def run_c(exe: str, text: str):
    out = subprocess.run([exe], input=text, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    return [[int(v) for v in ln.split()[3:]] for ln in out.stdout.splitlines()]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 500, 504])
def test_host_mapper_equals_c_transcription(c_mapper, seed):
    cmap, rules, w, ca = gen_map(PORT, seed, bulk_ok=seed % 2 == 0
                                 and seed < 500)
    queries = [(rn, x, 6) for rn in rules for x in range(48)]
    for (rn, x, _), want in zip(queries,
                                run_c(c_mapper, serialize(cmap, w, ca,
                                                          queries))):
        assert port_mapper.crush_do_rule(cmap, rn, x, 6, weight=w,
                                         choose_args=ca) == want, (rn, x)


def test_uniform_perm_state_equals_c(c_mapper):
    """Interleaved and repeated x through uniform buckets: the C keeps
    perm state across queries, the mapper builds fresh work per call."""
    T = PORT.types
    b = PORT.builder.CrushBuilder()
    b.add_type(1, "host")
    b.add_type(2, "root")
    hosts = [b.add_bucket("uniform", "host", list(range(h * 4, h * 4 + 4)),
                          [0x10000] * 4) for h in range(4)]
    root = b.add_bucket("uniform", "root", hosts, [0x40000] * 4)
    b.add_rule(0, [T.step_take(root), T.step_chooseleaf_firstn(3, 1),
                   T.step_emit()])
    b.add_rule(1, [T.step_take(root), T.step_chooseleaf_indep(3, 1),
                   T.step_emit()])
    w = [0x10000] * b.map.max_devices
    xs = [0, 5, 0, 7, 5, 1, 0, 9, 7, 2] + list(range(40))
    queries = [(rn, x, 4) for rn in (0, 1) for x in xs]
    for (rn, x, _), want in zip(queries, run_c(c_mapper, serialize(
            b.map, w, None, queries))):
        assert port_mapper.crush_do_rule(b.map, rn, x, 4, weight=w) == want


# -- golden mappings ----------------------------------------------------------------

@pytest.mark.parametrize("alg", ALG_NAMES + ["straw2_reweight"])
def test_bucket_alg_golden(alg):
    with open(TESTS / "golden" / "bucket_algs.json") as f:
        golden = json.load(f)[alg]
    b = alg_map(PORT, "straw2" if alg == "straw2_reweight" else alg)
    w = None
    if alg == "straw2_reweight":
        w = b.map.device_weights()
        w[0], w[5] = 0, 0x8000
    for mode, rule in (("firstn", 0), ("indep", 1)):
        assert golden[mode] == [port_mapper.crush_do_rule(
            b.map, rule, x, 3, weight=w) for x in range(64)], mode


@pytest.mark.parametrize("indep", [True, False])
@pytest.mark.parametrize("stable", [1, 0])
def test_chained_rules_golden(indep, stable):
    T = PORT.types
    b = PORT.builder.CrushBuilder(T.Tunables(chooseleaf_stable=stable))
    b.add_type(1, "host")
    b.add_type(2, "rack")
    b.add_type(3, "root")
    racks, d = [], 0
    for _ in range(3):
        hosts = []
        for _ in range(3):
            hosts.append(b.add_bucket("straw2", "host", [d, d + 1]))
            d += 2
        racks.append(b.add_bucket("straw2", "rack", hosts))
    root = b.add_bucket("straw2", "root", racks)
    choose = T.step_choose_indep if indep else T.step_choose_firstn
    leaf = T.step_chooseleaf_indep if indep else T.step_chooseleaf_firstn
    b.add_rule(0, [T.step_take(root), choose(2, 2), leaf(1, 1),
                   T.step_emit()])
    with open(TESTS / "golden" / "chained_rules.json") as f:
        golden = json.load(f)[f"indep={indep},stable={stable}"]
    assert golden == [port_mapper.crush_do_rule(b.map, 0, x, 2)
                      for x in range(64)]


# -- the interchange forms across the packages ------------------------------------

def _maps(P):
    """Maps with every bucket algorithm, choose_args, device classes and
    shadow trees, legacy tunables."""
    out = [alg_map(P, alg).map for alg in ALG_NAMES]
    for seed in (0, 3, 5):
        cmap, _, _, ca = gen_map(P, seed, bulk_ok=seed != 5)
        if ca:
            cmap.choose_args["balancer"] = ca
        out.append(cmap)
    b = P.builder.CrushBuilder()
    root = b.build_two_level(3, 2)
    for d in range(6):
        b.set_item_class(d, "ssd" if d % 2 else "hdd")
    b.populate_classes()
    b.add_erasure_rule("root", [P.types.step_chooseleaf_indep(0, 1)],
                       device_class="ssd")
    out.append(b.map)
    return out


@pytest.mark.parametrize("i", range(9))
def test_map_forms_cross_the_packages(i):
    """A map written by one package reads in the other to the same map:
    the binary wire form byte for byte both ways, the JSON and the
    crushtool text forms through both compilers, and the same
    placements."""
    ref_map, port_map = _maps(REF)[i], _maps(PORT)[i]
    blob = REF.binary.encode_map(ref_map)
    assert PORT.binary.encode_map(port_map) == blob
    from_ref = PORT.binary.decode_map(blob)
    assert PORT.binary.encode_map(from_ref) == blob
    assert REF.binary.encode_map(REF.binary.decode_map(
        PORT.binary.encode_map(from_ref))) == blob
    js = REF.compiler.decompile(ref_map)
    assert PORT.compiler.decompile(PORT.compiler.compile_map(js)) == js
    assert REF.compiler.decompile(REF.compiler.compile_map(
        PORT.compiler.decompile(port_map))) == js
    text = REF.text_compiler.decompile_text(ref_map)
    assert PORT.text_compiler.decompile_text(port_map) == text
    assert PORT.text_compiler.decompile_text(
        PORT.text_compiler.compile_text(text)) == \
        REF.text_compiler.decompile_text(REF.text_compiler.compile_text(text))
    for rn in sorted(port_map.rules)[:3]:
        for x in range(32):
            assert port_mapper.crush_do_rule(from_ref, rn, x, 4) == \
                ref_mapper.crush_do_rule(ref_map, rn, x, 4)
