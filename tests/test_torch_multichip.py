"""The data plane as an engine tier (``ceph_tpu_torch.parallel`` with the
mesh row of ``ops/gf_kernels.py`` and the engine's mesh variants)
against the reference's (``tests/test_multichip.py``) on the CPU.

The reference runs on its 8 forced CPU devices (tests/conftest.py); the
port on 8 virtual CPU members (``CEPH_TPU_TORCH_VIRTUAL_DEVICES=8``, the
counterpart of ``--xla_force_host_platform_device_count``).  Sharded
encode, decode and repair equal, byte for byte, the port's
single-device result and the reference's (its mesh tier, or for clay —
whose jitted device programs compile for minutes — its host path,
which its own tests hold equal to its mesh tier); non-dividing batches
pad and drop; CRUSH sharded over the x axis equals the scalar mapper;
one supervised dispatch per pattern batch.  Outputs are gathered on the
caller's device, so the reference's "output stays sharded" case is
replaced by the member partition.  The sharded audit entries are held
in tests/test_torch_entrypoints.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from ceph_tpu.codes import engine as ref_engine
from ceph_tpu.codes.registry import ErasureCodePluginRegistry as RefRegistry
from ceph_tpu.ops import pallas_gf as ref_gf
from ceph_tpu.ops.xla_ops import matrix_to_static as ref_static
from ceph_tpu.parallel import plane as ref_plane
from ceph_tpu_torch.codes import engine
from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.matrices.jerasure import \
    reed_sol_vandermonde_coding_matrix
from ceph_tpu_torch.ops.gf_kernels import (apply_matrix_best,
                                           apply_matrix_packed_best,
                                           pack_chunks, select_matrix_engine)
from ceph_tpu_torch.parallel import plane as plane_mod
from ceph_tpu_torch.parallel.mesh import (VIRTUAL_DEVICES_ENV, make_mesh,
                                          visible_devices)
from ceph_tpu_torch.utils.errors import NoDeviceError
from ceph_tpu_torch.utils.shard import last_partition

C = 4096  # chunk bytes — lane-aligned, clay sub-chunk friendly

FAMILIES = {
    "jerasure": {"technique": "reed_sol_van", "k": "4", "m": "2"},
    "isa": {"k": "4", "m": "2"},
    "shec": {"k": "4", "m": "3", "c": "2"},
    "lrc": {"k": "4", "m": "2", "l": "3"},
    "clay": {"k": "4", "m": "2", "d": "5"},
}


def factory(plugin):
    return ErasureCodePluginRegistry.instance().factory(
        plugin, dict(FAMILIES[plugin]), device="cpu")


def ref_factory(plugin):
    return RefRegistry.instance().factory(plugin, dict(FAMILIES[plugin]))


def static(mat):
    return tuple(tuple(int(v) for v in row) for row in np.asarray(mat))


def one_erasure(ec):
    n = ec.get_chunk_count()
    return tuple(i for i in range(n) if i != 1), (1,)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def np_(out):
    if isinstance(out, tuple):
        return tuple(np_(o) for o in out)
    if isinstance(out, torch.Tensor):
        return out.numpy()
    return np.asarray(out)


@pytest.fixture(autouse=True)
def eight_members(monkeypatch):
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "8")


@pytest.fixture
def plane():
    with plane_mod.mesh_plane() as p:
        assert p is not None and p.n_devices == 8 and p.kind == "cpu"
        yield p


@pytest.fixture
def ref_mesh():
    with ref_plane.mesh_plane() as p:
        assert p is not None and p.n_devices == 8
        yield p


@pytest.fixture
def fresh_cache():
    cache = engine.PatternCache()
    prev = engine.set_global_pattern_cache(cache)
    try:
        yield cache
    finally:
        engine.set_global_pattern_cache(prev)


# -- meshes, the knob, activation ----------------------------------------------

def test_make_mesh_tp_selection_1_2_4_8():
    from ceph_tpu.parallel.mesh import make_mesh as ref_make_mesh
    for n, tp in ((1, None), (2, None), (4, None), (8, None), (8, 1),
                  (8, 2)):
        assert make_mesh(n, tp=tp).shape == dict(ref_make_mesh(n, tp=tp)
                                                 .shape), (n, tp)
    with pytest.raises(ValueError):
        make_mesh(9)          # more than available
    with pytest.raises(ValueError):
        make_mesh(8, tp=3)    # tp does not divide n


def test_virtual_devices_knob(monkeypatch):
    """The counterpart of the forced host device count: N members over
    the one physical device; unset, the real devices (one CPU); a cuda
    mesh without a card raises."""
    assert visible_devices("cpu") == [torch.device("cpu")] * 8
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV)
    assert visible_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(NoDeviceError):
            visible_devices("cuda")
        assert visible_devices() == [torch.device("cpu")]


def test_plane_activation_env_knob(monkeypatch):
    for env, want in (("auto", 8), ("off", None), ("4", 4)):
        monkeypatch.setattr(plane_mod, "_active", None)
        monkeypatch.setattr(plane_mod, "_env_resolved", False)
        monkeypatch.setenv("CEPH_TPU_MESH", env)
        p = plane_mod.data_plane()
        assert (p.n_devices if p is not None else None) == want, env
    monkeypatch.setattr(plane_mod, "_active", None)
    monkeypatch.setattr(plane_mod, "_env_resolved", False)
    monkeypatch.setenv("CEPH_TPU_MESH", "auto")
    monkeypatch.setenv("CEPH_TPU_HOSTS", "3")     # clamps 8 -> 3 x 2
    p = plane_mod.data_plane()
    assert (p.n_devices, p.hosts, p.devices_per_host) == (6, 3, 2)


def test_plane_default_is_single_device(monkeypatch):
    monkeypatch.setattr(plane_mod, "_active", None)
    monkeypatch.setattr(plane_mod, "_env_resolved", False)
    monkeypatch.delenv("CEPH_TPU_MESH", raising=False)
    assert plane_mod.data_plane() is None
    with plane_mod.single_device(), plane_mod.mesh_plane(4):
        assert plane_mod.data_plane() is None     # inside a member body


# -- the selection table ----------------------------------------------------------

SHAPES = [((8, 4, C), False), ((11, 4, C), False), ((8, 4, 8, 128), True),
          ((1, 4, C), False), ((4, C), False), ((2, 4, C), False),
          ((2, 4, 8, 128), True), ((8, 4, 128), True)]


def test_select_engine_mesh_row_equals_reference(plane, ref_mesh):
    """Row for row the reference's answers on the same shapes (its
    "xla" is the port's "torch"), with the plane, with ``mesh=0`` and
    with the numpy tier forced."""
    rs = reed_sol_vandermonde_coding_matrix(4, 2, 8)
    ms, rms = static(rs), ref_static(rs)
    names = {"xla": "torch"}
    for shape, packed in SHAPES:
        for mesh, engine_ in ((None, None), (0, None), (None, "numpy")):
            want = ref_gf.select_matrix_engine(
                shape, rms, 8, packed=packed, engine=engine_, mesh=mesh)
            got = select_matrix_engine(8, "cpu", engine_, shape=shape,
                                       matrix_t=ms, packed=packed,
                                       mesh=mesh)
            assert got == names.get(want, want), (shape, mesh, engine_)


def test_select_engine_without_plane_unchanged():
    ms = static(reed_sol_vandermonde_coding_matrix(4, 2, 8))
    assert select_matrix_engine(8, "cpu", shape=(8, 4, C),
                                matrix_t=ms) == "torch"


def test_mesh_row_keeps_to_the_planes_kind(plane):
    """A CPU plane never takes a card tensor, and a card plane never a
    CPU tensor: the row needs members of the tensor's device kind."""
    assert plane_mod.plane_for(None, "cpu") is plane
    assert plane_mod.plane_for(None, "cuda") is None


# -- apply-level mesh tier: pad-and-drop identity at awkward batches ------------

@pytest.mark.parametrize("b", [1, 2, 7, 8, 64])
def test_apply_matrix_mesh_identity(plane, ref_mesh, b):
    rs = reed_sol_vandermonde_coding_matrix(8, 3, 8)
    ms, rms = static(rs), ref_static(rs)
    rng = np.random.default_rng(b)
    c = 1024
    data = rng.integers(0, 256, (b, 8, c), dtype=np.uint8)
    single = np_(apply_matrix_best(t(data), ms, 8, mesh=0))
    out = np_(apply_matrix_best(t(data), ms, 8))
    ref = np.asarray(ref_gf.apply_matrix_best(jax.device_put(data), rms, 8))
    np.testing.assert_array_equal(out, single)
    np.testing.assert_array_equal(out, ref)
    if b >= 2:
        assert last_partition() == [-(-b // 8)] * 8
    words = pack_chunks(t(data))
    pout = apply_matrix_packed_best(words, ms)
    pref = apply_matrix_packed_best(words, ms, mesh=0)
    assert torch.equal(pout.view(torch.int32), pref.view(torch.int32))


def test_mesh_tier_counts_one_dispatch(plane):
    """One supervised dispatch at ``ops.apply_matrix`` and one
    ``engine_mesh_dispatches`` per mesh call; the per-member applies
    run bare."""
    from ceph_tpu_torch.ops import supervisor
    from ceph_tpu_torch.telemetry import metrics as tel
    ms = static(reed_sol_vandermonde_coding_matrix(8, 3, 8))
    sup = supervisor.DispatchSupervisor()
    prev = supervisor.set_global_supervisor(sup)
    try:
        reg = tel.global_metrics()
        before = reg.counter_value("engine_mesh_dispatches",
                                   tier="apply-bytes", devices="8")
        apply_matrix_best(t(np.zeros((16, 8, 1024), np.uint8)), ms, 8)
        assert sup.stats()["dispatches"] == 1
        assert reg.counter_value("engine_mesh_dispatches",
                                 tier="apply-bytes",
                                 devices="8") == before + 1
        assert last_partition() == [2] * 8
    finally:
        supervisor.set_global_supervisor(prev)


# -- engine-level mesh variants: all five families --------------------------------

@pytest.mark.parametrize("plugin", sorted(FAMILIES))
def test_family_sharded_encode_decode_repair_identity(plane, ref_mesh,
                                                      plugin):
    ec, rec_ = factory(plugin), ref_factory(plugin)
    k = ec.get_data_chunk_count()
    available, erased = one_erasure(ec)
    rng = np.random.default_rng(17)
    b = 6  # non-dividing on 8 members: pads and drops
    data = rng.integers(0, 256, (b, k, C), dtype=np.uint8)
    stack = rng.integers(0, 256, (b, len(available), C), dtype=np.uint8)

    got = {
        "enc": np_(engine.serve_dispatch_call(ec, "encode")(t(data))),
        "dec": np_(engine.serve_dispatch_call(ec, "decode", available,
                                              erased)(t(stack))),
        "rep": np_(engine.fused_repair_call(ec, available,
                                            erased)(t(stack))),
    }
    single = {
        "enc": np_(engine.serve_dispatch_call(ec, "encode",
                                              mesh=False)(t(data))),
        "dec": np_(engine.serve_dispatch_call(
            ec, "decode", available, erased, mesh=False)(t(stack))),
        "rep": np_(engine.fused_repair_call(ec, available, erased,
                                            mesh=False)(t(stack))),
    }
    if plugin == "clay":
        from ceph_tpu.serve.batcher import _host_repair
        want = {"enc": np.asarray(rec_.encode_chunks_batch(data)),
                "dec": np.asarray(rec_.decode_chunks_batch(
                    stack, available, erased)),
                "rep": tuple(np.asarray(o) for o in _host_repair(
                    rec_, stack, available, erased))}
    else:
        want = {
            "enc": np.asarray(ref_engine.serve_dispatch_call(
                rec_, "encode")(jax.device_put(data))),
            "dec": np.asarray(ref_engine.serve_dispatch_call(
                rec_, "decode", available, erased)(jax.device_put(stack))),
            "rep": tuple(np.asarray(o) for o in ref_engine.fused_repair_call(
                rec_, available, erased)(jax.device_put(stack))),
        }
    for key in got:
        for a, s, w in zip(*(v if isinstance(v, tuple) else (v,)
                             for v in (got[key], single[key], want[key]))):
            np.testing.assert_array_equal(a, s, err_msg=key)
            np.testing.assert_array_equal(a, w, err_msg=key)


def test_ragged_page_sharding_identity(plane):
    """serve_dispatch_ragged's mesh variant shards the page axis with
    the mask alongside (a non-dividing pool pads dead pages): equal to
    the single-device callable, dead pages zero."""
    ec = factory("jerasure")
    k = ec.get_data_chunk_count()
    available, erased = one_erasure(ec)
    rng = np.random.default_rng(4)
    pages, page = 13, 512
    for op, rows, args in (("encode", k, ()),
                           ("decode", len(available), (available, erased)),
                           ("repair", len(available), (available, erased))):
        pool = t(rng.integers(0, 256, (pages, rows, page), dtype=np.uint8))
        mask = t((rng.random(pages) < 0.5).astype(np.uint8))
        kw = dict(pages=pages, page_size=page)
        got = engine.serve_dispatch_ragged(ec, op, *args, **kw)(pool, mask)
        want = engine.serve_dispatch_ragged(ec, op, *args, mesh=False,
                                            **kw)(pool, mask)
        for a, b in zip(*(v if isinstance(v, tuple) else (v,)
                          for v in (got, want))):
            assert torch.equal(a, b), op
            assert not a[mask == 0].any(), op
        assert last_partition() == [2] * 8


def test_sharded_repair_heals_real_data(plane):
    ec = factory("jerasure")
    rng = np.random.default_rng(23)
    data = rng.integers(0, 256, (5, ec.get_data_chunk_count(), C),
                        dtype=np.uint8)
    parity = np.asarray(ec.encode_chunks_batch(data))
    allchunks = np.concatenate([data, parity], axis=1)
    available, erased = one_erasure(ec)
    stack = np.ascontiguousarray(allchunks[:, list(available), :])
    rec, par = engine.fused_repair_call(ec, available, erased)(t(stack))
    np.testing.assert_array_equal(rec.numpy(), allchunks[:, [1], :])
    np.testing.assert_array_equal(par.numpy(), parity)


def test_serve_rung1_pads_through_mesh(plane):
    """The batcher's smallest rung (one request) rides the mesh
    variant: pad 1 -> 8, the pad rows dropped."""
    ec = factory("jerasure")
    data = np.random.default_rng(3).integers(
        0, 256, (1, ec.get_data_chunk_count(), C), dtype=np.uint8)
    out = engine.serve_dispatch_call(ec, "encode")(t(data))
    ref = engine.serve_dispatch_call(ec, "encode", mesh=False)(t(data))
    assert torch.equal(out, ref) and out.shape[0] == 1
    assert last_partition() == [1] * 8


def test_pattern_cache_keys_mesh_and_single_separately(plane,
                                                      fresh_cache):
    """The mesh variant lives in the same keyspace under a key ending
    in ("mesh", 8): one build each, warm hits after."""
    ec = factory("jerasure")
    available, erased = one_erasure(ec)
    f_single = engine.fused_repair_call(ec, available, erased, mesh=False)
    f_mesh = engine.fused_repair_call(ec, available, erased)
    assert f_single is not f_mesh
    assert fresh_cache.builds == 2
    assert engine.fused_repair_call(ec, available, erased) is f_mesh
    assert fresh_cache.builds == 2 and fresh_cache.hits >= 1
    keys = list(fresh_cache._entries)
    assert keys[1][-2:] == ("mesh", 8) and keys[0][-2] == "device"
    assert keys[1][:-2] == keys[0]


def test_repair_batched_one_dispatch_per_pattern(plane, fresh_cache):
    from ceph_tpu_torch.chaos import ShardErasure, inject
    from ceph_tpu_torch.codes.stripe import HashInfo, StripeInfo
    from ceph_tpu_torch.codes.stripe import encode as stripe_encode
    from ceph_tpu_torch.scrub import repair_batched
    from ceph_tpu_torch.telemetry.metrics import global_metrics

    ec = factory("jerasure")
    k = ec.get_data_chunk_count()
    width = k * ec.get_chunk_size(k * 1024)
    sinfo = StripeInfo(k, width)
    rng = np.random.default_rng(5)
    faults = [[1], [0, 4], [1], [0, 4], [1]]  # 2 distinct patterns
    objs, stores = [], []
    for i, erased in enumerate(faults):
        obj = rng.integers(0, 256, size=width * 2, dtype=np.uint8).tobytes()
        shards = stripe_encode(sinfo, ec, obj)
        hinfo = HashInfo(ec.get_chunk_count())
        hinfo.append(0, shards)
        objs.append((shards, hinfo))
        st, _ = inject(shards, [ShardErasure(shards=list(erased))],
                       seed=100 + i, chunk_size=sinfo.chunk_size)
        stores.append(st)
    reg = global_metrics()
    before = reg.counter_value("engine_mesh_dispatches",
                               tier="fused-repair", devices="8")
    rep = repair_batched(sinfo, ec, stores, [h for _, h in objs],
                         device=True)
    assert rep.pattern_batches == 2
    assert rep.device_calls == rep.pattern_batches
    assert rep.host_batches == 0
    after = reg.counter_value("engine_mesh_dispatches",
                              tier="fused-repair", devices="8")
    assert after - before == rep.device_calls
    for i, (shards, _) in enumerate(objs):
        assert stores[i].snapshot() == {s: bytes(v)
                                        for s, v in shards.items()}, i


# -- CRUSH: the x axis sharded through the bulk evaluator -------------------------

def test_sharded_vs_scalar_crush_bulk_equivalence(plane):
    """A non-dividing lane count, firstn and indep rules: the sharded
    bulk evaluator equals the scalar host mapper and the single-device
    sweep."""
    from ceph_tpu_torch.crush import CrushBuilder, crush_do_rule
    from ceph_tpu_torch.crush.bulk import bulk_do_rule
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE

    b = CrushBuilder()
    root = b.build_two_level(6, 3)
    b.add_simple_rule(0, root, "host", firstn=True)
    b.add_simple_rule(1, root, "host", firstn=False)
    xs = np.arange(157)
    for ruleno in (0, 1):
        out, cnt = bulk_do_rule(b.map, ruleno, xs, 3, device="cpu")
        one, one_cnt = bulk_do_rule(b.map, ruleno, xs, 3, device="cpu",
                                    mesh=0)
        np.testing.assert_array_equal(out, one)
        np.testing.assert_array_equal(cnt, one_cnt)
        for x in range(157):
            ref = crush_do_rule(b.map, ruleno, x, 3)
            ref = ref + [CRUSH_ITEM_NONE] * (3 - len(ref))
            assert list(out[x]) == ref, (ruleno, x)


# -- the bench CLI's multichip row ------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "host"])
def test_bench_multichip_row(device, capsys):
    from ceph_tpu_torch.bench import erasure_code_benchmark as bench
    assert bench.main(["-p", "jerasure", "-P", "technique=reed_sol_van",
                       "-P", "k=4", "-P", "m=2", "-s", "65536",
                       "--batch", "12", "--workload", "multichip",
                       "--device", device, "--json"]) == 0
    import json
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["workload"] == "multichip" and row["verified"] is True
    if device == "cpu":
        assert row["n_devices"] == 8 and row["physical_devices"] == 1
        assert row["mesh_shape"] == [8, 1]
        assert row["stripes_per_device"] == [2] * 8
    else:
        assert row["n_devices"] == 1 and row["mesh_shape"] is None
        assert row["stripes_per_device"] == [12]
    assert plane_mod.data_plane() is None       # the plane it found


# -- the minimum-read sharded repair ----------------------------------------------

@pytest.mark.parametrize("plugin", ["jerasure", "shec", "clay"])
def test_sharded_single_erasure_repair_n_read(plugin):
    """The minimum-read decode through the engine's mesh serve-decode
    callable: ``n_read`` equal to the reference's and to
    ``minimum_to_decode``'s size, shec and clay reading fewer than n,
    the bytes intact."""
    from ceph_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from ceph_tpu.parallel.sharded_codes import \
        sharded_single_erasure_repair as ref_repair
    from ceph_tpu_torch.parallel.sharded_codes import \
        sharded_single_erasure_repair

    rng = np.random.default_rng(9)
    ec = factory(plugin)
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    c = ec.get_chunk_size(k * 1024)
    data = rng.integers(0, 256, (6, k, c), dtype=np.uint8)
    repaired, n_read, n_chunks = sharded_single_erasure_repair(
        make_mesh(8), plugin, dict(FAMILIES[plugin]), data)
    assert n_chunks == n
    minimum = ec.minimum_to_decode({0}, set(range(1, n)))
    assert n_read == len(minimum)
    if plugin != "jerasure":
        assert n_read < n
    np.testing.assert_array_equal(repaired, data[:, :1, :])
    if plugin != "clay":
        _, ref_read, _ = ref_repair(ref_make_mesh(8), plugin,
                                    dict(FAMILIES[plugin]), data)
        assert n_read == ref_read
