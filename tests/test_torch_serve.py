"""The port's paged (and dense) serving plane against the JAX package's,
on the CPU: the ragged GF(2^8) ops, their routing, the serving streams
and the page pool.

Inputs are seeded with numpy and handed to both.  The reference runs
as its own tests run it: ``tests/test_serve.py`` drives its streams on
a ``FakeClock`` with ``throughput_service_model``, and its ragged
Pallas kernels run in interpret mode.  The tolerance is 0 bytes
(GF(2^8) math is integer), and the FakeClock dispatch logs and SLO
reports must be equal letter for letter.  Streams with clay in the mix
are in ``tests/test_torch_clay.py``.
"""

import json

import numpy as np
import pytest
import torch

from ceph_tpu.ops import pallas_gf as ref_ops
from ceph_tpu.serve import CodecSpec as RefCodecSpec
from ceph_tpu.serve import TrafficSpec as RefTrafficSpec
from ceph_tpu.serve import run_serving_scenario as ref_run
from ceph_tpu.serve import throughput_service_model as ref_model
from ceph_tpu.utils.retry import FakeClock as RefFakeClock

from ceph_tpu_torch.codes import engine
from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ops import gf_kernels
from ceph_tpu_torch.ops.gf_kernels import (
    apply_matrix_best_ragged, apply_matrix_cuda_packed_ragged,
    apply_matrix_cuda_ragged, apply_matrix_packed_best_ragged, mask_pages,
    select_ragged_engine)
from ceph_tpu_torch.ops.torch_ops import matrix_to_static
from ceph_tpu_torch.serve import (
    AdmissionQueue, CodecSpec, ContinuousBatcher, EcRequest, LADDER,
    PagedStripePool, PoolExhausted, SloPolicy, TrafficSpec, join_pages,
    pool_selftest, run_serving_scenario, split_pages,
    throughput_service_model, verify_results)
from ceph_tpu_torch.utils.errors import NoDeviceError
from ceph_tpu_torch.utils.retry import FakeClock

RS4 = CodecSpec("rs_k4_m2", "jerasure",
                {"technique": "reed_sol_van", "k": "4", "m": "2"}, 4096)
ISA4 = CodecSpec("isa_k4_m2", "isa", {"k": "4", "m": "2"}, 4096)
SHEC4 = CodecSpec("shec_k4_m3_c2", "shec",
                  {"k": "4", "m": "3", "c": "2"}, 4096)
LRC4 = CodecSpec("lrc_k4_m2_l3", "lrc",
                 {"k": "4", "m": "2", "l": "3"}, 4096)
FAMILIES = [RS4, ISA4, SHEC4, LRC4]
MIXED_SIZES = (2048, 4096, 8192)


def mixed_codecs(base):
    """The same (plugin, profile) at three stripe sizes: one ragged
    queue, three dense buckets."""
    return [CodecSpec(f"{base.name}_{s}", base.plugin, dict(base.profile), s)
            for s in MIXED_SIZES]


def spec_for(codecs, n=40, seed=7, paged=False, **kw):
    kw.setdefault("ladder", (1, 2, 4, 8))
    kw.setdefault("concurrency", 16)
    if paged:
        kw.setdefault("page_size", 512)
        kw.setdefault("pool_pages", 64)
    return TrafficSpec(seed=seed, n_requests=n, codecs=list(codecs),
                       paged=paged, **kw)


def port_sim(spec, executor="host", **kw):
    return run_serving_scenario(spec, clock=FakeClock(), executor=executor,
                                service_model=throughput_service_model(),
                                **kw)


def ref_sim(spec, executor="host"):
    rspec = RefTrafficSpec.from_dict(spec.to_dict())
    return ref_run(rspec, clock=RefFakeClock(), executor=executor,
                   service_model=ref_model())


def _outputs(results):
    """{req_id: output bytes}, repair outputs as (rec, parity)."""
    out = {}
    for res in results:
        o = res.output
        out[res.request.req_id] = (
            tuple(np.asarray(x).tobytes() for x in o)
            if isinstance(o, tuple) else np.asarray(o).tobytes())
    return out


# ----------------------------------------------------------------------
# ragged ops

def _ragged_case(seed, r, s, p, page, kind):
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, 256, (r, s))
    mat[0, 0] = 0
    pool = rng.integers(0, 256, (p, s, page), dtype=np.uint8)
    if kind == "scattered":
        mask = (rng.random(p) < 0.5).astype(np.uint8)
        mask[0], mask[-1] = 1, 0 if p > 1 else 1
    elif kind == "dead":
        mask = np.zeros(p, np.uint8)
    else:
        mask = np.ones(p, np.uint8)
    return matrix_to_static(mat), pool, mask


@pytest.mark.parametrize("kind", ["scattered", "dead", "live"])
@pytest.mark.parametrize("r,s,p,page", [(1, 5, 6, 1024), (3, 8, 5, 2048),
                                        (8, 6, 4, 1024), (11, 8, 3, 4096),
                                        (3, 8, 1, 1024)])
def test_ragged_ops_equal_reference_interpret_kernels(r, s, p, page, kind):
    """apply_matrix_best_ragged / apply_matrix_packed_best_ragged (and
    the CPU wrappers, which run their plain versions) equal the
    reference's ragged Pallas kernels in interpret mode and its mask
    tier, byte for byte; dead pages are zero.  P = 1 sits below the
    cutover (mask tier in both)."""
    ms, pool, mask = _ragged_case(r * 100 + p, r, s, p, page, kind)
    ref = np.asarray(ref_ops.apply_matrix_pallas_ragged(
        pool, ms, mask, interpret=True))
    ref_mask_tier = np.asarray(ref_ops.apply_matrix_best_ragged(pool, ms,
                                                                mask))
    assert np.array_equal(ref, ref_mask_tier)
    tpool, tmask = torch.from_numpy(pool), torch.from_numpy(mask)
    got = apply_matrix_best_ragged(tpool, ms, tmask).numpy()
    assert np.array_equal(got, ref)
    assert np.array_equal(apply_matrix_cuda_ragged(tpool, ms, tmask).numpy(),
                          ref)
    assert not got[mask == 0].any()
    words = pool.view(np.uint32).reshape(p, s, -1, 128)
    refp = np.asarray(ref_ops.apply_matrix_pallas_packed_ragged(
        words, ms, mask, interpret=True))
    assert np.array_equal(refp.view(np.uint8).reshape(ref.shape), ref)
    tw = torch.from_numpy(words)
    gotp = apply_matrix_packed_best_ragged(tw, ms, tmask)
    assert gotp.dtype == torch.uint32
    assert np.array_equal(gotp.numpy(), refp)
    assert np.array_equal(
        apply_matrix_cuda_packed_ragged(tw, ms, tmask).numpy(), refp)
    # the forced numpy tier walks the live pages only
    assert np.array_equal(
        gf_kernels._host_apply_bytes_ragged(tpool, ms, tmask).numpy(), ref)
    assert np.array_equal(
        gf_kernels._host_apply_packed_ragged(tw, ms, tmask).numpy(), refp)


def test_ragged_ops_word_pools_take_the_mask_tier():
    """w=16/32 pools: the mask tier in both packages, equal bytes."""
    rng = np.random.default_rng(4)
    for w, dt in ((16, np.uint16), (32, np.uint32)):
        mat = rng.integers(0, 1 << w, (3, 4), dtype=np.uint64)
        ms = matrix_to_static(mat)
        pool = rng.integers(0, 256, (5, 4, 1024), dtype=np.uint8).view(dt)
        mask = np.array([1, 0, 0, 1, 1], np.uint8)
        ref = np.asarray(ref_ops.apply_matrix_best_ragged(pool, ms, mask, w))
        got = apply_matrix_best_ragged(torch.from_numpy(pool), ms,
                                       torch.from_numpy(mask), w).numpy()
        assert np.array_equal(got, ref)
        assert not got[mask == 0].any()


@pytest.mark.parametrize("plugin,profile", [
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2",
                  "w": "16"}),
    ("jerasure", {"technique": "cauchy_good", "k": "4", "m": "2",
                  "packetsize": "32"}),
    ("shec", {"k": "6", "m": "3", "c": "2"})])
def test_ragged_surfaces_equal_reference(plugin, profile):
    """The codes' ragged surfaces (matrix mixin, bitmatrix mixin, shec's
    minimum-read override) against the reference's ``*_ragged_jax``, with
    ``page_unit`` equal too."""
    from ceph_tpu.codes.registry import ErasureCodePluginRegistry as RefReg
    ref = RefReg.instance().factory(plugin, dict(profile))
    ours = ErasureCodePluginRegistry.instance().factory(
        plugin, dict(profile), device="cpu")
    assert ours.page_unit() == ref.page_unit()
    assert ours.page_interleave() == ref.page_interleave() == 1
    rng = np.random.default_rng(21)
    n, k = ours.get_chunk_count(), ours.get_data_chunk_count()
    page = 2 * ours.page_unit() * 4
    mask = np.array([1, 0, 1, 1, 0], np.uint8)
    pool = rng.integers(0, 256, (5, k, page), dtype=np.uint8)
    want = np.asarray(ref.encode_chunks_ragged_jax(pool, mask))
    got = ours.encode_chunks_ragged_torch(torch.from_numpy(pool),
                                          torch.from_numpy(mask))
    assert np.array_equal(got.numpy(), want)
    assert not want[mask == 0].any()
    erased = (1, n - 1)
    avail = tuple(i for i in range(n) if i not in erased)
    surv = rng.integers(0, 256, (5, len(avail), page), dtype=np.uint8)
    want = np.asarray(ref.decode_chunks_ragged_jax(surv, mask, avail,
                                                   erased))
    got = ours.decode_chunks_ragged_torch(torch.from_numpy(surv),
                                          torch.from_numpy(mask), avail,
                                          erased)
    assert np.array_equal(got.numpy(), want)


def test_mask_pages_and_mask_checks():
    pool = torch.arange(3 * 2 * 8, dtype=torch.uint8).reshape(3, 2, 8)
    m = torch.tensor([1, 0, 1], dtype=torch.uint8)
    got = mask_pages(pool, m)
    assert torch.equal(got[0], pool[0]) and not got[1].any()
    words = pool.view(torch.uint32)
    assert torch.equal(mask_pages(words, m).view(torch.uint8), got)
    ms = ((1, 2),)
    with pytest.raises(ValueError, match="pool"):
        apply_matrix_cuda_ragged(pool, ms, torch.ones(2, dtype=torch.uint8))
    with pytest.raises(ValueError, match="device"):
        apply_matrix_cuda_ragged(pool, ms,
                                 torch.ones(3, dtype=torch.uint8,
                                            device="meta"))
    with pytest.raises(ValueError):
        apply_matrix_cuda_ragged(pool[:, :1], ms, m)


# ----------------------------------------------------------------------
# routing

def _routing_matrices():
    reg = ErasureCodePluginRegistry.instance()
    out = []
    rs = reg.factory("jerasure", {"technique": "reed_sol_van", "k": "8",
                                  "m": "3"}, device="cpu")
    out.append(("rs encode", rs._matrix_static))
    n = 11
    for t in (1, 2):
        import itertools
        for erased in itertools.combinations(range(n), t):
            avail = tuple(i for i in range(n) if i not in erased)
            out.append((f"rs decode {erased}",
                        rs._decode_matrix(avail, erased)[1]))
    shec = reg.factory("shec", {"k": "6", "m": "3", "c": "2"}, device="cpu")
    out.append(("shec encode", shec._matrix_static))
    for e in range(9):
        avail = tuple(i for i in range(9) if i != e)
        out.append((f"shec plan {e}",
                    shec._plan_static(shec._plan(avail, (e,)))[1]))
    r6 = reg.factory("jerasure", {"technique": "reed_sol_r6_op", "k": "8"},
                     device="cpu")
    out.append(("r6 encode", r6._matrix_static))
    for erased in ((0,), (8,), (9,), (8, 9), (2, 9)):
        avail = tuple(i for i in range(10) if i not in erased)
        out.append((f"r6 decode {erased}",
                    r6._decode_matrix(avail, erased)[1]))
    return out


def test_ragged_routing_matches_the_reference_device_row():
    """select_ragged_engine equals the reference's table forced to its
    device row ("pallas" there is "cuda" here) for the RS k=8 m=3
    encode and every 1- and 2-erasure decode matrix, the shec k=6 m=3
    c=2 encode and single-erasure plans, and r6 k=8 m=2, in both
    layouts, at the serving pool shape and at P = 1."""
    name_map = {"pallas": "cuda", "mask": "mask", "numpy": "numpy"}
    seen = set()
    for label, ms in _routing_matrices():
        s = len(ms[0])
        for shape, packed in (((512, s, 4096), False), ((1, s, 4096), False),
                              ((512, s, 8, 128), True)):
            want = ref_ops.select_ragged_engine(shape, ms, 8, packed=packed,
                                                engine="pallas")
            got = select_ragged_engine(shape, ms, 8, packed=packed,
                                       engine="cuda")
            assert got == name_map[want], (label, shape, want, got)
            seen.add(got)
        assert select_ragged_engine((512, s, 4096), ms, 8,
                                    engine="numpy") == "numpy"
    assert seen == {"cuda", "mask"}


# ----------------------------------------------------------------------
# serving streams

@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arrival", ["closed", "open"])
def test_serving_equals_reference_letter_for_letter(paged, arrival):
    """Same spec, port against reference, host executor on a FakeClock
    with the service model: the dispatch logs and the SLO reports are
    equal letter for letter, over RS, isa, shec and lrc (mixed stripe
    sizes on the paged runs)."""
    codecs = ([c for f in FAMILIES for c in mixed_codecs(f)] if paged
              else FAMILIES)
    spec = spec_for(codecs, n=48, paged=paged, arrival=arrival)
    ours = port_sim(spec)
    ref = ref_sim(spec)
    assert len(ours.results) == 48
    assert verify_results(ours.results) == []
    assert ours.batcher.dispatch_log == ref.batcher.dispatch_log
    assert json.dumps(ours.report, sort_keys=True) == \
        json.dumps(ref.report, sort_keys=True)
    assert _outputs(ours.results) == _outputs(ref.results)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_device_executor_on_cpu_equals_reference_device_seam(paged):
    """executor="device" with device="cpu" (the caller asking for the
    CPU): verified against ground truth, and the outputs byte-identical
    to the reference's device-seam run of the same spec."""
    codecs = ([c for f in (RS4, SHEC4) for c in mixed_codecs(f)] if paged
              else [RS4, SHEC4])
    spec = spec_for(codecs, n=24, seed=11, paged=paged)
    ours = port_sim(spec, executor="device", device="cpu")
    ref = ref_sim(spec, executor="device")
    assert verify_results(ours.results) == []
    assert _outputs(ours.results) == _outputs(ref.results)
    assert ours.batcher.dispatch_log == ref.batcher.dispatch_log
    assert ours.report["stream_compiles"] == 0


def test_device_executor_without_a_card_raises(monkeypatch):
    """The device executor defaults to the card: with none present it
    raises NoDeviceError instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        ContinuousBatcher(executor="device")
    with pytest.raises(NoDeviceError):
        port_sim(spec_for([RS4], n=4), executor="device")
    assert ContinuousBatcher(executor="host").device.type == "cpu"


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_warm_stream_builds_nothing(paged):
    """A second run of the same stream under an armed PatternCache
    recompile budget builds no entry, and reports stream_compiles ==
    0; the batch composition repeats."""
    codecs = mixed_codecs(RS4) + mixed_codecs(SHEC4)
    spec = spec_for(codecs, n=80, seed=13, paged=paged, concurrency=32,
                    pool=4)
    first = port_sim(spec, executor="device", device="cpu")
    assert verify_results(first.results) == []
    cache = engine.global_pattern_cache()
    prev, builds = cache.recompile_budget, cache.builds
    cache.recompile_budget = cache.builds
    try:
        second = port_sim(spec, executor="device", device="cpu")
    finally:
        cache.recompile_budget = prev
    assert cache.builds == builds
    assert verify_results(second.results) == []
    assert second.report["stream_compiles"] == 0
    assert first.batcher.dispatch_log == second.batcher.dispatch_log


def test_pattern_cache_budget_trips_loudly():
    cache = engine.PatternCache(recompile_budget=1)
    cache.get_or_build(("a",), lambda: 1)
    assert cache.get_or_build(("a",), lambda: 2) == 1
    with pytest.raises(RuntimeError, match="budget"):
        cache.get_or_build(("b",), lambda: 3)
    assert cache.stats()["builds"] == 2 and cache.stats()["hits"] == 1


def test_spec_json_round_trips_both_ways():
    """A TrafficSpec JSON written by the reference loads in the port and
    drives the same stream, and the reverse."""
    ref_spec = RefTrafficSpec(
        seed=3, n_requests=12, arrival="open", rate=500.0, paged=True,
        page_size=512, pool_pages=32, ladder=(1, 4),
        codecs=[RefCodecSpec("rs", "jerasure",
                             {"technique": "reed_sol_van", "k": "4",
                              "m": "2"}, 4096, weight=2.0),
                RefCodecSpec("shec", "shec", {"k": "4", "m": "3",
                                              "c": "2"}, 8192)])
    text = json.dumps(ref_spec.to_dict(), sort_keys=True)
    ours = TrafficSpec.from_dict(json.loads(text))
    assert json.dumps(ours.to_dict(), sort_keys=True) == text
    back = RefTrafficSpec.from_dict(json.loads(json.dumps(ours.to_dict())))
    assert back == ref_spec
    a = port_sim(ours)
    b = ref_run(ref_spec, clock=RefFakeClock(), executor="host",
                service_model=ref_model())
    assert a.batcher.dispatch_log == b.batcher.dispatch_log
    assert json.dumps(a.report, sort_keys=True) == \
        json.dumps(b.report, sort_keys=True)


# ----------------------------------------------------------------------
# the page pool (mirrors tests/test_serve.py's pool cases)

def _encode_req(ec, codec, req_id, length):
    rng = np.random.default_rng(req_id)
    return EcRequest(op="encode", plugin=codec.plugin,
                     profile=codec.profile, stripe_size=codec.stripe_size,
                     payload=rng.integers(0, 256,
                                          (ec.get_data_chunk_count(),
                                           length), dtype=np.uint8),
                     req_id=req_id, arrival=0.0, deadline=99.0)


def test_pool_split_join_and_selftest():
    st = pool_selftest()
    assert st["ok"] and st["round_trips"] > 0
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 256, (5, 2048), dtype=np.uint8)
    pages = split_pages(arr, 512, interleave=8)
    assert pages.shape == (4, 5, 512)
    assert np.array_equal(join_pages(pages, 2048, interleave=8), arr)
    tail = split_pages(arr[:, :1000], 512)
    assert tail.shape == (2, 5, 512) and not tail[1, :, 488:].any()
    assert np.array_equal(join_pages(tail, 1000), arr[:, :1000])
    with pytest.raises(ValueError, match="interleave"):
        split_pages(arr, 516, interleave=8)
    pool = PagedStripePool(4, 5, 512)
    pool.write("x", arr)
    with pytest.raises(ValueError, match="already staged"):
        pool.write("x", arr)
    with pytest.raises(PoolExhausted):
        pool.write("y", arr)


def test_pool_exhaustion_backpressure():
    """A write that cannot allocate fires the queue (demux reclaims
    every page), then retries; bytes stay identical, and a request no
    empty pool could hold is a sizing error."""
    batcher = ContinuousBatcher(clock=FakeClock(), executor="host",
                                service_model=lambda b, r: 1e-4,
                                paged=True, page_size=512, pool_pages=3)
    ec = batcher._instance(RS4.plugin, RS4.profile)
    reqs = [_encode_req(ec, RS4, i, 1024) for i in range(4)]
    fired = batcher.admit(reqs) + batcher.flush()
    assert sorted(r.request.req_id for r in fired) == [0, 1, 2, 3]
    ps = batcher.pool_stats()
    assert ps["backpressure"] >= 1
    assert ps["used_pages"] == 0 and ps["allocs"] == ps["reclaims"]
    for res in fired:
        assert np.array_equal(
            res.output, ec.encode_chunks_batch(res.request.payload[None])[0])
    big = _encode_req(ec, RS4, 9, 4096)
    big.stripe_size = 16384
    with pytest.raises(ValueError, match="pool"):
        batcher.admit([big])


def test_page_reclaim_after_demux_accounting():
    """After a mixed paged run the pools are empty, allocs == reclaims,
    and real co-residency happened; a page size that does not divide
    the chunks shows page-tail bytes."""
    run = port_sim(spec_for(mixed_codecs(RS4), n=24, paged=True))
    assert verify_results(run.results) == []
    ps = run.batcher.pool_stats()
    assert ps["used_pages"] == 0
    assert ps["allocs"] == ps["reclaims"] > 0
    assert ps["high_water"] > 1
    st = run.batcher.padding_stats()
    assert st["padded_stripes"] == 0 and st["padded_bytes"] == 0
    odd = port_sim(spec_for([RS4], n=8, paged=True, page_size=768))
    assert verify_results(odd.results) == []
    assert 0.0 < odd.batcher.padding_stats()["padding_overhead"] < 1.0


def test_deadline_slack_firing_and_admission():
    """A non-full bucket holds until its oldest request's slack runs
    out; due buckets fire earliest deadline first; the queue rejects
    above capacity."""
    clock = FakeClock()
    reg = ErasureCodePluginRegistry.instance()
    ec_a = reg.factory(RS4.plugin, dict(RS4.profile), device="cpu")
    ec_b = reg.factory(SHEC4.plugin, dict(SHEC4.profile), device="cpu")
    queue = AdmissionQueue(clock=clock, capacity=2, slo=SloPolicy(
        deadlines={"encode": 1.0, "decode": 1.0, "repair": 1.0}))
    batcher = ContinuousBatcher(clock=clock, ladder=(4,), executor="host",
                                service_model=lambda b, rung: 1e-4,
                                min_slack=1e-3)
    ra = _encode_req(ec_a, RS4, 0, 1024)
    rb = _encode_req(ec_b, SHEC4, 1, 1024)
    ra.deadline = rb.deadline = None
    assert queue.submit(ra) and queue.submit(rb)
    assert not queue.submit(_encode_req(ec_a, RS4, 2, 1024))
    rb.deadline = 0.5
    assert batcher.poll(queue) == [] and batcher.pending() == 2
    clock.now = 0.4995
    assert [r.request.req_id for r in batcher.poll()] == [1]
    clock.now = 0.9995
    assert [r.request.req_id for r in batcher.poll()] == [0]
    assert batcher.ladder == (4,) and LADDER == (1, 4, 16, 64)
