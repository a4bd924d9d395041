"""The port's program profiler (``ceph_tpu_torch.telemetry.profiler``)
and the telemetry selftests against the reference's
(``ceph_tpu.telemetry``), on the CPU.

- the selftests (``profiler_selftest``, ``flight_recorder_selftest``,
  ``telemetry_selftest``, ``tracing_selftest``) return sections equal,
  as sorted JSON, to the reference's;
- the same synthetic captures under the tick clock give equal
  attribution rows, and the copied analytic models equal the
  reference's;
- the engine seams' rows on CPU tensors carry the reference's names and
  labels (the reference's cost comes from XLA, the port's from the
  analytic models: ``source`` and the cost columns differ by design);
- the roofline peak resolves for the CPU, an H100, an unknown card and
  the env override; the card's CUDA-event pairs are read lazily, in
  stream order, without blocking when asked;
- one cost model: the kernel table's bound of the north-star encode
  (``chip_smoke.bound_ms``, ``tools/dense_times.py``) is the profiler's
  model, 0.027545 ms: 64 x 11 x 131072 bytes at 3.35 TB/s.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import ceph_tpu.telemetry as ref_tel
from ceph_tpu.telemetry import profiler as ref_prof
from ceph_tpu_torch import telemetry as port_tel
from ceph_tpu_torch.telemetry import metrics as port_metrics
from ceph_tpu_torch.telemetry import profiler as port_prof


def canon(x) -> str:
    return json.dumps(x, sort_keys=True)


@pytest.mark.parametrize("name", ["telemetry_selftest", "profiler_selftest",
                                  "flight_recorder_selftest",
                                  "tracing_selftest"])
def test_selftest_sections_equal_the_reference(name):
    assert canon(getattr(port_tel, name)()) == \
        canon(getattr(ref_tel, name)())


def _captures(mod):
    """One synthetic scenario on an isolated profiler with the tick
    clock: analytic and cost-free records, idempotent captures,
    observes and timed blocks, a second platform."""
    prof = mod.ProgramProfiler(clock=mod._Tick())
    prof.capture(("a",), name="prog.a", platform="cpu",
                 cost=mod.analytic_matrix_cost(8, 3, 8, 65536),
                 arg_bytes=8 * 8 * 65536, plugin="ErasureCodeJerasure",
                 kind="serve-encode", engine="device", devices=1, batch=8)
    prof.capture(("b",), name="prog.b", platform="cpu",
                 cost=mod.analytic_xor_schedule_cost(4, 2, 6, 4096, 37),
                 arg_bytes=4 * 6 * 4096, plugin="ErasureCodeShec",
                 kind="serve-decode", pattern="e1", engine="xor")
    prof.capture(("c",), name="prog.c", platform=None, plugin="x")
    prof.capture(("a",), name="ignored")
    for i in range(5):
        with prof.timed(("a",)):
            pass
        prof.observe(("b",), 0.001 * (i + 1))
    prof.observe(("missing",), 1.0)
    return prof


def test_attribution_rows_equal_the_reference():
    port, ref = _captures(port_prof), _captures(ref_prof)
    assert canon(port.attribution_rows()) == canon(ref.attribution_rows())
    assert canon(port.to_dict()) == canon(ref.to_dict())
    assert port.top_programs(2) == ref.top_programs(2)
    port.reset()
    assert port.to_dict()["programs"] == 0


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (4, 3, 8, 4096),
                                   (64, 3, 8, 131072), (2, 64, 704, 2048)])
def test_analytic_models_equal_the_reference(shape):
    assert port_prof.analytic_matrix_cost(*shape) == \
        ref_prof.analytic_matrix_cost(*shape)
    for ops in (0, 7, 306):
        assert port_prof.analytic_xor_schedule_cost(*shape, ops) == \
            ref_prof.analytic_xor_schedule_cost(*shape, ops)


def test_fused_repair_cost_is_its_decode_plus_encode():
    dec = port_prof.analytic_matrix_cost(4, 1, 5, 4096)
    enc = port_prof.analytic_matrix_cost(4, 2, 4, 4096)
    got = port_prof.analytic_fused_repair_cost(dec, enc)
    assert got == {k: dec[k] + enc[k] for k in ("flops", "bytes accessed")}


def test_kernel_models_count_the_function_traffic():
    """The card's word-kernel models: each input read once, each output
    written once; a ragged pool reads its live stripes and its mask; the
    packet product over its packet rows."""
    got = port_prof.analytic_kernel_cost(64, 3, 8, 131072, 47)
    assert got["bytes accessed"] == 64 * 11 * 131072
    assert got["flops"] == 47 * 64 * 131072 / 4
    rag = port_prof.analytic_kernel_cost(512, 3, 8, 4096, 47, live=256)
    assert rag["bytes accessed"] == 256 * 8 * 4096 + 512 * 3 * 4096 + 512
    assert rag["flops"] == 47 * 256 * 4096 / 4
    bm = port_prof.analytic_bitmatrix_cost(64, 3, 8, 131072, 120, 8)
    assert bm["bytes accessed"] == 64 * 11 * 131072
    assert bm["flops"] == 120 * 64 * 131072 / 8 / 4
    part = port_prof.analytic_bitmatrix_cost(4, 2, 6, 4096, 10, 8,
                                             reads=20)
    assert part["bytes accessed"] == 4 * 4096 // 8 * (20 + 16)
    assert port_prof.analytic_walk_cost(4, 64, 704, 2048, 9) == \
        port_prof.analytic_kernel_cost(4, 64, 704, 2048, 9)
    crush = port_prof.analytic_crush_cost(1000, 3, 11, 40, 11)
    assert crush["flops"] == 1000 * 3 * 11 * 40 * port_prof.STRAW2_DRAW_OPS
    assert crush["bytes accessed"] == 1000 * (8 + 44 + 8 + 1)


def test_north_star_bound_is_one_cost_model():
    """The kernel table's bound of the RS k=8 m=3 encode at 64 stripes
    of 131072-byte chunks: 0.027545 ms (bytes) in chip_smoke.py, in
    tools/dense_times.py and in the profiler's model alike."""
    import chip_smoke
    from ceph_tpu_torch.matrices.jerasure import \
        reed_sol_vandermonde_coding_matrix
    from ceph_tpu_torch.ops.gf_kernels import sm90_op_floor
    from ceph_tpu_torch.ops.torch_ops import matrix_to_static
    from ceph_tpu_torch.tools import dense_times

    ms = matrix_to_static(reed_sol_vandermonde_coding_matrix(8, 3, 8))
    cost = port_prof.analytic_kernel_cost(64, 3, 8, 131072,
                                          sm90_op_floor(ms))
    ms_, by = port_prof.roofline_ms(cost)
    assert by == "bytes" and round(ms_, 6) == 0.027545
    assert ms_ == 64 * 11 * 131072 / 3.35e12 * 1e3
    assert chip_smoke.bound_ms(cost) == (ms_, by)
    assert dense_times.bound_ms(cost) == (ms_, by)
    # the engine's serve-encode row counts the same bytes
    assert port_prof.analytic_matrix_cost(64, 3, 8, 131072)[
        "bytes accessed"] == cost["bytes accessed"]


def test_peak_resolves_by_platform_and_card(monkeypatch):
    monkeypatch.delenv("CEPH_TPU_HBM_PEAK_GBPS", raising=False)
    assert port_prof.resolve_peak_gbps("cpu") == \
        ref_prof.resolve_peak_gbps("cpu") == 64.0
    assert port_prof.resolve_peak_gbps(None) is None
    assert port_prof.resolve_peak_gbps(
        "cuda", "NVIDIA H100 80GB HBM3") == 3350.0
    assert port_prof.resolve_peak_gbps("cuda", "Some Other Card") is None
    assert "tpu" not in port_prof.HBM_PEAK_GBPS
    if not torch.cuda.is_initialized():
        # no card name to read: no peak, and CUDA stays uninitialised
        assert port_prof.resolve_peak_gbps("cuda") is None
        assert not torch.cuda.is_initialized()
    monkeypatch.setenv("CEPH_TPU_HBM_PEAK_GBPS", "1234.5")
    assert port_prof.resolve_peak_gbps("cuda", "Some Other Card") == 1234.5
    assert port_prof.resolve_peak_gbps("cpu") == 1234.5


class _FakeEvent:
    def __init__(self, t, done=True):
        self.t, self.done, self.synced = t, done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.synced = self.done = True

    def elapsed_time(self, end):
        return end.t - self.t


def test_cuda_pairs_resolve_lazily_in_stream_order():
    """Event pairs wait in the pending list; a non-blocking resolve reads
    the finished prefix and stops at the first pair the card has not
    finished; the join blocks on the rest; each pair is read less the
    pair's own cost."""
    prof = port_prof.ProgramProfiler(clock=port_prof._Tick())
    prof.capture(("k",), name="k", platform="cuda",
                 cost=port_prof.analytic_matrix_cost(1, 1, 1, 1000))
    pairs = [(_FakeEvent(0.0), _FakeEvent(0.5)),
             (_FakeEvent(1.0), _FakeEvent(1.25, done=False)),
             (_FakeEvent(2.0), _FakeEvent(3.0))]
    prof._pending = [(("k",), a, b, 1e-4) for a, b in pairs]
    assert prof.resolve(block=False) == 1
    assert len(prof._pending) == 2
    rows = prof.attribution_rows()             # blocks on the rest
    assert prof._pending == [] and pairs[1][1].synced
    assert rows[0]["calls"] == 3
    assert rows[0]["p50_ms"] == pytest.approx(0.4, rel=0.02)


def test_timed_on_the_cpu_reads_the_clock_and_off_records_nothing():
    prof = port_prof.ProgramProfiler(clock=port_prof._Tick())
    prof.capture(("k",), name="k", platform="cpu")
    with prof.timed(("k",), device=torch.device("cpu")):
        pass
    prev = port_metrics.set_enabled(False)
    try:
        with prof.timed(("k",)):
            pass
    finally:
        port_metrics.set_enabled(prev)
    assert prof.attribution_rows()[0]["calls"] == 1
    assert prof.attribution_rows()[0]["p50_ms"] == 1.0


@pytest.fixture
def fresh_profilers():
    """Fresh global profilers and pattern caches in both packages."""
    from ceph_tpu.codes import engine as ref_engine
    from ceph_tpu_torch.codes import engine as port_engine
    prev = (port_prof.set_global_profiler(port_prof.ProgramProfiler()),
            ref_prof.set_global_profiler(ref_prof.ProgramProfiler()))
    caches = (port_engine.set_global_pattern_cache(
        port_engine.PatternCache()),
        ref_engine.set_global_pattern_cache(ref_engine.PatternCache()))
    yield
    port_prof.set_global_profiler(prev[0])
    ref_prof.set_global_profiler(prev[1])
    port_engine.set_global_pattern_cache(caches[0])
    ref_engine.set_global_pattern_cache(caches[1])


LABELS = ("name", "series", "calls", "arg_bytes", "platform", "plugin",
          "kind", "profile", "pattern", "engine", "devices", "batch",
          "config")


def test_engine_seam_rows_equal_the_reference(fresh_profilers):
    """The same seeded serve encode, serve decode, fused repair and
    ragged encode through both packages' engine seams (the port on CPU
    tensors): the same programs, names and labels; the port's cost is
    the analytic model."""
    from ceph_tpu.codes import engine as ref_engine
    from ceph_tpu.codes.registry import \
        ErasureCodePluginRegistry as RefRegistry
    from ceph_tpu_torch.codes import engine as port_engine
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry

    profile = {"technique": "reed_sol_van", "k": "4", "m": "2"}
    pec = ErasureCodePluginRegistry.instance().factory(
        "jerasure", dict(profile), device="cpu")
    rec = RefRegistry.instance().factory("jerasure", dict(profile))
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (4, 4, 4096), dtype=np.uint8)
    surv = rng.integers(0, 256, (4, 5, 4096), dtype=np.uint8)
    pool = rng.integers(0, 256, (8, 4, 512), dtype=np.uint8)
    mask = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.uint8)
    avail, erased = (0, 2, 3, 4, 5), (1,)
    for eng, ec, wrap in ((port_engine, pec, torch.from_numpy),
                          (ref_engine, rec, np.asarray)):
        for _ in range(2):
            eng.serve_dispatch_call(ec, "encode")(wrap(data))
            eng.serve_dispatch_call(ec, "decode", avail, erased)(wrap(surv))
            eng.fused_repair_call(ec, avail, erased)(wrap(surv))
            eng.serve_dispatch_ragged(ec, "encode", pages=8,
                                      page_size=512)(wrap(pool), wrap(mask))
    port = port_prof.global_profiler().attribution_rows()
    ref = ref_prof.global_profiler().attribution_rows()
    assert [{k: r.get(k) for k in LABELS} for r in port] == \
        [{k: r.get(k) for k in LABELS} for r in ref]
    assert {r["source"] for r in port} == {"analytic"}
    rows = {r["kind"]: r for r in port}
    assert rows["serve-encode"]["bytes_accessed"] == \
        port_prof.analytic_matrix_cost(4, 2, 4, 4096)["bytes accessed"]
    # the decode reads the k survivors its matrix reads, of 5
    assert rows["serve-decode"]["bytes_accessed"] == \
        port_prof.analytic_matrix_cost(4, 1, 4, 4096)["bytes accessed"]
    assert rows["fused-repair"]["bytes_accessed"] == (
        port_prof.analytic_matrix_cost(4, 2, 4, 4096)["bytes accessed"]
        + port_prof.analytic_matrix_cost(4, 1, 4, 4096)["bytes accessed"])


def test_seams_record_nothing_with_telemetry_disabled(fresh_profilers):
    from ceph_tpu_torch.codes import engine as port_engine
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    ec = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"},
        device="cpu")
    x = torch.zeros((2, 4, 1024), dtype=torch.uint8)
    call = port_engine.serve_dispatch_call(ec, "encode")
    prev = port_metrics.set_enabled(False)
    try:
        off = call(x)
    finally:
        port_metrics.set_enabled(prev)
    assert port_prof.global_profiler().to_dict()["programs"] == 0
    assert torch.equal(call(x), off)
    assert port_prof.global_profiler().to_dict()["programs"] == 1


def test_crush_first_rung_is_a_program(fresh_profilers):
    """bulk_do_rule's first-rung blocks are one profiler program priced
    by the straw2 draw model (crush/bulk.py::first_rung_cost)."""
    from ceph_tpu_torch.crush import bulk
    from ceph_tpu_torch.analysis.entrypoints import _crush_map
    cmap = _crush_map()
    cm = bulk.CompiledCrushMap(cmap, device="cpu")
    bulk.bulk_do_rule(cm, 0, np.arange(64), 3)
    rows = port_prof.global_profiler().attribution_rows()
    assert [r["name"] for r in rows] == ["crush.bulk_rule"]
    row = rows[0]
    assert (row["kind"], row["pattern"], row["engine"]) == (
        "bulk-rule", "rule0x3", "device")
    tries = bulk.auto_ladder(cmap, 0, 3, bulk.auto_tries(cmap, 0, 3))[0][0]
    assert row["flops"] == bulk.first_rung_cost(
        cm, 0, 3, tries, int(row["batch"]))["flops"]
    assert row["calls"] >= 1


def test_dump_all_has_the_profile_section_and_reset_all_clears_it(
        fresh_profilers):
    port_prof.global_profiler().capture(
        ("x",), name="x", platform="cpu",
        cost=port_prof.analytic_matrix_cost(1, 1, 1, 64))
    dump = port_tel.dump_all(profile=True)
    assert dump["profile"]["programs"] == 1
    assert port_tel.validate_dump(dump) == []
    assert "profile" not in port_tel.dump_all()
    port_tel.reset_all()
    assert port_tel.dump_all(profile=True)["profile"]["programs"] == 0
