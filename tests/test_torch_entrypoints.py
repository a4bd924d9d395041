"""The port's entry-point registry and audit
(``ceph_tpu_torch.analysis.{entrypoints,audit}``) against the
reference's registry (``ceph_tpu.analysis.entrypoints``), on the CPU.

- the names are the reference's, in its order; the families, the
  representative profiles and the surface names are the reference's;
- ``registry_gaps()`` is empty;
- every entry audits clean on CPU tensors (warm setups 0, the torch
  tier's bytes equal the numpy ground truth's), and each device entry's
  output equals the reference entry's on the same seeded args (where
  the reference's entry traces a Pallas kernel in interpret mode, its
  XLA twin of the same math stands in: the interpreter's compile takes
  minutes);
- the audit's findings: a warm rebuild, a tier that differs, a host entry
  returning a CUDA tensor, a declared sync that no longer happens.

The sharded entries run over 8 virtual CPU members
(``CEPH_TPU_TORCH_VIRTUAL_DEVICES``, the reference's forced host device
count).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ceph_tpu.analysis import entrypoints as ref_ep
from ceph_tpu_torch.analysis import audit
from ceph_tpu_torch.analysis import entrypoints as port_ep

PORT = {e.name: e for e in port_ep.registry()}
REF = {e.name: e for e in ref_ep.registry()}


@pytest.fixture(autouse=True)
def virtual_members(monkeypatch):
    monkeypatch.setenv("CEPH_TPU_TORCH_VIRTUAL_DEVICES", "8")


def test_names_are_the_reference_minus_pending():
    # no entry is pending any more: the names are the reference's
    ref = ref_ep.registry_names()
    assert port_ep.registry_names() == ref
    assert not hasattr(port_ep, "PENDING")
    assert port_ep.FAMILIES == ref_ep.FAMILIES
    assert port_ep.REPRESENTATIVE_PROFILES == ref_ep.REPRESENTATIVE_PROFILES
    assert [port_ep.SURFACE_NAMES[s] for s in port_ep.PLUGIN_SURFACES] == \
        list(ref_ep.PLUGIN_SURFACES)
    assert (port_ep.B, port_ep.C, port_ep.R) == (ref_ep.B, ref_ep.C,
                                                 ref_ep.R)
    for name, e in PORT.items():
        r = REF[name]
        assert e.family == r.family
        assert e.kind == ("device" if r.kind == "jit" else "host"), name


def test_registry_names_equal_the_reference():
    """The cluster and scenario entries are in: 59 names, the
    reference's, each with the reference's family and kind."""
    names = port_ep.registry_names()
    assert names == ref_ep.registry_names() and len(names) == 59
    for name in ("cluster.balancer_round", "cluster.storm_reeval",
                 "cluster.rateless_dispatch"):
        assert PORT[name].kind == "device" and REF[name].kind == "jit"
    for name in ("scenario.runner", "scenario.qos", "scenario.week"):
        assert PORT[name].kind == "host" == REF[name].kind
    # the bulk evaluator's entries declare the rung ladder's host syncs
    assert PORT["cluster.balancer_round"].sync_ok == \
        PORT["crush.bulk_rule"].sync_ok != ""
    assert PORT["cluster.storm_reeval"].sync_ok == \
        PORT["crush.bulk_rule"].sync_ok


def test_registry_has_no_gaps():
    assert port_ep.registry_gaps() == []


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return x


def _ref_fn(name: str, built):
    """The reference's callable for an entry: its own, or, where it
    traces a Pallas kernel in interpret mode, the XLA twin of the same
    math on the same static coefficients."""
    import jax.numpy as jnp

    from ceph_tpu.ops import pallas_gf, xla_ops
    ms = ref_ep._rs_static()
    twins = {
        "ops.apply_matrix_pallas": lambda x: xla_ops.apply_matrix_xla(
            x, ms, 8),
        "ops.apply_matrix_pallas_packed":
            lambda w: pallas_gf.apply_matrix_packed_best(
                jnp.asarray(w), ms, mesh=0),
        "ops.apply_matrix_xor_pallas": lambda x: pallas_gf.
            apply_matrix_xor_xla(x, ref_ep._xor_cse_static()),
        "ops.apply_matrix_xor_packed": lambda w: pallas_gf.
            apply_matrix_xor_xla_packed(jnp.asarray(w),
                                        ref_ep._xor_ring_static()),
    }
    if name in twins:
        return twins[name]
    if name == "ops.apply_bitmatrix_pallas":
        ec = ref_ep.representative_instance("jerasure_cauchy")
        rows = xla_ops.bitmatrix_to_static(ec.bitmatrix)
        return lambda x: xla_ops.apply_bitmatrix_xla(x, rows, ec.w, 512)
    if name == "ops.apply_bitmatrix_xor":
        from ceph_tpu.codes.registry import ErasureCodePluginRegistry
        from ceph_tpu.ops.xor_schedule import probe_bitmatrix_schedule
        ec = ErasureCodePluginRegistry.instance().factory(
            "jerasure", {"technique": "cauchy_orig", "k": "4", "m": "2",
                         "packetsize": "512"})
        sched = probe_bitmatrix_schedule(
            xla_ops.bitmatrix_to_static(ec.bitmatrix), ec.w)
        return lambda x: pallas_gf.apply_bitmatrix_xor_xla(
            x, sched.static, ec.w, 512)
    if name.startswith("crush."):
        # the port's map, the reference's mapper-equal bulk evaluator
        # over the same x (its jitted rule takes its own weight vector)
        from ceph_tpu.crush import bulk as rbulk
        from ceph_tpu.crush import (CrushBuilder, step_chooseleaf_indep,
                                    step_emit, step_take)
        b = CrushBuilder()
        root = b.build_two_level(4, 2)
        b.add_rule(0, [step_take(root), step_chooseleaf_indep(0, 1),
                       step_emit()])
        return lambda xs: rbulk.bulk_do_rule(b.map, 0, xs, 3)
    if name in ("cluster.balancer_round", "cluster.storm_reeval"):
        # the reference's jitted rule takes its own weight vector: its
        # mapper-equal bulk evaluator over the reference's cluster map
        from ceph_tpu.cluster.topology import EC_POOL, REPLICATED_POOL
        from ceph_tpu.crush import bulk as rbulk
        m = ref_ep._cluster_map()
        pool = m.pools[REPLICATED_POOL if name.endswith("round")
                       else EC_POOL]
        return lambda xs: rbulk.bulk_do_rule(
            m.crush, pool.crush_rule, xs, pool.size,
            weight=list(m.osd_weight))
    return REF[name].build().fn


def _same(port_out, ref_out) -> None:
    p = [_np(x) for x in audit._flat(port_out)]
    r = [np.asarray(x) for x in audit._flat(ref_out)]
    assert len(p) == len(r)
    for a, b in zip(p, r):
        assert np.array_equal(np.asarray(a), b.astype(np.asarray(a).dtype))


@pytest.mark.parametrize("name", sorted(PORT))
def test_every_entry_audits_clean_and_equals_the_reference(name):
    entry = PORT[name]
    res = audit.audit_entry(entry, device="cpu")
    assert res.ok, res.findings
    assert res.warm_setups == 0
    if entry.kind == "host":
        assert res.tiers == [] and res.sync == "n/a"
        return
    assert res.tiers == ["cpu", "numpy"]
    built = entry.build("cpu")
    out = built.fn(*built.args)
    ref = _ref_fn(name, built)(*[_np(a) for a in built.args])
    _same(out, ref)


def test_audit_reports_each_finding(monkeypatch):
    """A warm rebuild, a tier that differs, a host entry returning a
    CUDA tensor (faked), a declared sync on a CPU device (no sync check
    there: only drift on the card) and a failing build."""
    from ceph_tpu_torch.telemetry import metrics as tel
    base = PORT["ops.apply_matrix_pallas"]
    builds = []

    def rebuilding(device=None):
        built = base.build(device)
        fn = built.fn

        def every_call(x):
            tel.note_kernel_setup()
            return fn(x)
        builds.append(device)
        return port_ep.Built(every_call, built.args, built.anchor,
                             built.twin)
    e = port_ep.EntryPoint("t.rebuild", "ops", "device", rebuilding,
                           setup_budget=4)
    res = audit.audit_entry(e, device="cpu")
    assert any(f.startswith("audit-setup: warm repeat set up 1")
               for f in res.findings)

    def differing(device=None):
        built = base.build(device)
        return port_ep.Built(built.fn, built.args, built.anchor,
                             lambda x: built.twin(x) ^ 1)
    res = audit.audit_entry(port_ep.EntryPoint(
        "t.differ", "ops", "device", differing), device="cpu")
    assert res.findings == ["audit-bytes: the numpy tier differs from the "
                            "cpu output"]

    monkeypatch.setattr(audit, "_has_cuda", lambda out: True)
    res = audit.audit_entry(PORT["telemetry.selftest"])
    assert res.findings == ["audit-host: a host entry returned a CUDA "
                            "tensor"]
    monkeypatch.undo()

    def broken(device=None):
        raise RuntimeError("no such map")
    res = audit.audit_entry(port_ep.EntryPoint("t.err", "ops", "device",
                                               broken), device="cpu")
    assert res.findings == ["audit-error: RuntimeError: no such map"]


def test_audit_registry_turns_telemetry_on_for_the_count():
    from ceph_tpu_torch.telemetry import metrics as tel
    prev = tel.set_enabled(False)
    try:
        got = audit.audit_registry([PORT["ops.apply_matrix_best"],
                                    PORT["tune.sweep"]], device="cpu")
        assert tel.enabled() is False
    finally:
        tel.set_enabled(prev)
    assert [a.ok for a in got] == [True, True]
    assert got[0].tiers == ["cpu", "numpy"] and got[1].tiers == []


def test_device_entries_need_a_card_by_default():
    from ceph_tpu_torch.utils.errors import NoDeviceError
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(NoDeviceError):
        audit.audit_entry(PORT["ops.apply_matrix_best"])
    with pytest.raises(NoDeviceError):
        PORT["serve.dispatch"].build()


def test_profile_entrypoints_rows_on_the_cpu():
    """Every device entry, or those a filter names, gets a profiler row
    with its function traffic as the cost."""
    from ceph_tpu_torch.telemetry import profiler
    prof = profiler.ProgramProfiler()
    rows, failed = profiler.profile_entrypoints(
        ("ops.apply_matrix_best", "serve.dispatch"), repeats=2,
        profiler=prof, device="cpu")
    assert failed == []
    names = [r["name"] for r in rows]
    assert names == sorted(names) and "ops.apply_matrix_best" in names
    for r in rows:
        assert r["source"] == "analytic" and r["calls"] == 2
        assert r["bytes_accessed"] > r["arg_bytes"] > 0
