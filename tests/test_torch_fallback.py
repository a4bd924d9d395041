"""The port's tier policy (``ceph_tpu_torch.ops.fallback``): the cases of
``tests/test_fallback.py`` on the cuda -> torch -> numpy ladder, held to
the reference's (``ceph_tpu.ops.fallback``, Pallas -> XLA -> numpy) where
the two answer the same question: the ladder walk of ``demote`` /
``promote``, the thread-local ``numpy_tier()``, the log-once counter and
event, the flight-recorder trip at the first step onto the numpy floor.
The port's own rule is tested beside them: a FORCED torch or numpy tier
raises for a card tensor, and the supervisor's LIVE demotion moves CPU
tensors and host rows down the ladder but never a card tensor (no card
is needed: the policy reads the device's type).
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from ceph_tpu.ops import fallback as ref_fallback
from ceph_tpu_torch.ops import fallback, gf_kernels
from ceph_tpu_torch.ops.fallback import (FallbackPolicy, global_policy,
                                         numpy_tier, set_global_policy)

CARD, CPU = torch.device("cuda"), torch.device("cpu")
# the port's tiers for the reference's: the card's kernel for Pallas on
# the TPU, the plain torch ops for XLA, numpy for numpy
TIER = {"pallas": "cuda", "xla": "torch", "numpy": "numpy"}


def test_device_to_tier_ladder():
    p = FallbackPolicy(force=None)
    assert p.engine(CARD) == "cuda"
    assert p.engine(CPU) == "torch"
    assert p.engine() == "torch"
    assert p.engine("cuda:0") == "cuda"
    # the reference's ladder, name for name
    r = ref_fallback.FallbackPolicy(force=None)
    assert [TIER[r.engine(k)] for k in ("tpu", "cpu")] == \
        [p.engine(CARD), p.engine(CPU)]


def test_probe_lets_unrelated_errors_propagate(monkeypatch):
    """device_kind() asks torch; an error that is not an answer is a
    bug and propagates (the reference's old bare except swallowed
    them)."""
    p = FallbackPolicy(force=None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert p.device_kind() == "cpu"
    p2 = FallbackPolicy(force=None)
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: (_ for _ in ()).throw(KeyError("bug")))
    with pytest.raises(KeyError):
        p2.device_kind()


def test_probe_result_is_cached(monkeypatch):
    calls = []
    p = FallbackPolicy(force=None)
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: (calls.append(1), True)[1])
    assert p.device_kind() == "cuda"
    assert p.device_kind() == "cuda"
    assert calls == [1]


def test_force_override_wins():
    p = FallbackPolicy(force="numpy")
    assert p.engine(CPU) == "numpy"
    with pytest.raises(ValueError):
        FallbackPolicy(force="pallas")
    with pytest.raises(ValueError):
        FallbackPolicy(force="xla")


def test_env_force(monkeypatch):
    monkeypatch.setenv("CEPH_TPU_ENGINE", "torch")
    assert FallbackPolicy().engine(CPU) == "torch"
    monkeypatch.setenv("CEPH_TPU_ENGINE", "cuda")
    assert FallbackPolicy().engine(CARD) == "cuda"
    monkeypatch.delenv("CEPH_TPU_ENGINE")
    assert FallbackPolicy().engine(CARD) == "cuda"


@pytest.mark.parametrize("force", ["torch", "numpy"])
def test_forced_tier_raises_for_a_card_tensor(force):
    """An inherited CEPH_TPU_ENGINE never takes a card tensor off the
    kernel — even inside numpy_tier() the forced rule is the policy's,
    and the live tier is the supervisor's alone."""
    p = FallbackPolicy(force=force)
    with pytest.raises(ValueError, match="CPU tensors"):
        p.engine(CARD)
    assert p.engine(CPU) == force


def test_selection_logged_exactly_once(monkeypatch):
    lines = []
    monkeypatch.setattr(fallback, "dout",
                        lambda sub, lvl, msg: lines.append(msg))
    p = FallbackPolicy(force=None)
    for _ in range(3):
        p.engine(CPU)
    assert len(lines) == 1 and "engine=torch" in lines[0]
    p.engine(CARD)              # a DIFFERENT outcome logs again
    assert len(lines) == 2 and "engine=cuda" in lines[1]


def test_log_once_counts_and_trips_like_the_reference():
    """The transition counter and event, and the flight dump at the first
    step onto the numpy floor, as the reference emits them."""
    from ceph_tpu.telemetry import metrics as ref_metrics
    from ceph_tpu.telemetry import recorder as ref_recorder
    from ceph_tpu_torch.telemetry import metrics, recorder

    def run(met, rec, pol, device):
        prev_m = met.set_global_metrics(met.MetricsRegistry())
        prev_r = rec.set_global_flight_recorder(rec.FlightRecorder())
        try:
            for _ in range(3):
                pol.engine(device)
            pol.demote()
            pol.engine(device)
            pol.promote()
            pol.engine(device)
            dump = met.global_metrics().dump()
            counts = sorted(v for k, v in dump.items()
                            if "fallback_tier_transitions" in k)
            trig = [d["trigger"] for d in
                    rec.global_flight_recorder().to_dict()["dumps"]]
            return counts, trig
        finally:
            met.set_global_metrics(prev_m)
            rec.set_global_flight_recorder(prev_r)

    got = run(metrics, recorder, FallbackPolicy(force=None), CPU)
    want = run(ref_metrics, ref_recorder,
               ref_fallback.FallbackPolicy(force=None), "cpu")
    assert got == want
    assert got[1] == ["backend_lost"]


def test_selection_routes_through_policy():
    """select_matrix_engine reads the process policy: the card's kernel
    by default, the plain torch ops on a CPU tensor, numpy when forced on
    the CPU (the seam tests/test_torch_ops.py relies on)."""
    prev = set_global_policy(FallbackPolicy(force=None))
    try:
        assert gf_kernels.select_matrix_engine(8, CARD) == "cuda"
        assert gf_kernels.select_matrix_engine(8, CPU) == "torch"
        set_global_policy(FallbackPolicy(force="numpy"))
        assert gf_kernels.select_matrix_engine(8, CPU) == "numpy"
        with pytest.raises(ValueError, match="CPU tensors"):
            gf_kernels.select_matrix_engine(8, CARD)
    finally:
        set_global_policy(prev)


def test_numpy_tier_pins_host_path(monkeypatch):
    """With the policy forced to numpy, the mixin batch paths run the
    numpy reference ops even above min_xla_bytes."""
    from ceph_tpu_torch.codes import techniques
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops import regionops
    prev = set_global_policy(FallbackPolicy(force="numpy"))
    try:
        ec = ErasureCodePluginRegistry.instance().factory(
            "jerasure", {"technique": "reed_sol_van", "k": "2", "m": "1"},
            device="cpu")
        ec.min_xla_bytes = 1          # everything would go to the device
        called = []
        monkeypatch.setattr(techniques, "apply_matrix_best",
                            lambda *a, **k: called.append(1))
        data = np.arange(2 * 64, dtype=np.uint8).reshape(1, 2, 64)
        parity = ec.encode_chunks_batch(data)
        assert called == []           # the device path never dispatched
        assert np.array_equal(parity, regionops.matrix_encode(
            data, ec.matrix, 8))
    finally:
        set_global_policy(prev)


def test_numpy_tier_context_pins_a_card_code_to_the_host(monkeypatch):
    """Inside numpy_tier() a card code's batch surfaces run the host path
    — the supervisor's twins and self-verify never dispatch through the
    backend they verify — where a forced tier would raise."""
    from ceph_tpu_torch.codes import techniques
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    ec = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "2", "m": "1"},
        device="cpu")
    ec.device = CARD                  # the policy reads the type only
    ec.min_xla_bytes = 1
    called = []
    monkeypatch.setattr(techniques, "apply_matrix_best",
                        lambda *a, **k: called.append(1))
    data = np.arange(2 * 64, dtype=np.uint8).reshape(1, 2, 64)
    with numpy_tier():
        assert techniques._numpy_tier(CARD)
        ec.encode_chunks_batch(data)
    assert called == []
    assert not techniques._numpy_tier(CARD)


def test_global_policy_is_process_wide():
    a = global_policy()
    assert global_policy() is a


# -- live demotion / invalidation ---------------------------------------

def test_invalidate_reprobes(monkeypatch):
    p = FallbackPolicy(force=None)
    answers = iter([False, True])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: next(answers))
    assert p.device_kind() == "cpu"
    assert p.device_kind() == "cpu"        # cached
    p.invalidate()
    assert p.device_kind() == "cuda"       # re-probed live


def test_demote_walks_the_ladder_and_promote_restores():
    """The same walk as the reference's, tier for tier, on a CPU tensor;
    a card tensor stays on its kernel throughout."""
    p = FallbackPolicy(force="cuda")
    r = ref_fallback.FallbackPolicy(force="pallas")
    assert p.engine(CPU) == TIER[r.engine()] == "cuda"
    assert p.demote(device=CPU) == TIER[r.demote()] == "torch"
    assert p.engine(CPU) == "torch" and p.demoted
    assert p.engine(CARD) == "cuda"
    assert p.demote(device=CPU) == TIER[r.demote()] == "numpy"
    assert p.engine(CPU) == "numpy" and p.engine() == "numpy"
    assert p.engine(CARD) == "cuda"
    assert p.demotions == r.demotions == 2
    assert p.promote(device=CPU) == TIER[r.promote()] == "torch"
    assert p.promote(device=CPU) == TIER[r.promote()] == "cuda"
    assert not p.demoted
    assert p.promote() is None and r.promote() is None
    with pytest.raises(ValueError):
        p.demote(to="pallas")


def test_demote_explicit_target():
    p = FallbackPolicy(force=None)
    assert p.demote(to="numpy", device=CPU) == "numpy"
    assert p.engine(CPU) == "numpy" and p.engine(CARD) == "cuda"
    assert p.promote(device=CPU) == "torch"


def test_live_demotion_leaves_card_tensors_on_the_kernels():
    """The live tier moves CPU tensors (torch -> numpy) and never a card
    tensor: on the card every row keeps its kernel while the CPU's tier
    is demoted, and the numpy tier's functions raise for a card
    tensor."""
    p = FallbackPolicy(force=None)
    prev = set_global_policy(p)
    try:
        r6 = ((1, 1, 1, 1, 1, 1, 1, 1),
              (1, 2, 4, 8, 16, 32, 64, 128))    # the r6 encode: "xor" row
        shape = (4, 8, 4096)
        ragged = gf_kernels.select_ragged_engine(shape, r6, device=CARD)
        p.demote(device=CPU)
        assert gf_kernels.select_matrix_engine(8, CPU) == "numpy"
        assert gf_kernels.select_matrix_engine(
            8, CARD, shape=shape, matrix_t=r6) == "xor"
        assert gf_kernels.select_matrix_engine(8, CARD) == "cuda"
        assert gf_kernels.select_ragged_engine(
            shape, r6, device=CARD) == ragged != "numpy"
        p.promote(device=CPU)
        assert gf_kernels.select_matrix_engine(8, CPU) == "torch"
    finally:
        set_global_policy(prev)
    meta = torch.empty((1, 2, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CPU tensors"):
        gf_kernels.apply_matrix_numpy(meta, ((1, 1),))
    with pytest.raises(ValueError, match="CPU tensors"):
        gf_kernels.apply_bitmatrix_numpy(meta, (3,), 8, 8)


def test_numpy_tier_context_is_thread_local_override():
    p = FallbackPolicy(force="torch")
    assert p.engine(CPU) == "torch"
    seen = []
    with numpy_tier():
        assert p.engine(CPU) == "numpy"
        assert p.engine(CARD) == "numpy"
        t = threading.Thread(target=lambda: seen.append(p.engine(CPU)))
        t.start()
        t.join()
        with numpy_tier():                  # reentrant
            assert p.engine(CPU) == "numpy"
        assert p.engine(CPU) == "numpy"
    assert p.engine(CPU) == "torch"
    assert seen == ["torch"]                # another thread: untouched
