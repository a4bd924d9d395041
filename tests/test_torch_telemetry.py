"""The port's metrics series and device-result verification, held to
``ceph_tpu`` on the CPU.

- The same seeded encodes and decodes through both packages (matrix and
  bitmatrix codes, the numpy batch entries on the host and the device
  rule, the tensor / array entries, the packed and ragged layouts)
  leave equal series names and call counts in the metrics plane:
  ``ops_apply_matrix_{seconds,calls}{engine,layout}``,
  ``ops_apply_matrix_ragged_*``, ``ec_apply_*{path}`` and the pattern
  cache's.  The reference's "xla" tier is the port's "torch".  Left
  out: jax's compile series, and the fallback policy's first-probe
  record, which a process writes once, whichever test probes first.
- ``CEPH_TPU_VERIFY=1``: with the device tier patched to flip one byte,
  both packages raise ``DeviceVerificationError`` from the same batch
  entries; unset, both return the flipped bytes unchecked.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceph_tpu.codes.engine as ref_engine
import ceph_tpu.codes.techniques as ref_techniques
from ceph_tpu import telemetry as ref_telemetry
from ceph_tpu.codes.registry import ErasureCodePluginRegistry as RefRegistry
from ceph_tpu.ops.pallas_gf import pack_chunks as ref_pack
from ceph_tpu.telemetry.metrics import MetricsRegistry as RefMetrics
from ceph_tpu.utils.debug import DeviceVerificationError as RefVerifyError

import ceph_tpu_torch.codes.engine as engine
import ceph_tpu_torch.codes.techniques as techniques
from ceph_tpu_torch import telemetry
from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ops.gf_kernels import pack_chunks
from ceph_tpu_torch.telemetry.metrics import MetricsRegistry
from ceph_tpu_torch.utils.debug import DeviceVerificationError

RS = ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"})
ISA = ("isa", {"technique": "reed_sol_van", "k": "4", "m": "2"})
CAUCHY = ("jerasure", {"technique": "cauchy_good", "k": "4", "m": "2",
                       "packetsize": "64"})
SKIP = ("backend_compile", "jax_", "fallback_tier", "__events__")


def _pair(plugin, profile):
    ours = ErasureCodePluginRegistry.instance().factory(
        plugin, dict(profile), device="cpu")
    ref = RefRegistry.instance().factory(plugin, dict(profile))
    return ours, ref


def _series(dump) -> dict:
    """{series name: calls} of a metrics dump, the reference's "xla"
    tier named as the port's "torch", the skipped families left out."""
    out = {}
    for key, val in dump["ceph_tpu_telemetry"].items():
        if key.startswith(SKIP):
            continue
        key = key.replace("engine=xla", "engine=torch")
        out[key] = val["count"] if isinstance(val, dict) else val
    return out


def _workload(code, array, small: bool, packed: bool, ragged: bool):
    """One seeded encode and one 2-erasure decode through the numpy
    batch entries (``small``: below the host rule, else above it), the
    tensor entries (``array`` wraps numpy as the package's array type),
    and, where the code has them, the packed and ragged entries."""
    rng = np.random.default_rng(7)
    k, n = code.k, code.k + code.m
    chunk = 2048 if small else 8192
    data = rng.integers(0, 256, (2, k, chunk), dtype=np.uint8)
    if not small:
        code.min_xla_bytes = 0
    parity = code.encode_chunks_batch(data)
    full = np.concatenate([data, parity], axis=1)
    erased = (1, n - 1)
    avail = tuple(i for i in range(n) if i not in erased)
    code.decode_chunks_batch(full[:, list(avail)], avail, erased)
    suffix = "torch" if isinstance(array(data), torch.Tensor) else "jax"
    enc = getattr(code, f"encode_chunks_{suffix}")
    dec = getattr(code, f"decode_chunks_{suffix}")
    np.asarray(enc(array(data)))
    np.asarray(dec(array(full[:, list(avail)]), avail, erased))
    if packed:
        pack = pack_chunks if suffix == "torch" else ref_pack
        words = pack(array(np.ascontiguousarray(full[:, :, :512])))
        np.asarray(getattr(code, f"encode_chunks_packed_{suffix}")(
            words[:, :k]))
        np.asarray(getattr(code, f"decode_chunks_packed_{suffix}")(
            words[:, list(avail)], avail, erased))
    if ragged:
        pool = array(full[:, :k, :code.page_unit() * 2])
        mask = array(np.array([1, 0], dtype=np.uint8))
        np.asarray(getattr(code, f"encode_chunks_ragged_{suffix}")(
            pool, mask))


@pytest.mark.parametrize("small", [True, False], ids=["host", "device"])
@pytest.mark.parametrize("plugin,profile,packed,ragged", [
    RS + (True, True), ISA + (False, False), CAUCHY + (False, True)],
    ids=["rs", "isa", "cauchy_good"])
def test_metrics_series_match_reference(plugin, profile, packed, ragged,
                                        small):
    ours, ref = _pair(plugin, profile)
    # fresh metrics and fresh pattern caches: what earlier tests left in
    # the process caches (evictions, hits) is not this workload's
    prev_ref = ref_telemetry.set_global_metrics(RefMetrics())
    prev_ref_cache = ref_engine.set_global_pattern_cache(
        ref_engine.PatternCache())
    try:
        _workload(ref, jnp.asarray, small, packed, ragged)
        want = _series(ref_telemetry.global_metrics().dump())
    finally:
        ref_telemetry.set_global_metrics(prev_ref)
        ref_engine.set_global_pattern_cache(prev_ref_cache)
    prev = telemetry.set_global_metrics(MetricsRegistry())
    prev_cache = engine.set_global_pattern_cache(engine.PatternCache())
    try:
        _workload(ours, torch.from_numpy, small, packed, ragged)
        got = _series(telemetry.global_metrics().dump())
    finally:
        telemetry.set_global_metrics(prev)
        engine.set_global_pattern_cache(prev_cache)
    assert any(key.startswith("ec_apply_calls") for key in want)
    assert any(key.startswith("ops_apply_matrix_calls") for key in want) \
        or plugin == "jerasure" and "packetsize" in profile
    assert got == want


def _flip(fn):
    """``fn`` with the first byte of its result flipped: a device tier
    that returns one wrong byte."""
    def patched(*args, **kwargs):
        out = fn(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            out = out.clone()
            out.view(-1).view(torch.uint8)[0] ^= 1
        else:
            out = np.array(out)
            out.reshape(-1).view(np.uint8)[0] ^= 1
        return out
    return patched


@pytest.mark.parametrize("verify", [True, False], ids=["verify", "unset"])
@pytest.mark.parametrize("plugin,profile,entry", [
    (RS[0], RS[1], "apply_matrix_best"),
    (CAUCHY[0], CAUCHY[1], "apply_bitmatrix_best")],
    ids=["matrix", "bitmatrix"])
def test_verification_raises_where_reference_raises(plugin, profile, entry,
                                                     verify, monkeypatch):
    if verify:
        monkeypatch.setenv("CEPH_TPU_VERIFY", "1")
    else:
        monkeypatch.delenv("CEPH_TPU_VERIFY", raising=False)
    ours, ref = _pair(plugin, profile)
    ours.min_xla_bytes = ref.min_xla_bytes = 0
    monkeypatch.setattr(techniques, entry, _flip(getattr(techniques, entry)))
    monkeypatch.setattr(ref_techniques, entry,
                        _flip(getattr(ref_techniques, entry)))
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (2, ours.k, 4096), dtype=np.uint8)
    want = _host_parity(ref, data)
    outcomes = []
    for code, error in ((ref, RefVerifyError),
                        (ours, DeviceVerificationError)):
        try:
            got = code.encode_chunks_batch(data)
        except error as e:
            outcomes.append(("raised", str(e).split(" (")[0]))
        else:
            flipped = want.copy()
            flipped.reshape(-1)[0] ^= 1
            assert np.array_equal(got, flipped)
            outcomes.append(("returned", None))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ("raised" if verify else "returned")


def _host_parity(ref, data):
    """The reference's host-tier parity of ``data`` (no device tier)."""
    keep = ref.min_xla_bytes
    ref.min_xla_bytes = 1 << 62
    try:
        return ref.encode_chunks_batch(data)
    finally:
        ref.min_xla_bytes = keep
