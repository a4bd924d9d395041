"""The port's roofline tool (``ceph_tpu_torch.tools.roofline``), its two
probe kernels' plain versions (``ops/probe_kernels.py``) and the bench
harness's ``build_chain``, held to the reference on the CPU.

The copy and fold kernels run only on the card (``tests/test_torch_cuda``);
here the wrappers take their plain versions on CPU tensors, which must
equal numpy.  The reference's ``tools/roofline.py`` runs its Pallas
probes on a TPU only, so its two Pallas kernels are replaced here by
plain jnp folds: what is compared is each probe's row (its keys, its
traffic multiplier, the slabs it times and the chain it runs), not a
time.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu_torch.bench.erasure_code_benchmark import _xor, build_chain
from ceph_tpu_torch.ops.launches import launch_counts, reset_launch_counts
from ceph_tpu_torch.ops.probe_kernels import (copy_slab_cuda, copy_slab_torch,
                                              fold_slab_cuda, fold_slab_torch)
from ceph_tpu_torch.tools import roofline
from ceph_tpu_torch.utils.errors import NoDeviceError

ROOT = Path(__file__).resolve().parent.parent
K, M = 8, 3


def _ref_roofline():
    """The reference's tools/roofline.py as a module (tools/ is not a
    package)."""
    spec = importlib.util.spec_from_file_location(
        "_ref_tools_roofline", ROOT / "tools" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _slab(seed, b, s, rows):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, (b, s, rows, 128), dtype=np.uint32)


@pytest.mark.parametrize("b,s,rows", [(1, 1, 1), (2, 8, 4), (3, 5, 256)])
def test_probe_plain_versions_match_numpy(b, s, rows):
    """copy and fold (plain and through the wrappers on CPU tensors)
    equal numpy; a CPU tensor launches no kernel."""
    host = _slab(b * s + rows, b, s, rows)
    x = torch.from_numpy(host)
    reset_launch_counts()
    fold = np.bitwise_xor.reduce(host, axis=1, keepdims=True)
    for fn in (copy_slab_torch, copy_slab_cuda):
        got = fn(x)
        assert got.dtype == torch.uint32 and np.array_equal(got.numpy(), host)
        assert got.data_ptr() != x.data_ptr()
    for fn in (fold_slab_torch, fold_slab_cuda):
        got = fn(x)
        assert got.dtype == torch.uint32 and np.array_equal(got.numpy(), fold)
    counts = launch_counts()
    assert counts["copy_slab_cuda"] == counts["fold_slab_cuda"] == 0
    assert not any(counts.values())


def test_probe_wrappers_refuse_what_the_kernels_do_not_take():
    for bad in (torch.zeros((2, 8, 4, 128), dtype=torch.int32),
                torch.zeros((8, 4, 128), dtype=torch.uint32),
                torch.zeros((2, 8, 4, 64), dtype=torch.uint32)):
        for fn in (copy_slab_cuda, fold_slab_cuda):
            with pytest.raises(ValueError):
                fn(bad)
    meta = torch.zeros((2, 8, 4, 128), dtype=torch.uint32, device="meta")
    for fn in (copy_slab_cuda, fold_slab_cuda):
        with pytest.raises(ValueError):
            fn(meta)


@pytest.mark.parametrize("layout", ["packed", "bytes"])
def test_slabs_match_reference(layout):
    """make_slabs gives the reference's seeded slabs (slab i = the data
    XOR i, per byte or per packed word) and the same byte count."""
    ref = _ref_roofline()
    packed = layout == "packed"
    want, want_bytes = ref._slabs(1, 3, packed)
    got, got_bytes = roofline.make_slabs(1, 3, packed, torch.device("cpu"))
    assert got_bytes == want_bytes == 1 << 20
    assert tuple(got.shape) == tuple(want.shape)
    assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        roofline.make_slabs(0, 1, packed, torch.device("cpu"))


@pytest.mark.parametrize("packed", [False, True], ids=["bytes", "packed"])
@pytest.mark.parametrize("chain", ["slice", "carry"])
def test_build_chain_matches_reference(chain, packed):
    """The port's loop over slabs with a carry equals the reference's
    jitted scan for the same op, in both chains and layouts."""
    import jax.numpy as jnp
    from ceph_tpu.bench.erasure_code_benchmark import \
        build_chain as ref_build_chain

    rng = np.random.default_rng(3)
    host = rng.integers(0, 256, (3, 2, K, 1024), dtype=np.uint8)
    if packed:
        host = host.view(np.uint32).reshape(3, 2, K, 2, 128)

    def op_ref(slab):
        return slab[:, :M] ^ slab[:, 1:M + 1]

    def op_ours(slab):
        return _xor(slab[:, :M], slab[:, 1:M + 1])

    def init_ref(s):
        return jnp.zeros((s.shape[1], M) + s.shape[3:], s.dtype)

    def init_ours(s):
        return torch.zeros((s.shape[1], M) + tuple(s.shape[3:]),
                           dtype=s.dtype)

    want = ref_build_chain(op_ref, chain, packed, init_ref, 3)(
        jnp.asarray(host))
    got = build_chain(op_ours, chain, packed, init_ours, 3)(
        torch.from_numpy(host))
    assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        build_chain(op_ours, "bogus", packed, init_ours, 1)


def _plain_pallas_probes(ref):
    """The reference's two Pallas probe kernels as plain jnp (the same
    functions), so its probe() runs on the CPU."""
    import jax

    ref._pallas_copy_fn = lambda: jax.jit(lambda t: t + 0)
    ref._pallas_fold_fn = lambda: jax.jit(
        lambda t: jax.lax.reduce(t, np.uint32(0), jax.lax.bitwise_xor,
                                 (1,))[:, None])


FORMULA = {"cuda-fold": 1.0 + 2.0 / K, "cuda-copy": 2.0, "xor3": 3.0,
           "kernel": 1.0 + M / K, "harness": 1.0 + 4.0 * M / K}
REF_NAME = {"cuda-fold": "pallas-fold", "cuda-copy": "pallas-copy"}


@pytest.mark.parametrize("name", roofline.PROBES)
def test_probe_rows_match_reference(name):
    """Each probe's JSON row has the reference's keys (plus the device
    it ran on), its traffic multiplier and formula, on the CPU."""
    ref = _ref_roofline()
    _plain_pallas_probes(ref)
    want = ref.probe(REF_NAME.get(name, name), 1, 2, "packed")
    got = roofline.probe(name, 1, 2, "packed", device="cpu")
    assert set(got) == set(want) | {"device"}
    assert got["device"] == "cpu"
    assert got["probe"] == name
    for key in ("layout", "slab_mib", "loop", "traffic_mult"):
        assert got[key] == want[key], key
    assert got["traffic_mult"] == roofline.traffic_mult(name) \
        == FORMULA[name]
    # rates are rounded to 0.1 GB/s, as the reference's are
    assert got["input_gbps"] >= 0 and got["implied_hbm_gbps"] >= 0


@pytest.mark.parametrize("name", ["xor3", "kernel", "harness"])
def test_bytes_layout_probes_run(name):
    row = roofline.probe(name, 1, 2, "bytes", device="cpu")
    assert row["layout"] == "bytes" and row["input_gbps"] >= 0


def test_cli_prints_one_json_row_per_probe(capsys):
    assert roofline.main(["--probe", "xor3", "--mib", "1", "--loop", "2",
                          "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["probe"] == "xor3" and row["traffic_mult"] == 3.0
    with pytest.raises(SystemExit):
        roofline.main(["--probe", "pallas-fold", "--device", "cpu"])


def test_cuda_probes_are_packed_only_and_default_to_the_card(monkeypatch):
    with pytest.raises(SystemExit):
        roofline.probe("cuda-copy", 1, 2, "bytes", device="cpu")
    with pytest.raises(SystemExit):
        roofline.probe("no-such-probe", 1, 2, "packed", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        roofline.probe("xor3", 1, 2, "packed")
