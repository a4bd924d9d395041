"""The port's benchmark CLI (``ceph_tpu_torch.bench.erasure_code_benchmark``)
and bench line (``ceph_tpu_torch.bench.bench_line``), held to the
reference's ``ceph_tpu.bench.erasure_code_benchmark`` on the CPU.

``--device cpu`` (the plain torch tier on CPU tensors) is compared with
the reference's ``--device jax`` on its CPU backend, and ``host`` with
``host``.  Times are real-clock and are never compared: what must agree
is the output format and byte counts, the erasure patterns, the bytes of
the ``--loop`` carry at an odd pass count (the only counts where the
carry proves anything), the decode rows' routing metadata and the
serving stream.
"""

import json

import numpy as np
import pytest
import torch

import ceph_tpu.bench.erasure_code_benchmark as ref_bench
from ceph_tpu.codes.registry import \
    ErasureCodePluginRegistry as RefRegistry
from ceph_tpu_torch.bench import bench_line
from ceph_tpu_torch.bench import erasure_code_benchmark as port_bench
from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ops.gf_kernels import unpack_chunks
from ceph_tpu_torch.utils.errors import NoDeviceError

RS = ["--plugin", "jerasure", "-P", "technique=reed_sol_van",
      "-P", "k=4", "-P", "m=2"]
SHEC = ["--plugin", "shec", "-P", "k=4", "-P", "m=3", "-P", "c=2"]
LRC = ["--plugin", "lrc", "-P", "k=4", "-P", "m=2", "-P", "l=3"]
CLAY = ["--plugin", "clay", "-P", "k=4", "-P", "m=2", "-P", "d=5"]


def _setup(module, argv):
    bench = module.ErasureCodeBench()
    bench.setup(argv)
    return bench


def _run(module, argv):
    return _setup(module, argv).run()


# -- CLI output --------------------------------------------------------------

@pytest.mark.parametrize("port_dev,ref_dev,extra", [
    ("host", "host", ["--size", "4096", "--iterations", "2"]),
    ("host", "host", ["--size", "1048576", "--batch", "2"]),
    ("cpu", "jax", ["--size", "8192", "--iterations", "1"]),
    ("cpu", "jax", ["--size", "8192", "--batch", "2", "--loop", "5"]),
    ("cpu", "jax", ["--size", "8192", "--resident", "--iterations", "3"]),
    ("host", "host", ["--workload", "decode", "--erasures", "2",
                      "--size", "4096", "--iterations", "3"]),
])
def test_cli_line_matches_reference(capsys, port_dev, ref_dev, extra):
    """"<seconds>\\t<KiB>", the same KiB as the reference on the same
    arguments."""
    lines = []
    for module, dev in ((port_bench, port_dev), (ref_bench, ref_dev)):
        assert module.main(RS + extra + ["--device", dev]) == 0
        lines.append(capsys.readouterr().out.strip())
    for line in lines:
        secs, kib = line.split("\t")
        assert float(secs) > 0 and f"{float(secs):.6f}" == secs
    assert lines[0].split("\t")[1] == lines[1].split("\t")[1]


@pytest.mark.parametrize("workload,extra", [
    ("encode", ["--loop", "3", "--layout", "packed"]),
    ("encode", ["--iterations", "2"]),
    ("decode", ["--iterations", "2"]),
    ("decode", ["--loop", "3", "--chain", "slice"]),
])
def test_json_row_has_the_reference_fields(capsys, workload, extra):
    """--json prints one row with every field of the reference's row,
    the tuning provenance at its defaults and the topology of the run."""
    argv = RS + ["--size", "8192", "--workload", workload, "--json"] + extra
    assert port_bench.main(argv + ["--device", "cpu"]) == 0
    port = json.loads(capsys.readouterr().out)
    # the reference refuses --chain slice off a TPU (XLA could narrow
    # the op); the port's eager chain runs it: its row against carry's
    ref_argv = ["carry" if a == "slice" else a for a in argv]
    assert ref_bench.main(ref_argv + ["--device", "jax"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert port["chain"] == ("slice" if "slice" in argv else "carry")
    assert set(port) == set(ref)
    assert port["total_bytes"] == ref["total_bytes"]
    assert (port["config_source"], port["tune_key_hash"]) == ("default",
                                                               None)
    assert (port["platform"], port["device_count"],
            port["mesh_shape"]) == ("cpu", 1, None)
    assert port["device"] == "cpu" and port["gbps"] > 0
    host = _run(port_bench, RS + ["--size", "8192", "--workload", workload,
                                  "--device", "host"])
    assert (host["platform"], host["device_count"]) == (None, 0)


def test_batch_extension_scales_bytes():
    r1 = _run(port_bench, RS + ["--size", "4096", "--batch", "1",
                                "--device", "host"])
    r8 = _run(port_bench, RS + ["--size", "4096", "--batch", "8",
                                "--device", "host"])
    assert r8["total_bytes"] == 8 * r1["total_bytes"]


def test_device_cuda_is_the_default_and_needs_a_card():
    """--device defaults to cuda; without a card the run raises
    NoDeviceError and never falls back to the CPU."""
    bench = _setup(port_bench, RS + ["--size", "4096"])
    assert bench.args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(NoDeviceError):
        bench.run()


# the cluster, scenario and tenant-week rows at small sizes
_CLUSTER_ARGS = {
    "cluster": ["--osds", "60", "--cluster-pgs", "64", "--storm-events",
                "3", "--size", "4096", "--batch", "4"],
    "scenario": ["--requests", "32", "--size", "4096", "--batch", "2",
                 "--storm-events", "2"],
    "tenant-week": ["--iterations", "2"],
}
_REF_ROWS: dict = {}


def _ref_host_row(workload):
    """The reference's ``--device host`` row (run once per workload)."""
    if workload not in _REF_ROWS:
        _REF_ROWS[workload] = _run(ref_bench, RS + _CLUSTER_ARGS[workload]
                                   + ["-w", workload, "--device", "host"])
    return _REF_ROWS[workload]


@pytest.mark.parametrize("workload,device", [
    ("cluster", "host"), ("cluster", "cpu"),
    ("scenario", "host"), ("scenario", "cpu"),
    ("tenant-week", "host"), ("tenant-week", "cpu"),
])
def test_cluster_scenario_week_rows_match_the_reference(capsys, workload,
                                                        device):
    """-w cluster|scenario|tenant-week run on the host and on CPU
    tensors: a verified JSON row whose fields are the reference's row's;
    the deterministic numbers (the storm, the balancer, the rateless
    schedule, the simulated week) equal the reference's."""
    assert port_bench.main(RS + _CLUSTER_ARGS[workload]
                           + ["-w", workload, "--device", device,
                              "--json"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref = _ref_host_row(workload)
    assert row["workload"] == workload and row["verified"] is True
    assert set(row) == set(ref)
    same = {
        "cluster": ("osds", "total_pgs", "storm_events",
                    "remap_convergence_epochs", "remapped_total",
                    "balancer_iterations", "balancer_moves",
                    "balancer_converged", "balancer_max_dev_final",
                    "n_shards", "p99_ratio", "straggler_reassignments"),
        # the real clock paces the scenario's churn: only its
        # simulated rateless schedule is deterministic
        "scenario": ("rateless_p99_ratio", "straggler_reassignments"),
        "tenant-week": ("dispatch_crc", "dispatched", "requests_offered",
                        "tenants", "isolation_ok", "isolation_victims",
                        "disasters", "lat_p99_ms", "deadline_miss_rate"),
    }[workload]
    if workload == "cluster" and device == "cpu":
        # the bulk row measures every epoch, the host row every second
        same = tuple(k for k in same if not k.startswith("remap"))
    assert {k: row[k] for k in same} == {k: ref[k] for k in same}
    if workload == "cluster":
        assert row["engine"] == ("host" if device == "host" else "bulk")


def test_workload_choices_match_the_reference():
    """--help matches: the same workload choices and the same flags."""
    import argparse

    def flags(module):
        seen = {}
        real = argparse.ArgumentParser.parse_args

        def capture(self, argv=None, namespace=None):
            seen["parser"] = self
            return real(self, argv, namespace)
        argparse.ArgumentParser.parse_args = capture
        try:
            _setup(module, ["--device", "host"])
        finally:
            argparse.ArgumentParser.parse_args = real
        acts = seen["parser"]._actions
        return ({a.dest: (tuple(a.option_strings), a.default)
                 for a in acts if a.dest not in ("help", "device")},
                {a.dest: a.choices for a in acts if a.choices})

    port_flags, port_choices = flags(port_bench)
    ref_flags, ref_choices = flags(ref_bench)
    assert port_flags == ref_flags
    assert port_choices["workload"] == ref_choices["workload"]
    assert port_choices["device"] == ["host", "cuda", "cpu"]
    assert not hasattr(port_bench, "UNPORTED_WORKLOADS")


def test_device_chaos_names_the_supervisor(capsys):
    """device-chaos runs on the supervisor: the CLI prints its line, and
    the row names the supervisor's counter deltas (the reference's, and
    the card's failures)."""
    assert port_bench.main(RS + ["--workload", "device-chaos", "--device",
                                 "host", "--size", "4096", "--batch", "2",
                                 "--json"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["workload"] == "device-chaos" and row["verified"] is True
    assert set(row["supervisor"]) == {
        "retries", "rung_downshifts", "demotions", "quarantines",
        "card_failures", "repromotions", "host_completions", "hangs",
        "verify_failures"}
    assert row["demoted_at_end"] is False


# -- the recovery workloads ------------------------------------------------------

RECOVERY_FIELDS = ("pattern_batches", "device_calls", "host_batches",
                   "replans", "regroups", "rounds", "epochs_advanced",
                   "erasures", "corruptions", "churn_every")


@pytest.mark.parametrize("workload,extra", [
    ("degraded", ["-e", "1", "--corruptions", "1", "--batch", "2"]),
    ("degraded", ["-e", "0", "--iterations", "2"]),
    ("repair-batched", ["-e", "1", "--corruptions", "1", "--batch", "6",
                        "--iterations", "2"]),
    ("repair-batched", ["-e", "2", "--batch", "3"]),
    ("recovery-churn", ["-e", "1", "--batch", "4"]),
    ("recovery-churn", ["-e", "1", "--corruptions", "1", "--batch", "3",
                        "--churn-every", "0"]),
])
@pytest.mark.parametrize("port_dev,ref_dev", [("cpu", "jax"),
                                              ("host", "host")])
def test_recovery_workloads_equal_the_reference(capsys, workload, extra,
                                                port_dev, ref_dev):
    """degraded, repair-batched and recovery-churn: the same bytes and the
    same counts as the reference (``--device cpu`` against its ``jax`` on
    the CPU, ``host`` against ``host``), and every timed pass healed."""
    argv = RS + ["--size", "8192", "--workload", workload, "--json"] + extra
    bench = _setup(port_bench, argv + ["--device", port_dev])
    port = bench.run()
    assert ref_bench.main(argv + ["--device", ref_dev]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(port) == set(ref)
    for f in ("workload", "total_bytes", "batch", "iterations", "size")\
            + RECOVERY_FIELDS:
        assert port.get(f) == ref.get(f), f
    assert port["device"] == port_dev and port["gbps"] > 0
    run = bench.last_run
    assert len(run.runs) == bench.args.iterations
    for stores in run.runs:
        for store, (shards, _) in zip(stores, run.objects):
            assert store.snapshot() == {s: bytes(b)
                                        for s, b in shards.items()}
    if workload == "repair-batched":
        on_dev = port_dev != "host"
        assert port["pattern_batches"] == (
            port["device_calls"] if on_dev else port["host_batches"])
    if workload == "recovery-churn" and "--churn-every" not in extra:
        assert port["epochs_advanced"] >= 1


def test_recovery_workloads_need_faults_they_can_heal():
    for workload, extra, msg in (
            ("degraded", ["-e", "6"], "leave no clean shards"),
            ("repair-batched", ["--corruptions", "-1"], "must be >= 0"),
            ("recovery-churn", ["-e", "0"], "needs --erasures >= 1")):
        bench = _setup(port_bench, RS + ["--workload", workload,
                                         "--device", "host",
                                         "--size", "8192"] + extra)
        with pytest.raises(ValueError, match=msg):
            bench.run()


def test_tune_table_exits_with_its_item(capsys, tmp_path):
    """--tune-table: a table that is not there fails the run before any
    workload; a valid one is installed
    and every row names it (config_source, tune_key_hash), as the
    reference's rows do."""
    from ceph_tpu_torch.tune import table as port_table
    from ceph_tpu_torch.tune.sweep import analytic_sweep
    with pytest.raises(FileNotFoundError):
        port_bench.main(RS + ["--tune-table", str(tmp_path / "t.json"),
                              "--device", "host"])
    path = tmp_path / "tuned.json"
    analytic_sweep(seed=0, platform="cpu").table.save(str(path))
    try:
        assert port_bench.main(RS + ["--tune-table", str(path), "--size",
                                     "4096", "--device", "host",
                                     "--json"]) == 0
        row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert row["config_source"] == "tuned"
        assert row["tune_key_hash"] == \
            port_table.BestConfigTable.load(str(path)).content_hash()
    finally:
        port_table.install_table(None)


def test_packed_layout_needs_a_device_loop_and_a_w8_matrix_code():
    with pytest.raises(SystemExit):
        _setup(port_bench, RS + ["--layout", "packed", "--device", "host",
                                 "--loop", "3"])
    with pytest.raises(SystemExit):
        _setup(port_bench, RS + ["--layout", "packed", "--device", "cpu"])
    bench = _setup(port_bench, ["--plugin", "jerasure", "-P", "k=4",
                                "-P", "m=2", "-P", "technique=cauchy_good",
                                "--size", "8192", "--layout", "packed",
                                "--device", "cpu", "--loop", "3"])
    with pytest.raises(SystemExit, match="w=8 matrix codes only"):
        bench.run()


# -- erasure patterns --------------------------------------------------------

@pytest.mark.parametrize("code", [RS, SHEC, LRC, CLAY])
@pytest.mark.parametrize("gen", [
    ["-E", "random", "-e", "1", "--iterations", "9"],
    ["-E", "random", "-e", "2", "--iterations", "12"],
    ["-E", "exhaustive", "-e", "2", "--iterations", "20"],
    ["--erased", "0", "--erased", "3", "--iterations", "3"],
])
def test_erasure_patterns_equal_the_reference(code, gen):
    """The same pattern list for the same --seed: default_rng(seed + 1),
    the same skip of undecodable patterns (shec, lrc)."""
    argv = code + gen + ["--workload", "decode", "--seed", "5",
                         "--device", "host"]
    pats = []
    for module in (port_bench, ref_bench):
        bench = _setup(module, argv)
        ec = bench._instance()
        pats.append(bench._erasure_patterns(ec, ec.get_chunk_count()))
    assert pats[0] == pats[1]
    assert len(pats[0]) == int(gen[-1])


def test_erasure_patterns_reject_what_the_reference_rejects():
    for module in (port_bench, ref_bench):
        bench = _setup(module, RS + ["-e", "7", "--workload", "decode",
                                     "--device", "host"])
        ec = bench._instance()
        with pytest.raises(ValueError, match="exceeds chunk count 6"):
            bench._erasure_patterns(ec, 6)


# -- the --loop carry --------------------------------------------------------

def _ref_instance(argv):
    bench = _setup(ref_bench, argv + ["--device", "jax"])
    return bench, bench._instance()


def _host_step(ec, packed):
    """The numpy tier's output of one slab: the independent ground
    truth of a chain step."""
    def step(slab, *pattern):
        x = unpack_chunks(slab).numpy() if packed else slab.numpy()
        if pattern:
            return ec.decode_chunks_batch(np.ascontiguousarray(x), *pattern)
        return ec.encode_chunks_batch(np.ascontiguousarray(x))
    return step


@pytest.mark.parametrize("layout", ["bytes", "packed"])
@pytest.mark.parametrize("loop", [5, 15])
def test_encode_loop_carry_equals_the_reference(layout, loop):
    """An odd number of steps (one pass over 5 or 15 slabs), so the
    carry holds the data's parity; equal to the reference's build_chain
    over the same slabs with encode_chunks_jax (or its packed form) as
    the step, and to the numpy tier slab by slab."""
    import jax.numpy as jnp
    argv = RS + ["--size", "8192", "--batch", "2", "--loop", str(loop),
                 "--layout", layout]
    bench = _setup(port_bench, argv + ["--device", "cpu"])
    ec = bench._instance()
    chained, slabs = bench._encode_chain(ec, bench._make_batch(ec))
    got = chained(slabs)
    n_slabs, reps = bench._loop_shape(16)
    assert reps % 2 == 1 and slabs.shape[0] == n_slabs

    rbench, rec = _ref_instance(argv)
    packed = layout == "packed"
    data = rbench._make_batch(rec)
    if packed:
        from ceph_tpu.ops.pallas_gf import pack_chunks
        staged = jnp.asarray(pack_chunks(data))
        iota = jnp.arange(n_slabs, dtype=jnp.uint32)[:, None, None, None,
                                                     None]
        step = rec.encode_chunks_packed_jax
    else:
        staged = jnp.asarray(data)
        iota = jnp.arange(n_slabs, dtype=jnp.uint8)[:, None, None, None]
        step = rec.encode_chunks_jax
    ref_slabs = staged[None] ^ iota
    assert np.array_equal(np.asarray(ref_slabs), slabs.numpy())

    def full_init(s):
        return jnp.zeros((s.shape[1], 2) + s.shape[3:], s.dtype)
    ref = ref_bench.build_chain(step, "carry", packed, full_init, reps)(
        ref_slabs)
    assert np.array_equal(np.asarray(ref), got.numpy())

    host = _host_step(_setup(port_bench, argv[:-2] + ["--device", "host"])
                      ._instance(), packed)
    expect = np.zeros_like(unpack_chunks(got).numpy() if packed
                           else got.numpy())
    for slab in slabs:
        expect ^= host(slab)
    assert expect.any()
    assert np.array_equal(unpack_chunks(got).numpy() if packed
                          else got.numpy(), expect)


@pytest.mark.parametrize("code,layout,erasures", [
    (RS, "bytes", "2"), (RS, "packed", "2"), (SHEC, "packed", "1"),
    (SHEC, "bytes", "2"), (LRC, "bytes", "1"),
])
def test_decode_loop_carry_equals_the_reference(code, layout, erasures):
    """--loop 3 decodes (one pass over 3 slabs of survivors): the carry
    equals the reference's build_chain with decode_chunks_jax (or its
    packed form) over the same slabs, and the numpy tier's decodes."""
    import jax.numpy as jnp
    argv = code + ["--size", "8192", "--batch", "2", "--loop", "3",
                   "--workload", "decode", "-e", erasures,
                   "--layout", layout]
    bench = _setup(port_bench, argv + ["--device", "cpu"])
    ec, data, allchunks, patterns = bench._decode_setup()
    pat = patterns[0]
    n = ec.get_chunk_count()
    available = tuple(i for i in range(n) if i not in pat)
    chained, slabs = bench._decode_chain(ec, allchunks, available, pat)
    got = chained(slabs)

    rbench, rec = _ref_instance(argv)
    assert rbench._erasure_patterns(rec, n)[0] == pat
    packed = layout == "packed"
    if packed:
        from ceph_tpu.ops.pallas_gf import pack_chunks
        staged = jnp.asarray(pack_chunks(allchunks))
        iota = jnp.arange(3, dtype=jnp.uint32)[:, None, None, None, None]
        step = rec.decode_chunks_packed_jax
    else:
        staged = jnp.asarray(allchunks)
        iota = jnp.arange(3, dtype=jnp.uint8)[:, None, None, None]
        step = rec.decode_chunks_jax
    ref_slabs = (staged[None] ^ iota)[:, :, np.array(available)]
    assert np.array_equal(np.asarray(ref_slabs), slabs.numpy())

    def full_init(s):
        return jnp.zeros((allchunks.shape[0], len(pat)) + s.shape[3:],
                         s.dtype)
    ref = ref_bench.build_chain(lambda s: step(s, available, pat), "carry",
                                packed, full_init, 1)(ref_slabs)
    assert np.array_equal(np.asarray(ref), got.numpy())

    host = _host_step(_setup(port_bench, argv[:-2] + ["--device", "host"])
                      ._instance(), packed)
    expect = 0
    for slab in slabs:
        expect = expect ^ host(slab, available, pat)
    assert np.array_equal(unpack_chunks(got).numpy() if packed
                          else got.numpy(), expect)


@pytest.mark.parametrize("loop,shape", [(32, (16, 2)), (16, (16, 1)),
                                        (1024, (16, 64))])
def test_even_step_count_carries_zero(loop, shape):
    """The step is linear and slab i is data ^ i, so the carry of T
    steps is the op of (T mod 2) * data ^ (the XOR of the slab indices):
    at an even T over 16 (or 8) slabs both terms vanish, whatever the
    step computes.  Even one pass over 16 slabs proves nothing; the
    carry is checked at an odd number of steps only."""
    bench = _setup(port_bench, RS + ["--size", "8192", "--batch", "2",
                                     "--loop", str(loop), "--device",
                                     "cpu"])
    ec = bench._instance()
    chained, slabs = bench._encode_chain(ec, bench._make_batch(ec))
    assert bench._loop_shape(16) == shape
    assert not chained(slabs).any()


@pytest.mark.parametrize("workload,code,extra", [
    ("encode", RS, ["--layout", "packed"]),
    ("encode", RS, []),
    ("decode", SHEC, ["--layout", "packed"]),
    ("decode", CLAY, []),
])
def test_slice_chain_runs_the_full_op_every_step(workload, code, extra):
    """--chain slice is honest for every code: the chain is eager, so
    each of the --loop steps runs the whole op on a whole slab, and the
    carry is the XOR of each step's first element."""
    argv = code + ["--size", "8192", "--batch", "2", "--loop", "7",
                   "--chain", "slice", "--workload", workload,
                   "--device", "cpu"] + extra
    bench = _setup(port_bench, argv)
    ec = bench._instance()
    packed = bool(extra)
    name = (f"{workload}_chunks_packed_torch" if packed
            else f"{workload}_chunks_torch")
    real = getattr(ec, name)
    outs = []

    def spy(*a):
        out = real(*a)
        outs.append((a[0].shape, out.clone()))
        return out
    setattr(ec, name, spy)
    if workload == "encode":
        chained, slabs = bench._encode_chain(ec, bench._make_batch(ec))
        want = (2, ec.get_coding_chunk_count())
    else:
        _, _, allchunks, pats = bench._decode_setup()
        avail = tuple(i for i in range(ec.get_chunk_count())
                      if i not in pats[0])
        chained, slabs = bench._decode_chain(ec, allchunks, avail, pats[0])
        want = (2, len(pats[0]))
    carry = chained(slabs)
    assert len(outs) == 7 and carry.shape == ()
    expect = 0
    for i, (shape, out) in enumerate(outs):
        assert tuple(shape) == tuple(slabs.shape[1:])
        assert tuple(out.shape[:2]) == want
        assert out.shape[2:] == slabs.shape[3:]
        first = out.reshape(-1)[0]
        expect ^= int(first.view(torch.int32) if packed else first)
    assert int(carry.view(torch.int32) if packed else carry) == expect


# -- decode row metadata ------------------------------------------------------

ENGINE_NAMES = {"xla": "torch", "pallas": "cuda"}


@pytest.mark.parametrize("code,erased,layout", [
    (RS, (0, 1), "bytes"), (RS, (2,), "packed"), (RS, (4, 5), "packed"),
    (SHEC, (0,), "packed"), (SHEC, (1, 4), "bytes"),
    (LRC, (0,), "bytes"), (LRC, (3,), "packed"),
    (CLAY, (0,), "packed"), (CLAY, (5,), "bytes"),
    (["--plugin", "jerasure", "-P", "technique=cauchy_good", "-P", "k=4",
      "-P", "m=2"], (0,), "bytes"),
])
def test_decode_row_meta_equals_the_reference(code, erased, layout):
    """The decode rows' provenance: equal XOR-schedule stats, the engine
    under the name map ("xla" is "torch", "pallas" is "cuda") — on the
    CPU against the reference's CPU backend, on the card against the
    reference's table forced to "pallas", and "numpy" for host rows."""
    from ceph_tpu.ops.pallas_gf import select_matrix_engine as ref_select
    packed = layout == "packed"
    argv = code + ["--size", "65536", "--batch", "4", "--workload",
                   "decode"]
    port = _setup(port_bench, argv + ["--device", "cpu"])
    ec = port._instance()
    n = ec.get_chunk_count()
    avail = tuple(i for i in range(n) if i not in erased)
    rbench, rec = _ref_instance(argv)
    got = port._decode_row_meta(ec, avail, erased, packed)
    ref = rbench._decode_row_meta(rec, avail, erased, packed)
    assert got["xor_schedule"] == ref["xor_schedule"]
    assert got["engine"] == ENGINE_NAMES.get(ref["engine"], ref["engine"])
    if ref["engine"] is None:
        assert got["engine"] is None
        return

    host = _setup(port_bench, argv + ["--device", "host"])
    ref_host = _setup(ref_bench, argv + ["--device", "host"])
    assert host._decode_row_meta(ec, avail, erased, packed) == \
        ref_host._decode_row_meta(rec, avail, erased, packed)

    card = _setup(port_bench, argv + ["--device", "cuda"])
    ms = port_bench.ErasureCodeBench._decode_matrix_static(ec, avail,
                                                           erased)
    chunk = ec.get_chunk_size(65536)
    shape = ((4, len(ms[0]), max(1, chunk // 512), 128) if packed
             else (4, len(ms[0]), chunk))
    ref_card = ref_select(shape, ms, 8, packed=packed, engine="pallas",
                          mesh=0)
    assert card._decode_row_meta(ec, avail, erased, packed)["engine"] == \
        ENGINE_NAMES.get(ref_card, ref_card)


# -- serving -----------------------------------------------------------------

def _stream(run):
    """(request id from the stream's first, op, plugin, stripe size,
    available, erased) of every served request, in id order (the
    completion order follows the real clock; ids come from a process-wide
    counter)."""
    reqs = sorted((r.request for r in run.results), key=lambda q: q.req_id)
    return [(q.req_id - reqs[0].req_id, q.op, q.plugin, q.stripe_size,
             tuple(q.available), tuple(q.erased)) for q in reqs]


@pytest.mark.parametrize("paged", [False, True])
def test_serving_stream_equals_the_reference(monkeypatch, paged):
    """The serving workload's seeded stream (request ids, ops, codecs,
    sizes, erasures) equals the reference's at the same --seed; every
    request verifies on both sides; the port's device executor on the
    CPU reports no kernel setup after warmup."""
    import ceph_tpu.serve as ref_serve
    from ceph_tpu.serve import verify_results as ref_verify
    from ceph_tpu_torch.serve import verify_results

    runs = []
    real = ref_serve.run_serving_scenario

    def capture(*a, **kw):
        runs.append(real(*a, **kw))
        return runs[-1]
    monkeypatch.setattr(ref_serve, "run_serving_scenario", capture)
    argv = ["--workload", "serving", "--requests", "24", "--size", "4096",
            "--seed", "7"] + (["--paged", "--page-size", "512"]
                              if paged else [])
    ref_row = _run(ref_bench, argv + ["--device", "host"])
    (ref_run,) = runs

    rows = {}
    for dev in ("host", "cpu"):
        bench = _setup(port_bench, argv + ["--device", dev])
        rows[dev] = bench.run()
        run = bench.last_run
        assert verify_results(run.results) == []
        assert _stream(run) == _stream(ref_run)
    assert ref_verify(ref_run.results) == []
    for dev, row in rows.items():
        assert set(row) == set(ref_row)
        assert row["requests"] == ref_row["requests"] == 24
        assert row["total_bytes"] == ref_row["total_bytes"]
        assert row["paged"] is paged
        assert set(row["tail_attribution"]) == set(
            ref_row["tail_attribution"])
    assert rows["host"]["stream_compiles"] is None
    assert rows["cpu"]["stream_compiles"] == 0
    assert rows["cpu"]["platform"] == "cpu"


# -- the bench line ------------------------------------------------------------

def test_bench_line_rows_are_bench_py_rows_on_the_card():
    """The line's rows are bench.py's argv with --device cuda."""
    import bench as ref_line

    def on_card(argv):
        return ["cuda" if a == "jax" else a for a in argv]
    assert bench_line.NORTH_STAR == ref_line.NORTH_STAR
    assert bench_line.DECODE_ROWS == [(n, on_card(a))
                                      for n, a in ref_line.DECODE_ROWS]
    assert bench_line.SERVING_ROWS == [(n, on_card(a))
                                       for n, a in ref_line.SERVING_ROWS]
    # the recovery rows: degraded stays on the host, the batched repair
    # and the churn run on the card
    assert bench_line.DEGRADED_COMMON == ref_line.DEGRADED_COMMON
    assert bench_line.DEGRADED_ROWS == [(n, on_card(a))
                                        for n, a in ref_line.DEGRADED_ROWS]
    for name, extra in bench_line.DEGRADED_ROWS:
        bench = _setup(port_bench, bench_line.DEGRADED_COMMON + extra)
        assert bench.args.device == ("host" if bench.args.workload
                                     == "degraded" else "cuda"), name
    assert bench_line.DEVICE_CHAOS_ROWS == [
        (n, on_card(a)) for n, a in ref_line.DEVICE_CHAOS_ROWS]
    assert bench_line.DEVICE_CHAOS_FIELDS == \
        ref_line.DEVICE_CHAOS_ROW_FIELDS
    assert bench_line.METRIC == \
        "encode_gbps_jerasure_rs_k8_m3_1MiB_stripes"
    for name, argv in bench_line.ENCODE_ROWS:
        bench = _setup(port_bench, argv)
        assert bench.args.device == "cuda" and bench.args.batch == 64
        if name == "percall":
            assert bench.args.resident and bench.args.iterations == 100
        else:
            assert bench.args.loop == 1024
            assert f"{bench.args.layout}_{bench.args.chain}" == name


def test_bench_line_without_a_card(capsys, monkeypatch):
    """No card: one parseable line, value null, an error naming the
    missing CUDA device, the host GB/s, platform null; exit 0."""
    monkeypatch.setattr(bench_line.torch.cuda, "is_available",
                        lambda: False)
    monkeypatch.setattr(bench_line, "native_baseline",
                        lambda: (None, "cpp-rs-avx2: not built"))
    assert bench_line.main() == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["metric"] == bench_line.METRIC
    assert line["value"] is None and line["vs_baseline"] is None
    assert "CUDA" in line["error"]
    assert line["host_gbps"] > 0
    assert line["topology"]["platform"] is None
    assert "partial_error" not in line
    assert not any(k.endswith("_rows") for k in line)


def test_bench_line_records_a_failing_degraded_row_as_null(monkeypatch):
    """A recovery row that fails is null in ``degraded_rows`` and named in
    ``partial_error``; it is never re-run on the host, and the rows that
    ran carry their recovery counts."""
    calls = []

    def fake_row(argv):
        bench = _setup(port_bench, argv)
        a = bench.args
        calls.append((a.workload, a.device))
        if a.workload == "recovery-churn":
            raise RuntimeError("recovery-churn: data loss")
        res = {"gbps": 1.0, "chain": a.chain, "loop": a.loop,
               "layout": a.layout, "platform": "gpu", "workload":
               a.workload}
        if a.workload == "repair-batched":
            res.update(pattern_batches=4, device_calls=4, host_batches=0)
        return res, 3

    monkeypatch.setattr(bench_line, "run_row", fake_row)
    monkeypatch.setattr(bench_line, "_host_run",
                        lambda batch, iterations: {"gbps": 0.5})
    monkeypatch.setattr(bench_line, "native_baseline",
                        lambda: (None, "cpp-rs-avx2: not built"))
    monkeypatch.setattr(bench_line, "card",
                        lambda: {"name": None, "power_limit": None})
    line = bench_line.measure()
    rows = line["degraded_rows"]
    assert set(rows) == {n for n, _ in bench_line.DEGRADED_ROWS}
    assert rows["rs_k8_m3_recovery_churn"] is None
    assert "degraded/rs_k8_m3_recovery_churn: RuntimeError" in \
        line["partial_error"]
    batched = rows["rs_k8_m3_repair_batched_e1"]
    assert (batched["pattern_batches"], batched["device_calls"],
            batched["host_batches"], batched["kernel_launches"]) == \
        (4, 4, 0, 3)
    assert "pattern_batches" not in rows["rs_k8_m3_scrub_e0"]
    assert [c for c in calls if c[0] == "recovery-churn"] == \
        [("recovery-churn", "cuda")]
    assert ("degraded", "host") in calls and \
        ("repair-batched", "cuda") in calls


def test_row_launch_count_reads_the_counters(monkeypatch):
    """run_row counts the kernel launches of one run (none on the
    CPU: the wrappers launch only on the card)."""
    res, launches = bench_line.run_row(RS + ["--size", "8192",
                                             "--device", "cpu"])
    assert res["workload"] == "encode" and launches == 0


def test_native_baseline_is_null_when_not_built(monkeypatch, tmp_path):
    monkeypatch.setattr(bench_line, "NATIVE_BENCH",
                        str(tmp_path / "ceph_erasure_code_benchmark"))
    gbps, src = bench_line.native_baseline()
    assert gbps is None and "not built" in src


def test_registry_instances_run_where_asked():
    """--device host and cpu build CPU instances; host pins the numpy
    tier."""
    for dev, inf in (("host", True), ("cpu", False)):
        ec = _setup(port_bench, RS + ["--device", dev])._instance()
        assert ec.device.type == "cpu"
        assert (ec.min_xla_bytes == float("inf")) is inf
    ref = RefRegistry.instance().factory("jerasure", {"k": "4", "m": "2"})
    port = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"k": "4", "m": "2"}, device="cpu")
    assert np.array_equal(ref.matrix, port.matrix)


def test_profile_dir_and_dump_perf(capsys, tmp_path):
    """--profile-dir records a torch.profiler trace of the run;
    --dump-perf prints the perf-counter registry to stderr, as the
    reference's does."""
    out = tmp_path / "trace"
    assert port_bench.main(RS + ["--size", "8192", "--device", "cpu",
                                 "--profile-dir", str(out),
                                 "--dump-perf"]) == 0
    err = capsys.readouterr().err
    assert "ceph_tpu_torch" in json.loads(err.strip().splitlines()[-1])
    trace = json.loads((out / "trace.json").read_text())
    assert trace["traceEvents"]


def test_line_turns_summarises_each_run():
    """tools/line_turns.py reads one bench line per checkout: the value,
    each encode row's host ms per step (64 MiB over its GB/s), the
    decode rows, the device-chaos row and the card."""
    from ceph_tpu_torch.tools import line_turns
    line = {"value": 800.0, "carry_chain_gbps": 800.0, "slice_gbps": 700.0,
            "percall_gbps": 900.0,
            "encode_rows": {"bytes_carry": {"gbps": 800.0},
                            "percall": {"gbps": None}},
            "decode_rows": {"rs_k8_m3_e2": {"gbps": 600.0},
                            "shec_k6_m3_c2_e1": None},
            "device_chaos_rows": {"rs_k8_m3_device_chaos": {
                "gbps": 0.01, "faults_fired": 4, "supervisor": {},
                "demoted_at_end": False, "kernel_launches": 9}},
            "topology": {"name": "card", "power_limit": "700.00 W"}}
    got = line_turns.summary("parent", line)
    assert got["root"] == "parent" and got["value"] == 800.0
    assert got["host_ms_per_step"] == {
        "bytes_carry": 64 * (1 << 20) / 800e9 * 1e3, "percall": None}
    assert got["decode_gbps"] == {"rs_k8_m3_e2": 600.0,
                                  "shec_k6_m3_c2_e1": None}
    assert got["device_chaos"] == {"gbps": 0.01, "faults_fired": 4,
                                   "supervisor": {},
                                   "demoted_at_end": False}
    assert got["card"] == {"name": "card", "power_limit": "700.00 W"}
    assert got["partial_error"] is None


# -- profile and autotune (the program profiler and the tuner) ----------------

LABELS = ("name", "plugin", "kind", "pattern", "profile", "devices",
          "batch", "config")


def test_profile_host_rows_equal_the_reference(capsys):
    """-w profile --device host: the numpy batch surfaces under the
    analytic cost model, on both packages the same rows (names, labels,
    cost, arguments), one sample a call."""
    argv = RS + ["--workload", "profile", "--size", "65536", "--batch",
                 "4", "--iterations", "3", "--device", "host", "--json"]
    assert port_bench.main(argv) == 0
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ref_bench.main(argv) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(port) == set(ref)
    assert port["programs"] == ref["programs"] == 2
    keep = LABELS + ("engine", "source", "flops", "bytes_accessed",
                     "arg_bytes", "calls", "platform")
    assert [{k: r.get(k) for k in keep} for r in port["profile_rows"]] == \
        [{k: r.get(k) for k in keep} for r in ref["profile_rows"]]
    for r in port["profile_rows"]:
        assert r["p50_ms"] > 0 and r["utilization_pct"] > 0


def test_profile_cpu_rows_are_the_engine_programs(capsys):
    """-w profile --device cpu: the serve encode, serve decode and fused
    repair callables, each a profiler program with the reference's
    labels (its rows on the CPU backend); the port's cost side is the
    analytic model over what each reads (the decode: the k survivors its
    matrix reads), the fused repair the sum of its decode and
    re-encode."""
    from ceph_tpu.telemetry import profiler as ref_prof
    from ceph_tpu_torch.telemetry import profiler as prof
    prof.global_profiler().reset()
    ref_prof.global_profiler().reset()
    argv = RS + ["--workload", "profile", "--size", "65536", "--batch",
                 "4", "--iterations", "2", "--json"]
    assert port_bench.main(argv + ["--device", "cpu"]) == 0
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ref_bench.main(argv + ["--device", "jax"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port["programs"] == ref["programs"] == 3
    rows = {r["kind"]: r for r in port["profile_rows"]}
    assert [{k: r.get(k) for k in LABELS} for r in port["profile_rows"]] \
        == [{k: r.get(k) for k in LABELS} for r in ref["profile_rows"]]
    assert {r["source"] for r in port["profile_rows"]} == {"analytic"}
    assert {r["calls"] for r in port["profile_rows"]} == {3}
    k, m, c = 4, 2, 65536 // 4
    enc = prof.analytic_matrix_cost(4, m, k, c)
    dec = prof.analytic_matrix_cost(4, 1, k, c)
    assert rows["serve-decode"]["bytes_accessed"] == dec["bytes accessed"]
    assert rows["serve-encode"]["bytes_accessed"] == enc["bytes accessed"]
    assert rows["fused-repair"]["bytes_accessed"] == \
        enc["bytes accessed"] + dec["bytes accessed"]


def test_autotune_host_is_the_analytic_sweep(capsys):
    """-w autotune --device host: the reference's analytic sweep, the
    same tuned keys and rows apart from its row-tile step (and, where
    the reference's process sees more devices than the port's one CPU,
    the device-count slot and the mesh fan-out row)."""
    argv = ["--workload", "autotune", "--device", "host", "--json",
            "--seed", "17"]
    assert port_bench.main(argv) == 0
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ref_bench.main(argv) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port["mode"] == ref["mode"] == "analytic"

    def slots(keys):
        return [k.split("|")[:4] for k in keys
                if "|row-tile|" not in k and "|mesh-fanout|" not in k]
    assert slots(port["tuned_keys"]) == slots(ref["tuned_keys"])
    assert [r["name"] for r in port["rows"]] == [
        r["name"] for r in ref["rows"]
        if r["kind"] not in ("row-tile", "mesh-fanout")]
    assert port["verified"] is True and port["config_source"] == "default"


def test_autotune_cpu_times_the_torch_tier(capsys):
    """-w autotune --device cpu: the timed sweep over the CPU's one
    tier (the torch tier), the encode and one decode unit, nothing
    pinned, every candidate's time in its row."""
    assert port_bench.main(RS + ["--workload", "autotune", "--device",
                                 "cpu", "--size", "16384", "--batch", "2",
                                 "--json"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["mode"] == "timed" and row["n_tuned"] == 0
    assert [r["name"] for r in row["rows"]] == [
        "jerasure.encode_chunks_jax", "jerasure.decode_chunks_jax"]
    for r in row["rows"]:
        assert list(r["candidates_ms"]) == ["torch"]
        assert r["before"]["engine"] == r["after"]["engine"] == "torch"
