"""ceph_tpu_torch.bench — the benchmark harness, a port of
``ceph_tpu/bench``.  Ported so far: ``erasure_code_benchmark.build_chain``
(the chained harness the roofline tool's kernel and harness probes run);
the benchmark CLI itself is not ported yet."""
