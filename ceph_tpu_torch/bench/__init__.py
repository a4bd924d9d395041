"""ceph_tpu_torch.bench — the benchmark harness, a port of
``ceph_tpu/bench``.

- ``erasure_code_benchmark`` — the ``ceph_erasure_code_benchmark`` CLI
  (``ErasureCodeBench``: the encode, decode, recovery, serving,
  cluster, scenario and tenant-week workloads) and
  ``build_chain``, the chained harness its ``--loop`` mode and the
  roofline tool share.
- ``bench_line`` — the port's bench line: one JSON line of the card's
  encode, decode and serving rows.
- ``non_regression`` — the byte-stability corpus check.
- ``erasure_code_tool`` — the ``ceph_erasure_code`` CLI.
- ``crushtool`` — the ``crushtool`` CLI (``--test`` sweeps on the bulk
  evaluator, ``--device cuda|cpu``).
- ``osdmaptool`` — the ``osdmaptool`` CLI (``--test-map-pgs``,
  ``--upmap``, ``--createsimple``, ``--print``, ``--create-ec-pool``).
- ``sweep`` — the bench.sh grid: one JSON line per (plugin, technique,
  k, m, workload) cell; profile rejections soft-fail a cell, device
  failures propagate.
"""
