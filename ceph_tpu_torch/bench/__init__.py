"""ceph_tpu_torch.bench — the benchmark harness, a port of
``ceph_tpu/bench``.

- ``erasure_code_benchmark`` — the ``ceph_erasure_code_benchmark`` CLI
  (``ErasureCodeBench``: the encode, decode and serving workloads) and
  ``build_chain``, the chained harness its ``--loop`` mode and the
  roofline tool share.
- ``bench_line`` — the port's bench line: one JSON line of the card's
  encode, decode and serving rows.
- ``non_regression`` — the byte-stability corpus check.
- ``erasure_code_tool`` — the ``ceph_erasure_code`` CLI.

Not ported yet: ``crushtool``, ``osdmaptool`` (ROADMAP Queue A item 3)
and ``sweep`` (item 7).
"""
