"""ceph_tpu_torch — the PyTorch/CUDA port of ceph_tpu.

A second package beside the JAX reference (``ceph_tpu``), written for an
NVIDIA H100.  It imports torch and numpy, never jax and nothing of
``ceph_tpu``: the host modules it needs are kept here as copies.

- ``gf``, ``matrices`` — GF(2^w) arithmetic and the jerasure / ISA-L
  generator matrices (numpy).
- ``ops`` — the numpy ground truth (``regionops``), the plain torch tier
  (``torch_ops``), the hand-written CUDA kernels and their wrappers
  (``gf_kernels``, ``csrc/``: the GF(2^w) matrix kernel, the packet
  bitmatrix kernel, the GF(2^8) XOR-schedule kernel), the XOR
  schedulers (``xor_schedule``: the GF(2^8) matrix scheduler and the
  bitmatrix CSE), and the cuda -> torch -> numpy tier policy
  (``fallback``).
- ``codes`` — the erasure-code plugin framework: registry, jerasure (all
  seven techniques: reed_sol_van and reed_sol_r6_op at w=8/16/32, and
  the bitmatrix techniques cauchy_orig, cauchy_good, liberation,
  blaum_roth, liber8tion), isa (reed_sol_van, cauchy), shec (minimum-read
  plans, ``codes.linear``), lrc (layers and kml), example; and
  ``codes.engine``, the process-wide pattern cache and the serving
  dispatch seams.
- ``serve``, ``scenario`` — the paged (and dense) serving plane: the
  admission queue, the continuous batcher, the paged stripe pool, the
  SLO ledger, the load generator and its event loop.
- ``crush`` — CRUSH placement: the host mapper and map forms (copies of
  the reference's), the OSDMap pipeline, the upmap balancer, EC pool
  creation, and the bulk evaluator (eager torch on the card);
  ``bench`` holds the ``crushtool`` and ``osdmaptool`` CLIs beside the
  erasure-code benchmark.
- ``chaos``, ``scrub``, ``recovery`` — seeded fault injection and map
  churn, deep scrub and (batched) repair with the fused decode →
  re-encode on the card, and the epoch-fenced recovery orchestrator;
  ``crush.incremental`` carries the OSDMap epochs they fence on.
- ``telemetry``, ``utils`` — metrics, spans, causal tracing, histograms,
  the flight recorder and the dump schema; clocks, bounded retry,
  logging, locks, errors, the erasure-code profile store.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``).
"""
