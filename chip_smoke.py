#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ceph_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with a CUDA device.  It
builds every kernel from ``ceph_tpu_torch/ops/csrc`` (one ``nvcc`` per
source, all started together) and then, in order:

1. prints the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions and the kernel build time;
2. holds each kernel against its plain torch version on the card
   (``torch.equal``: GF(2^w) and GF(2) math is integer, so the tolerance
   is 0):

   - the GF(2^8) kernel (bytes and packed wrappers): the jerasure RS k=8
     m=3 matrix at (64, 8, 131072), random matrices with zero entries for
     r in {1, 3, 8, 11}, a chunk size off the 16-byte vector (4096 + 4),
     no leading batch dimension, a strided survivor slice; the RS decode
     e=2 matrix at 1, 4 and 64 stripes, on both sides of the kernel's
     one-wave rule (``gf_kernels.dense_plan`` reports the grid);
   - the w=16/32 word kernel: the reed_sol_van k=8 m=3 matrices at (64,
     8, 65536) words, random matrices, a tail, a strided slice;
   - the packet-layout bitmatrix kernel through both its wrappers (the
     plain product and a CSE schedule): the jerasure cauchy_good k=8 m=3
     bitmatrix (packetsize 2048) and its e=2 decode schedule at (64, 8,
     131072), and random bitmatrices for w in {6, 7, 8} and packetsizes
     {8, 32, 2048}, with and without a leading batch dimension, through a
     strided survivor slice; the cauchy_good decodes (3,), (3, 9) and
     (5, 6, 7) at 4 stripes (row groups on grid y) and 64 (one group)
     through the wrappers, and random bitmatrices at the packet sizes
     that take each other unit width (16 bytes at 32, 4 at 12, 1 at 3);
   - the XOR-schedule kernel (bytes and packed wrappers): the
     reed_sol_r6_op k=8 m=2 encode schedule (the ring transform) at (64,
     8, 131072), an lrc k=4 m=2 l=3 local repair at (64, 7, 262144), the
     4 shec k=4 m=3 c=2 plans that take a schedule, random sparse and
     monomial schedules, a strided slice and C = 4096 + 4;
   - the ragged kernel (bytes and packed wrappers): the serving pool
     (512 pages, 8 rows, 4096 bytes) under a scattered half-live, an
     all-dead and an all-live mask, for the RS encode matrix and random
     r in {1, 3, 11}, also against the dense kernel on the masked pool;
     dead pages must be zero;
   - the "mxu" row's column-walk kernel (bytes and packed wrappers),
     against its plain version over the same kernel data
     (``apply_matrix_walk_torch``) and the reference's MXU twin
     (``apply_matrix_mxu_torch``): the clay k=8 m=4 d=11 encode
     composite (256 x 512) at (64, 512, 2048), a (64, 704)
     single-erasure decode composite at (4, 704, 2048), where the kernel
     splits the columns, and at (64, 704, 2048), where it does not,
     random matrices with zeros for r in {16, 64, 300, 513, 600} (up to
     three row tiles) and s from 24 to 704, C off the tile and the word
     (2048 + 4, 1000, 1003), no batch dimension, with and without the
     split;
   - the dense kernel's table variant (a table above 2048
     coefficients): the four clay (64, 704) parity repair composites,
     dense and ragged (half-live mask), bytes and packed;
   - the roofline probes' copy and fold kernels on a (64, 8, 256, 128)
     slab (64 MiB);

   and two stripes of each against the numpy ground truth;
3. drives the paths through the entry points a user calls, each with
   the kernel launch counters set to 0 just before it and read just
   after; every kernel a path runs must have launched there:

   - RS: ``ErasureCodePluginRegistry.factory("jerasure", reed_sol_van
     k=8 m=3)`` on the card encodes 64 x 1 MiB stripes through
     ``encode_chunks_torch``, ``encode_chunks_batch`` and the packed
     entry, decodes every 1-, 2- and 3-erasure pattern (231) of a
     4-stripe batch in both layouts and checks the recovered bytes, and
     runs the isa reed_sol_van k=8 m=3 code once;
   - cauchy_good: jerasure cauchy_good k=8 m=3 (packetsize 2048) encodes
     64 x 1 MiB through ``encode_chunks_torch`` and
     ``encode_chunks_batch``, and decodes all 231 patterns of a 4-stripe
     batch through ``decode_chunks_torch`` (9 plain, 222 scheduled
     launches), then repeats them warm: the same launches and bytes, no
     kernel setup;
   - minimal density: liberation k=7 w=7, blaum_roth k=6 w=6 and
     liber8tion k=8, an encode and a decode each;
   - wide words: reed_sol_van w=16 and w=32 k=8 m=3, an encode and a
     3-erasure decode each;
   - lrc k=4 m=2 l=3: 64 x 1 MiB encode through ``encode_chunks_torch``
     and the packed entry, and all 36 one- and two-erasure decodes of a
     4-stripe batch in both layouts (29 take the XOR-schedule kernel);
   - r6: jerasure reed_sol_r6_op k=8 m=2, 64 x 1 MiB encode through the
     tensor and packed entries (the XOR-schedule kernel) and its 55 one-
     and two-erasure decodes in both layouts (the XOR-schedule kernel for
     (9,) and (8, 9), the dense kernel for the rest);
   - shec k=4 m=3 c=2: 64 x 1 MiB encode, and every 1-, 2- and 3-erasure
     pattern of a 4-stripe batch in both layouts (the undecodable ones
     must raise);
   - serving: one closed-loop stream of 512 requests (64 in flight;
     RS k=8 m=3 at 64 KiB, 1 MiB and 4 MiB, shec k=6 m=3 c=2 at 1 MiB;
     encode / decode / repair) through ``run_serving_scenario`` on the
     real clock, dense (rung ladder 1/4/16/64) and paged (pages of 4096
     bytes, 512 per pool): every output verified byte for byte, no
     kernel setup after warmup, the pools drained; the ragged kernel
     launches on the paged run and never on the dense one;
   - ``apply_matrix_packed_best_ragged``, the packed ragged ops entry,
     once;
   - clay: ``factory("clay", k=8 m=4 d=11)`` on the card encodes 64 x
     1 MiB stripes through ``encode_chunks_torch``,
     ``encode_chunks_batch`` and the packed entry, decodes all 78 one-
     and two-erasure patterns of a 4-stripe batch in both layouts (the
     column-walk kernel on the 74 "mxu" patterns, the dense kernel's table
     variant on the 4 parity repairs), repairs one chunk through the
     dict API from the sub-chunk runs of ``minimum_to_decode``, and runs
     clay k=4 m=2 d=5 once;
   - the serving stream above carries the reference ``default_spec``'s
     clay share (clay k=8 m=4 d=11 at 1 MiB, weight 1 beside RS 3 and
     shec 2), dense and paged;
   - the roofline tool (``ceph_tpu_torch.tools.roofline``): its five
     probes at 64 MiB slabs, loop 64;
4. times each kernel, its plain version and a copy of the same bytes
   with CUDA events at its main shape, with the host's issue time beside
   it, and each kernel's own device time per launch from a profiler
   trace, against the bound (the program profiler's analytic cost,
   ``telemetry/profiler.py``, at the card's roofline: the larger of the
   bytes over HBM bandwidth and the integer ops over the INT32 peak,
   the GF(2^w) matrices' ops
   the floor of the chain per column and per row,
   ``gf_kernels.sm90_op_floor``; for the "mxu" row the dense GEMM at the
   int8 peak, the reference's MXU form, printed beside it as the GEMM
   bound); the dense kernel's by-value and table variants on the RS k=8
   m=3 encode (w=8 and w=16); the dense kernel at the shapes of
   ``ceph_tpu_torch/tools/dense_times.py`` (the RS encode, the decode
   e=2 at 4 and 64 stripes, e=1 at 4, clay's (64, 704) repair through
   the device program, w=16/32, the ragged pool) with the instructions
   per word position its row program spends and its grid; the packet
   kernel at the shapes of ``ceph_tpu_torch/tools/packet_times.py`` (the
   cauchy_good encode plain and scheduled, the scheduled decode (3, 9)
   at 4 and 64 stripes, the plain decode (3,) at 4, a random w=7
   bitmatrix at packetsize 32) with its bound and plan; the RS path's
   launches per decode call (phase 3); the ragged kernel at 25,
   50 and 100 % live pages beside the dense kernel on the same bytes;
   the host-to-device copy of one pool; the serving runs' GB/s, GB/s
   under SLO and p50/p99 per op, and where one fire's time goes (copy
   in, the call, copy out, demux), paged and dense; and prints one JSON
   line ``{"kernels": [...]}`` (thirteen wrappers, and the CRUSH rule
   kernel from phase 6; "ms" is the profiler's
   device time, the event time where the trace has no kernel); the
   column-walk kernel on the three clay shapes (the encode, the (0,)
   decode and the (8,) repair; the two decodes split their columns at
   4 stripes and are also timed at 64, where they do not split),
   beside the dense kernel and ``torch._int_mm`` on the materialised
   bit-planes of the same matrices (the library GEMM, timed here and
   used nowhere in the port) and the bit-plane kernel's earlier times,
   each with its share of the floor; the copy kernel, ``copy_`` into a
   buffer allocated once and ``clone`` in turns on the same slab; the
   host issue per call of clay's encode and decode entry points, and the
   host time of the clay composite probes.

5. runs the bench line's rows (``ceph_tpu_torch/bench/bench_line.py``)
   through ``ErasureCodeBench`` in this process with ``--json --device
   cuda``, each with the launch counters at 0 just before it and read
   just after: the four headline encode candidates (packed/slice,
   packed/carry, bytes/carry at ``--batch 64 --loop 1024``, the resident
   per-call run), the three decode rows (RS k=8 m=3 e=2, shec k=6 m=3
   c=2 e=1, clay k=8 m=4 d=11 e=1) and the two serving rows (256
   requests of 64 KiB, dense and paged).  Every row must launch a kernel
   and report ``platform: "gpu"``; each --loop row's configuration runs
   once more at an odd number of steps (15 encodes, 7 decodes), its
   carry held byte for byte to the numpy tier's outputs XORed over the
   same slabs (at an even count the carry cancels whatever the step
   computes); the serving rows must verify with no kernel setup after
   warmup; the profiler's device time per chain step is printed beside
   each row's GB/s; ``non_regression.check`` runs every corpus entry on
   the card with 0 errors.  It prints one ``{"bench": {...}}`` line.

6. CRUSH on the card (``ceph_tpu_torch/crush/bulk.py``; its first rung
   the rule kernel, ``ops/csrc/crush_rule.cu``, where the map and rule are
   in its scope, the deeper rungs eager torch): three rows through
   ``crushtool.main([...,
   "--test", "--engine", "bulk", "--device", "cuda",
   "--show-statistics"])`` over x in 0..999999 — A: ``--build-two-level
   8 4`` (32 OSDs, straw2), rule 0 (``chooseleaf firstn`` host),
   ``--num-rep 3``; B: the same map with the canonical EC rule
   (``add_erasure_rule``: set_chooseleaf_tries 5, set_choose_tries 100,
   take root, chooseleaf indep 0 host, emit), ``--num-rep 6``; C:
   ``--build-two-level 100 12`` (1200 OSDs) with the rule the port's
   ``create_rule`` emits for jerasure reed_sol_van k=8 m=3,
   crush-failure-domain=host, ``--num-rep 11``.  Each row prints its
   mappings/s and host-residue lanes, and from one profiled sweep
   (``torch.profiler``, the card's events only) the device time, kernel
   launches and host syncs per block, the card's busy share and the
   peak memory above what was allocated before the sweep; the card's
   rows must equal the host mapper on a seeded sample (1000 x; 500 on
   row C, whose Python mapper takes ~0.1 s an x) plus a seeded sample
   of 8000 of the lanes the first rung flagged and every lane of the
   host residue, the CPU evaluator (``device="cpu"``) on x < 4096 and
   every flagged lane, and
   the profiled sweep's per-device counts those of the crushtool sweep;
   each row's profiled sweep must launch the rule kernel (its output
   held as ``crush_rule_cuda`` against the CPU evaluator, so phase 12
   may launch it; the launch counters are reset before each profiled
   sweep, and the three sweeps' launches are the kernel's ``launches``
   in the ``{"kernels": [...]}`` line).  The rule kernel alone at the
   remap cell's shape (``ceph_tpu_torch/tools/crush_times.py``: 16384
   pps seeds, 100 hosts x 12, the EC rule, 8 OSDs down and 40
   reweighted) gives that line's device ms, operations bound and the
   eager tier's sweep.  The host mapper runs in CRUSH_PROCS
   spawned processes beside the card's later rows; its verdicts are read
   after the last row.  Then,
   on row C's map, ``osdmaptool --create-ec-pool`` makes a k=8 m=3 pool
   with ``--pg-num 16384`` (1200 OSDs x 100 PGs per OSD / 11 shards,
   rounded up to a power of two), ``--test-map-pgs`` runs on the card
   and its arrays must equal the host engine's on a 500-PG sample, and
   ``--upmap --upmap-max 100`` runs, its moves and deviation printed.

7. scrub -> repair -> recover on the card (``scrub/``, ``recovery/``,
   ``chaos/``), at Ceph's defaults: 4 MiB objects (RADOS's default
   object size) of jerasure reed_sol_van k=8 m=3.  Each workload runs
   through ``ErasureCodeBench`` with the launch counters at 0 just
   before it and read just after, and each of its timed passes is
   probed (``PassProbe``: launches, wall time, span roots, the fused
   calls' device time by CUDA events):

   - 7a ``-w repair-batched --size 4194304 --batch 8 -e 2
     --corruptions 1 --iterations 1``: 8 objects, 3 bad shards each
     (the whole budget), 4 patterns; one device call per pattern, no
     host batch, the dense kernel in every timed pass, every healed
     store equal to its object and to the host path's heal
     (``device=False`` on a CPU instance pinned to the numpy tier);
   - 7b ``-w recovery-churn --size 4194304 --batch 8 -e 1
     --churn-every 2 --iterations 1``: converged, nothing
     unrecoverable, every store healed, the map advanced; replans,
     regroups and rounds printed;
   - 7c ``-w degraded --size 1048576 --batch 4 -e 2 --corruptions 1``:
     the per-object repair through the stripe layer, healed;
   - 7d each family once (``FAMILIES``: jerasure reed_sol_van and
     cauchy_good, isa k=8 m=3, shec k=6 m=3 c=2, lrc k=4 m=2 l=3, clay
     k=8 m=4 d=11): ``repair_batched`` on 6 objects of ~1 MiB with 3
     decodable patterns, equal to the objects and the host path; the
     kernel ``select_matrix_engine`` names for each pattern's decode and
     for the encode must have launched;
   - 7e 4 bad shards of a k=8 m=3 object raise ``UnrecoverableError``,
     and its flight-recorder dump passes ``validate_flight_dump``.

   7a-7c print GB/s, p50/p99 per pass, the seconds in each span
   (``scrub``, ``plan``, ``dispatch``, ``verify``) and the fused calls'
   device ms against the pass's wall time; the phase prints its own
   seconds and one ``{"recovery": {...}}`` line.

8. the supervised dispatch plane on the card (``ops/supervisor.py``,
   ``ops/fallback.py``'s live tier, ``utils/locks.py``):

   - 8a clean: with no fault plan armed, one fused repair per family
     (``FAMILIES``, a stack of ``REPAIR_STRIPES`` 6 objects of ~1 MiB)
     under the supervisor launches exactly the kernels the same call
     launches with the nested-seam mark set (its body alone), makes one
     supervised dispatch, returns the host path's bytes, and leaves
     retries, demotions, host completions and rung downshifts at 0; a
     warm RS fused call under ``torch.cuda.set_sync_debug_mode("warn")``
     warns of nothing the unsupervised call does not; the host cost of
     one clean dispatch (the dispatch alone on a no-op body, the fused
     repair and ``apply_matrix_best`` on small stacks): issue time per
     warm call, supervised minus unsupervised, best of 10 turns;
   - 8b the CLI's ``-w device-chaos --size 4194304 --batch 32 -e 2
     --device cuda --iterations 1 --seed 42``: 4 faults fired, a retry
     and a rung downshift (both launch the kernel again), the loss
     raised twice as ``DeviceDispatchError`` and the pass re-queued (the
     card's work never moves to the plain ops or the host: no demotion,
     no host completion, no re-promotion), the heal byte for byte; then
     one clean fused call launches the dense kernel at tier cuda; GB/s
     and the split of a pass printed;
   - 8c a real ``torch.cuda.OutOfMemoryError`` in a child process
     (``--child oom``): a fused repair of 256 objects of 4 MiB under
     ``torch.cuda.set_per_process_memory_fraction`` set between the
     unsplit call's peak and its halves'; the unsplit call raises, the
     supervised call splits the rung, returns the unsplit bytes and
     demotes nothing;
   - 8d CRUSH row A (32 OSDs, chooseleaf firstn host, 3 replicas) over
     65536 x in blocks of 1024 lanes: a ``transient`` fault at
     ``crush.bulk_rule`` is retried and the mappings equal the unfailed
     sweep; a ``backend_loss`` fault raises ``DeviceDispatchError``
     naming the seam (no host mapper takes the card's block), and the
     sweep run again once it clears equals the unfailed one;
   - 8e a 64-request dense serving run (the bench's serving row, cut)
     with one ``transient`` fault at ``engine.serve-encode``: every
     request verified, one retry, nothing demoted;
   - 8f 8b again in a child process under ``CEPH_TPU_LOCKCHECK=1``
     (``--child lockcheck``): a report that passes
     ``validate_lockcheck_report``, with no order violation, no blocking
     event and no unregistered lock.

   8c and 8f start after 8a and run beside 8b, 8d and 8e; the phase
   prints one ``{"supervisor": {...}}`` line.

9. the data plane on the card (``parallel/``, the mesh row of
   ``select_matrix_engine``, the engine's mesh variants, the
   supervisor's member and host quarantine), over 4 virtual members of
   the card (``CEPH_TPU_TORCH_VIRTUAL_DEVICES=4``, set around the phase):

   - 9a the mesh tier at full width: RS k=8 m=3, 64 stripes of 1 MiB,
     bytes and packed, and 63 stripes (padded to 64): equal to the
     single-device call and (two stripes at each end) the numpy tier;
     one ``engine_mesh_dispatches``, the partition [16, 16, 16, 16],
     launches 4 x the single-device call's; device ms (profiler) and
     host issue ms per call beside the single-device call's;
   - 9b each family's fused repair, serving encode and decode on stacks
     of ``MESH_STRIPES`` (16 and 14) objects of ~1 MiB, 4 stripes a
     member (the 14 padded to 16), and the page-sharded ragged encode
     on the (512, 8, 4096)
     pool at half-live pages, each equal to its single-device callable;
     the pattern-cache keys with and without the plane;
   - 9c row B (the canonical EC rule, 1M x) through
     ``sharded_bulk_do_rule``: equal to the single-device sweep on every
     lane and to the host mapper on 100 seeded x; ``--test-map-pgs``
     (``osdmaptool.test_map_pgs``) with ``engine="sharded"`` equal to
     ``"bulk"`` on a 16384-PG EC pool of row C's map;
   - 9d ``sharded_encode`` on (2, 2) and (1, 4) meshes equal to the
     single-device encode, ``sharded_roundtrip_step`` and
     ``sharded_single_erasure_repair`` for jerasure, shec and clay
     (``n_read`` = ``minimum_to_decode``'s size);
   - 9e the CLI's ``-w multichip`` at the north-star argv (batch 64 of
     1 MiB, 100 iterations): GB/s, ``mesh_shape`` [4, 1], ``n_devices``
     4, ``physical_devices`` 1, the partition, verified; beside it the
     per-call resident encode row;
   - 9f the CLI's ``-w host-chaos --size 4194304 --batch 16 -e 1 --hosts
     2``: one host quarantine (2 hosts -> 1), the reclaim hook, one host
     re-promotion, no card failure, no demotion, healed byte for byte;
     then a loss of two calls at ``engine.fused_repair`` on the 4-member
     plane: quarantines 4 -> 2 -> 1 on the card and a re-promotion to 4;
     the same loss with no plane raises ``DeviceDispatchError``; and the
     host-chaos row again with no virtual members (one card, no plane):
     host 0's loss raises twice, the pass is re-queued, no demotion;
   - 9g ``host_chaos_selftest()`` (its rows are numpy, so its plane is
     4 virtual members of the CPU), and 9f's row in a child
     under ``CEPH_TPU_LOCKCHECK=1`` (``--child plane-lockcheck``, started
     at the phase's start): a clean report that holds the plane's lock.

   The phase prints one ``{"data_plane": {...}}`` line.
10. the program profiler, the tuning table and the entry-point registry
   (``telemetry/profiler.py``, ``tune/``, ``analysis/``), with the
   launch counters at 0 just before and read after 10c (the dense,
   ragged, XOR-schedule, packet and column-walk kernels must launch):

   - 10a the CLI's ``-w profile`` at the north-star argv (RS k=8 m=3,
     1 MiB, batch 64, 20 rounds): one row per program (serve encode,
     serve decode, fused repair), each ``source`` "analytic" with a p50
     from CUDA events and a utilization in (0, 100]; the serve-encode
     row's p50 within 10 % of the ``torch.profiler`` kernel time of the
     same call, and, where it runs the dense kernel, its utilization
     within 7 % of the kernel table's 100 x 0.027545 / 0.041319; then
     ``-w profile`` for jerasure cauchy_good k=8 m=3 (the packet kernel)
     and shec k=6 m=3 c=2 (the XOR-schedule kernel on its decodes), 1
     MiB, batch 64, 5 rounds: three rows each, utilization in (0, 100];
   - 10b the registry audit of every entry (``analysis/audit.py``) on
     the card, the sharded ones over 4 virtual members: kernel setups
     cold within budget and none warm, no host sync on a warm repeat
     under ``torch.cuda.set_sync_debug_mode("error")`` but CRUSH's
     declared one, every tier's bytes equal; one line per entry;
   - 10c ``tune.sweep.timed_sweep`` of reed_sol_van k=8 m=3 and
     reed_sol_r6_op k=8 (1 MiB, batch 64): each candidate's min device
     ms, the default and the winner, byte identity asserted in the
     sweep; whether the dense kernel beats the XOR schedule on the r6
     encode (a measurement, not a check);
   - 10d in a child (``--child tune-table``) the CLI's r6 encode row
     under ``--tune-table`` with 10c's table: ``config_source`` tuned,
     its launches, the routed kernel and its device ms a call, the
     bytes equal the default regime's; the same table with another
     card's name: ignored (``tune_config_stale``), the default route,
     the same bytes;
   - 10e ``CEPH_TPU_COMPILE_CACHE`` at an empty directory in two
     children (``--child build-cache``): the first builds (misses, nvcc
     runs), the second loads every library with no nvcc run and no
     miss.

   The phase prints one ``{"profiler": {...}}`` line.
11. the cluster plane and the scenarios (``cluster/``, ``scenario/``,
   ``bench/sweep.py``), with no data plane active (checked at the start
   and the end: a plane would change every rateless plan), the launch
   counters read around each run:

   - 11a the CLI's ``-w cluster`` at the north star's code (jerasure
     reed_sol_van k=8 m=3, 1 MiB, batch 8) and the reference's 10k-OSD
     acceptance shape: ``--osds 10000 --cluster-pgs 1024
     --storm-events 12`` (``ClusterSpec.sized(10000)``: 20 racks x 25
     hosts x 20 OSDs, 1024 replicated PGs and 128 EC PGs on the card's
     bulk evaluator, a 12-event storm with ``max_down=8``, the storm
     equivalence gate, the balancer to deviation 1, a rateless recovery
     of 8 objects under a 10x straggler on shard 0): verified, the
     balancer converged at max deviation <= 1, p99 ratio <= 2, a
     straggler reassignment, the dense kernel launched; prints the
     build, storm, balance and recovery seconds, the bulk evaluator's
     blocks and their device ms (the profiler's ``crush.bulk_rule``
     rows) and the recovery's spans (scrub, decode, verify, writeback);
   - 11b ``ClusterSpec.sized(120, seed=7, replicated_pg_num=128,
     ec_pg_num=32)``: a 6-event storm and the balancer on the card's
     bulk evaluator give the host mapper's ``StormReport``,
     ``BalanceReport`` and upmap items (the host side runs in a child,
     ``--child cluster-host``, beside 11a);
   - 11c ``default_scenario(seed=42, n_requests=64, damaged_objects=3,
     storm_events=4)`` on a FakeClock with ``throughput_service_model()``
     on the card and on the CPU, arbiter on and off: each report's JSON
     and dispatch log equal across the two, and the arbiter's client
     p99 and miss rate strictly better; then the CLI's ``-w scenario``
     on the real clock (256 requests of 1 MiB, batch 8, 12 storm
     events) and its ``--no-arbiter`` control, after the recovery code's
     single-erasure repairs are set up once: verified,
     ``stream_compiles`` 0; GB/s under SLO, p50, p99, the miss rate and
     ``tail_attribution`` printed;
   - 11d the CLI's ``-w tenant-week --iterations 2``: the gates and the
     isolation gate hold; with ``--no-arbiter`` the row reports the gate
     failing; ``run_tenant_week`` on the card and on the CPU give equal
     ``dispatch_crc`` and report JSON;
   - 11e the registry's six cluster and scenario entries audited on the
     card: clean, the two cluster rules' declared syncs only; 59 names;
   - 11f ``bench.sweep.main`` over jerasure k=8 m=3 at 1 MiB, batch 8,
     on the card: every cell the profile accepts carries ``gbps``; the
     only errors are liberation's two cells (k=8 > w=7), with the
     reference's text.

   The phase prints one ``{"cluster_scenario": {...}}`` line.
12. the repo-root tools, demos and examples (``ceph_tpu_torch/tools/``)
   on the card, each at its reference defaults, in-process through its
   ``main(argv)`` (``TOOL_RUNS``) with a new process's global state
   (policy, supervisor, flight recorder, pattern cache; no plane, no
   armed fault plan) and the launch counters read around it:
   ``bulk_crush_row`` and ``--ec`` at 1M x (the mappings/s beside
   phase 6's row A); ``perf_dump --scenario both --validate``,
   ``--profile --validate``, ``--scenario unrecoverable
   --flight-recorder --validate`` and ``--check-overhead 3`` (rc 0 or
   3: on the card's host its 3 % verdict is noise, so both series and
   the verdict are printed, not held);
   ``trace_view --run-scenario --check``; ``bench_diff`` over phase 5's
   rows of this run (the same line clean, rc 0; at half its GB/s a
   regression, rc 4); the eight demos (rc 0) and their arms past the
   erasure budget (rc 2; ``cluster_demo``'s after a 2-event storm),
   ``cluster_demo`` at its 400 OSDs and
   ``host_chaos_demo`` over PLANE_MEMBERS virtual members of the card;
   ``replay_bisect --days 1``, plain and ``--inject-jitter`` (the
   divergence localized to a dispatch checkpoint); the two examples;
   and ``host_chaos_demo --kill-one``, two worker processes on the card
   started once the overhead gate is done (it times host-paced runs, so
   nothing of this script runs beside it) and read at the phase's end
   (the survivor reports its own launches).  Every kernel a tool launched must have
   been held against its plain version in phases 2-4, and the dense
   GF(2^8) kernel must be among them.  The phase prints one ``{"tools":
   {...}}`` line: per tool its rc, seconds and launches.

13. ``plugin=cuda``, the native bridge (``ceph_tpu_torch/native``):
   the registry, the AVX2 ``rs`` plugin, ``libec_cuda.so`` and the tools
   built from the checkout with ``c++`` (``native/build.py``, started in
   phase 1 beside the ``nvcc`` runs); the corpus's RS k=4 m=2, shec k=6
   m=3 c=2 and RS k=8 m=3 entries encoded by the unmodified
   ``ceph_erasure_code`` through ``plugin=cuda``, byte for byte (their
   stripes are below ``min_xla_bytes``, so the port runs the reference's
   host rule for them); a seeded 1 MiB RS k=8 m=3 payload encoded by the
   same tool through ``plugin=cuda`` on the card, whose counters (read
   in the tool's process, ``CEPH_TPU_BRIDGE_STATS``) must show a
   device-tier call and a launch of the dense GF(2^8) kernel, and whose
   11 chunks must equal the same tool's with ``-P device=cpu`` and
   ``regionops.matrix_encode`` here; ``ceph_erasure_code_benchmark -p
   cuda`` and ``-p rs`` on the north star's flags (RS k=8 m=3, 1 MiB,
   500 encodes, 200 decodes ``-e 2`` and 200 on the fixed pattern
   ``--erased 0 --erased 9``), each GB/s printed, and for ``-p cuda``
   the bridge's own time per call read inside the tool (taking the GIL,
   the copies in, the port's call, the copies out; a decode's first use
   of a pattern apart from its repeats, with the steady-state GB/s);
   ``bridge_mt`` (init on the main thread, round trips from two more, 1
   MiB stripes) on the card, whose counter line, read inside the C++
   process, must show device-tier calls and launches of the dense
   GF(2^8) kernel (row 1), each kernel held in phases 2-4; the no-card
   arm (``CUDA_VISIBLE_DEVICES=``) must exit non-zero naming
   ``NoDeviceError``; and ``python -m ceph_tpu_torch.tools.lint`` with
   its ``--conc`` and ``--det`` forms must exit 0.  The encodes,
   ``bridge_mt``, the lint tiers and the arm run side by side, the
   benchmarks one at a time.  Then where a bridge encode's time goes, in this process (host
   ms per stripe): the tool's call, the dict API the plugin calls, the
   batch entry on a host array, the apply on a card tensor.  The phase
   prints one ``{"bridge": {...}}`` line.

Every phase prints its own seconds: phases 1-4 a ``{"phase": N,
"seconds": S}`` line, phases 5-13 a ``seconds`` key in their line; a
``{"phase_seconds": {...}}`` line follows phase 13.  The last line of
standard output is ``{"ok": true, "device": {...}}``, after the
``{"kernels": [...]}`` line.
Any failed check raises, so the script exits non-zero and prints no
result.  Without a CUDA device, or without the package beside it, it
exits non-zero before printing anything to standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import subprocess
import sys
import time

# H100 SXM peaks: HBM3 bandwidth (NVIDIA data sheet), and the INT32 rate
# of the SMs outside the tensor cores: 132 SMs x 64 INT32 lanes x 1.98 GHz
# boost clock.  The SWAR xtime/XOR walks and the packet XORs are INT32
# work, counted at the least they need on sm_90 (4 instructions per
# xtime at w=8 and w=16, 3 at w=32, XORs folded three at a time by LOP3:
# gf_kernels.sm90_op_floor, the cheaper of the doubling chain per input
# column and per output row; bitmatrix_op_count, schedule_op_count).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# the dense int8 tensor-core peak (the bit-plane kernel's operand type)
INT8_OPS_PER_S = 1979e12

K, M, BATCH, CHUNK = 8, 3, 64, 128 * 1024     # 64 x 1 MiB stripes
LRC_K, LRC_CHUNK = 4, 256 * 1024              # lrc / shec k=4: 1 MiB stripes
DECODE_BATCH = 4
PACKETSIZE = 2048                             # jerasure's default
CLAY = {"k": "8", "m": "4", "d": "11"}        # the reference's clay mix
ROOF_MIB, ROOF_LOOP = 64, 64                  # the roofline tool's defaults
WORDS = 65536                                 # w=16/32 words per chunk
SRC = "ceph_tpu_torch/ops/csrc/"
# phase 6: CRUSH rows over x in 0..CRUSH_X-1; seeded host-mapper samples
# per row (row C's mapper takes ~0.1 s an x on one core), beside a
# seeded CRUSH_FLAGGED_SAMPLE of the lanes the first rung flags (~10 %
# of row A's lanes at ~7 ms each, ~5 % of row B's at ~23 ms: every one
# of them took the mapper 227 s of the phase's wall time), spread over
# CRUSH_PROCS processes; the CPU evaluator's x (every flagged lane
# besides); the EC pool.  The flagged sample and the CPU evaluator's x
# (16384 before) were cut to make room for the tools' phase
CRUSH_X, CRUSH_CPU_X, CRUSH_PROCS = 1_000_000, 4096, 8
CRUSH_FLAGGED_SAMPLE = 8000
CRUSH_SAMPLE = {"A": 1000, "B": 1000, "C": 500}
EC_PG_NUM, EC_PG_SAMPLE = 16384, 500
EC_PROFILE = {"technique": "reed_sol_van", "k": "8", "m": "3",
              "crush-failure-domain": "host", "crush-root": "root"}
CRUSH_WORK = "chip_smoke_work"
# phase 7: scrub -> repair -> recover at Ceph's defaults: 4 MiB objects
# (RADOS's default object size, rbd's default order 22) of the north
# star's code, jerasure reed_sol_van k=8 m=3
RS_ARGV = ["--plugin", "jerasure", "-P", "technique=reed_sol_van",
           "-P", "k=8", "-P", "m=3"]
# 8 objects, 3 bad shards each (the whole budget of m=3), 4 patterns.
# One timed pass each (after the workload's warm pass): the host CRC sets
# a pass's pace, so --iterations and the object counts (7a 8, 7b 8, 7d
# 6: halved once for the data plane's phase and again, 7d by a quarter,
# for the tools' phase, and 7a once more for the bridge's) are the cuts
# that keep the phase's time down; the object size and the fault budget
# are Ceph's and stay
REPAIR_ARGV = RS_ARGV + ["--workload", "repair-batched", "--size",
                         str(4 << 20), "--batch", "8", "-e", "2",
                         "--corruptions", "1", "--iterations", "1",
                         "--device", "cuda"]
CHURN_ARGV = RS_ARGV + ["--workload", "recovery-churn", "--size",
                        str(4 << 20), "--batch", "8", "-e", "1",
                        "--churn-every", "2", "--iterations", "1",
                        "--device", "cuda"]
DEGRADED_ARGV = RS_ARGV + ["--workload", "degraded", "--size",
                           str(1 << 20), "--batch", "4", "-e", "2",
                           "--corruptions", "1", "--device", "cuda"]
# each family once: 6 objects of about 1 MiB (two a pattern)
FAMILY_OBJECTS, FAMILY_SIZE = 6, 1 << 20
# 8a's fused-repair stack (stripes of FAMILY_SIZE objects)
REPAIR_STRIPES = 6
# 9b's stacks over the plane's members: 4 stripes a member, and a batch
# the member count does not divide
MESH_STRIPES = (16, 14)
FAMILIES = (
    ("jerasure reed_sol_van k=8 m=3", "jerasure",
     {"technique": "reed_sol_van", "k": "8", "m": "3"}),
    ("jerasure cauchy_good k=8 m=3", "jerasure",
     {"technique": "cauchy_good", "k": "8", "m": "3"}),
    ("isa k=8 m=3", "isa", {"k": "8", "m": "3"}),
    ("shec k=6 m=3 c=2", "shec", {"k": "6", "m": "3", "c": "2"}),
    ("lrc k=4 m=2 l=3", "lrc", {"k": "4", "m": "2", "l": "3"}),
    ("clay k=8 m=4 d=11", "clay", dict(CLAY)),
)

# phase 8: the supervised dispatch plane.  8b is the CLI's device-chaos
# at RADOS's default object size (32 objects, 2 erasures each, 4
# patterns); 8c a real out-of-memory error on a stack of OOM_OBJECTS
# 4 MiB objects (1 GiB of data) under a memory fraction the unsplit call
# cannot fit in and its halves can; 8d CRUSH row A over CHAOS_CRUSH_X x in
# blocks of 1024 lanes; 8e 64 requests of the bench's serving row
CHAOS_ARGV = RS_ARGV + ["--workload", "device-chaos", "--size",
                        str(4 << 20), "--batch", "32", "-e", "2",
                        "--device", "cuda", "--iterations", "1",
                        "--seed", "42"]
SERVE_CHAOS_ARGV = ["--workload", "serving", "--device", "cuda", "--size",
                    str(1 << 16), "--requests", "64", "--concurrency", "64",
                    "--seed", "42"]
OOM_OBJECTS, CHAOS_CRUSH_X = 256, 65536
# phase 9: the data plane over PLANE_MEMBERS virtual members of the card
# (CEPH_TPU_TORCH_VIRTUAL_DEVICES, set around the phase); 9c checks the
# sharded row B against the host mapper on PLANE_CRUSH_SAMPLE seeded x;
# 9e the CLI's multichip row at the north-star argv beside the per-call
# encode row; 9f the CLI's host-chaos row at RADOS's object size, 16
# objects (enough for a mid-stream loss: 4 patterns, the loss at the
# 2nd fused call), 2 hosts of 2 members
PLANE_ENV, PLANE_MEMBERS, PLANE_CRUSH_SAMPLE = \
    "CEPH_TPU_TORCH_VIRTUAL_DEVICES", 4, 100
NORTH_STAR_ARGV = RS_ARGV + ["--size", str(1 << 20), "--batch", "64",
                             "--iterations", "100", "--device", "cuda"]
MULTICHIP_ARGV = NORTH_STAR_ARGV + ["--workload", "multichip"]
PERCALL_ARGV = NORTH_STAR_ARGV + ["--workload", "encode", "--resident"]
HOST_CHAOS_ARGV = RS_ARGV + ["--workload", "host-chaos", "--size",
                             str(4 << 20), "--batch", "16", "-e", "1",
                             "--hosts", "2", "--device", "cuda",
                             "--iterations", "1", "--seed", "42"]

# the serving stream: 512 closed-loop requests, 64 in flight; RS k=8 m=3
# at 64 KiB (the bench serving row's size), 1 MiB (the north-star stripe)
# and 4 MiB (RADOS's default object size), shec k=6 m=3 c=2 at 1 MiB,
# weighted 3 : 2 between RS and shec as the reference's default_spec
# does; pages of 4096 bytes (Ceph's default EC stripe_unit, which divides
# every RS chunk of the mix), 512 per pool; and default_spec's clay share,
# clay k=8 m=4 d=11 at 1 MiB, weight 1
SERVE_REQUESTS, SERVE_CONCURRENCY = 512, 64
PAGE, SERVE_POOL_PAGES = 4096, 512
RAG_PAGES = 512                               # the ragged kernel's pool
# the dense encode's profiler time under the chain per input column, the
# form the row form replaced, and the card it was read on
EARLIER_DENSE_MS, EARLIER_CARD = 0.060692, "H100 80GB HBM3, 700 W"
# the bit-plane tensor-core kernel's profiler times on the three clay
# shapes before the column walk replaced it (the same card), printed
# beside this run's times
EARLIER_MXU_MS = {"clay encode": 9.498964, "clay decode (0,)": 0.235018,
                  "clay repair (8,)": 0.239114}


def serving_spec(paged: bool):
    """The serving stream's TrafficSpec (seed 0), dense or paged."""
    from ceph_tpu_torch.serve import CodecSpec, TrafficSpec
    rs = {"technique": "reed_sol_van", "k": "8", "m": "3"}
    codecs = [CodecSpec(f"rs_k8_m3_{size >> 10}k", "jerasure", dict(rs),
                        size, weight=1.0)
              for size in (64 << 10, 1 << 20, 4 << 20)]
    codecs.append(CodecSpec("shec_k6_m3_c2_1024k", "shec",
                            {"k": "6", "m": "3", "c": "2"}, 1 << 20,
                            weight=2.0))
    codecs.append(CodecSpec("clay_k8_m4_d11_1024k", "clay", dict(CLAY),
                            1 << 20, weight=1.0))
    return TrafficSpec(seed=0, n_requests=SERVE_REQUESTS, codecs=codecs,
                       concurrency=SERVE_CONCURRENCY, erasures=1,
                       ladder=(1, 4, 16, 64), paged=paged,
                       page_size=PAGE if paged else None,
                       pool_pages=SERVE_POOL_PAGES if paged else None)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, iters: int, warmup: int = 2) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn`` over ``iters``
    back-to-back calls after ``warmup`` calls: the device time between
    two CUDA events, and the host time to issue the calls.  Where the
    host time is the larger, the device waited on the host and the
    device time measures the dispatch, not the kernel."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host


def walk_kernels(splits: int) -> tuple[str, ...]:
    """The kernels one column-walk call launches: the walk, and the
    zeroing kernel before it where the columns are split."""
    return ("gf8_column_walk_kernel",) + (
        ("gf8_column_walk_zero",) if splits > 1 else ())


def bound_ms(cost: dict, peak: float = INT32_OPS_PER_S
             ) -> tuple[float, str]:
    """The least time the card could take for an analytic cost of the
    program profiler (``ceph_tpu_torch/telemetry/profiler.py``: the
    bytes the function moves, each input read once and each output
    written once, and its operations): the larger of the bytes over HBM
    bandwidth and the ops over their type's peak (INT32 unless ``peak``
    says otherwise), by ``roofline_ms``, so the kernels line and the
    profiler's attribution rows count the same work."""
    from ceph_tpu_torch.telemetry.profiler import roofline_ms
    return roofline_ms(cost, HBM_BYTES_PER_S / 1e9, peak)


def max_abs_err(a, b) -> int:
    """The largest difference between two tensors' bytes."""
    import torch
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    a8 = a.contiguous().view(torch.uint8).to(torch.int16)
    b8 = b.contiguous().view(torch.uint8).to(torch.int16)
    return int((a8 - b8).abs().max().item()) if a8.numel() else 0


class Errors(dict):
    """Largest error seen per kernel, over every comparison."""

    def hold(self, name: str, got, want, what: str) -> None:
        import torch
        torch.cuda.synchronize()
        self[name] = max(self.get(name, 0), max_abs_err(got, want))
        check(torch.equal(got, want), f"{name}: {what}")


def drive(name: str, counts, reset, fn, need) -> dict:
    """Run one path with the launch counters at 0 just before it, read
    them just after, and require a launch of every kernel in ``need``."""
    import torch
    reset()
    fn()
    torch.cuda.synchronize()
    got = counts()
    for kernel in need:
        check(got[kernel] >= 1, f"{kernel} launched on the {name} path")
    print(f"phase 3: {name} path ok; launches {got}")
    return got


def _host_truth(bench_argv: list, slabs, packed: bool, pattern=None):
    """The XOR over the slabs of each slab's output from the numpy tier
    (``--device host``): the ground truth of an odd-step carry."""
    import numpy as np
    from ceph_tpu_torch.bench.erasure_code_benchmark import ErasureCodeBench
    from ceph_tpu_torch.ops.gf_kernels import unpack_chunks
    host = ErasureCodeBench()
    host.setup(list(bench_argv) + ["--device", "host", "--layout", "bytes"])
    ec = host._instance()
    truth = None
    for slab in slabs:
        x = np.ascontiguousarray(
            (unpack_chunks(slab) if packed else slab).cpu().numpy())
        out = (ec.decode_chunks_batch(x, *pattern) if pattern
               else ec.encode_chunks_batch(x))
        truth = out if truth is None else truth ^ out
    return truth


def _chain(argv: list, kind: str):
    """(bench, code, input bytes per step, (available, erased) or None,
    chained, slabs) of one --loop configuration."""
    from ceph_tpu_torch.bench.erasure_code_benchmark import ErasureCodeBench
    bench = ErasureCodeBench()
    bench.setup(argv)
    if kind == "encode":
        ec = bench._instance()
        data = bench._make_batch(ec)
        return (bench, ec, data.nbytes, None) + bench._encode_chain(ec, data)
    ec, data, allchunks, pats = bench._decode_setup()
    n = ec.get_chunk_count()
    pattern = (tuple(i for i in range(n) if i not in pats[0]), pats[0])
    return (bench, ec, data.nbytes, pattern) + bench._decode_chain(
        ec, allchunks, *pattern)


def bench_phase(kernel_ms) -> dict:
    """Phase 5: the bench line's rows (``ceph_tpu_torch.bench.bench_line``)
    through ``ErasureCodeBench`` in this process, ``--json --device
    cuda``, each with the launch counters at 0 just before it and read
    just after (every row must launch a kernel and report the card);
    each --loop row's configuration once more at an odd number of steps
    (15 encodes over 15 slabs, 7 decodes over 7: at an even count the
    carry cancels whatever the step computes), its carry held byte for
    byte to the numpy tier's outputs XORed over the same slabs (a slice
    chain's one-element carry, and the carry chain of the same
    configuration); the profiler's device time per step of the row's
    chain (every kernel of a step, the carry's XOR included) beside the
    row's GB/s; the per-call row's parity and device time per call; the
    serving rows verified with no kernel setup after warmup; and the
    corpus check on the card with 0 errors.  Returns the ``{"bench":
    ...}`` blob."""
    import numpy as np
    import torch
    from ceph_tpu_torch.bench import bench_line, non_regression
    from ceph_tpu_torch.bench.erasure_code_benchmark import ErasureCodeBench
    from ceph_tpu_torch.ops.gf_kernels import unpack_chunks
    from ceph_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from ceph_tpu_torch.serve import verify_results

    rows = {}
    truths = {}
    for kind, table in (("encode", bench_line.ENCODE_ROWS),
                        ("decode", bench_line.DECODE_ROWS),
                        ("serving", bench_line.SERVING_ROWS)):
        for name, argv in table:
            bench = ErasureCodeBench()
            bench.setup(list(argv) + ["--json"])
            reset_launch_counts()
            res = bench.run()
            torch.cuda.synchronize()
            got = {k: v for k, v in launch_counts().items() if v}
            check(sum(got.values()) >= 1,
                  f"bench row {name} launched a kernel")
            check(res["platform"] == "gpu" and res["device"] == "cuda",
                  f"bench row {name} ran on the card")
            row = {"gbps": res["gbps"], "seconds": res["seconds"],
                   "total_bytes": res["total_bytes"], "launches": got,
                   "lat_p50_ms": res.get("lat_p50_ms"),
                   "lat_p99_ms": res.get("lat_p99_ms")}
            rows[name] = row
            print(f"phase 5: {name}: {res['gbps']:.6f} GB/s in "
                  f"{res['seconds']:.6f} s, launches {got}")
            if kind == "serving":
                check(res["stream_compiles"] == 0,
                      f"{name}: no kernel setup after warmup "
                      f"({res['stream_compiles']})")
                check(verify_results(bench.last_run.results) == [],
                      f"{name}: every request verifies")
                if res["paged"]:
                    check(res["page_pool"]["used_pages"] == 0,
                          f"{name}: the pools drained")
                for f in ("gbps_under_slo", "deadline_miss_rate",
                          "padding_overhead", "requests", "dispatches",
                          "stream_compiles"):
                    row[f] = res[f]
                continue
            if kind == "decode":
                row["engine"] = res["engine"]
            if not res["loop"]:
                # the resident per-call row: one call's parity against
                # the numpy tier, and its device time per call
                ec = bench._instance()
                data = bench._make_batch(ec)
                on_card = torch.from_numpy(data).cuda()
                out = ec.encode_chunks_torch(on_card).cpu().numpy()
                check(np.array_equal(out, _host_truth(
                    list(argv), [torch.from_numpy(data)], False)),
                    f"{name}: parity equals the numpy tier's")
                step_ms = kernel_ms(lambda: ec.encode_chunks_torch(on_card),
                                    "", iters=20)
                in_bytes = data.nbytes
            else:
                steps = 15 if kind == "encode" else 7
                odd, ec, in_bytes, pattern, chained, slabs = _chain(
                    list(argv) + ["--loop", str(steps)], kind)
                packed = odd.args.layout == "packed"
                check(slabs.shape[0] == steps, f"{name}: {steps} slabs")
                key = (kind, odd.args.layout, name if kind == "decode"
                       else "")
                if key not in truths:
                    truths[key] = _host_truth(list(argv), slabs, packed,
                                              pattern)
                truth = truths[key]
                check(truth.any(), f"{name}: the odd-step truth is zero")
                if odd.args.chain == "slice":
                    carry = chained(slabs)
                    got1 = carry.reshape(1).view(torch.uint8).cpu().numpy()
                    check(np.array_equal(got1, truth.reshape(-1)[
                        :got1.size]), f"{name}: the slice carry at {steps} "
                                      f"steps equals the numpy tier's")
                _, _, _, _, full, slabs = _chain(
                    list(argv) + ["--loop", str(steps), "--chain", "carry"],
                    kind)
                carry = full(slabs)
                check(np.array_equal(
                    (unpack_chunks(carry) if packed else carry).cpu().numpy(),
                    truth), f"{name}: the carry at {steps} steps equals "
                            f"the numpy tier's, byte for byte")
                dev_ms = kernel_ms(lambda: chained(slabs), "", iters=3)
                step_ms = None if dev_ms is None else dev_ms / steps
                row["odd_steps_checked"] = steps
            row["device_ms_per_step"] = step_ms
            row["device_implied_gbps"] = (None if not step_ms
                                          else in_bytes / step_ms / 1e6)
            print(f"phase 5: {name}: bytes equal the numpy tier's; device "
                  f"time per step " + (
                      "not measured" if step_ms is None else
                      f"{step_ms:.6f} ms (every kernel of a step), "
                      f"{row['device_implied_gbps']:.6f} GB/s if the card "
                      f"never waited; the row's {res['gbps']:.6f} GB/s is "
                      f"{res['gbps'] / row['device_implied_gbps']:.4f} "
                      f"of it"))

    reset_launch_counts()
    corpus = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "corpus")
    dirs = non_regression.corpus_dirs(corpus)
    errors = []
    for d in dirs:
        errors.extend(non_regression.check(d, device="cuda"))
    torch.cuda.synchronize()
    corpus_launches = sum(launch_counts().values())
    for e in errors:
        print(f"phase 5: corpus: {e}")
    check(not errors, f"corpus check: {len(errors)} errors")
    check(corpus_launches >= 1, "the corpus check launched a kernel")
    print(f"phase 5: corpus check on the card: {len(dirs)} entries, 0 "
          f"errors, {corpus_launches} kernel launches")
    return {"rows": rows, "corpus": {"entries": len(dirs), "errors": 0,
                                     "launches": corpus_launches}}


def _host_rows(job):
    """Host-mapper rows of ``xs`` (a worker of ``host_rows``)."""
    from ceph_tpu_torch.crush.mapper import crush_do_rule
    cmap, ruleno, xs, num_rep = job
    rows = [crush_do_rule(cmap, ruleno, int(x), num_rep) for x in xs]
    return [r + [0x7FFFFFFF] * (num_rep - len(r)) for r in rows]


def _host_pgs(job):
    """pg_to_up_acting_osds of each ps (a worker of ``host_rows``)."""
    m, pool_id, pss = job
    return [m.pg_to_up_acting_osds(pool_id, int(ps)) for ps in pss]


def host_rows(pool, worker, make_job, items):
    """Start ``worker`` over ``items`` on ``pool``'s processes (the
    pure-Python host mapper); returns a function that waits for the
    rows, in order."""
    import numpy as np
    parts = [p for p in np.array_split(np.asarray(items), 4 * CRUSH_PROCS)
             if len(p)]
    pending = pool.map_async(worker, [make_job(p) for p in parts])
    return lambda: [row for part in pending.get() for row in part]


def device_time(prof) -> tuple[float, int, dict]:
    """(device ms, kernel launches, ms by kind) of a profiler trace: the
    summed durations of the card's events, how many were kernels, and
    the time of each kind (the kernel's name up to its template
    arguments)."""
    from torch.autograd import DeviceType
    ms, launches, kinds = 0.0, 0, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        t = e.duration_ns() / 1e6
        ms += t
        name = e.name()
        if not (name.startswith("Memcpy") or name.startswith("Memset")):
            launches += 1
        kind = name.split("<")[0].split("(")[0].strip()[-60:]
        kinds[kind] = kinds.get(kind, 0.0) + t
    return ms, launches, kinds


def crush_phase(seed: int, err: "Errors") -> dict:
    """Phase 6 (the module docstring): CRUSH rows A-C and the OSDMap
    steps on the card."""
    import contextlib
    import io
    import multiprocessing
    import shutil
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ceph_tpu_torch.bench import crushtool, osdmaptool
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.crush import bulk
    from ceph_tpu_torch.crush.balancer import calc_pg_upmaps
    from ceph_tpu_torch.crush.builder import CrushBuilder
    from ceph_tpu_torch.crush.osdmap import OSDMap
    from ceph_tpu_torch.crush.text_compiler import decompile_text
    from ceph_tpu_torch.crush.types import step_chooseleaf_indep
    from ceph_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from ceph_tpu_torch.telemetry.profiler import STRAW2_DRAW_OPS
    from ceph_tpu_torch.tools import crush_times
    from ceph_tpu_torch.utils.perf import global_perf

    perf = global_perf()
    rng = np.random.default_rng(seed)
    work = os.path.abspath(CRUSH_WORK)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def run(tool, argv) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tool.main(argv)
        check(rc == 0, f"{tool.__name__} {argv}: rc {rc}")
        return buf.getvalue()

    def two_level(hosts: int, devs: int):
        path = os.path.join(work, f"two_level_{hosts}x{devs}.txt")
        run(crushtool, ["--build-two-level", str(hosts), str(devs),
                        "-o", path])
        return CrushBuilder.from_map(crushtool.read_map(path))

    def write(b, name: str) -> str:
        path = os.path.join(work, name)
        with open(path, "w") as f:
            f.write(decompile_text(b.map))
        return path

    b_a = two_level(8, 4)
    b_b = two_level(8, 4)
    rule_b = b_b.add_erasure_rule(
        "root", [step_chooseleaf_indep(0, b_b.type_id("host"))],
        name="ec_canonical")
    b_c = two_level(100, 12)
    ec = ErasureCodePluginRegistry.instance().factory(
        "jerasure", dict(EC_PROFILE), device="cuda")
    rule_c = ec.create_rule(b_c, name="ec_k8_m3")
    span = ["--min-x", "0", "--max-x", str(CRUSH_X - 1), "--show-statistics",
            "--engine", "bulk", "--device", "cuda"]
    rows = [("A", ["--build-two-level", "8", "4", "--rule", "0",
                   "--num-rep", "3"], b_a.map, 0, 3),
            ("B", ["-i", write(b_b, "row_b.txt"), "--rule", str(rule_b),
                   "--num-rep", "6"], b_b.map, rule_b, 6),
            ("C", ["-i", write(b_c, "row_c.txt"), "--rule", str(rule_c),
                   "--num-rep", "11"], b_c.map, rule_c, 11)]
    print(f"phase 6: {torch.cuda.get_device_name(0)}; x in 0..{CRUSH_X - 1};"
          " host-mapper samples "
          + ", ".join(f"{k} {v}" for k, v in CRUSH_SAMPLE.items())
          + f" x, with {CRUSH_FLAGGED_SAMPLE} flagged lanes and every "
          f"residue lane; CPU evaluator on x < {CRUSH_CPU_X} and every "
          f"flagged lane; {CRUSH_PROCS} host processes")
    result, waits = {}, []
    xs = np.arange(CRUSH_X)
    with multiprocessing.get_context("spawn").Pool(CRUSH_PROCS) as pool:
        t_host = time.perf_counter()
        for name, argv, cmap, rule, nrep in rows:
            # the user's entry point: crushtool's warm sweep, then its
            # timed one
            lanes0 = perf.get("crush_bulk_host_lanes")
            t0 = time.perf_counter()
            text = run(crushtool, argv + ["--test"] + span)
            tool_s = time.perf_counter() - t0
            residue = perf.get("crush_bulk_host_lanes") - lanes0
            head = text.splitlines()[0]
            check(f"num_mappings {CRUSH_X} (bulk," in head, head)
            rate = float(head.split("(bulk, ")[1].split(" ")[0]
                         .replace(",", ""))
            tool_counts = {int(ln.split()[1].rstrip(":")): int(ln.split()[2])
                           for ln in text.splitlines()
                           if ln.startswith("  device ")}
            check(text.rstrip().endswith("bad mappings: 0"),
                  f"row {name}: {text.splitlines()[-1]}")
            # one profiled sweep on a map compiled alike; its peak memory
            # counts from what was allocated before the map was compiled
            syncs0 = perf.get("crush_bulk_host_syncs")
            blocks0 = perf.get("crush_bulk_blocks")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            cm = bulk.CompiledCrushMap(cmap, device="cuda")
            reset_launch_counts()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out, cnt, n_host = bulk.bulk_do_rule(cm, rule, xs, nrep,
                                                     return_stats=True)
                wall = (time.perf_counter() - t0) * 1e3
            k_launches = launch_counts()["crush_rule_cuda"]
            check(k_launches >= 1, f"row {name}: the rule kernel placed "
                                   f"the profiled sweep")
            peak = torch.cuda.max_memory_allocated() - base
            syncs = perf.get("crush_bulk_host_syncs") - syncs0
            blocks = perf.get("crush_bulk_blocks") - blocks0
            dev_ms, launches, kinds = device_time(prof)
            top = sorted(kinds.items(), key=lambda kv: -kv[1])[:6]
            flagged = cm.last_flagged
            devs, dcnt = np.unique(out[out != 0x7FFFFFFF],
                                   return_counts=True)
            check({int(d): int(c) for d, c in zip(devs, dcnt)}
                  == tool_counts,
                  f"row {name}: two sweeps give the same per-device counts")
            # the card against the host mapper: a seeded sample, a
            # seeded sample of the lanes the first rung flagged and every
            # lane of the host residue, mapped in the pool while the
            # card goes on
            flag_pick = (flagged if flagged.size <= CRUSH_FLAGGED_SAMPLE
                         else rng.choice(flagged, CRUSH_FLAGGED_SAMPLE,
                                         replace=False))
            pick = np.union1d(np.union1d(
                rng.choice(CRUSH_X, CRUSH_SAMPLE[name], replace=False),
                flag_pick), cm.last_residue)
            waits.append((name, pick, out[pick], host_rows(
                pool, _host_rows, lambda p: (cmap, rule, p, nrep), pick)))
            # the card against the CPU evaluator: x < CRUSH_CPU_X and
            # every lane the first rung flagged
            lanes = np.union1d(np.arange(CRUSH_CPU_X), flagged)
            t0 = time.perf_counter()
            cpu_out, cpu_cnt = bulk.bulk_do_rule(cmap, rule, xs[lanes], nrep,
                                                 device="cpu")
            cpu_s = time.perf_counter() - t0
            err.hold(f"crush row {name} cpu", torch.from_numpy(out[lanes]),
                     torch.from_numpy(cpu_out), f"row {name} vs the CPU")
            err.hold("crush_rule_cuda", torch.from_numpy(out[lanes]),
                     torch.from_numpy(cpu_out),
                     f"row {name}: the rule kernel vs the CPU evaluator")
            check(np.array_equal(cnt[lanes], cpu_cnt), f"row {name} counts")
            # the bound of the first rung's straw2 draws (the profiler's
            # model, bulk.first_rung_cost): on the rule kernel lanes x
            # replicas x the widths of the levels a replica descends
            t1 = bulk.auto_ladder(cmap, rule, nrep,
                                  bulk.auto_tries(cmap, rule, nrep))[0][0]
            rung_cost = bulk.first_rung_cost(cm, rule, nrep, t1, CRUSH_X)
            draws = rung_cost["flops"] / STRAW2_DRAW_OPS
            bound = bound_ms(rung_cost)[0]
            row = {"mappings_per_s": rate, "crushtool_s": tool_s,
                   "straw2_draws": draws, "straw2_bound_ms": bound,
                   "residue_lanes_per_sweep": residue / 2,
                   "profiled_wall_ms": wall, "device_ms": dev_ms,
                   "busy": dev_ms / wall, "blocks": blocks,
                   "launches_per_block": launches / max(blocks, 1),
                   "host_syncs_per_block": syncs / max(blocks, 1),
                   "peak_bytes": peak, "base_bytes": base,
                   "profiled_host_lanes": n_host,
                   "flagged": int(flagged.size),
                   "host_flagged": int(flag_pick.size),
                   "host_sample": int(pick.size),
                   "cpu_lanes": int(lanes.size), "cpu_s": cpu_s,
                   "device_ms_by_kind": dict(top),
                   "block_lanes": bulk.block_lanes(cm, rule, nrep, t1),
                   "kernel_launches": k_launches}
            result[name] = row
            print(f"phase 6: row {name}: {rate:,.0f} mappings/s (crushtool, "
                  f"{tool_s:.1f} s for both sweeps); residue "
                  f"{residue / 2:g} lanes a sweep; profiled sweep {wall:.1f}"
                  f" ms wall, {dev_ms:.1f} ms device (busy "
                  f"{dev_ms / wall:.3f}), {blocks} blocks of "
                  f"{row['block_lanes']} lanes, "
                  f"{row['launches_per_block']:.0f} launches and "
                  f"{row['host_syncs_per_block']:.1f} host syncs a block, "
                  f"peak {peak / 2**30:.3f} GiB above {base / 2**30:.3f} "
                  f"GiB held before; {flagged.size} lanes flagged; equal to"
                  f" the CPU evaluator on {lanes.size} x ({cpu_s:.1f} s); "
                  f"first rung: {draws:.4g} straw2 draws, bound "
                  f"{bound:.3f} ms ({STRAW2_DRAW_OPS} INT32 ops a draw); "
                  "device ms by kind: "
                  + ", ".join(f"{k} {v:.1f}" for k, v in top))

        # the kernel's launches on the main path: the rows' profiled
        # sweeps, each counted from 0
        result["kernel_launches"] = sum(result[name]["kernel_launches"]
                                        for name, *_ in rows)
        # -- the rule kernel alone at the remap cell's shape (its times;
        # its launches are the rows') -----------------------------------
        kern = crush_times.measure(seed)
        check(kern["equal"],
              f"the rule kernel's sweep equals the eager tier's: {kern}")
        result["kernel"] = kern
        print(f"phase 6: the rule kernel at the remap cell's shape "
              f"({kern['lanes']} lanes): {kern['kernel_ms']} ms device "
              f"({kern['kernel_event_ms']:.4f} ms by events) against an "
              f"operations bound of {kern['bound_ms']:.4f} ms; a sweep "
              f"{kern['kernel_sweep_ms']:.3f} ms through the kernel, "
              f"{kern['eager_sweep_ms']:.1f} ms through the eager rungs "
              f"({kern['eager_device_ms']:.1f} ms device)")

        # -- the OSDMap steps, on row C's map ----------------------------
        plain_map = os.path.join(work, "osdmap_c.json")
        with open(plain_map, "w") as f:
            json.dump(osdmaptool.dump_osdmap(OSDMap(crush=b_c.map), []), f)
        ec_map = os.path.join(work, "osdmap_c_ec.json")
        prof_argv = []
        for k, v in [("plugin", "jerasure")] + list(EC_PROFILE.items()):
            prof_argv += ["--ec-profile", f"{k}={v}"]
        print("phase 6: " + run(osdmaptool, [
            plain_map, "--create-ec-pool", "ecpool", *prof_argv, "--pg-num",
            str(EC_PG_NUM), "-o", ec_map, "--device", "cuda"]).strip())
        t0 = time.perf_counter()
        text = run(osdmaptool, [ec_map, "--test-map-pgs", "--device", "cuda"])
        map_s = time.perf_counter() - t0
        lines = text.splitlines()
        print(f"phase 6: --test-map-pgs ({map_s:.1f} s): "
              f"{lines[-2].strip()}; {lines[-1].strip()}")
        m = osdmaptool.load_osdmap(ec_map)
        m.device = "cuda"
        pool_id = max(m.pools)
        ec_pool = m.pools[pool_id]
        check(ec_pool.size == 11 and ec_pool.pg_num == EC_PG_NUM
              and ec_pool.erasure, f"pool {ec_pool}")
        up, upp, act, actp = m.pg_to_up_acting_bulk(pool_id, engine="bulk")
        pss = np.sort(rng.choice(EC_PG_NUM, EC_PG_SAMPLE, replace=False))
        host_m = OSDMap(crush=m.crush, pools=m.pools, device="cpu")
        pgs = host_rows(pool, _host_pgs, lambda p: (host_m, pool_id, p), pss)
        out_path = os.path.join(work, "upmap.txt")
        t0 = time.perf_counter()
        text = run(osdmaptool, [ec_map, "--upmap", out_path, "--upmap-max",
                                "100", "--device", "cuda"])
        upmap_s = time.perf_counter() - t0
        with open(out_path) as f:
            moves = sum(ln.count(" ") - 3 for ln in f if ln.strip()) // 2
        devs = []
        m2 = osdmaptool.load_osdmap(ec_map)
        m2.device = "cuda"
        entries = calc_pg_upmaps(m2, pool_id, max_iterations=100,
                                 on_iteration=lambda i, d: devs.append(
                                     float(np.abs(d).max())))
        check(len(entries) == len(open(out_path).read().splitlines()),
              "the CLI's upmap entries and calc_pg_upmaps agree")
        print(f"phase 6: --upmap ({upmap_s:.1f} s): {text.strip()}; {moves}"
              f" moves; max |deviation| {devs[0]:.2f} -> {devs[-1]:.2f} "
              f"PGs over {len(devs)} iterations")

        # -- the host mapper's verdicts, in the order they were asked ----
        for name, pick, got, rows_of in waits:
            t0 = time.perf_counter()
            want = np.asarray(rows_of(), dtype=np.int32)
            err.hold(f"crush row {name} host", torch.from_numpy(got),
                     torch.from_numpy(want), f"row {name} vs the host mapper")
            result[name]["host_wait_s"] = time.perf_counter() - t0
            print(f"phase 6: row {name}: equal to the host mapper on "
                  f"{pick.size} x ({CRUSH_SAMPLE[name]} seeded, "
                  f"{result[name]['host_flagged']} of "
                  f"{result[name]['flagged']} flagged, the residue); waited"
                  f" {time.perf_counter() - t0:.1f} s for it")
        got = pgs()
        host_s = time.perf_counter() - t_host
    want = np.asarray([u + [0x7FFFFFFF] * (up.shape[1] - len(u))
                       for u, _, _, _ in got], dtype=np.int32)
    err.hold("crush osdmap up", torch.from_numpy(up[pss]),
             torch.from_numpy(want), "--test-map-pgs up vs the host engine")
    check(all(int(upp[ps]) == p and int(actp[ps]) == ap
              and list(act[ps][:len(a)]) == a
              for ps, (_, p, a, ap) in zip(pss, got)),
          "primaries and acting sets equal the host engine's")
    print(f"phase 6: --test-map-pgs equal to the host engine on {pss.size} "
          f"PGs; the host mapper's checks took {host_s:.1f} s from the "
          "first row")
    result["host_mapper_s"] = host_s
    result["osdmap"] = {"pg_num": EC_PG_NUM, "test_map_pgs_s": map_s,
                        "host_sample": int(pss.size),
                        "upmap_s": upmap_s, "upmap_entries": len(entries),
                        "moves": moves, "deviation": [devs[0], devs[-1]]}
    shutil.rmtree(work, ignore_errors=True)
    return result


# -- phase 7: scrub -> repair -> recover on the card ---------------------------

class PassProbe:
    """Per timed pass of a bench workload (each ``_LatTimer.run``): the
    kernel launches, the wall time, the finished span roots and the
    device time of every fused repair call (CUDA events around the
    callable, which launches the decode and re-encode kernels; the stack
    is already on the card when it is called)."""

    def __init__(self) -> None:
        self.passes: list = []
        self.active = None
        self._undo: list = []

    def __enter__(self):
        import torch
        from ceph_tpu_torch.bench import erasure_code_benchmark as ecb
        from ceph_tpu_torch.codes import engine
        from ceph_tpu_torch.ops.launches import launch_counts
        from ceph_tpu_torch.telemetry import global_tracer
        probe = self
        real_run, real_fused = ecb._LatTimer.run, engine.fused_repair_call

        def run(lat, fn):
            tracer = global_tracer()
            torch.cuda.synchronize()
            before = launch_counts()
            n_roots = len(tracer.finished)
            rec = {"events": []}
            probe.active = rec
            t0 = time.perf_counter()
            try:
                return real_run(lat, fn)
            finally:
                torch.cuda.synchronize()
                rec["wall_s"] = time.perf_counter() - t0
                probe.active = None
                rec["launches"] = {k: v - before[k]
                                   for k, v in launch_counts().items()
                                   if v - before[k]}
                rec["roots"] = tracer.to_dict()["spans"][n_roots:]
                rec["fused_ms"] = [s.elapsed_time(e)
                                   for s, e in rec.pop("events")]
                probe.passes.append(rec)

        def fused(ec, available, erased):
            fn = real_fused(ec, available, erased)

            def call(stack):
                if probe.active is None:
                    return fn(stack)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(stack)
                end.record()
                probe.active["events"].append((start, end))
                return out
            # the supervisor's rebuild re-derives the body through the
            # (patched) entry point
            call._raw = fn._raw
            return call

        ecb._LatTimer.run = run
        engine.fused_repair_call = fused
        self._undo = [(ecb._LatTimer, "run", real_run),
                      (engine, "fused_repair_call", real_fused)]
        return self

    def __exit__(self, *exc):
        for obj, name, value in self._undo:
            setattr(obj, name, value)
        return False


def span_seconds(roots: list) -> dict:
    """Seconds per span path (``repair/scrub``, ...) summed over roots."""
    out: dict = {}

    def walk(sp, path):
        p = f"{path}/{sp['name']}" if path else sp["name"]
        out[p] = out.get(p, 0.0) + sp["duration"]
        for c in sp.get("children", ()):
            walk(c, p)
    for r in roots:
        walk(r, "")
    return out


def recovery_workload(name: str, argv: list, need=(),
                      phase: str = "phase 7") -> tuple:
    """One recovery workload of the port's CLI on the card, with the
    launch counters at 0 just before it and read just after; every
    kernel in ``need`` must have launched in each timed pass.  Prints the
    row's GB/s, p50/p99, the seconds in each span of a timed pass, and
    the fused calls' device ms against the pass's wall time.  Returns
    (bench, result, row)."""
    import torch
    from ceph_tpu_torch.bench.erasure_code_benchmark import ErasureCodeBench
    from ceph_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from ceph_tpu_torch.telemetry import global_tracer
    bench = ErasureCodeBench()
    bench.setup(list(argv) + ["--json"])
    global_tracer().reset()
    t0 = time.perf_counter()
    reset_launch_counts()
    with PassProbe() as probe:
        res = bench.run()
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if v}
    wall = time.perf_counter() - t0
    check(res["platform"] == "gpu" and res["device"] == "cuda",
          f"{name} ran on the card")
    check(len(probe.passes) == bench.args.iterations,
          f"{name}: {bench.args.iterations} timed passes probed")
    passes = []
    for i, p in enumerate(probe.passes):
        for kernel in need:
            check(p["launches"].get(kernel, 0) >= 1,
                  f"{name}: {kernel} launched in timed pass {i}")
        spans = span_seconds(p["roots"])
        fused = sum(p["fused_ms"])
        passes.append({"wall_s": p["wall_s"], "launches": p["launches"],
                       "fused_calls": len(p["fused_ms"]),
                       "fused_device_ms": fused, "span_s": spans})
        top = {k: v for k, v in spans.items() if k.count("/") <= 1
               or k.endswith(("/scrub", "/plan", "/dispatch", "/verify",
                              "/write_back"))}
        print(f"{phase}: {name}: pass {i}: wall {p['wall_s']:.3f} s; "
              f"{len(p['fused_ms'])} fused calls, {fused:.3f} ms on the "
              f"card ({fused / 1e3 / p['wall_s']:.5f} of the pass); "
              f"launches {p['launches']}; span s "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(top.items())))
    print(f"{phase}: {name}: {res['gbps']:.6f} GB/s over "
          f"{res['total_bytes']} logical bytes, p50 "
          f"{res['lat_p50_ms']:.3f} ms, p99 {res['lat_p99_ms']:.3f} ms "
          f"per pass; {wall:.1f} s with set-up and warm pass; launches "
          f"{launches}")
    row = {"gbps": res["gbps"], "seconds": res["seconds"],
           "total_bytes": res["total_bytes"],
           "lat_p50_ms": res["lat_p50_ms"], "lat_p99_ms": res["lat_p99_ms"],
           "launches": launches, "passes": passes, "wall_s": wall}
    for f in ("pattern_batches", "device_calls", "host_batches", "replans",
              "regroups", "rounds", "epochs_advanced", "erasures",
              "corruptions"):
        if f in res:
            row[f] = res[f]
    return bench, res, row


def healed_stores(run) -> bool:
    """Every store every timed pass healed equals its undamaged object."""
    return all(store.snapshot() == {s: bytes(b) for s, b in shards.items()}
               for stores in run.runs
               for store, (shards, _) in zip(stores, run.objects))


def host_twin(argv: list):
    """The same workload's code as ``--device host`` builds it: a CPU
    instance pinned to the numpy region ops."""
    from ceph_tpu_torch.bench.erasure_code_benchmark import ErasureCodeBench
    bench = ErasureCodeBench()
    bench.setup(list(argv) + ["--device", "host"])
    return bench._instance()


def routed_kernels(ec, available: tuple, erased: tuple, stripes: int,
                   chunk: int) -> dict:
    """{"decode": wrapper, "encode": wrapper}: the kernel wrapper that
    ``select_matrix_engine`` names for this code's decode of the pattern
    and for its encode, at the fused call's shapes."""
    from ceph_tpu_torch.ops.gf_kernels import select_matrix_engine
    names = {"cuda": "apply_matrix_cuda", "xor": "apply_matrix_xor_cuda",
             "mxu": "apply_matrix_mxu_cuda"}
    if hasattr(ec, "bitmatrix"):
        # the packet codes: one kernel, the CSE schedule's wrapper where
        # a schedule pays
        check(select_matrix_engine(ec.w, ec.device) == "cuda",
              "the packet codes route to the card")
        dec = ec._decode_bitmatrix(available, erased)[3]
        return {"decode": "apply_bitmatrix_xor_cuda" if dec is not None
                else "apply_bitmatrix_cuda",
                "encode": "apply_bitmatrix_xor_cuda"
                if ec._encode_sched is not None else "apply_bitmatrix_cuda"}
    sub = getattr(ec, "sub_chunk_no", 1)
    if hasattr(ec, "_encode_composite"):                   # clay
        dec = ec._decode_composite(available, erased)[1]
        enc = ec._encode_composite()[1]
        cols = (len(available) * sub, ec.k * sub)
    elif hasattr(ec, "_encode_static"):                    # lrc
        dec = ec._decode_composite(available, erased)[1]
        enc = ec._encode_static()
        cols = (len(available), ec.k)
    elif hasattr(ec, "_plan_static"):                      # shec
        plan, sel, _ = ec._plan_indices(available, erased)
        dec = ec._plan_static(plan)[1]
        enc = ec._matrix_static
        cols = (len(sel), ec.k)
    else:                                                  # RS, isa
        _, dec, ns = ec._decode_matrix(available, erased)
        enc = ec._matrix_static
        cols = (ns, ec.k)
    out = {}
    for kind, ms, c in (("decode", dec, cols[0]), ("encode", enc, cols[1])):
        eng = select_matrix_engine(8, ec.device,
                                   shape=(stripes * sub, c, chunk // sub),
                                   matrix_t=ms)
        out[kind] = names[eng]
    return out


def recovery_phase(seed: int) -> dict:
    """Phase 7 (the module docstring): scrub -> repair -> recover on the
    card through the port's CLI and ``repair_batched``."""
    import numpy as np
    import torch
    from ceph_tpu_torch.chaos import BitFlip, ShardErasure, inject
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.codes.stripe import HashInfo, StripeInfo, encode
    from ceph_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from ceph_tpu_torch.scrub import repair_batched
    from ceph_tpu_torch.telemetry import global_flight_recorder
    from ceph_tpu_torch.telemetry.schema import validate_flight_dump
    from ceph_tpu_torch.utils.errors import UnrecoverableError

    t_phase = time.perf_counter()
    out = {}

    # -- 7a: repair-batched through the CLI ---------------------------------
    bench, res, row = recovery_workload("7a repair-batched", REPAIR_ARGV,
                                        need=("apply_matrix_cuda",))
    check(res["device_calls"] == res["pattern_batches"] == 4
          and res["host_batches"] == 0,
          f"7a: one device call per pattern ({res['pattern_batches']} "
          f"patterns, {res['device_calls']} device calls, "
          f"{res['host_batches']} host batches)")
    run = bench.last_run
    check(healed_stores(run), "7a: every healed store equals its object")
    t0 = time.perf_counter()
    stores = bench._damaged_stores(run.sinfo, run.objects, run.pool)
    rep = repair_batched(run.sinfo, host_twin(REPAIR_ARGV), stores,
                         [h for _, h in run.objects], device=False)
    check(rep.host_batches == rep.pattern_batches == 4
          and rep.device_calls == 0, "7a: the host path's batches")
    check(all(a.snapshot() == b.snapshot()
              for a, b in zip(stores, run.runs[-1])),
          "7a: the card's heal equals the host path's, byte for byte")
    row["host_check_s"] = time.perf_counter() - t0
    print(f"phase 7: 7a: {len(stores)} stores equal the undamaged objects "
          f"and the host path (device=False, numpy tier) byte for byte "
          f"({row['host_check_s']:.1f} s)")
    out["repair_batched"] = row

    # -- 7b: recovery-churn --------------------------------------------------
    bench, res, row = recovery_workload("7b recovery-churn", CHURN_ARGV,
                                        need=("apply_matrix_cuda",))
    check(res["epochs_advanced"] >= 1, "7b: the map advanced")
    check(healed_stores(bench.last_run) and not
          bench.last_run.report.unrecoverable and
          bench.last_run.report.converged,
          "7b: converged, nothing unrecoverable, every store healed")
    print(f"phase 7: 7b: converged with no data loss; replans "
          f"{res['replans']}, regroups {res['regroups']}, rounds "
          f"{res['rounds']}, epochs advanced {res['epochs_advanced']}")
    out["recovery_churn"] = row

    # -- 7c: degraded (per-object repair through the stripe layer) ----------
    bench, res, row = recovery_workload("7c degraded", DEGRADED_ARGV)
    check(healed_stores(bench.last_run), "7c: every store healed")
    out["degraded"] = row

    # -- 7d: each family once ------------------------------------------------
    reg = ErasureCodePluginRegistry.instance()
    rng = np.random.default_rng(seed)
    fams = {}
    for label, plugin, profile in FAMILIES:
        t0 = time.perf_counter()
        ec = reg.factory(plugin, dict(profile), device="cuda")
        host = reg.factory(plugin, dict(profile), device="cpu")
        host.min_xla_bytes = float("inf")
        n, k = ec.get_chunk_count(), ec.get_data_chunk_count()
        chunk = ec.get_chunk_size(FAMILY_SIZE)
        sinfo = StripeInfo(k, k * chunk)
        # up to three decodable (erased, flipped) patterns
        pats = []
        for bad in ((1,), (k,), (0, n - 1), (2, k + 1), (0,)):
            try:
                ec.minimum_to_decode(set(bad), set(range(n)) - set(bad))
            except (IOError, ValueError):
                continue
            pats.append(([bad[0]], list(bad[1:])))
            if len(pats) == 3:
                break
        objects = []
        for _ in range(FAMILY_OBJECTS):
            obj = rng.integers(0, 256, k * chunk, dtype=np.uint8).tobytes()
            shards = encode(sinfo, ec, obj)
            hinfo = HashInfo(n)
            hinfo.append(0, shards)
            objects.append((shards, hinfo))

        def damaged():
            stores = []
            for i, (shards, _) in enumerate(objects):
                erased, flipped = pats[i % len(pats)]
                inj = [ShardErasure(shards=erased)] + (
                    [BitFlip(shards=flipped, flips=1)] if flipped else [])
                stores.append(inject(shards, inj, seed=seed + i,
                                     chunk_size=chunk)[0])
            return stores

        hinfos = [h for _, h in objects]
        on_card, on_host = damaged(), damaged()
        reset_launch_counts()
        rep = repair_batched(sinfo, ec, on_card, hinfos)
        torch.cuda.synchronize()
        launches = {kk: v for kk, v in launch_counts().items() if v}
        check(rep.device_calls == rep.pattern_batches == len(pats)
              and rep.host_batches == 0,
              f"7d {label}: one device call per pattern")
        hrep = repair_batched(sinfo, host, on_host, hinfos, device=False)
        check(hrep.host_batches == len(pats), f"7d {label}: host batches")
        for store, hstore, (shards, _) in zip(on_card, on_host, objects):
            want = {s: bytes(b) for s, b in shards.items()}
            check(store.snapshot() == want == hstore.snapshot(),
                  f"7d {label}: healed bytes equal the object and the "
                  f"host path")
        need = {}
        for erased, flipped in pats:
            bad = tuple(sorted(erased + flipped))
            avail = tuple(s for s in range(n) if s not in bad)
            routes = routed_kernels(ec, avail, bad,
                                    FAMILY_OBJECTS // len(pats) + 1, chunk)
            for kind, kernel in routes.items():
                check(launches.get(kernel, 0) >= 1,
                      f"7d {label}: {kernel} ({kind} of {bad}) launched")
                need.setdefault(kernel, []).append(f"{kind} {bad}")
        fams[label] = {"patterns": [list(e + f) for e, f in pats],
                       "launches": launches, "routed": need,
                       "seconds": time.perf_counter() - t0}
        print(f"phase 7: 7d {label}: {FAMILY_OBJECTS} objects of "
              f"{k * chunk} bytes, {len(pats)} patterns, equal to the host "
              f"path and the objects; routed {need}; launches {launches}")
    out["families"] = fams

    # -- 7e: an over-budget object ------------------------------------------
    ec = reg.factory("jerasure", {"technique": "reed_sol_van", "k": "8",
                                  "m": "3"}, device="cuda")
    chunk = ec.get_chunk_size(FAMILY_SIZE)
    sinfo = StripeInfo(8, 8 * chunk)
    obj = rng.integers(0, 256, 8 * chunk, dtype=np.uint8).tobytes()
    shards = encode(sinfo, ec, obj)
    hinfo = HashInfo(11)
    hinfo.append(0, shards)
    store, _ = inject(shards, [ShardErasure(shards=[0, 4]),
                               BitFlip(shards=[2, 9], flips=1)],
                      seed=seed, chunk_size=chunk)
    try:
        repair_batched(sinfo, ec, [store], [hinfo])
        raise RuntimeError("check failed: 7e: 4 bad shards of k=8 m=3 "
                           "did not raise")
    except UnrecoverableError as e:
        blob = global_flight_recorder().last_dump()
        check(e.shards == (0, 2, 4, 9), f"7e: the error names {e.shards}")
        check(blob is not None and blob["trigger"] == "unrecoverable"
              and blob["context"]["shards"] == [0, 2, 4, 9],
              "7e: the flight recorder froze the unrecoverable dump")
        errors = validate_flight_dump(blob)
        check(errors == [], f"7e: the dump validates ({errors})")
        out["unrecoverable"] = {"shards": list(e.shards),
                                "extents": [list(x) for x in e.extents],
                                "dump": blob["dump"],
                                "entries": len(blob["entries"])}
        print(f"phase 7: 7e: UnrecoverableError on shards {list(e.shards)} "
              f"with {len(e.extents)} extents; its flight dump "
              f"#{blob['dump']} validates ({len(blob['entries'])} ring "
              f"entries)")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 7: {out['seconds']:.1f} s")
    return out


# -- phase 8: the supervised dispatch plane on the card -----------------------

def _child(kind: str, env_extra: dict | None = None):
    """Start ``python3 chip_smoke.py --child KIND`` (8c, 8f) in the
    background; its last line of output is one JSON object."""
    env = dict(os.environ)
    env.update(env_extra or {})
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", kind],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)


def _child_result(proc, what: str, timeout: float = 600) -> dict:
    try:
        out, errs = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"check failed: {what}: child timed out")
    for line in errs.splitlines()[-5:]:
        print(f"{what} (stderr): {line}")
    check(proc.returncode == 0, f"{what}: child exit {proc.returncode}")
    return json.loads(out.strip().splitlines()[-1])


def _fused_stack(ec, stripes: int, object_size: int, seed: int):
    """(stack on the card, avail, erased, host stack): ``stripes``
    stripes of random survivors of objects of ``object_size`` bytes,
    shard 1 erased.  A fused repair is GF-linear, so any survivor bytes
    hold the card to the host path."""
    import numpy as np
    import torch
    n = ec.get_chunk_count()
    chunk = ec.get_chunk_size(object_size)
    avail = tuple(s for s in range(n) if s != 1)
    rng = np.random.default_rng(seed)
    surv = rng.integers(0, 256, (stripes, len(avail), chunk), dtype=np.uint8)
    return torch.from_numpy(surv).cuda(), avail, (1,), surv


def _issue_us(loop, calls: int) -> float:
    """Host microseconds per call that ``loop()`` (``calls`` warm calls)
    takes to issue: timed before the barrier, with few enough launches
    that the card's queue never fills."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def supervisor_phase(seed: int) -> dict:
    """Phase 8 (the module docstring): the supervised dispatch plane on
    the card."""
    import collections
    import warnings
    import numpy as np
    import torch
    from ceph_tpu_torch.chaos.dispatch import DispatchFault, dispatch_faults
    from ceph_tpu_torch.codes.engine import fused_repair_call
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.crush import bulk
    from ceph_tpu_torch.crush.builder import CrushBuilder
    from ceph_tpu_torch.ops import fallback, supervisor
    from ceph_tpu_torch.ops.gf_kernels import apply_matrix_best
    from ceph_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from ceph_tpu_torch.ops.supervisor import _inside_seam
    from ceph_tpu_torch.ops.torch_ops import matrix_to_static
    from ceph_tpu_torch.serve.batcher import _host_repair
    from ceph_tpu_torch.utils.errors import DeviceDispatchError

    t_phase = time.perf_counter()
    out: dict = {}
    sup = supervisor.global_supervisor()
    card = torch.device("cuda")
    reg = ErasureCodePluginRegistry.instance()

    def delta(before, keys=("retries", "demotions", "host_completions",
                            "rung_downshifts", "repromotions",
                            "card_failures", "dispatches")):
        now = sup.stats()
        return {k: now[k] - before[k] for k in keys}

    # -- 8a: clean, one fused repair per family --------------------------
    clean = {}
    st0 = sup.stats()
    for label, plugin, profile in FAMILIES:
        ec = reg.factory(plugin, dict(profile), device="cuda")
        host = reg.factory(plugin, dict(profile), device="cpu")
        host.min_xla_bytes = float("inf")
        x, avail, erased, surv = _fused_stack(
            ec, REPAIR_STRIPES, FAMILY_SIZE, seed)
        call = fused_repair_call(ec, avail, erased)
        call(x)                                         # warm
        runs = {}
        for name in ("supervised", "unsupervised"):
            torch.cuda.synchronize()
            reset_launch_counts()
            d0 = sup.stats()["dispatches"]
            if name == "supervised":
                got = call(x)
            else:
                with _inside_seam():
                    got = call(x)
            torch.cuda.synchronize()
            runs[name] = ({k: v for k, v in launch_counts().items() if v},
                          sup.stats()["dispatches"] - d0, got)
        (l_sup, n_sup, got_sup), (l_raw, n_raw, got_raw) = \
            runs["supervised"], runs["unsupervised"]
        check(l_sup == l_raw and l_sup,
              f"8a {label}: launches {l_sup} supervised, {l_raw} not")
        check(n_sup == 1 and n_raw == 0,
              f"8a {label}: one supervised dispatch ({n_sup}, {n_raw})")
        want = _host_repair(host, surv, avail, erased)
        for a, b, w in zip(got_sup, got_raw, want):
            check(torch.equal(a, b) and np.array_equal(a.cpu().numpy(), w),
                  f"8a {label}: bytes equal the host path")
        clean[label] = {"launches": l_sup, "stack": list(x.shape)}
        print(f"phase 8: 8a {label}: fused repair of {tuple(x.shape)}: "
              f"launches {l_sup} supervised = unsupervised, bytes equal "
              f"the host path")
    d = delta(st0)
    check(d["retries"] == d["demotions"] == d["host_completions"]
          == d["rung_downshifts"] == d["card_failures"] == 0,
          f"8a: a clean ladder {d}")
    # torch's sync debug mode: the supervised call adds no synchronizing
    # operation to the unsupervised one's
    ec = reg.factory("jerasure", {"technique": "reed_sol_van", "k": "8",
                                  "m": "3"}, device="cuda")
    x, avail, erased, _ = _fused_stack(ec, 4, 1 << 20, seed + 1)
    call = fused_repair_call(ec, avail, erased)
    call(x)
    seen = {}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for name in ("supervised", "unsupervised"):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                if name == "supervised":
                    call(x)
                else:
                    with _inside_seam():
                        call(x)
            seen[name] = collections.Counter(str(m.message) for m in w)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    extra = seen["supervised"] - seen["unsupervised"]
    check(not extra, f"8a: the supervisor adds no synchronize ({extra})")
    # host cost per clean dispatch: the dispatch alone (a no-op body),
    # and warm calls of two seams on small stacks, supervised and with
    # the nested-seam mark set (the same call, unsupervised), in turns
    xs, avail_s, erased_s, _ = _fused_stack(ec, 1, 8 * 4096, seed + 2)
    small = fused_repair_call(ec, avail_s, erased_s)
    ms_rs = matrix_to_static(ec.matrix)
    enc_x = torch.randint(0, 256, (1, 8, 4096), dtype=torch.uint8,
                          device=card)
    noop = np.zeros(1, np.uint8)
    cost = {}
    for label, fn, calls in (
            ("dispatch alone", lambda: sup.dispatch("smoke.noop", len,
                                                    (noop,)), 20000),
            ("engine.fused_repair", lambda: small(xs), 200),
            ("ops.apply_matrix",
             lambda: apply_matrix_best(enc_x, ms_rs), 400)):
        fn()

        def supervised():
            for _ in range(calls):
                fn()

        def unsupervised():
            with _inside_seam():
                for _ in range(calls):
                    fn()
        turns = {"supervised": [], "unsupervised": []}
        for _ in range(5):
            for name, loop in (("supervised", supervised),
                               ("unsupervised", unsupervised),
                               ("unsupervised", unsupervised),
                               ("supervised", supervised)):
                turns[name].append(_issue_us(loop, calls))
        best = {k: min(v) for k, v in turns.items()}
        cost[label] = {"calls": calls, "supervised_us": turns["supervised"],
                       "unsupervised_us": turns["unsupervised"],
                       "us_per_dispatch": best["supervised"]
                       - best["unsupervised"]}
        print(f"phase 8: 8a host cost of one clean supervised dispatch, "
              f"{label}: {cost[label]['us_per_dispatch']:.3f} us (best of "
              f"10 turns of {calls} warm calls' issue: supervised "
              f"{best['supervised']:.3f} us a call, unsupervised "
              f"{best['unsupervised']:.3f}; medians "
              f"{sorted(turns['supervised'])[5]:.3f} / "
              f"{sorted(turns['unsupervised'])[5]:.3f})")
    out["clean"] = {"families": clean, "host_cost": cost,
                    "sync_warnings": dict(seen["supervised"])}

    # 8c and 8f run in child processes beside 8b, 8d and 8e
    child_oom = _child("oom")
    child_lock = _child("lockcheck", {"CEPH_TPU_LOCKCHECK": "1"})

    try:
        # -- 8b: the CLI's device-chaos at a real size -----------------------
        bench, res, row = recovery_workload("8b device-chaos", CHAOS_ARGV,
                                            need=("apply_matrix_cuda",),
                                            phase="phase 8")
        sv = res["supervisor"]
        check(res["verified"] and healed_stores(bench.last_run),
              "8b: the heal is byte-identical")
        check(res["faults_fired"] == 4, f"8b: 4 faults fired "
              f"({res['faults_fired']})")
        check(sv["card_failures"] == 2, f"8b: the loss raised twice ({sv})")
        check(sv["rung_downshifts"] >= 1 and sv["retries"] >= 1,
              f"8b: a retry and a rung split ({sv})")
        check(sv["demotions"] == sv["host_completions"]
              == sv["repromotions"] == 0 and not res["demoted_at_end"],
              f"8b: the card's work stayed on the card ({sv})")
        check(fallback.global_policy().engine(card) == "cuda",
              "8b: the tier is cuda")
        run = bench.last_run
        x, avail, erased, _ = _fused_stack(run.ec, 2, 1 << 20, seed + 3)
        reset_launch_counts()
        fused_repair_call(run.ec, avail, erased)(x)
        torch.cuda.synchronize()
        check(launch_counts()["apply_matrix_cuda"] >= 1,
              "8b: the dense kernel launches after the faults")
        row.update(supervisor=sv, faults_fired=res["faults_fired"],
                   demoted_at_end=res["demoted_at_end"])
        out["device_chaos"] = row
        print(f"phase 8: 8b: {res['faults_fired']} faults fired; supervisor "
              f"{sv}; healed byte for byte; the dense kernel launches after "
              f"the faults at tier cuda")

        # -- 8d: CRUSH row A under a flaky and a lost backend ---------------
        b = CrushBuilder()
        root = b.build_two_level(8, 4)
        b.add_simple_rule(0, root, "host", firstn=True, name="replicated")
        xs_c = np.arange(CHAOS_CRUSH_X, dtype=np.int64)
        cm = bulk.CompiledCrushMap(b.map, device="cuda")
        t0 = time.perf_counter()
        want, want_n = bulk.bulk_do_rule(cm, 0, xs_c, 3)
        clean_s = time.perf_counter() - t0
        iso = supervisor.DispatchSupervisor()
        prev = supervisor.set_global_supervisor(iso)
        block_bytes = bulk.BLOCK_BYTES
        bulk.BLOCK_BYTES = 1                    # blocks of 1024 lanes
        runs = {}
        try:
            for kind in ("transient", "backend_loss"):
                t0 = time.perf_counter()
                raised = None
                with dispatch_faults([DispatchFault(
                        kind, seam="crush.bulk_rule", at=1, calls=1)],
                        seed=seed) as plan:
                    try:
                        got, got_n = bulk.bulk_do_rule(cm, 0, xs_c, 3)
                    except DeviceDispatchError as e:
                        raised = e
                        got, got_n = bulk.bulk_do_rule(cm, 0, xs_c, 3)
                    fired = plan.summary()["fired"]
                check(np.array_equal(got, want)
                      and np.array_equal(got_n, want_n),
                      f"8d {kind}: the mappings equal the unfailed sweep")
                runs[kind] = {"s": time.perf_counter() - t0,
                              "fired": fired,
                              "raised": None if raised is None
                              else f"{raised.seam}: {raised.kind}"}
        finally:
            bulk.BLOCK_BYTES = block_bytes
            supervisor.set_global_supervisor(prev)
        ist = iso.stats()
        check(runs["transient"]["raised"] is None
              and runs["backend_loss"]["raised"]
              == "crush.bulk_rule: backend_loss",
              f"8d: the retry heals, the loss raises naming the seam ({runs})")
        check(ist["retries"] == 1 and ist["card_failures"] == 1
              and ist["demotions"] == ist["host_completions"] == 0,
              f"8d: retried once, raised once, nothing moved off the card "
              f"({ist})")
        out["crush"] = {"x": CHAOS_CRUSH_X, "clean_s": clean_s, "runs": runs,
                        "supervisor": {k: ist[k] for k in (
                            "dispatches", "retries", "card_failures",
                            "demotions", "host_completions")}}
        print(f"phase 8: 8d: row A over {CHAOS_CRUSH_X} x (clean "
              f"{clean_s:.2f} s; blocks of 1024 lanes): a transient fault "
              f"retried, a lost backend raised and the sweep re-run, both "
              f"equal to the unfailed sweep: {out['crush']}")

        # -- 8e: serving with one transient fault --------------------------
        from ceph_tpu_torch.bench.erasure_code_benchmark import \
            ErasureCodeBench
        srv = ErasureCodeBench()
        srv.setup(SERVE_CHAOS_ARGV)
        st0 = sup.stats()
        fault = DispatchFault("transient", seam="engine.serve-encode",
                              at=1, calls=1)
        with dispatch_faults([fault], seed=seed) as plan:
            sres = srv.run()
            fired = plan.summary()
        d = delta(st0)
        check(sres["requests"] == 64 and sres["rejected"] == 0,
              f"8e: 64 requests served ({sres['requests']}, "
              f"{sres['rejected']} rejected)")
        check(d["retries"] == 1 and d["demotions"] == 0
              and fired["fired"] == 1, f"8e: one retry ({d}, {fired})")
        out["serving"] = {"gbps": sres["gbps"],
                          "lat_p99_ms": sres["lat_p99_ms"],
                          "supervisor": d, "plan": fired}
        print(f"phase 8: 8e: 64 requests verified, {sres['gbps']:.6f} GB/s, "
              f"p99 {sres['lat_p99_ms']:.3f} ms; supervisor {d}")

        # -- 8f: lockcheck (child) -------------------------------------------
        lk = _child_result(child_lock, "phase 8: 8f")
        from ceph_tpu_torch.utils.locks import validate_lockcheck_report
        rep = lk["lockcheck"]
        validate_lockcheck_report(rep)
        check(rep["enabled"] and not rep["order_violations"]
              and not rep["blocking_events"] and not rep["unregistered"],
              f"8f: a clean lockcheck report ({rep['order_violations']}, "
              f"{rep['blocking_events']}, {rep['unregistered']})")
        check(lk["result"]["faults_fired"] == 4, f"8f: {lk['result']}")
        out["lockcheck"] = {"locks": len(rep["locks"]),
                            "edges": len(rep["edges"]),
                            "held_max_s": max(v["held_max_s"]
                                              for v in rep["locks"].values()),
                            "result": lk["result"]}
        print(f"phase 8: 8f: lockcheck report valid: {len(rep['locks'])} "
              f"locks, {len(rep['edges'])} edges, 0 order violations, 0 "
              f"blocking events; the longest hold "
              f"{out['lockcheck']['held_max_s'] * 1e3:.3f} ms")
        # -- 8c: a real out-of-memory error (child) --------------------------
        oom = _child_result(child_oom, "phase 8: 8c")
        check(oom["oom_raised"] and oom["rung_downshifts"] >= 1
              and oom["demotions"] == oom["card_failures"] == 0
              and oom["equal"],
              f"8c: a real OOM split ({oom})")
        out["oom"] = oom
        print(f"phase 8: 8c: {oom}")
    finally:
        # a failed check above leaves the children running: stop them
        for proc in (child_oom, child_lock):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 8: {out['seconds']:.1f} s")
    return out


# -- phase 9: the data plane on the card -------------------------------------

def _plane_child():
    """Start 9g's child: 9f's host-chaos row under CEPH_TPU_LOCKCHECK=1
    (``--child plane-lockcheck``) on 4 virtual members of the card."""
    return _child("plane-lockcheck", {"CEPH_TPU_LOCKCHECK": "1",
                                      PLANE_ENV: str(PLANE_MEMBERS)})


def _pct(a: float, b: float) -> str:
    return f"{a / b:.3f}x" if b else "n/a"


def data_plane_phase(seed: int) -> dict:
    """Phase 9 (the module docstring): the data plane on the card, over
    PLANE_MEMBERS virtual members of it."""
    import contextlib
    import io
    import shutil
    import numpy as np
    import torch
    from ceph_tpu_torch.bench import crushtool, osdmaptool
    from ceph_tpu_torch.bench.erasure_code_benchmark import ErasureCodeBench
    from ceph_tpu_torch.chaos.dispatch import DispatchFault, dispatch_faults
    from ceph_tpu_torch.chaos.hosts import host_chaos_selftest
    from ceph_tpu_torch.codes import engine
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.crush import bulk
    from ceph_tpu_torch.crush.builder import CrushBuilder
    from ceph_tpu_torch.crush.mapper import crush_do_rule
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE, \
        step_chooseleaf_indep
    from ceph_tpu_torch.matrices.jerasure import \
        reed_sol_vandermonde_coding_matrix
    from ceph_tpu_torch.ops import fallback, supervisor
    from ceph_tpu_torch.ops.gf_kernels import (
        apply_matrix_best, apply_matrix_numpy, apply_matrix_packed_best,
        pack_chunks, select_matrix_engine, unpack_chunks)
    from ceph_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from ceph_tpu_torch.ops.torch_ops import matrix_to_static
    from ceph_tpu_torch.parallel import plane as planemod
    from ceph_tpu_torch.parallel.mesh import make_mesh
    from ceph_tpu_torch.parallel.sharded_codes import (
        sharded_encode, sharded_roundtrip_step, sharded_single_erasure_repair)
    from ceph_tpu_torch.parallel.sharded_crush import (default_crush_mesh,
                                                       sharded_bulk_do_rule)
    from ceph_tpu_torch.telemetry import metrics as tel
    from ceph_tpu_torch.tools.dense_times import kernel_ms
    from ceph_tpu_torch.utils.errors import DeviceDispatchError
    from ceph_tpu_torch.utils.shard import last_partition

    t_phase = time.perf_counter()
    out: dict = {}
    reg = ErasureCodePluginRegistry.instance()
    metrics = tel.global_metrics()
    child = _plane_child()
    prev_env = os.environ.get(PLANE_ENV)
    os.environ[PLANE_ENV] = str(PLANE_MEMBERS)
    prev_plane = planemod.set_data_plane(None)
    try:
        p4 = planemod.activate(PLANE_MEMBERS, kind="cuda")
        check(p4 is not None and p4.n_devices == PLANE_MEMBERS
              and p4.kind == "cuda" and len(set(p4.members)) == 1,
              f"9: a plane of {PLANE_MEMBERS} members over one card")
        n = PLANE_MEMBERS

        def mesh_count(tier: str) -> float:
            return metrics.counter_value("engine_mesh_dispatches",
                                         tier=tier, devices=str(n))

        def launched(fn):
            torch.cuda.synchronize()
            reset_launch_counts()
            res = fn()
            torch.cuda.synchronize()
            return res, {k: v for k, v in launch_counts().items() if v}

        # -- 9a: the mesh tier at full width -----------------------------
        ec = reg.factory("jerasure", {"technique": "reed_sol_van",
                                      "k": str(K), "m": str(M)},
                         device="cuda")
        ms = matrix_to_static(ec.matrix)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randint(0, 256, (BATCH, K, CHUNK), dtype=torch.uint8,
                          device="cuda", generator=gen)
        check(select_matrix_engine(8, x.device, shape=tuple(x.shape),
                                   matrix_t=ms) == "mesh",
              "9a: the mesh row on the north-star shape")
        single, l_single = launched(lambda: apply_matrix_best(x, ms, mesh=0))
        c0 = mesh_count("apply-bytes")
        got, l_mesh = launched(lambda: apply_matrix_best(x, ms))
        part = last_partition()
        dispatches = mesh_count("apply-bytes") - c0
        check(torch.equal(got, single), "9a: mesh bytes = single-device")
        for cut in (slice(0, 2), slice(BATCH - 2, BATCH)):
            check(np.array_equal(got[cut].cpu().numpy(), apply_matrix_numpy(
                x[cut].cpu(), ms).numpy()), "9a: mesh bytes = numpy tier")
        check(part == [BATCH // n] * n, f"9a: partition {part}")
        check(dispatches == 1, f"9a: engine_mesh_dispatches {dispatches}")
        check(set(l_mesh) == set(l_single) and all(
            l_mesh[k] == n * l_single[k] for k in l_single),
            f"9a: launches {l_mesh} = {n} x {l_single}")
        words = pack_chunks(x)
        pgot, l_pmesh = launched(lambda: apply_matrix_packed_best(words, ms))
        psingle = apply_matrix_packed_best(words, ms, mesh=0)
        check(torch.equal(unpack_chunks(pgot), single)
              and torch.equal(unpack_chunks(psingle), single),
              "9a: packed mesh bytes = single-device")
        odd = apply_matrix_best(x[:BATCH - 1], ms)
        check(torch.equal(odd, single[:BATCH - 1])
              and last_partition() == [BATCH // n] * n,
              f"9a: {BATCH - 1} stripes pad to {BATCH} "
              f"({last_partition()})")
        t_mesh = kernel_ms(lambda: apply_matrix_best(x, ms),
                           "gf_matrix_kernel")
        t_single = kernel_ms(lambda: apply_matrix_best(x, ms, mesh=0),
                             "gf_matrix_kernel")
        ev_mesh, host_mesh = time_ms(lambda: apply_matrix_best(x, ms), 20)
        ev_single, host_single = time_ms(
            lambda: apply_matrix_best(x, ms, mesh=0), 20)
        out["9a"] = {"partition": part, "launches": l_mesh,
                     "launches_single": l_single,
                     "launches_packed": l_pmesh,
                     "mesh_dispatches": dispatches,
                     "device_ms": t_mesh, "device_ms_single": t_single,
                     "event_ms": ev_mesh, "event_ms_single": ev_single,
                     "host_ms": host_mesh, "host_ms_single": host_single}
        print(f"phase 9: 9a RS k={K} m={M} {tuple(x.shape)} over {n} "
              f"members: bytes and packed equal the single-device call and"
              f" the numpy tier ({BATCH - 1} stripes too); partition {part};"
              f" engine_mesh_dispatches {dispatches}; launches {l_mesh} "
              f"against {l_single}; device ms per call (profiler) "
              f"{t_mesh} mesh, {t_single} single; events {ev_mesh:.6f} / "
              f"{ev_single:.6f} ms; host issue {host_mesh:.6f} / "
              f"{host_single:.6f} ms ({_pct(host_mesh, host_single)})")

        # -- 9b: the engine's mesh variants ------------------------------
        fams = {}
        for label, plugin, profile in FAMILIES:
            fec = reg.factory(plugin, dict(profile), device="cuda")
            kf = fec.get_data_chunk_count()
            for stripes in MESH_STRIPES:
                st, avail, erased, _ = _fused_stack(
                    fec, stripes, FAMILY_SIZE, seed)
                data = torch.randint(0, 256, (stripes, kf, st.shape[2]),
                                     dtype=torch.uint8, device="cuda",
                                     generator=gen)
                tag = f"9b {label} x{stripes}"
                c_rep = mesh_count("fused-repair")
                rep, l_rep = launched(
                    lambda: engine.fused_repair_call(fec, avail,
                                                     erased)(st))
                part = last_partition()
                check(mesh_count("fused-repair") - c_rep == 1,
                      f"{tag}: one mesh dispatch")
                check(part == [-(-stripes // n)] * n,
                      f"{tag}: partition {part}")
                want = engine.fused_repair_call(fec, avail, erased,
                                                mesh=False)(st)
                check(all(torch.equal(a, b) for a, b in zip(rep, want)),
                      f"{tag}: fused repair = single-device")
                enc = engine.serve_dispatch_call(fec, "encode")(data)
                check(torch.equal(enc, engine.serve_dispatch_call(
                    fec, "encode", mesh=False)(data)),
                    f"{tag}: serve encode = single-device")
                dec = engine.serve_dispatch_call(fec, "decode", avail,
                                                 erased)(st)
                check(torch.equal(dec, engine.serve_dispatch_call(
                    fec, "decode", avail, erased, mesh=False)(st)),
                    f"{tag}: serve decode = single-device")
                check(bool(l_rep), f"{tag}: kernels launched")
                fams[f"{label} x{stripes}"] = {
                    "stack": list(st.shape), "launches": l_rep,
                    "partition": part}
                print(f"phase 9: {tag}: fused repair of "
                      f"{tuple(st.shape)} over partition {part}, serve "
                      f"encode and decode equal the single-device "
                      f"callables; launches {l_rep}")
        pool = torch.randint(0, 256, (RAG_PAGES, K, PAGE), dtype=torch.uint8,
                             device="cuda", generator=gen)
        mask = (torch.rand(RAG_PAGES, device="cuda", generator=gen)
                < 0.5).to(torch.uint8)
        kw = dict(pages=RAG_PAGES, page_size=PAGE)
        c_rag = mesh_count("serve-encode-ragged")
        rag, l_rag = launched(lambda: engine.serve_dispatch_ragged(
            ec, "encode", **kw)(pool, mask))
        check(mesh_count("serve-encode-ragged") - c_rag == 1,
              "9b ragged: one mesh dispatch")
        check(torch.equal(rag, engine.serve_dispatch_ragged(
            ec, "encode", mesh=False, **kw)(pool, mask))
            and not rag[mask == 0].any(),
            "9b ragged: page-sharded = single-device, dead pages zero")
        keys = [k for k in engine.global_pattern_cache()._entries
                if k[2] == "serve-encode-ragged" and k[0] == type(ec).__name__]
        check(any(k[-2:] == ("mesh", n) for k in keys)
              and any(k[-2:] != ("mesh", n) for k in keys),
              f"9b: cache keys with and without the plane: {keys}")
        fams["ragged"] = {"pool": list(pool.shape), "launches": l_rag,
                          "partition": last_partition(),
                          "live": int(mask.sum())}
        out["9b"] = fams
        print(f"phase 9: 9b ragged pool {tuple(pool.shape)} at "
              f"{int(mask.sum())} live pages: page-sharded = single-device,"
              f" partition {last_partition()}, launches {l_rag}; cache keys "
              + " | ".join(str(k[-4:]) for k in keys))

        # -- 9c: sharded CRUSH -------------------------------------------
        t9c = time.perf_counter()
        b = CrushBuilder()
        root = b.build_two_level(8, 4)
        rule = b.add_erasure_rule(
            "root", [step_chooseleaf_indep(0, b.type_id("host"))],
            name="ec_canonical")
        xs = np.arange(CRUSH_X)
        cm = bulk.CompiledCrushMap(b.map, device="cuda")
        bulk.bulk_do_rule(cm, rule, xs[:4096], 6, mesh=0)       # warm
        t0 = time.perf_counter()
        one, one_cnt = bulk.bulk_do_rule(cm, rule, xs, 6, mesh=0)
        one_s = time.perf_counter() - t0
        cmesh = default_crush_mesh(kind="cuda")
        check(cmesh.shape == {"x": n}, f"9c: crush mesh {cmesh.shape}")
        c_cr = mesh_count("crush-bulk")
        t0 = time.perf_counter()
        shd, shd_cnt = sharded_bulk_do_rule(cmesh, cm, rule, xs, 6)
        shd_s = time.perf_counter() - t0
        check(mesh_count("crush-bulk") - c_cr == 1, "9c: one mesh sweep")
        err_lanes = int((shd != one).any(axis=1).sum())
        check(err_lanes == 0 and np.array_equal(shd_cnt, one_cnt),
              f"9c: row B sharded = single-device on every lane "
              f"({err_lanes} differ)")
        pick = np.sort(np.random.default_rng(seed).choice(
            CRUSH_X, PLANE_CRUSH_SAMPLE, replace=False))
        for xv in pick:
            r = crush_do_rule(b.map, rule, int(xv), 6)
            r = r + [CRUSH_ITEM_NONE] * (6 - len(r))
            check(list(shd[xv]) == r, f"9c: x={xv} vs the host mapper")
        work = os.path.abspath(CRUSH_WORK + "_plane")
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)

        def run(tool, argv) -> str:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = tool.main(argv)
            check(rc == 0, f"{tool.__name__} {argv}: rc {rc}")
            return buf.getvalue()
        cpath = os.path.join(work, "c.txt")
        run(crushtool, ["--build-two-level", "100", "12", "-o", cpath])
        from ceph_tpu_torch.crush.osdmap import OSDMap
        plain = os.path.join(work, "osdmap.json")
        with open(plain, "w") as f:
            json.dump(osdmaptool.dump_osdmap(
                OSDMap(crush=crushtool.read_map(cpath)), []), f)
        ec_map = os.path.join(work, "osdmap_ec.json")
        prof_argv = []
        for k_, v in [("plugin", "jerasure")] + list(EC_PROFILE.items()):
            prof_argv += ["--ec-profile", f"{k_}={v}"]
        run(osdmaptool, [plain, "--create-ec-pool", "ecpool", *prof_argv,
                         "--pg-num", str(EC_PG_NUM), "-o", ec_map,
                         "--device", "cuda"])
        m = osdmaptool.load_osdmap(ec_map)
        m.device = "cuda"
        pid = max(m.pools)
        texts = {}
        for eng in ("bulk", "sharded"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                osdmaptool.test_map_pgs(m, [pid], eng)
            texts[eng] = buf.getvalue().splitlines()
        raw_b, _ = m.pg_to_raw_bulk(pid, engine="bulk")
        raw_s, _ = m.pg_to_raw_bulk(pid, engine="sharded")
        check(np.array_equal(raw_b, raw_s)
              and texts["bulk"][:-1] == texts["sharded"][:-1],
              "9c: --test-map-pgs engine=sharded = engine=bulk")
        shutil.rmtree(work, ignore_errors=True)
        out["9c"] = {"x": CRUSH_X, "single_s": one_s, "sharded_s": shd_s,
                     "host_sample": int(pick.size), "pg_num": EC_PG_NUM,
                     "test_map_pgs": texts["sharded"][-1].strip(),
                     "seconds": time.perf_counter() - t9c}
        print(f"phase 9: 9c row B over {CRUSH_X} x: sharded over {n} "
              f"members ({shd_s:.3f} s) = single-device ({one_s:.3f} s) "
              f"on every lane, = the host mapper on {pick.size} seeded x; "
              f"--test-map-pgs engine=sharded = bulk on {EC_PG_NUM} PGs "
              f"({texts['sharded'][-1].strip()})")

        # -- 9d: sharded_encode on the tp meshes, the roundtrip, and the
        # minimum-read repair ---------------------------------------------
        rs = reed_sol_vandermonde_coding_matrix(K, M, 8)
        devs = [torch.device("cuda", 0)] * n
        tp_rows = {}
        for dp, tp in ((2, 2), (1, 4)):
            mesh = make_mesh(n, tp=tp, devices=devs)
            check(mesh.shape == {"stripe": dp, "chunk": tp},
                  f"9d: mesh {mesh.shape}")
            par, l_enc = launched(lambda: sharded_encode(mesh, x, rs))
            check(torch.equal(par, single),
                  f"9d: sharded_encode ({dp}, {tp}) = single-device")
            tp_rows[f"{dp}x{tp}"] = {"launches": l_enc,
                                     "partition": last_partition()}
        dec, par = sharded_roundtrip_step(make_mesh(n, tp=2, devices=devs),
                                          x[:8], m=M)
        check(torch.equal(dec, x[:8]) and torch.equal(par, single[:8]),
              "9d: sharded_roundtrip_step decodes the data")
        reads = {}
        for plugin, profile in (
                ("jerasure", {"technique": "reed_sol_van", "k": str(K),
                              "m": str(M)}),
                ("shec", {"k": "6", "m": "3", "c": "2"}),
                ("clay", dict(CLAY))):
            rec_ = reg.factory(plugin, dict(profile), device="cuda")
            kk, nn = rec_.get_data_chunk_count(), rec_.get_chunk_count()
            cs = rec_.get_chunk_size(FAMILY_SIZE)
            data = np.random.default_rng(seed).integers(
                0, 256, (8, kk, cs), dtype=np.uint8)
            repaired, n_read, n_chunks = sharded_single_erasure_repair(
                make_mesh(n, tp=1, devices=devs), plugin, profile, data)
            minimum = rec_.minimum_to_decode({0}, set(range(1, nn)))
            check(n_read == len(minimum) and n_chunks == nn
                  and np.array_equal(repaired, data[:, :1, :]),
                  f"9d: {plugin} minimum-read repair (n_read {n_read})")
            reads[plugin] = {"n_read": n_read, "n": nn}
        out["9d"] = {"tp": tp_rows, "reads": reads}
        print(f"phase 9: 9d sharded_encode on (2, 2) and (1, 4) = "
              f"single-device ({tp_rows}); roundtrip decodes; minimum-read "
              f"repair n_read {reads}")

        # -- 9e: the CLI's multichip row ---------------------------------
        bench = ErasureCodeBench()
        bench.setup(MULTICHIP_ARGV)
        row = bench.run()
        check(row["verified"] and row["n_devices"] == n
              and row["physical_devices"] == 1
              and row["mesh_shape"] == [n, 1]
              and row["stripes_per_device"] == [BATCH // n] * n,
              f"9e: multichip row {row}")
        # the single-device per-call row beside it: no plane
        planemod.set_data_plane(None)
        bench = ErasureCodeBench()
        bench.setup(PERCALL_ARGV)
        percall = bench.run()
        check(percall["mesh_shape"] is None, "9e: the per-call row unsharded")
        out["9e"] = {k: row[k] for k in (
            "gbps", "mesh_shape", "n_devices", "physical_devices",
            "stripes_per_device", "verified", "lat_p50_ms")}
        out["9e"]["percall_gbps"] = percall["gbps"]
        print(f"phase 9: 9e multichip {row['gbps']:.6f} GB/s over "
              f"{row['n_devices']} members of {row['physical_devices']} "
              f"card, mesh_shape {row['mesh_shape']}, stripes "
              f"{row['stripes_per_device']}, verified; the single-device "
              f"per-call encode {percall['gbps']:.6f} GB/s")

        # -- 9f: host chaos, member quarantine, the width-1 loss ---------
        sup = supervisor.global_supervisor()
        bench = ErasureCodeBench()
        bench.setup(HOST_CHAOS_ARGV)
        row = bench.run()
        sv = row["supervisor"]
        check(row["verified"] and row["hosts"] == 2
              and healed_stores(bench.last_run), "9f: host-chaos healed")
        check(sv["host_quarantines"] == 1 and sv["host_repromotions"] == 1
              and row["reclaim_calls"] >= 1 and sv["card_failures"] == 0
              and sv["demotions"] == 0 and sv["host_completions"] == 0
              and not row["demoted_at_end"],
              f"9f: host-chaos counters {sv}, reclaims "
              f"{row['reclaim_calls']}")
        out["9f"] = {"gbps": row["gbps"], "supervisor": sv,
                     "faults_fired": row["faults_fired"],
                     "reclaim_calls": row["reclaim_calls"],
                     "lat_p50_ms": row.get("lat_p50_ms")}
        print(f"phase 9: 9f host-chaos {row['gbps']:.6f} GB/s, "
              f"{row['faults_fired']} faults, supervisor {sv}, reclaims "
              f"{row['reclaim_calls']}, healed")
        # the same row on the one card with no virtual members: no
        # plane forms, so losing host 0 raises and the pass is re-queued
        os.environ.pop(PLANE_ENV)
        try:
            solo = ErasureCodeBench()
            solo.setup(HOST_CHAOS_ARGV)
            srow = solo.run()
        finally:
            os.environ[PLANE_ENV] = str(PLANE_MEMBERS)
        ssv = srow["supervisor"]
        check(srow["verified"] and srow["hosts"] == 1
              and healed_stores(solo.last_run),
              "9f: host-chaos with no plane healed")
        check(ssv["card_failures"] == srow["faults_fired"] == 2
              and ssv["demotions"] == 0 and ssv["host_completions"] == 0
              and ssv["host_quarantines"] == 0
              and not srow["demoted_at_end"],
              f"9f: host-chaos with no plane re-queues on the card {ssv}")
        out["9f"]["no_plane"] = {"gbps": srow["gbps"], "supervisor": ssv}
        print(f"phase 9: 9f host-chaos with no plane {srow['gbps']:.6f} "
              f"GB/s: host 0 lost, {ssv['card_failures']} card failures, "
              f"the pass re-queued, no demotion, healed")
        pol = fallback.FallbackPolicy(force=None)
        prev_pol = fallback.set_global_policy(pol)
        # re-promotion after two clean probes, driven by hand below
        qsup = supervisor.DispatchSupervisor(promote_after=2, probe_every=8)
        prev_sup = supervisor.set_global_supervisor(qsup)
        try:
            planemod.activate(n, kind="cuda")
            st, avail, erased, _ = _fused_stack(ec, 16, FAMILY_SIZE, seed)
            want = engine.fused_repair_call(ec, avail, erased,
                                            mesh=False)(st)
            widths = []
            with dispatch_faults([DispatchFault(
                    "backend_loss", seam="engine.fused_repair", at=1,
                    calls=2)], seed=seed):
                got = engine.fused_repair_call(ec, avail, erased)(st)
                p = planemod.data_plane()
                widths.append(p.n_devices if p is not None else 1)
            q = qsup.stats()
            check(all(torch.equal(a, b) for a, b in zip(got, want))
                  and q["quarantines"] == 2 and widths == [1]
                  and q["card_failures"] == 0 and q["demotions"] == 0,
                  f"9f: member quarantine {n} -> 2 -> 1 on the card: {q}")
            qsup.tick()
            qsup.tick()
            p = planemod.data_plane()
            check(p is not None and p.n_devices == n and not qsup.demoted
                  and qsup.stats()["repromotions"] == 1,
                  f"9f: re-promoted to {n} members")
            planemod.set_data_plane(None)
            raised = False
            with dispatch_faults([DispatchFault(
                    "backend_loss", seam="engine.fused_repair", at=1,
                    calls=2)], seed=seed):
                try:
                    engine.fused_repair_call(ec, avail, erased)(st)
                except DeviceDispatchError:
                    raised = True
            check(raised and qsup.stats()["card_failures"] == 1,
                  "9f: the same loss with no plane raises "
                  "DeviceDispatchError")
            out["9f"]["member_quarantine"] = {
                k: qsup.stats()[k] for k in ("quarantines", "repromotions",
                                             "card_failures", "demotions")}
        finally:
            supervisor.set_global_supervisor(prev_sup)
            fallback.set_global_policy(prev_pol)
        print(f"phase 9: 9f member quarantine {n} -> 2 -> 1, re-promoted "
              f"to {n}, no demotion; with no plane the loss raises "
              f"DeviceDispatchError")

        # -- 9g: the selftest (host rows), and 9f under lockcheck ---------
        planemod.set_data_plane(None)
        st9 = host_chaos_selftest()
        check(st9["multi_host"] and st9["host_quarantines"] >= 1
              and st9["host_repromotions"] >= 1 and not st9["demoted"],
              f"9g: host_chaos_selftest {st9}")
        lk = _child_result(child, "phase 9: 9g lockcheck")
        rep = lk["lockcheck"]
        from ceph_tpu_torch.utils.locks import validate_lockcheck_report
        validate_lockcheck_report(rep)
        check(rep["enabled"] and not rep["order_violations"]
              and not rep["blocking_events"] and not rep["unregistered"],
              f"9g: a clean lockcheck report ({rep['order_violations']}, "
              f"{rep['blocking_events']}, {rep['unregistered']})")
        check("parallel.plane._lock" in rep["locks"],
              "9g: the plane lock was taken under lockcheck")
        out["9g"] = {"selftest": {k: st9[k] for k in (
            "host_quarantines", "host_repromotions",
            "journal_redispatches", "multi_host")},
            "lockcheck_locks": len(rep["locks"]),
            "child": lk["result"]}
        print(f"phase 9: 9g host_chaos_selftest (host rows): "
              f"{out['9g']['selftest']}; 9f under CEPH_TPU_LOCKCHECK=1: "
              f"valid, {len(rep['locks'])} locks, 0 violations, "
              f"supervisor {lk['result']['supervisor']}")
    finally:
        planemod.set_data_plane(prev_plane)
        if prev_env is None:
            os.environ.pop(PLANE_ENV, None)
        else:
            os.environ[PLANE_ENV] = prev_env
        if child.poll() is None:
            child.kill()
            child.communicate()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 9: {out['seconds']:.1f} s")
    return out


# -- phase 10: the program profiler, the tuning table and the registry ------

# 10a: the CLI's -w profile at the north-star argv (20 rounds of the three
# calls); the §6 table's dense encode: its bound over its profiler time
PROFILE_ARGV = RS_ARGV + ["--workload", "profile", "--size", str(1 << 20),
                          "--batch", "64", "--iterations", "20",
                          "--device", "cuda"]
DENSE_SHARE = 0.027545 / 0.041319
# 10a also profiles a bitmatrix code and shec (5 rounds each): the
# packet kernel's and the XOR-schedule kernel's programs
PROFILE_MORE = (
    ("cauchy_good k=8 m=3", ["--plugin", "jerasure", "-P",
                             "technique=cauchy_good", "-P", "k=8", "-P",
                             "m=3"]),
    ("shec k=6 m=3 c=2", ["--plugin", "shec", "-P", "k=6", "-P", "m=3",
                          "-P", "c=2"]))
# 10c: the timed sweeps (size 1 MiB, batch 64, min of 5 device times);
# 10d: the r6 encode row of the CLI under the swept table
SWEEPS = (("reed_sol_van k=8 m=3",
           {"technique": "reed_sol_van", "k": "8", "m": "3"}),
          ("reed_sol_r6_op k=8", {"technique": "reed_sol_r6_op", "k": "8",
                                  "m": "2"}))
R6_ARGV = ["--plugin", "jerasure", "-P", "technique=reed_sol_r6_op",
           "-P", "k=8", "-P", "m=2", "--workload", "encode", "--size",
           str(1 << 20), "--batch", "64", "--iterations", "20",
           "--resident", "--device", "cuda"]
# the kernels phase 10's paths must launch (counts at 0 just before)
PHASE10_KERNELS = ("apply_matrix_cuda", "apply_matrix_cuda_packed",
                   "apply_matrix_cuda_ragged", "apply_matrix_xor_cuda",
                   "apply_matrix_xor_cuda_packed", "apply_bitmatrix_cuda",
                   "apply_bitmatrix_xor_cuda", "apply_matrix_mxu_cuda")


def profiler_phase(seed: int) -> dict:
    """Phase 10 (the module docstring): the program profiler, the
    registry audit, the timed sweep, a tuned table in a child, and the
    kernel build cache across two children."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from ceph_tpu_torch.analysis.audit import audit_registry
    from ceph_tpu_torch.bench.erasure_code_benchmark import ErasureCodeBench
    from ceph_tpu_torch.codes.engine import serve_dispatch_call
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops.gf_kernels import select_matrix_engine
    from ceph_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from ceph_tpu_torch.ops.torch_ops import matrix_to_static
    from ceph_tpu_torch.telemetry.profiler import global_profiler
    from ceph_tpu_torch.tools.dense_times import kernel_ms
    from ceph_tpu_torch.tune.sweep import timed_sweep
    from ceph_tpu_torch.tune.table import BestConfigTable

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    out: dict = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_phase10_")
    cache_dir = os.path.join(work, "build_cache")
    # 10e's first child builds every source into an empty cache while
    # the phase runs
    cache_env = {"CEPH_TPU_COMPILE_CACHE": cache_dir}
    cold = _child("build-cache", cache_env)

    reset_launch_counts()
    # -- 10a: -w profile at the north-star argv --------------------------
    global_profiler().reset()
    bench = ErasureCodeBench()
    bench.setup(PROFILE_ARGV + ["--seed", str(seed)])
    res = bench.run()
    rows = {r["kind"]: r for r in res["profile_rows"]}
    check(sorted(rows) == ["fused-repair", "serve-decode", "serve-encode"],
          f"10a rows {sorted(rows)}")
    for kind, r in sorted(rows.items()):
        check(r["source"] == "analytic", f"10a {kind} source {r['source']}")
        check(r["p50_ms"] is not None and r["calls"] >= 20,
              f"10a {kind} p50 {r['p50_ms']}, {r['calls']} calls")
        check(r["utilization_pct"] is not None
              and 0 < r["utilization_pct"] <= 100,
              f"10a {kind} utilization {r['utilization_pct']}")
        print(f"phase 10: 10a {kind}: p50 {r['p50_ms']:.6f} ms, p99 "
              f"{r['p99_ms']:.6f} ms over {r['calls']} calls, "
              f"{r['bytes_accessed']:.0f} bytes accessed, "
              f"{r['hbm_gbps']:.3f} GB/s, utilization "
              f"{r['utilization_pct']:.4f} % (source {r['source']}, "
              f"batch {r['batch']}, pattern {r['pattern']})")
    ec = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"},
        device=dev)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 256, (BATCH, K, CHUNK),
                                      dtype=np.uint8)).to(dev)
    enc = serve_dispatch_call(ec, "encode")
    k_enc = kernel_ms(lambda: enc(x), "", iters=20)
    check(k_enc is not None, "10a: the profiler traced the encode")
    enc_row = rows["serve-encode"]
    rel = enc_row["p50_ms"] / k_enc - 1
    eng = select_matrix_engine(8, dev, shape=tuple(x.shape),
                               matrix_t=matrix_to_static(ec.matrix))
    print(f"phase 10: 10a serve-encode p50 {enc_row['p50_ms']:.6f} ms "
          f"against the profiler's kernel time {k_enc:.6f} ms for the "
          f"same call ({rel:+.2%}); its engine {eng}")
    check(abs(rel) <= 0.10, f"10a: encode p50 {rel:+.2%} of the kernel time")
    want = 100 * DENSE_SHARE
    if eng == "cuda":
        check(abs(enc_row["utilization_pct"] / want - 1) <= 0.07,
              f"10a: dense encode utilization {enc_row['utilization_pct']} "
              f"against {want:.2f}")
    more = {}
    for label, argv in PROFILE_MORE:
        global_profiler().reset()
        bench = ErasureCodeBench()
        bench.setup(argv + ["--workload", "profile", "--size", str(1 << 20),
                            "--batch", str(BATCH), "--iterations", "5",
                            "--device", "cuda", "--seed", str(seed)])
        rows_m = bench.run()["profile_rows"]
        check(len(rows_m) == 3, f"10a {label}: {len(rows_m)} rows")
        for r in rows_m:
            check(r["source"] == "analytic" and r["p50_ms"] is not None
                  and 0 < r["utilization_pct"] <= 100,
                  f"10a {label} {r['kind']}: {r['p50_ms']} ms, "
                  f"{r['utilization_pct']} %")
            print(f"phase 10: 10a {label} {r['kind']}: p50 "
                  f"{r['p50_ms']:.6f} ms over {r['calls']} calls, "
                  f"{r['bytes_accessed']:.0f} bytes accessed, utilization "
                  f"{r['utilization_pct']:.4f} % (pattern {r['pattern']})")
        more[label] = rows_m
    out["10a"] = {"rows": res["profile_rows"], "encode_kernel_ms": k_enc,
                  "encode_p50_vs_kernel": rel, "encode_engine": eng,
                  "gbps": res["gbps"], "more": more}

    # -- 10b: the registry audit on the card (sharded entries over the
    # plane's virtual members) ------------------------------------------
    prev = os.environ.get(PLANE_ENV)
    os.environ[PLANE_ENV] = str(PLANE_MEMBERS)
    try:
        t0 = time.perf_counter()
        audits = audit_registry(device=dev)
        audit_s = time.perf_counter() - t0
    finally:
        if prev is None:
            os.environ.pop(PLANE_ENV, None)
        else:
            os.environ[PLANE_ENV] = prev
    for a in audits:
        print(f"phase 10: 10b {a.name} ({a.kind}): setups {a.cold_setups} "
              f"cold / {a.warm_setups} warm (budget {a.setup_budget}), "
              f"sync {a.sync}, tiers {'/'.join(a.tiers) or '-'}: "
              + ("ok" if a.ok else "; ".join(a.findings)))
    bad = [a.name for a in audits if not a.ok]
    check(not bad, f"10b: entries not clean: {bad}")
    out["10b"] = {"entries": len(audits), "seconds": audit_s,
                  "device": sum(a.kind == "device" for a in audits),
                  "declared_syncs": [a.name for a in audits
                                     if a.sync == "declared"]}

    # -- 10c: the timed sweep -------------------------------------------
    entries = {}
    sweeps = {}
    for label, profile in SWEEPS:
        t0 = time.perf_counter()
        rep = timed_sweep("jerasure", profile, size=1 << 20, batch=BATCH,
                          repeats=5, seed=seed, device=dev)
        for row in rep.rows:
            print(f"phase 10: 10c {label} {row['name']}: "
                  + ", ".join(f"{t} {v:.6f} ms" for t, v in
                              row["candidates_ms"].items())
                  + f"; default {row['before']['engine']}, winner "
                  f"{row['after']['engine']} "
                  f"({row['improvement_pct']:+.2f} %); bytes identical "
                  f"across {len(row['candidates_ms'])} tiers")
        entries.update(rep.table.entries)
        sweeps[label] = {"rows": rep.rows, "tuned": sorted(rep.table.entries),
                         "seconds": time.perf_counter() - t0}
    r6_row = sweeps["reed_sol_r6_op k=8"]["rows"][0]
    dense_wins = (r6_row["candidates_ms"].get("cuda", float("inf"))
                  < r6_row["candidates_ms"].get("xor", float("inf")))
    print(f"phase 10: 10c the r6 encode: dense "
          f"{r6_row['candidates_ms'].get('cuda')} ms, XOR schedule "
          f"{r6_row['candidates_ms'].get('xor')} ms: the dense kernel "
          + ("wins, as PERF.md §7 records" if dense_wins
             else "does not win here"))
    out["10c"] = {"sweeps": sweeps, "r6_dense_beats_xor": dense_wins}
    launches = launch_counts()
    for kernel in PHASE10_KERNELS:
        check(launches[kernel] >= 1, f"{kernel} launched in phase 10")
    print(f"phase 10: launches {launches}")
    out["launches"] = launches

    # -- 10d: the swept table in a child, and a stale copy ----------------
    table = BestConfigTable.from_dict({"table_schema_version": 1,
                                       "entries": entries})
    path, stale = os.path.join(work, "tuned.json"), \
        os.path.join(work, "stale.json")
    table.save(path)
    blob = table.to_dict()
    for e in blob["entries"].values():
        e["env"]["device_name"] = "another card"
    BestConfigTable.from_dict(blob).save(stale)
    tuned = _child("tune-table", {"CEPH_TPU_SMOKE_TABLE": path,
                                  "CEPH_TPU_SMOKE_STALE": stale})

    # -- 10e: the build cache: the first child built, the second loads --
    first = _child_result(cold, "phase 10: 10e first build-cache child")
    warm = _child("build-cache", cache_env)
    second = _child_result(warm, "phase 10: 10e second build-cache child")
    print(f"phase 10: 10e CEPH_TPU_COMPILE_CACHE: first process "
          f"{first['misses']} misses, {first['hits']} hits, "
          f"{first['nvcc_runs']} nvcc runs in {first['seconds']:.1f} s; "
          f"second {second['misses']} misses, {second['hits']} hits, "
          f"{second['nvcc_runs']} nvcc runs in {second['seconds']:.2f} s; "
          f"{second['entries']} libraries in the cache")
    check(first["misses"] > 0 and first["nvcc_runs"] > 0,
          "10e: the first process built")
    check(second["misses"] == 0 and second["hits"] > 0
          and second["nvcc_runs"] == 0, "10e: the second ran no nvcc")
    out["10e"] = {"first": first, "second": second}

    got = _child_result(tuned, "phase 10: 10d tune-table child")
    print(f"phase 10: 10d r6 encode row under --tune-table: config_source "
          f"{got['config_source']} ({got['tune_key_hash']}), "
          f"{got['gbps']:.3f} GB/s, launches {got['launches']}; routed to "
          f"{got['engine']} ({got['kernel_ms']} ms device per call) "
          f"against the default {got['default_engine']}; bytes identical; "
          f"stale table: {got['stale']} stale lookups, routed to "
          f"{got['stale_engine']}, bytes identical")
    check(got["config_source"] == ("tuned" if entries else "default"),
          f"10d config_source {got['config_source']}")
    if got["pinned"]:
        check(got["stale"] > 0, "10d: the stale table was ignored")
    out["10d"] = got
    shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 10: {out['seconds']:.1f} s")
    return out


# phase 11: the cluster plane and the scenarios.  11a is the CLI's
# cluster row at the north star's code and the reference's 10k-OSD
# acceptance shape (ClusterSpec.sized(10000): 1024 replicated PGs, the
# EC pool at 1/8, a 12-event storm, the balancer to deviation 1, a
# rateless recovery of 8 objects of 1 MiB under a 10x straggler on
# shard 0); 11b a 120-OSD cluster on the card against the host mapper
# (run in a child beside 11a); 11c the production day simulated (seed
# 42, 64 requests, 3 damaged objects, a 4-event storm) and on the real
# clock (the CLI's scenario row: 256 requests of 1 MiB); 11d the CLI's
# tenant-week row; 11e the registry's cluster and scenario entries; 11f
# the sweep of jerasure k=8 m=3 at 1 MiB
CLUSTER_ARGV = RS_ARGV + ["--workload", "cluster", "--size", str(1 << 20),
                          "--batch", "8", "--osds", "10000",
                          "--cluster-pgs", "1024", "--storm-events", "12",
                          "--device", "cuda", "--json"]
CLUSTER_HOST_SPEC = dict(seed=7, replicated_pg_num=128, ec_pg_num=32)
CLUSTER_HOST_EVENTS = 6
SCENARIO_ARGV = RS_ARGV + ["--workload", "scenario", "--size", str(1 << 20),
                           "--requests", "256", "--batch", "8",
                           "--storm-events", "12", "--device", "cuda",
                           "--json"]
WEEK_ARGV = RS_ARGV + ["--workload", "tenant-week", "--iterations", "2",
                       "--device", "cuda", "--json"]
WEEK_SPEC = dict(seed=17, days=2, day_s=6.0, peak_rates=(40.0, 30.0, 20.0),
                 burst_factor=80.0)
SWEEP_ARGV = ["--plugin", "jerasure", "--km", "8,3", "--size",
              str(1 << 20), "--batch", "8", "--device", "cuda"]
# the sweep's only soft failures: the reference's text on its CPU run
SWEEP_ERRORS = {"liberation": "ValueError: liberation: k=8 must be <= w=7"}
PHASE11_ENTRIES = ("cluster.balancer_round", "cluster.storm_reeval",
                   "cluster.rateless_dispatch", "scenario.runner",
                   "scenario.qos", "scenario.week")


def cluster_host_child() -> dict:
    """11b's host side: the 120-OSD storm and balance on the host
    mapper (a CPU map), as plain dicts."""
    from ceph_tpu_torch.cluster import (ClusterSpec, balance_cluster,
                                        build_cluster, run_churn_storm)
    spec = ClusterSpec.sized(120, **CLUSTER_HOST_SPEC)
    t0 = time.perf_counter()
    m = build_cluster(spec, device="cpu")
    storm = run_churn_storm(m, seed=3, events=CLUSTER_HOST_EVENTS,
                            max_down=4, engine="host")
    bal = balance_cluster(m, engine="host")
    return {"storm": storm.to_dict(), "balance": bal.to_dict(),
            "upmap_items": sorted([list(k), [list(p) for p in v]]
                                  for k, v in m.pg_upmap_items.items()),
            "seconds": time.perf_counter() - t0}


def _launched(before: dict) -> dict:
    from ceph_tpu_torch.ops.launches import launch_counts
    return {k: v - before.get(k, 0) for k, v in launch_counts().items()
            if v - before.get(k, 0)}


def cluster_scenario_phase(seed: int) -> dict:
    """Phase 11 (the module docstring): the cluster plane and the
    production day, the tenant week, the registry's new entries and the
    sweep, on the card."""
    import contextlib
    import io
    import torch
    from ceph_tpu_torch import cluster as clustermod
    from ceph_tpu_torch.analysis import audit, entrypoints
    from ceph_tpu_torch.bench import sweep
    from ceph_tpu_torch.bench.erasure_code_benchmark import ErasureCodeBench
    from ceph_tpu_torch.codes.engine import fused_repair_call
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from ceph_tpu_torch.parallel.plane import data_plane
    from ceph_tpu_torch.scenario import (default_scenario, run_scenario,
                                         run_tenant_week,
                                         tenant_week_scenario)
    from ceph_tpu_torch.serve.loadgen import throughput_service_model
    from ceph_tpu_torch.telemetry import global_tracer
    from ceph_tpu_torch.telemetry.profiler import global_profiler
    from ceph_tpu_torch.utils.retry import FakeClock

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    out: dict = {}
    # a plane left active by an earlier phase would change every rateless
    # plan (shard_count) and shard the CRUSH sweeps
    check(data_plane() is None, "phase 11 starts with no plane active")
    host_side = _child("cluster-host")

    # -- 11a: the cluster row at 10k OSDs ---------------------------------
    builds: list = []
    real_build = clustermod.build_cluster

    def timed_build(spec, device=None):
        t0 = time.perf_counter()
        m = real_build(spec, device=device)
        builds.append(time.perf_counter() - t0)
        return m
    global_tracer().reset()
    global_profiler().reset()
    bench = ErasureCodeBench()
    bench.setup(CLUSTER_ARGV + ["--seed", str(seed)])
    reset_launch_counts()
    clustermod.build_cluster = timed_build
    t0 = time.perf_counter()
    try:
        res = bench.run()
    finally:
        clustermod.build_cluster = real_build
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _launched({})
    spans = span_seconds(global_tracer().to_dict()["spans"])
    bulk = [r for r in global_profiler().attribution_rows()
            if r["name"] == "crush.bulk_rule"]
    bulk_s = sum(p["total_s"] for p in global_profiler().top_programs(64)
                 if "crush.bulk_rule" in p["series"])
    check(res["platform"] == "gpu" and res["engine"] == "bulk",
          "11a ran the bulk evaluator on the card")
    check(res["osds"] >= 10000 and res["total_pgs"] == 1024 + 128,
          f"11a shape {res['osds']} OSDs, {res['total_pgs']} PGs")
    check(res["verified"] is True, "11a verified")
    check(res["balancer_converged"] and res["balancer_max_dev_final"] <= 1,
          f"11a balancer {res['balancer_converged']} "
          f"{res['balancer_max_dev_final']}")
    check(res["p99_ratio"] is not None and res["p99_ratio"] <= 2,
          f"11a p99 ratio {res['p99_ratio']}")
    check(res["straggler_reassignments"] > 0,
          f"11a reassignments {res['straggler_reassignments']}")
    check(launched.get("apply_matrix_cuda", 0) >= 1,
          f"11a: the dense kernel launched ({launched})")
    check(bulk and sum(r["calls"] for r in bulk) > 0,
          "11a: the bulk evaluator's blocks were timed")
    top = {k: v for k, v in spans.items()
           if k.startswith("cluster.") and (
               k.count("/") <= 1
               or k.endswith(("/scrub", "/verify", "/decode",
                              "/writeback")))}
    print(f"phase 11: 11a -w cluster: {res['osds']} OSDs, "
          f"{res['total_pgs']} PGs; build {builds[0]:.3f} s (the "
          f"equivalence gate's two rebuilds {sum(builds[1:]):.3f} s); "
          f"storm {spans.get('cluster.storm', 0):.3f} s "
          f"({res['storm_events']} epochs, {res['remapped_total']} PGs "
          f"remapped, quiescent after {res['remap_convergence_epochs']}), "
          f"balance {spans.get('cluster.balance', 0):.3f} s "
          f"({res['balancer_iterations']} rounds, {res['balancer_moves']} "
          f"moves, max deviation {res['balancer_max_dev_final']}), "
          f"recovery {spans.get('cluster.rateless', 0):.3f} s (p99 ratio "
          f"{res['p99_ratio']}, {res['straggler_reassignments']} "
          f"reassignments); the row {res['seconds']:.3f} s, {wall:.1f} s "
          f"with the build")
    print(f"phase 11: 11a bulk evaluations: "
          + "; ".join(f"{r['pattern']} ({r['batch']} lanes a block): "
                      f"{r['calls']} blocks, p50 {r['p50_ms']} ms, p99 "
                      f"{r['p99_ms']} ms" for r in bulk)
          + f"; {bulk_s * 1e3:.3f} ms of blocks in all (CUDA events)")
    print("phase 11: 11a spans s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(top.items())))
    print(f"phase 11: 11a launches {launched}")
    out["11a"] = {"row": res, "build_s": builds, "spans": top,
                  "bulk_rows": bulk, "bulk_ms": bulk_s * 1e3,
                  "launches": launched, "wall_s": wall}

    # -- 11b: a 120-OSD cluster, the card against the host mapper --------
    reset_launch_counts()
    spec = clustermod.ClusterSpec.sized(120, **CLUSTER_HOST_SPEC)
    m = real_build(spec, device="cuda")
    storm = clustermod.run_churn_storm(m, seed=3, events=CLUSTER_HOST_EVENTS,
                                       max_down=4, engine="bulk")
    bal = clustermod.balance_cluster(m, engine="bulk")
    host = _child_result(host_side, "phase 11: 11b host-mapper child")
    for name, card_d, host_d in (("storm", storm.to_dict(), host["storm"]),
                                 ("balance", bal.to_dict(),
                                  host["balance"])):
        card_d = dict(card_d, engine="host")
        check(card_d == host_d, f"11b {name}: the card's report equals "
              f"the host mapper's")
    items = sorted([list(k), [list(p) for p in v]]
                   for k, v in m.pg_upmap_items.items())
    check(items == host["upmap_items"], "11b: the same upmap items")
    print(f"phase 11: 11b 120 OSDs: storm {storm.events}+"
          f"{storm.drain_events} epochs, {storm.total_remapped} PGs "
          f"remapped; balance {bal.iterations} rounds, {bal.moves} moves; "
          f"the card's reports and {len(items)} upmap items equal the host "
          f"mapper's ({host['seconds']:.1f} s in the child)")
    out["11b"] = {"storm": storm.to_dict(), "balance": bal.to_dict(),
                  "host_s": host["seconds"]}

    # -- 11c: the production day, simulated and on the real clock --------
    sim = {}
    reset_launch_counts()
    for arb in (None, False):
        for where in ("cuda", "cpu"):
            spec = default_scenario(seed=42, n_requests=64,
                                    damaged_objects=3, storm_events=4)
            run = run_scenario(spec, clock=FakeClock(), device=where,
                               service_model=throughput_service_model(),
                               enable_arbiter=arb)
            sim[(arb, where)] = run
    sim_launches = _launched({})
    for arb in (None, False):
        card, cpu = sim[(arb, "cuda")], sim[(arb, "cpu")]
        check(card.report.to_json() == cpu.report.to_json(),
              f"11c simulated (arbiter {arb}): the card's report equals "
              f"the CPU's")
        check(card.serving.batcher.dispatch_log
              == cpu.serving.batcher.dispatch_log,
              f"11c simulated (arbiter {arb}): the same dispatch log")
        check(card.report.ok(), f"11c simulated gates {card.report.gates}")
    on, off = sim[(None, "cuda")].report, sim[(False, "cuda")].report
    check(on.p99_ms < off.p99_ms
          and on.deadline_miss_rate < off.deadline_miss_rate,
          f"11c simulated: arbiter on p99 {on.p99_ms} / miss "
          f"{on.deadline_miss_rate} against off {off.p99_ms} / "
          f"{off.deadline_miss_rate}")
    print(f"phase 11: 11c simulated day on the card = on the CPU: "
          f"arbiter on p99 {on.p99_ms} ms, miss {on.deadline_miss_rate}; "
          f"off p99 {off.p99_ms} ms, miss {off.deadline_miss_rate}; "
          f"launches {sim_launches}")
    # the recovery's fused repairs: every single-erasure program of the
    # recovery code set up before the real-clock rows (the serving
    # warmup covers the client stream only), so stream_compiles reads
    # the stream's own setups
    rec_ec = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"},
        device=dev)
    n = rec_ec.get_chunk_count()
    for lost in range(n):
        avail = tuple(s for s in range(n) if s != lost)
        fused_repair_call(rec_ec, avail, (lost,))(torch.zeros(
            (1, len(avail), 4096), dtype=torch.uint8, device=dev))
    rows = {}
    for label, extra in (("arbiter", []), ("no-arbiter", ["--no-arbiter"])):
        bench = ErasureCodeBench()
        bench.setup(SCENARIO_ARGV + extra + ["--seed", str(seed)])
        before = launch_counts()
        t0 = time.perf_counter()
        r = bench.run()
        torch.cuda.synchronize()
        r["wall_s"] = time.perf_counter() - t0
        r["launches"] = _launched(before)
        check(r["verified"] is True and r["platform"] == "gpu",
              f"11c {label}: verified on the card")
        check(r["stream_compiles"] == 0,
              f"11c {label}: stream_compiles {r['stream_compiles']}")
        check(r["launches"], f"11c {label}: kernels launched")
        print(f"phase 11: 11c -w scenario ({label}): "
              f"{r['gbps_under_slo']} GB/s under SLO, p50 "
              f"{r['lat_p50_ms']} ms, p99 {r['lat_p99_ms']} ms, miss rate "
              f"{r['deadline_miss_rate']}, {r['recovery_rounds']} recovery "
              f"rounds, {r['churn_events']} churn events, stream_compiles "
              f"{r['stream_compiles']}, {r['seconds']:.3f} s of stream "
              f"({r['wall_s']:.1f} s with set-up); tail_attribution "
              f"{json.dumps(r['tail_attribution'], sort_keys=True)}; "
              f"launches {r['launches']}")
        rows[label] = r
    out["11c"] = {"sim_on": on.to_dict(), "sim_off": off.to_dict(),
                  "sim_launches": sim_launches, "rows": rows}

    # -- 11d: the tenant week ---------------------------------------------
    weeks = {}
    for label, extra in (("arbiter", []), ("no-arbiter", ["--no-arbiter"])):
        bench = ErasureCodeBench()
        bench.setup(WEEK_ARGV + extra + ["--seed", str(seed)])
        before = launch_counts()
        t0 = time.perf_counter()
        r = bench.run()
        r["wall_s"] = time.perf_counter() - t0
        r["launches"] = _launched(before)
        check(r["verified"] is True and r["disasters_healed"],
              f"11d {label}: gates")
        weeks[label] = r
        print(f"phase 11: 11d -w tenant-week ({label}): isolation_ok "
              f"{r['isolation_ok']}, victims' GB/s under SLO "
              f"{r['victim_gbps_under_slo']}, p99 {r['lat_p99_ms']} ms, "
              f"dispatch_crc {r['dispatch_crc']}, {r['dispatched']} "
              f"dispatches of {r['requests_offered']} requests, "
              f"{r['wall_s']:.1f} s; launches {r['launches']}")
    check(weeks["arbiter"]["isolation_ok"], "11d: the isolation gate holds")
    check(not weeks["no-arbiter"]["isolation_ok"],
          "11d: the control arm fails the isolation gate")
    wk = {}
    for where in ("cuda", "cpu"):
        wk[where] = run_tenant_week(tenant_week_scenario(**WEEK_SPEC),
                                    device=where).report
    check(wk["cuda"].gates["dispatch_crc"] == wk["cpu"].gates["dispatch_crc"]
          and wk["cuda"].to_json() == wk["cpu"].to_json(),
          "11d: the week on the card equals the week on the CPU")
    out["11d"] = {"rows": weeks,
                  "dispatch_crc": wk["cuda"].gates["dispatch_crc"]}

    # -- 11e: the registry's cluster and scenario entries ----------------
    names = entrypoints.registry_names()
    check(len(names) == 59, f"11e: {len(names)} registry entries")
    byname = {e.name: e for e in entrypoints.registry()}
    audits = [audit.audit_entry(byname[n], device=dev)
              for n in PHASE11_ENTRIES]
    for a in audits:
        print(f"phase 11: 11e {a.name} ({a.kind}): setups {a.cold_setups} "
              f"cold / {a.warm_setups} warm, sync {a.sync}, tiers "
              f"{'/'.join(a.tiers) or '-'}: "
              + ("ok" if a.ok else "; ".join(a.findings)))
    check(all(a.ok for a in audits), "11e: the new entries are clean")
    declared = sorted(a.name for a in audits if a.sync == "declared")
    check(declared == ["cluster.balancer_round", "cluster.storm_reeval"],
          f"11e declared syncs {declared}")
    out["11e"] = {"entries": len(names), "declared": declared}

    # -- 11f: the sweep ---------------------------------------------------
    buf = io.StringIO()
    before = launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = sweep.main(SWEEP_ARGV)
    sweep_s = time.perf_counter() - t0
    cells = [json.loads(line) for line in buf.getvalue().splitlines()]
    check(rc == 0 and len(cells) == 8, f"11f: {len(cells)} cells")
    for c in cells:
        tech = c.get("technique")
        if "error" in c:
            check(c["error"] == SWEEP_ERRORS.get(tech),
                  f"11f {tech} {c['workload']}: {c['error']}")
        else:
            check(c.get("gbps") is not None, f"11f {tech}: gbps")
        print(f"phase 11: 11f {json.dumps(c)}")
    check(sum("error" in c for c in cells) == 2,
          "11f: only liberation's two cells soft-fail")
    sweep_launches = _launched(before)
    print(f"phase 11: 11f sweep {sweep_s:.1f} s; launches {sweep_launches}")
    out["11f"] = {"cells": cells, "seconds": sweep_s,
                  "launches": sweep_launches}
    check(data_plane() is None, "phase 11 leaves no plane active")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 11: {out['seconds']:.1f} s")
    return out


# -- phase 12: the repo-root tools and demos on the card ----------------------

# each tool at its reference defaults, in-process through main(argv): (label,
# module under ceph_tpu_torch/tools, argv, the rc it must give, or a tuple
# of them); --kill-one alone runs as processes (its own two workers)
TOOL_RUNS = (
    ("bulk_crush_row", "bulk_crush_row", [], 0),
    ("bulk_crush_row --ec", "bulk_crush_row", ["--ec"], 0),
    ("perf_dump both", "perf_dump", ["--scenario", "both", "--validate"], 0),
    ("perf_dump profile", "perf_dump", ["--profile", "--validate"], 0),
    ("perf_dump unrecoverable", "perf_dump",
     ["--scenario", "unrecoverable", "--flight-recorder", "--validate"], 0),
    # rc 0 or 3: over 40 interleaved pairs on an H100's host the on/off
    # ratio read median 0.997 with a standard deviation of 9.1 % (no
    # overhead), so a min-of-5 verdict on 3 % is noise: 13-28 % of
    # draws fail (min-of-15 failed too); its series and verdict are kept
    ("perf_dump check-overhead", "perf_dump", ["--check-overhead", "3"],
     (0, 3)),
    ("trace_view", "trace_view", ["--run-scenario", "--check"], 0),
    ("scrub_demo", "scrub_demo", [], 0),
    ("scrub_demo over m", "scrub_demo", ["--erasures", "3"], 2),
    ("recovery_demo", "recovery_demo", [], 0),
    ("recovery_demo over m", "recovery_demo", ["--erasures", "3"], 2),
    ("serve_demo", "serve_demo", [], 0),
    ("serve_demo over m", "serve_demo", ["--erasures", "4"], 2),
    ("scenario_demo", "scenario_demo", [], 0),
    ("scenario_demo over m", "scenario_demo", ["--erasures", "4"], 2),
    ("tenant_week_demo", "tenant_week_demo", [], 0),
    ("cluster_demo", "cluster_demo", [], 0),
    # the arm past the budget reaches its heal after a 2-event storm, not
    # 20: the storm's epochs are the arm's cost, the rc is the heal's
    ("cluster_demo over m", "cluster_demo", ["--erasures", "3", "--events",
                                             "2"], 2),
    ("device_chaos_demo", "device_chaos_demo", [], 0),
    ("device_chaos_demo over m", "device_chaos_demo", ["--erasures", "4"], 2),
    ("host_chaos_demo", "host_chaos_demo", [], 0),
    ("host_chaos_demo over m", "host_chaos_demo", ["--erasures", "4"], 2),
    ("replay_bisect", "replay_bisect", ["--days", "1"], 0),
    ("replay_bisect --inject-jitter", "replay_bisect",
     ["--days", "1", "--inject-jitter"], 0),
    ("cluster_lifecycle_demo", "cluster_lifecycle_demo", [], 0),
    ("failure_recovery_demo", "failure_recovery_demo", [], 0),
)
# the host-chaos demo's plane: virtual members of the card, as phase 9's
HOST_CHAOS_TOOLS = ("host_chaos_demo",)
KILL_ONE_TIMEOUT = 300
# --kill-one's processes start once this run is done: the overhead gate
# times host-paced runs, so no process of this script runs beside it
KILL_ONE_AFTER = "perf_dump check-overhead"


def _stop_session(proc) -> None:
    """Kill a child started with ``start_new_session`` and everything it
    started, then reap it."""
    import signal
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.communicate()


@contextlib.contextmanager
def _fresh_process_state():
    """Process-global state as a new process of a tool has it (the
    policy, the supervisor, the flight recorder, the pattern cache, no
    plane, no armed fault plan), so that no earlier phase's dumps or
    counters leak into a tool's gates; restored on exit."""
    from ceph_tpu_torch.chaos.dispatch import arm_plan
    from ceph_tpu_torch.chaos.hosts import arm_host_plan
    from ceph_tpu_torch.codes.engine import (PatternCache,
                                             set_global_pattern_cache)
    from ceph_tpu_torch.ops.fallback import (FallbackPolicy,
                                             set_global_policy)
    from ceph_tpu_torch.ops.supervisor import (DispatchSupervisor,
                                               set_global_supervisor)
    from ceph_tpu_torch.parallel.plane import set_data_plane
    from ceph_tpu_torch.telemetry.recorder import (
        FlightRecorder, set_global_flight_recorder)
    prev = (set_global_policy(FallbackPolicy()),
            set_global_supervisor(DispatchSupervisor()),
            set_global_flight_recorder(FlightRecorder()),
            set_global_pattern_cache(PatternCache()),
            set_data_plane(None))
    arm_plan(None)
    arm_host_plan(None)
    try:
        yield
    finally:
        set_global_policy(prev[0])
        set_global_supervisor(prev[1])
        set_global_flight_recorder(prev[2])
        set_global_pattern_cache(prev[3])
        set_data_plane(prev[4])
        arm_plan(None)
        arm_host_plan(None)


def _bench_record(bench: dict, stamp: str, scale: float = 1.0) -> dict:
    """Phase 5's rows in the bench line's shape (``bench_line.measure``):
    the headline (the best carry chain), the decode and serving rows."""
    from ceph_tpu_torch.bench import bench_line
    rows = bench["rows"]
    carry = [n for n, _ in bench_line.ENCODE_ROWS if n.endswith("_carry")]
    return {
        "metric": bench_line.METRIC, "unit": "GB/s", "git_sha": stamp,
        "timestamp": stamp,
        "value": max(rows[n]["gbps"] for n in carry) * scale,
        "decode_rows": {n: {"gbps": rows[n]["gbps"] * scale}
                        for n, _ in bench_line.DECODE_ROWS},
        "serving_rows": {n: {k: rows[n][k] for k in
                             ("gbps", "gbps_under_slo", "padding_overhead")}
                         for n, _ in bench_line.SERVING_ROWS},
    }


def tools_phase(seed: int, held: dict, row_a=None, bench=None) -> dict:
    """Phase 12 (the module docstring): each ported tool, demo and
    example at its reference defaults on the card, with the launch
    counters read around it.  ``held``: the wrappers phases 2-4 held
    against their plain versions (every kernel launched here must be
    among them); ``row_a``: phase 6's row A, beside bulk_crush_row's
    mappings/s; ``bench``: phase 5's blob, bench_diff's trajectory."""
    import importlib
    import io
    import tempfile
    import torch
    from ceph_tpu_torch.ops.launches import launch_counts
    from ceph_tpu_torch.parallel.plane import data_plane
    from ceph_tpu_torch.tools import bench_diff

    t_phase = time.perf_counter()
    check(data_plane() is None, "phase 12 starts with no plane active")
    kill = None
    runs: dict = {}
    outputs: dict = {}
    try:
        for label, name, argv, want in TOOL_RUNS:
            mod = importlib.import_module(f"ceph_tpu_torch.tools.{name}")
            before = launch_counts()
            buf = io.StringIO()
            prev_env = os.environ.get(PLANE_ENV)
            if name in HOST_CHAOS_TOOLS:
                os.environ[PLANE_ENV] = str(PLANE_MEMBERS)
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf), \
                        _fresh_process_state():
                    try:
                        rc = mod.main(list(argv))
                    except SystemExit as e:
                        rc = e.code
                    torch.cuda.synchronize()
            finally:
                if name in HOST_CHAOS_TOOLS:
                    if prev_env is None:
                        os.environ.pop(PLANE_ENV, None)
                    else:
                        os.environ[PLANE_ENV] = prev_env
            row = {"rc": rc, "seconds": time.perf_counter() - t0,
                   "launched": _launched(before)}
            runs[label] = row
            outputs[label] = buf.getvalue()
            print(f"phase 12: {label}: rc {rc} in {row['seconds']:.2f} s, "
                  f"launched {row['launched']}")
            if rc != want:
                print(f"phase 12: {label}: its output ends "
                      f"{outputs[label][-2000:]}")
            check(rc in (want if isinstance(want, tuple) else (want,)),
                  f"phase 12: {label} gave rc {rc}, not {want}")
            check(data_plane() is None, f"phase 12: {label} left a plane")
            if label == KILL_ONE_AFTER:
                # --kill-one: the demo and its two workers on the card,
                # in a session of their own (a failed check stops all)
                t_kill = time.perf_counter()
                kill = subprocess.Popen(
                    [sys.executable, "-m",
                     "ceph_tpu_torch.tools.host_chaos_demo", "--kill-one",
                     "--json"], stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True, env=dict(os.environ),
                    cwd=os.path.dirname(os.path.abspath(__file__)),
                    start_new_session=True)
    except BaseException:
        if kill is not None:
            _stop_session(kill)
        raise
    out: dict = {"runs": runs}

    # bulk_crush_row: its line, beside phase 6's row A of this run
    crush_rows = {}
    for label in ("bulk_crush_row", "bulk_crush_row --ec"):
        line = json.loads(outputs[label].strip().splitlines()[-1])
        check(line["n"] == 1_000_000 and line["value"] > 0,
              f"phase 12: {label}: {line}")
        crush_rows[label] = line
    if row_a is not None:
        crush_rows["row_a_mappings_per_s"] = row_a["mappings_per_s"]
        crush_rows["ratio_to_row_a"] = (
            crush_rows["bulk_crush_row"]["value"] / row_a["mappings_per_s"])
    out["bulk_crush_row"] = crush_rows
    print(f"phase 12: bulk_crush_row " + json.dumps(crush_rows))

    check("check: ok" in outputs["trace_view"], "trace_view --check")
    overhead = json.loads(outputs["perf_dump check-overhead"])
    out["check_overhead"] = overhead
    print(f"phase 12: perf_dump --check-overhead 3: "
          f"{json.dumps(overhead)}")
    bisect = outputs["replay_bisect --inject-jitter"]
    check("DIVERGENCE at checkpoint" in bisect
          and "run A: dispatch[" in bisect,
          "replay_bisect localizes the jitter to a dispatch checkpoint")
    out["replay_bisect"] = [ln.strip() for ln in bisect.splitlines()
                            if ln.startswith(("replay_bisect", "  run"))]

    # bench_diff over phase 5's rows of this run: the same line again is
    # clean (rc 0), the line at half its GB/s a regression (rc 4)
    if bench is not None:
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "BENCH_r01.json"), "w") as f:
                json.dump(_bench_record(bench, "phase5"), f)
            diffs = {}
            for tag, scale, want in (("again", 1.0, 0), ("halved", 0.5, 4)):
                cand = os.path.join(d, f"{tag}.json")
                with open(cand, "w") as f:
                    json.dump(_bench_record(bench, tag, scale), f)
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf), \
                        contextlib.redirect_stderr(io.StringIO()):
                    rc = bench_diff.main(["--repo", d, "--candidate", cand,
                                          "--json"])
                rep = json.loads(buf.getvalue())
                check(rc == want, f"bench_diff {tag}: rc {rc}, not {want}")
                diffs[tag] = {"rc": rc, "rows": len(rep["rows"]),
                              "regressions": rep["regressions"],
                              "seconds": time.perf_counter() - t0}
                runs[f"bench_diff {tag}"] = {
                    "rc": rc, "seconds": diffs[tag]["seconds"],
                    "launched": {}}
        out["bench_diff"] = diffs
        print(f"phase 12: bench_diff over phase 5's rows: "
              f"{json.dumps(diffs)}")

    # the kill-one processes, started after the overhead gate
    try:
        stdout, stderr = kill.communicate(timeout=KILL_ONE_TIMEOUT)
    except subprocess.TimeoutExpired:
        _stop_session(kill)
        raise RuntimeError("check failed: host_chaos_demo --kill-one "
                           "outlived its timeout")
    for line in stderr.splitlines()[-5:]:
        print(f"phase 12: --kill-one (stderr): {line}")
    check(kill.returncode == 0, f"--kill-one rc {kill.returncode}")
    kres = json.loads(stdout)
    check(all(kres["gates"].values()), f"--kill-one gates {kres['gates']}")
    runs["host_chaos_demo --kill-one"] = {
        "rc": kill.returncode, "seconds": time.perf_counter() - t_kill,
        "launched": kres["survivor"].get("launches", {}),
        "process": True}
    out["kill_one"] = {"gates": kres["gates"],
                       "victim_returncode": kres["victim_returncode"],
                       "detect": kres["survivor"]["detect"],
                       "topology": [kres["survivor"]["topology0"],
                                    kres["survivor"]["topology_end"]]}
    print(f"phase 12: --kill-one: {json.dumps(out['kill_one'])}, survivor "
          f"launched {runs['host_chaos_demo --kill-one']['launched']}")

    launched: dict = {}
    for row in runs.values():
        for k, v in row["launched"].items():
            launched[k] = launched.get(k, 0) + v
    unheld = sorted(set(launched) - set(held))
    check(not unheld, f"phase 12 launched kernels no earlier phase held "
                      f"against their plain versions: {unheld}")
    check(launched.get("apply_matrix_cuda", 0) >= 1,
          "phase 12 launched the dense GF(2^8) kernel (row 1)")
    out["launched"] = launched
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 12: {out['seconds']:.1f} s, launched {launched}")
    return out


# -- phase 13: plugin=cuda, the native bridge, and the lint tiers ------------

# the north star's flags (ceph_erasure_code_benchmark's own spelling)
NATIVE_NORTH_STAR = ["-P", "backend=jerasure", "-P", "technique=reed_sol_van",
                     "-P", "k=8", "-P", "m=3", "-s", str(1 << 20)]
# calls per benchmark run: 500 encodes, 200 decodes (a random -e 2
# pattern's first use sets up its decode matrix: 55 patterns; the fixed
# pattern, one)
NATIVE_ITERS = {"encode": 500, "decode": 200}
NATIVE_WORKLOADS = (["-w", "encode"], ["-w", "decode", "-e", "2"],
                    ["-w", "decode", "--erased", "0", "--erased", "9"])
BRIDGE_SEED = 17
# (corpus entry, chunk count, the bridge's profile)
BRIDGE_CORPUS = (
    ("jerasure__k=4__m=2__technique=reed_sol_van", 6,
     ["-P", "backend=jerasure", "-P", "technique=reed_sol_van",
      "-P", "k=4", "-P", "m=2"]),
    ("shec__c=2__k=6__m=3", 9,
     ["-P", "backend=shec", "-P", "k=6", "-P", "m=3", "-P", "c=2"]),
    ("jerasure__k=8__m=3__technique=reed_sol_van", 11,
     NATIVE_NORTH_STAR[:8]),
)
LINT_TIERS = ([], ["--conc"], ["--det"])


def bridge_phase(held: dict) -> dict:
    """Phase 13 (the module docstring): the port's native tree built
    from the checkout, an unmodified C++ consumer on ``plugin=cuda`` (the
    corpus, the north star's encode and decode beside ``-p rs``, three
    threads in ``bridge_mt`` with the port's counters read inside that
    process), the no-card arm, and the three lint tiers over the port.
    ``held``: the wrappers phases 2-4 held against their plain versions
    (every kernel the bridge launched must be among them)."""
    import shutil
    import tempfile
    from ceph_tpu_torch.native import build as native_build
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    built = native_build.build()
    build_s = time.perf_counter() - t0
    print(f"phase 13: native build {build_s:.2f} s: "
          + ", ".join(sorted(built)))
    work = tempfile.mkdtemp(prefix="chip_smoke_phase13_")
    procs: list = []
    try:
        out = _bridge_runs(held, built, root, work, procs)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(work, ignore_errors=True)
    out["build_s"] = build_s
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 13: {out['seconds']:.1f} s")
    return out


def _bridge_runs(held: dict, built: dict, root: str, work: str,
                 procs: list) -> dict:
    """Phase 13's runs (``bridge_phase``); every process started is
    added to ``procs``, which the caller stops."""
    out: dict = {}
    bdir = str(built["libec_cuda.so"].parent)
    tool = str(built["ceph_erasure_code"])

    def start(cmd, env=None):
        proc = subprocess.Popen([str(c) for c in cmd], cwd=root, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        procs.append(proc)
        return proc

    def finish(proc, what: str, timeout: float = 600):
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise RuntimeError(f"check failed: phase 13: {what} timed out")
        return proc.returncode, stdout, stderr

    # 13a: the corpus through plugin=cuda (its stripes run the host
    # rule), a seeded 1 MiB payload on the card and with device=cpu,
    # bridge_mt, the lint tiers and the no-card arm, side by side (the
    # lint is CPU work, the arm sees no device)
    import numpy as np
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops.regionops import matrix_encode
    t0 = time.perf_counter()
    payload = np.random.default_rng(BRIDGE_SEED).integers(
        0, 256, 1 << 20, dtype=np.uint8)
    payload_path = os.path.join(work, "payload")
    payload.tofile(payload_path)
    stripes = []
    for label, extra in (("cuda", []), ("cpu", ["-P", "device=cpu"])):
        d = os.path.join(work, f"stripe_{label}")
        os.makedirs(d)
        stats = os.path.join(work, f"stripe_{label}.jsonl")
        stripes.append((label, d, stats, start(
            [tool, "encode", "--plugin", "cuda", *NATIVE_NORTH_STAR[:8],
             *extra, "--input", payload_path, "--output-dir", d, "-d", bdir],
            env=dict(os.environ, CEPH_TPU_BRIDGE_STATS=stats))))
    encodes = []
    for cdir, n, params in BRIDGE_CORPUS:
        d = os.path.join(work, cdir)
        os.makedirs(d)
        src = os.path.join(root, "tests", "corpus", cdir)
        encodes.append((cdir, n, src, d, start(
            [tool, "encode", "--plugin", "cuda", *params, "--input",
             os.path.join(src, "content"), "--output-dir", d, "-d", bdir])))
    lints = [(tier, start([sys.executable, "-m", "ceph_tpu_torch.tools.lint",
                           *tier]))
             for tier in LINT_TIERS]
    # three threads on the card; the port's counters read inside the C++
    # process
    bridge_mt = start([built["bridge_mt"], bdir, "cuda"])
    no_card = start([tool, "encode", "--plugin", "cuda", *NATIVE_NORTH_STAR[:8],
                     "--input", os.path.join(root, "tests", "corpus",
                                             BRIDGE_CORPUS[0][0], "content"),
                     "--output-dir", work, "-d", bdir],
                    env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    corpus = {}
    for cdir, n, src, d, proc in encodes:
        rc, _, stderr = finish(proc, f"the {cdir} encode")
        check(rc == 0, f"phase 13: plugin=cuda encode of {cdir}: rc {rc}: "
                       f"{stderr[-2000:]}")
        for i in range(n):
            with open(os.path.join(d, f"chunk.{i}"), "rb") as f, \
                    open(os.path.join(src, str(i)), "rb") as g:
                check(f.read() == g.read(),
                      f"phase 13: {cdir} chunk {i} equals the corpus")
        corpus[cdir] = n
    out["corpus"] = corpus
    # the 1 MiB stripe: the card's chunks, the CPU's and numpy's agree
    rs83 = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"},
        device="cpu")
    data = payload.reshape(8, -1)
    want = list(data) + list(matrix_encode(data, np.asarray(rs83.matrix)))
    stripe = {}
    for label, d, stats, proc in stripes:
        rc, _, stderr = finish(proc, f"the 1 MiB {label} encode")
        check(rc == 0, f"phase 13: plugin=cuda 1 MiB encode ({label}): rc "
                       f"{rc}: {stderr[-2000:]}")
        for i, chunk in enumerate(want):
            with open(os.path.join(d, f"chunk.{i}"), "rb") as f:
                check(f.read() == chunk.tobytes(),
                      f"phase 13: the 1 MiB stripe's chunk {i} ({label}) "
                      f"equals regionops.matrix_encode's")
        with open(stats) as f:
            port = json.loads(f.read().splitlines()[-1])["port"]
        launched = {k: v for k, v in port["launches"].items() if v}
        stripe[label] = {"ec_device_calls": port["ec_device_calls"],
                         "ec_host_calls": port["ec_host_calls"],
                         "launched": launched}
        print(f"phase 13: ceph_erasure_code encode, 1 MiB RS k=8 m=3 "
              f"({label}): 11 chunks equal; ec_device_calls "
              f"{port['ec_device_calls']}, launched {launched}")
        check(port["ec_device_calls"] > 0 and port["ec_host_calls"] == 0,
              f"phase 13: the 1 MiB stripe ran on the device tier "
              f"({label})")
    check(stripe["cuda"]["launched"].get("apply_matrix_cuda", 0) > 0,
          "phase 13: the 1 MiB stripe's encode launched the dense GF(2^8) "
          "kernel (row 1) inside ceph_erasure_code")
    out["stripe_1mib"] = stripe
    out["lint"] = {}
    for tier, proc in lints:
        rc, stdout, stderr = finish(proc, f"lint {tier}")
        label = " ".join(["lint", *tier])
        tail = (stdout.strip().splitlines() or [stderr.strip()])[-1]
        print(f"phase 13: {label}: rc {rc}: {tail}")
        check(rc == 0, f"phase 13: {label} is clean: {stdout[-2000:]}"
                       f"{stderr[-2000:]}")
        out["lint"][label] = {"rc": rc, "summary": tail}
    rc, _, stderr = finish(no_card, "the no-card arm")
    line = (stderr.strip().splitlines() or [""])[-1]
    print(f"phase 13: no card (CUDA_VISIBLE_DEVICES=): rc {rc}: {line}")
    check(rc != 0 and "NoDeviceError" in stderr,
          "phase 13: without a card plugin=cuda fails with NoDeviceError")
    out["no_card"] = {"rc": rc, "stderr": line}
    rc, stdout, stderr = finish(bridge_mt, "bridge_mt")
    check(rc == 0, f"phase 13: bridge_mt on the card: rc {rc}: "
                   f"{stdout[-2000:]}{stderr[-2000:]}")
    counters = json.loads(stdout.strip().splitlines()[-1])
    launched = {k: v for k, v in counters["launches"].items() if v}
    print(f"phase 13: bridge_mt cuda: ec_device_calls "
          f"{counters['ec_device_calls']}, ec_host_calls "
          f"{counters['ec_host_calls']}, launched {launched}")
    check(counters["ec_device_calls"] > 0,
          "phase 13: the bridge's stripes ran on the device tier")
    check(launched.get("apply_matrix_cuda", 0) > 0,
          "phase 13: the dense GF(2^8) kernel (row 1) launched inside the "
          "C++ process")
    out["bridge_mt"] = {"ec_device_calls": counters["ec_device_calls"],
                        "ec_host_calls": counters["ec_host_calls"],
                        "launched": launched}
    launched = dict(launched)
    for label in stripe:
        for name, n in stripe[label]["launched"].items():
            launched[name] = launched.get(name, 0) + n
    out["side_by_side_s"] = time.perf_counter() - t0

    # 13b: the north star through ceph_erasure_code_benchmark, -p cuda
    # and -p rs on this host, one run at a time; decode -e 2 draws its
    # patterns at random (the reference's default), --erased fixes one;
    # -p cuda runs with the bridge's own timing on
    bench = str(built["ceph_erasure_code_benchmark"])
    rates = {}
    for plugin in ("cuda", "rs"):
        for workload in NATIVE_WORKLOADS:
            label = f"{plugin} {' '.join(workload[1:])}"
            iters = NATIVE_ITERS[workload[1]]
            stats = os.path.join(work, f"bench_{len(rates)}.jsonl")
            env = dict(os.environ, CEPH_TPU_BRIDGE_STATS=stats)
            rc, stdout, stderr = finish(start(
                [bench, "-p", plugin, *NATIVE_NORTH_STAR, *workload,
                 "-i", str(iters), "-d", bdir], env=env), label)
            check(rc == 0, f"phase 13: benchmark {label}: rc {rc}: "
                           f"{stderr[-2000:]}")
            elapsed, kib = stdout.split()
            row = {"seconds": float(elapsed), "kib": int(kib),
                   "gbps": int(kib) * 1024 / float(elapsed) / 1e9}
            print(f"phase 13: ceph_erasure_code_benchmark -p {plugin} "
                  f"{' '.join(workload)} -s 1048576 -i {iters}: "
                  f"{row['gbps']:.6f} GB/s ({elapsed} s, {kib} KiB)")
            if plugin == "cuda":
                with open(stats) as f:
                    line = json.loads(f.read().splitlines()[-1])
                row["bridge"] = bridge_time(line, workload[1], iters, row)
                for name, n in line["port"]["launches"].items():
                    if n:
                        launched[name] = launched.get(name, 0) + n
            rates[label] = row
    out["benchmark"] = rates
    # the bridge_mt, 1 MiB stripe and benchmark processes' launches
    out["launched"] = launched
    unheld = sorted(set(launched) - set(held))
    check(not unheld, f"phase 13 launched kernels no earlier phase held "
                      f"against their plain versions: {unheld}")
    out["anatomy"] = bridge_anatomy(rates["cuda encode"])
    return out


def bridge_time(line: dict, op: str, iters: int, row: dict) -> dict:
    """13c: a ``-p cuda`` benchmark run's time per call as the bridge
    timed it inside the tool (``CEPH_TPU_BRIDGE_STATS``'s line), in ms:
    taking the GIL, the copies into python objects, the port's call, the
    copies out, their sum (the entry), and the tool's own per-call time
    around it (its chunk split, its maps and compares).  Decodes split
    the entry by first use of a pattern (its decode matrix set up) and
    repeats; the steady-state GB/s takes the first uses' setup out."""
    b = line["bridge"][op]
    check(b["calls"] == iters, f"phase 13: the bridge timed {b['calls']} "
                               f"{op} calls of {iters}")
    ms = {seg: b[f"{seg}_ns"] / iters / 1e6
          for seg in ("gil", "in", "call", "out")}
    ms["entry"] = sum(ms.values())
    ms["tool"] = row["seconds"] * 1e3 / iters
    ms["consumer"] = ms["tool"] - ms["entry"]
    out = {"ms": ms, "first": b["first"],
           "kernel_setups": line["port"]["kernel_setups"],
           "ec_device_calls": line["port"]["ec_device_calls"]}
    check(line["port"]["ec_device_calls"] >= iters,
          f"phase 13: the benchmark's {op} calls ran on the device tier")
    repeats = iters - b["first"]
    if op == "decode" and repeats:
        first_ms = b["first_ns"] / b["first"] / 1e6
        repeat_ms = (ms["entry"] * iters - b["first_ns"] / 1e6) / repeats
        setup_s = b["first"] * max(first_ms - repeat_ms, 0.0) / 1e3
        out.update(first_ms=first_ms, repeat_ms=repeat_ms, setup_s=setup_s,
                   steady_gbps=row["kib"] * 1024
                   / (row["seconds"] - setup_s) / 1e9)
    print(f"phase 13: the bridge's ms per {op} call inside the tool: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
          + f"; first uses {b['first']}"
          + (f" at {out['first_ms']:.4f} ms, repeats {out['repeat_ms']:.4f}"
             f" ms, setup {out['setup_s']:.4f} s, steady state "
             f"{out['steady_gbps']:.6f} GB/s" if "first_ms" in out else "")
          + f"; kernel setups {out['kernel_setups']}")
    return out


ANATOMY_CALLS = 200


def bridge_anatomy(tool_rate: dict) -> dict:
    """13d: where a bridge encode's time goes, layer by layer, in this
    process on the card (host clock, ms per 1 MiB RS k=8 m=3 stripe):
    the C++ tool's call (from 13b's rate), the dict API the plugin calls
    (``encode_chunks``: bytes in, bytes out), the batch entry on a host
    array (``encode_chunks_batch``), and the matrix apply on a card
    tensor, synchronized (``apply_matrix_best``)."""
    import numpy as np
    import torch
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops.gf_kernels import apply_matrix_best
    ec = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"})
    data = np.random.default_rng(13).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    chunks = ec.encode_prepare(data)
    want = set(range(ec.get_chunk_count()))
    host = np.stack([np.frombuffer(chunks[i], dtype=np.uint8)
                     for i in range(ec.get_data_chunk_count())])[None]
    card = torch.from_numpy(host).to("cuda")

    def apply():
        apply_matrix_best(card, ec._matrix_static, 8)
        torch.cuda.synchronize()

    out = {"tool": (1 << 20) / (tool_rate["gbps"] * 1e6)}
    for name, fn in (("encode_chunks", lambda: ec.encode_chunks(want,
                                                                 chunks)),
                     ("encode_chunks_batch",
                      lambda: ec.encode_chunks_batch(host)),
                     ("apply_matrix_best", apply)):
        fn()
        t0 = time.perf_counter()
        for _ in range(ANATOMY_CALLS):
            fn()
        out[name] = (time.perf_counter() - t0) * 1e3 / ANATOMY_CALLS
    print("phase 13: a bridge encode's host ms per 1 MiB stripe: "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


def tune_table_child() -> dict:
    """10d's child: the CLI's r6 encode row under ``--tune-table``, the
    routed kernel and its device time, the bytes against the default
    regime, then the same table with another card's name."""
    import numpy as np
    import torch
    from ceph_tpu_torch.bench.erasure_code_benchmark import ErasureCodeBench
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops.gf_kernels import select_matrix_engine
    from ceph_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from ceph_tpu_torch.ops.torch_ops import matrix_to_static
    from ceph_tpu_torch.telemetry import metrics as tel
    from ceph_tpu_torch.tools.dense_times import kernel_ms
    from ceph_tpu_torch.tune.table import (BestConfigTable, consult,
                                           install_table, matrix_digest,
                                           scoped_table)
    path = os.environ["CEPH_TPU_SMOKE_TABLE"]
    reset_launch_counts()
    bench = ErasureCodeBench()
    bench.setup(R6_ARGV + ["--tune-table", path])
    res = bench.run()
    launches = {k: v for k, v in launch_counts().items() if v}
    dev = torch.device("cuda", 0)
    ec = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_r6_op", "k": "8", "m": "2"},
        device=dev)
    ms = matrix_to_static(ec.matrix)
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (BATCH, 8, CHUNK), dtype=np.uint8)).to(dev)

    def engine():
        return select_matrix_engine(8, dev, shape=tuple(x.shape),
                                    matrix_t=ms)
    pinned = consult("matrix-engine", profile="m:" + matrix_digest(ms),
                     layout="bytes", device_count=1) is not None
    eng, tuned_out = engine(), ec.encode_chunks_torch(x)
    k = kernel_ms(lambda: ec.encode_chunks_torch(x), "", iters=20)
    with scoped_table(None):
        default_engine, default_out = engine(), ec.encode_chunks_torch(x)
    check(torch.equal(tuned_out, default_out), "10d: tuned bytes")
    install_table(BestConfigTable.load(os.environ["CEPH_TPU_SMOKE_STALE"]))
    before = tel.global_metrics().counter_value("tune_config_stale")
    stale_engine, stale_out = engine(), ec.encode_chunks_torch(x)
    stale = tel.global_metrics().counter_value("tune_config_stale") - before
    check(torch.equal(stale_out, default_out), "10d: stale-table bytes")
    check(stale_engine == default_engine, "10d: a stale pin routes nothing")
    return {"config_source": res["config_source"],
            "tune_key_hash": res["tune_key_hash"], "gbps": res["gbps"],
            "launches": launches, "pinned": pinned, "engine": eng,
            "kernel_ms": k, "default_engine": default_engine,
            "stale": stale, "stale_engine": stale_engine}


def build_cache_child() -> dict:
    """10e's child: build and load every kernel library under
    ``CEPH_TPU_COMPILE_CACHE``; the cache's hits and misses and the nvcc
    runs it took."""
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.telemetry import metrics as tel
    from ceph_tpu_torch.utils.compile_cache import (HITS, MISSES,
                                                    cache_entries)
    t0 = time.perf_counter()
    built = _build.build()
    for name in built:
        _build.load(name)
    reg = tel.global_metrics()
    return {"hits": reg.counter_value(HITS),
            "misses": reg.counter_value(MISSES),
            "nvcc_runs": len(_build.build_log),
            "libraries": len(built), "entries": cache_entries(),
            "seconds": time.perf_counter() - t0}


def child_main(kind: str) -> int:
    """The child processes of phases 8-11: ``oom`` (8c), ``lockcheck``
    (8f), ``plane-lockcheck`` (9g), ``tune-table`` (10d), ``build-cache``
    (10e) and ``cluster-host`` (11b); each prints one JSON line."""
    import gc
    import torch
    if kind == "build-cache":
        print(json.dumps(build_cache_child()))
        return 0
    if kind == "tune-table":
        print(json.dumps(tune_table_child()))
        return 0
    if kind == "cluster-host":
        print(json.dumps(cluster_host_child()))
        return 0
    from ceph_tpu_torch.codes.engine import fused_repair_call
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops import supervisor
    from ceph_tpu_torch.ops.supervisor import _inside_seam
    torch.zeros(1, device="cuda")           # the context, outside any lock
    ec = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"},
        device="cuda")
    if kind in ("lockcheck", "plane-lockcheck"):
        from ceph_tpu_torch.bench.erasure_code_benchmark import \
            ErasureCodeBench
        from ceph_tpu_torch.utils import locks
        check(locks.lockcheck_enabled(), f"{kind}: CEPH_TPU_LOCKCHECK=1")
        bench = ErasureCodeBench()
        bench.setup(list(CHAOS_ARGV if kind == "lockcheck"
                         else HOST_CHAOS_ARGV) + ["--json"])
        res = bench.run()
        check(healed_stores(bench.last_run), f"{kind}: healed")
        print(json.dumps({"lockcheck": locks.lockcheck_report(),
                          "result": {k: res[k] for k in (
                              "supervisor", "faults_fired",
                              "demoted_at_end", "gbps")}}))
        return 0
    # oom: one fused repair of OOM_OBJECTS 4 MiB objects (one shard
    # erased: the call's temporaries, not its outputs, set its peak)
    # under a memory fraction the unsplit call cannot fit in and its
    # halves can
    n = ec.get_chunk_count()
    chunk = ec.get_chunk_size(4 << 20)
    erased = (1,)
    avail = tuple(s for s in range(n) if s not in erased)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, (OOM_OBJECTS, len(avail), chunk),
                      dtype=torch.uint8, device="cuda", generator=gen)
    call = fused_repair_call(ec, avail, erased)
    torch.cuda.synchronize()

    def peak(fn) -> int:
        """Bytes ``fn`` allocates above what is live when it starts, at
        its peak; its result is freed before returning."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        torch.cuda.synchronize()
        top = torch.cuda.max_memory_allocated() - base
        return top, tuple(t.cpu() for t in res)

    def split():
        h = OOM_OBJECTS // 2
        lo, hi = call(x[:h]), call(x[h:])
        return tuple(torch.cat([a, b]) for a, b in zip(lo, hi))

    with _inside_seam():
        p_full, want = peak(lambda: call(x))
        p_split, _ = peak(split)
    check(p_split < 0.85 * p_full, f"8c: halves need less ({p_split} "
          f"against {p_full} bytes)")
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    base = torch.cuda.memory_reserved()
    limit = base + (p_full + p_split) // 2
    torch.cuda.set_per_process_memory_fraction(limit / total)
    # the limit holds: one allocation past it raises
    try:
        torch.empty(limit - base + (64 << 20), dtype=torch.uint8,
                    device="cuda")
        probe_raised = False
    except torch.cuda.OutOfMemoryError:
        probe_raised = True
    torch.cuda.empty_cache()
    raised = False
    try:
        with _inside_seam():
            call(x)
    except torch.cuda.OutOfMemoryError as e:
        raised = True
        e.__traceback__ = None      # its frames hold the failed call's
    gc.collect()
    torch.cuda.empty_cache()
    sup = supervisor.DispatchSupervisor()
    supervisor.set_global_supervisor(sup)
    got = call(x)
    equal = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    st = sup.stats()
    print(json.dumps({"oom_raised": raised, "equal": equal,
                      "limit_probe_raised": probe_raised,
                      "alloc_conf": os.environ.get(
                          "PYTORCH_CUDA_ALLOC_CONF"),
                      "allocator": torch.cuda.get_allocator_backend(),
                      "reserved_after": torch.cuda.memory_reserved(),
                      "rung_downshifts": st["rung_downshifts"],
                      "demotions": st["demotions"],
                      "card_failures": st["card_failures"],
                      "retries": st["retries"],
                      "stack": list(x.shape), "peak_full": p_full,
                      "peak_split": p_split, "limit": limit,
                      "reserved_base": base}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random data (default 0)")
    ap.add_argument("--child", choices=("oom", "lockcheck",
                                        "plane-lockcheck", "tune-table",
                                        "build-cache", "cluster-host"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    seed = args.seed

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA device", file=sys.stderr)
        return 2
    if args.child:
        return child_main(args.child)
    # the port lives beside this script; a bare copy fails here
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops import _build, gf_kernels, regionops
    from ceph_tpu_torch.ops.launches import (
        device_and_stream, launch_counts, reset_launch_counts)
    from ceph_tpu_torch.ops.gf_kernels import (
        MXU_MATRIX_MIN, apply_bitmatrix_cuda, apply_bitmatrix_xor_cuda,
        apply_matrix_cuda, apply_matrix_cuda_packed,
        apply_matrix_cuda_packed_ragged, apply_matrix_cuda_ragged,
        apply_matrix_cuda_words, apply_matrix_mxu_cuda,
        apply_matrix_mxu_cuda_packed, apply_matrix_packed_best_ragged,
        apply_matrix_xor_cuda, apply_matrix_xor_cuda_packed,
        bitmatrix_op_count, dense_op_count, pack_chunks, schedule_op_count,
        dense_plan, dense_program, program_op_count, select_matrix_engine,
        sm90_op_count, sm90_op_floor, sm90_row_op_count, unpack_chunks,
        walk_data,
        walk_splits, xor_schedule_op_count)
    from ceph_tpu_torch.ops.probe_kernels import (
        copy_slab_cuda, copy_slab_torch, fold_slab_cuda, fold_slab_torch)
    from ceph_tpu_torch.ops.torch_ops import (
        WORD_DTYPE, apply_bitmatrix_torch, apply_bitmatrix_xor_torch,
        apply_matrix_mxu_torch, apply_matrix_packed_ragged_torch,
        apply_matrix_ragged_torch, apply_matrix_torch,
        apply_matrix_walk_torch, apply_matrix_xor_torch,
        bitmatrix_to_static, mask_pages, matrix_to_static, mxu_bitmatrix)
    from ceph_tpu_torch.telemetry import metrics as tel
    from ceph_tpu_torch.telemetry.profiler import (
        analytic_bitmatrix_cost, analytic_kernel_cost, analytic_walk_cost)
    from ceph_tpu_torch.tools import dense_times, packet_times, roofline
    from ceph_tpu_torch.tools.dense_times import kernel_ms
    from ceph_tpu_torch.codes.engine import (serve_dispatch_call,
                                             serve_dispatch_ragged)
    from ceph_tpu_torch.serve import (EcRequest, run_serving_scenario,
                                      verify_results)
    from ceph_tpu_torch.ops.xor_schedule import (
        build_schedule, preferred_schedule, probe_bitmatrix_schedule,
        word_program)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    err = Errors()
    phase_s: dict = {}
    t_mark = [time.perf_counter()]

    def phase_done(n: int) -> None:
        """Each phase's seconds: phases 1-4 print a line of their own,
        5-13 carry ``seconds`` in their JSON line."""
        now = time.perf_counter()
        phase_s[n] = now - t_mark[0]
        t_mark[0] = now
        if n <= 4:
            print(json.dumps({"phase": n, "seconds": phase_s[n]}))

    # -- phase 1: the card and the build ---------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    props = torch.cuda.get_device_properties(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"sms {props.multi_processor_count}")
    t0 = time.perf_counter()
    # the native tree (phase 13's) compiles with c++ beside the nvcc runs,
    # before anything is timed
    from concurrent.futures import ThreadPoolExecutor
    from ceph_tpu_torch.native import build as native_build
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(native_build.build)
        built = _build.build()
        native.result()
    print(f"kernel build {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{n} -> {p.name}" for n, p in sorted(built.items()))
          + ", and the native tree")
    for name, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    phase_done(1)

    # -- phase 2: each kernel against its plain version, on the card --------
    reg = ErasureCodePluginRegistry.instance()
    ec = reg.factory("jerasure", {"technique": "reed_sol_van",
                                  "k": str(K), "m": str(M)})
    check(ec.device.type == "cuda", f"code runs on {ec.device}")
    mat = ec.matrix
    ms = matrix_to_static(mat)
    host = rng.integers(0, 256, (BATCH, K, CHUNK), dtype=np.uint8)
    data = torch.from_numpy(host).to(dev)

    got = apply_matrix_cuda(data, ms)
    plain = apply_matrix_torch(data, ms, 8)
    err.hold("apply_matrix_cuda", got, plain, "bytes kernel, main shape")
    gotp = unpack_chunks(apply_matrix_cuda_packed(pack_chunks(data), ms))
    err.hold("apply_matrix_cuda_packed", gotp, plain,
             "packed kernel, main shape")
    ref2 = regionops.matrix_encode(host[:2], mat, 8)
    check(np.array_equal(got[:2].cpu().numpy(), ref2),
          "bytes kernel == numpy ground truth, 2 stripes")
    print(f"phase 2: main shape {tuple(data.shape)} equal in both layouts "
          f"and to the host ground truth")

    cases = []
    for r in (1, 3, 8, 11):
        for s, c, lead in ((8, 65536, (4,)), (5, 4096 + 4, (3,)),
                           (6, 8192, ())):
            cases.append((r, s, c, lead))
    for r, s, c, lead in cases:
        m_r = rng.integers(0, 256, (r, s))
        m_r[rng.random((r, s)) < 0.25] = 0
        m_r[0, 0] = 0
        x = torch.from_numpy(rng.integers(0, 256, lead + (s, c),
                                          dtype=np.uint8)).to(dev)
        mr = matrix_to_static(m_r)
        want = apply_matrix_torch(x, mr, 8)
        err.hold("apply_matrix_cuda", apply_matrix_cuda(x, mr), want,
                 f"bytes kernel r={r} s={s} C={c}")
        if c % 512 == 0:
            gotp = unpack_chunks(apply_matrix_cuda_packed(pack_chunks(x),
                                                          mr))
            err.hold("apply_matrix_cuda_packed", gotp, want,
                     f"packed kernel r={r} s={s}")
        if lead:
            # a survivor slice: strided chunk axis, no copy
            wide = torch.cat([x, x[..., :1, :]], dim=-2)
            err.hold("apply_matrix_cuda", apply_matrix_cuda(
                wide[..., :s, :], mr), want, f"strided slice r={r} s={s}")
    print(f"phase 2: {len(cases)} random GF(2^8) cases equal (r in 1,3,8,"
          f"11; tail C=4100; no batch dim; strided slices)")

    # the dense kernel on either side of its one-wave rule: the RS decode
    # e=2 (3, 9) matrix at 1, 4 and 64 stripes (below a wave of the card
    # each block takes one stripe; above, a block walks several), both
    # layouts
    e2_avail = [i for i in range(K + M) if i not in (3, 9)]
    dm_e2 = matrix_to_static(regionops.matrix_decode_matrix(
        mat, K, e2_avail[:K], [3, 9]))
    plans = {}
    for nb_ in (1, DECODE_BATCH, BATCH):
        x = data[:nb_]
        plans[nb_] = dense_plan(nb_, CHUNK, dm_e2, dev)
        want = apply_matrix_torch(x, dm_e2, 8)
        err.hold("apply_matrix_cuda", apply_matrix_cuda(x, dm_e2), want,
                 f"decode e=2 at {nb_} stripes")
        err.hold("apply_matrix_cuda_packed", unpack_chunks(
            apply_matrix_cuda_packed(pack_chunks(x), dm_e2)), want,
            f"packed decode e=2 at {nb_} stripes")
    check(plans[1][1] == 1 and plans[DECODE_BATCH][1] == DECODE_BATCH
          and plans[BATCH][1] < BATCH,
          f"grids on both sides of the one-wave rule: {plans}")
    print(f"phase 2: dense kernel equal on the decode e=2 matrix at 1, "
          f"{DECODE_BATCH} and {BATCH} stripes in both layouts; grids "
          f"(unit tiles, stripe blocks, row blocks) {plans}")

    # the w=16/32 word kernel: the reed_sol_van matrices at the main shape
    wide_codes = {w: reg.factory("jerasure", {
        "technique": "reed_sol_van", "k": str(K), "m": str(M),
        "w": str(w)}) for w in (16, 32)}
    word_data = {}
    for w, wc in wide_codes.items():
        nbytes = WORDS * w // 8
        wh = rng.integers(0, 256, (BATCH, K, nbytes), dtype=np.uint8)
        x = torch.from_numpy(wh).to(dev).view(WORD_DTYPE[w])
        word_data[w] = (wh, x)
        wms = matrix_to_static(wc.matrix)
        got = apply_matrix_cuda_words(x, wms, w)
        err.hold("apply_matrix_cuda_words", got,
                 apply_matrix_torch(x, wms, w), f"w={w} main shape")
        check(np.array_equal(
            got[:2].cpu().numpy(),
            regionops.matrix_encode(regionops.words_view(wh[:2], w),
                                    wc.matrix, w)),
            f"word kernel w={w} == numpy ground truth, 2 stripes")
        for r, s, nb, lead in ((1, 3, 4096 + 4, (2,)), (9, 5, 1028, ()),
                               (3, 8, 8192, (3,))):
            m_r = rng.integers(0, 1 << w, (r, s), dtype=np.uint64)
            m_r[0, 0] = 0
            mr = matrix_to_static(m_r)
            xs = torch.from_numpy(rng.integers(
                0, 256, lead + (s + 1, nb), dtype=np.uint8)).to(dev).view(
                    WORD_DTYPE[w])[..., :s, :]
            err.hold("apply_matrix_cuda_words",
                     apply_matrix_cuda_words(xs, mr, w),
                     apply_matrix_torch(xs.contiguous(), mr, w),
                     f"word kernel w={w} r={r} s={s} bytes={nb}")
    print(f"phase 2: word kernel equal for w=16/32 at (64, 8, {WORDS}) "
          f"words, 3 random cases each (tail, no batch dim, strided "
          f"slices), and to the host ground truth")

    # the bitmatrix kernels: cauchy_good k=8 m=3 at the main shape
    cg = reg.factory("jerasure", {"technique": "cauchy_good", "k": str(K),
                                  "m": str(M)})
    check(cg.packetsize == PACKETSIZE and cg.w == 8, "cauchy_good default")
    rows = cg._bitmatrix_static
    enc_sched = cg._encode_sched
    check(enc_sched is not None, "cauchy_good encode has a schedule")
    got = apply_bitmatrix_cuda(data, rows, 8, PACKETSIZE)
    plain_bm = apply_bitmatrix_torch(data, rows, 8, PACKETSIZE)
    err.hold("apply_bitmatrix_cuda", got, plain_bm,
             "plain packet kernel, cauchy_good encode, main shape")
    gots = apply_bitmatrix_xor_cuda(data, enc_sched.static, 8, PACKETSIZE)
    err.hold("apply_bitmatrix_xor_cuda", gots,
             apply_bitmatrix_xor_torch(data, enc_sched.static, 8,
                                       PACKETSIZE),
             "schedule kernel, cauchy_good encode, main shape")
    check(torch.equal(gots, got), "schedule == plain product")
    check(np.array_equal(got[:2].cpu().numpy(), regionops.bitmatrix_encode(
        host[:2], cg.bitmatrix, 8, PACKETSIZE)),
        "bitmatrix kernel == numpy ground truth, 2 stripes")
    cg_full = torch.cat([data, gots], dim=1)
    e2 = (3, 9)
    e2_avail = tuple(i for i in range(K + M) if i not in e2)
    e2_surv = cg_full.index_select(1, torch.tensor(e2_avail, device=dev))
    e2_dm, e2_rows, _, e2_sched = cg._decode_bitmatrix(e2_avail, e2)
    check(e2_sched is not None, "cauchy_good decode e=2 has a schedule")
    got = apply_bitmatrix_xor_cuda(e2_surv[:, :K], e2_sched.static, 8,
                                   PACKETSIZE)
    err.hold("apply_bitmatrix_xor_cuda", got, apply_bitmatrix_xor_torch(
        e2_surv[:, :K], e2_sched.static, 8, PACKETSIZE),
        "schedule kernel, decode e=2, main shape")
    check(torch.equal(got, cg_full[:, list(e2)]), "decode e=2 recovers")

    n_bm = 0
    for w in (6, 7, 8):
        for ps in (8, 32, PACKETSIZE):
            for lead in ((3,), ()):
                s, r = 5, 2
                bm = (rng.random((r * w, s * w)) < 0.4).astype(np.uint8)
                bm[0] = 0
                brows = bitmatrix_to_static(bm)
                xh = rng.integers(0, 256, lead + (s + 2, 2 * w * ps),
                                  dtype=np.uint8)
                xs = torch.from_numpy(xh).to(dev)[..., :s, :]
                want = apply_bitmatrix_torch(xs, brows, w, ps)
                err.hold("apply_bitmatrix_cuda",
                         apply_bitmatrix_cuda(xs, brows, w, ps), want,
                         f"plain packet kernel w={w} ps={ps} lead={lead}")
                sched = probe_bitmatrix_schedule(brows, w)
                check(sched is not None, f"random w={w} has a schedule")
                err.hold("apply_bitmatrix_xor_cuda",
                         apply_bitmatrix_xor_cuda(xs, sched.static, w, ps),
                         apply_bitmatrix_xor_torch(xs, sched.static, w, ps),
                         f"schedule kernel w={w} ps={ps} lead={lead}")
                check(np.array_equal(want.cpu().numpy(),
                                     regionops.bitmatrix_encode(
                                         xh[..., :s, :], bm, w, ps)),
                      f"plain w={w} ps={ps} == numpy ground truth")
                n_bm += 1
    print(f"phase 2: both bitmatrix kernels equal at the cauchy_good "
          f"main shape (encode, decode e=2) and on {n_bm} random cases "
          f"(w in 6,7,8; packetsize 8, 32, 2048; with and without a batch "
          f"dim; strided slices)")

    # the packet kernel's launches (gf_kernels.packet_launch_plan), all
    # through the wrappers, each against the plain version: the decodes at
    # 4 stripes (row groups on grid y) and 64 (one group), 8-byte units;
    # every other unit width at the packet size that selects it
    packet_seen = {"unit": set(), "groups": set()}

    def hold_packet(x, r, kind, key, what, w=8, ps=PACKETSIZE):
        wrapper, plain_fn = (
            (apply_bitmatrix_cuda, apply_bitmatrix_torch) if kind == "plain"
            else (apply_bitmatrix_xor_cuda, apply_bitmatrix_xor_torch))
        got = wrapper(x, key, w, ps)
        plan = gf_kernels.packet_launch_plan(x, r, w, ps, kind, key,
                                             x.shape[-2] * w)
        err.hold(wrapper.__name__, got, plain_fn(x, key, w, ps),
                 f"packet kernel, {what}, {plan}")
        packet_seen["unit"].add(plan.unit)
        packet_seen["groups"].add(plan.groups)
        return plan

    def cauchy_decode(erased):
        avail = tuple(i for i in range(K + M) if i not in erased)
        _, drows, _, dsched = cg._decode_bitmatrix(avail, erased)
        surv = cg_full.index_select(1, torch.tensor(avail, device=dev))
        if dsched is None:
            return surv[:, :K], "plain", tuple(drows)
        return surv[:, :K], "schedule", dsched.static

    packet_lines = []
    for erased in ((3,), (3, 9), (5, 6, 7)):
        x, kind, key = cauchy_decode(erased)
        for batch in (DECODE_BATCH, BATCH):
            plan = hold_packet(x[:batch], len(erased), kind, key,
                               f"decode {erased} at {batch} stripes")
            check((plan.groups == 1) == (batch == BATCH),
                  f"decode {erased} at {batch} stripes: {plan}")
            packet_lines.append(f"decode {erased} at {batch}: {plan}")
    # (w, packetsize, the unit the plan must take): 16 bytes at packets of
    # 32 (the minimal-density codes' size), 4 at 12, single bytes at 3
    for w, ps, unit in ((7, 32, 16), (8, 12, 4), (5, 3, 1)):
        s, r = 7, 2
        bm = (rng.random((r * w, s * w)) < 0.4).astype(np.uint8)
        brows = bitmatrix_to_static(bm)
        x = torch.from_numpy(rng.integers(0, 256, (BATCH, s, 512 * w * ps),
                                          dtype=np.uint8)).to(dev)
        plan = hold_packet(x, r, "plain", brows,
                           f"random w={w} packetsize {ps}", w, ps)
        check(plan.unit == unit, f"w={w} packetsize {ps}: {plan}")
        packet_lines.append(f"w={w} packetsize {ps}: {plan}")
        sched = probe_bitmatrix_schedule(brows, w)
        if sched is not None:
            hold_packet(x, r, "schedule", sched.static,
                        f"random w={w} packetsize {ps}, scheduled", w, ps)
    check(packet_seen["unit"] >= {16, 8, 4, 1}
          and max(packet_seen["groups"]) > 1,
          f"the packet kernel's launches cover {packet_seen}")
    print(f"phase 2: the packet kernel equal to the plain versions through "
          f"its wrappers (" + "; ".join(packet_lines) + f"): unit widths "
          f"{sorted(packet_seen['unit'])}, row groups "
          f"{sorted(packet_seen['groups'])}")

    # the XOR-schedule kernel: the r6 encode (ring schedule) at the main
    # shape, an lrc local repair at 64 x 1 MiB stripes, the shec plans
    def xor_static(ms):
        sched = preferred_schedule(ms, 8, mxu_min=MXU_MATRIX_MIN)
        check(sched is not None, f"{ms} has a preferred schedule")
        return sched.static

    def hold_xor(x, st, what, ground=None):
        """Both XOR wrappers against the plain schedule on x; when
        ``ground`` (the matrix) is given, two stripes against the numpy
        ground truth."""
        want = apply_matrix_xor_torch(x, st)
        got = apply_matrix_xor_cuda(x, st)
        err.hold("apply_matrix_xor_cuda", got, want, what)
        if x.shape[-1] % 512 == 0:
            xw = pack_chunks(x)
            err.hold("apply_matrix_xor_cuda_packed", unpack_chunks(
                apply_matrix_xor_cuda_packed(xw, st)), want, what)
        if ground is not None:
            def two(t):
                return t.reshape((-1,) + tuple(t.shape[-2:]))[:2].cpu().numpy()
            check(np.array_equal(two(got), regionops.matrix_encode(
                two(x), np.asarray(ground), 8)),
                f"{what}: XOR kernel == numpy ground truth, 2 stripes")
        return got

    r6 = reg.factory("jerasure", {"technique": "reed_sol_r6_op",
                                  "k": str(K)})
    r6_ms = matrix_to_static(r6.matrix)
    r6_st = xor_static(r6_ms)
    check(preferred_schedule(r6_ms, 8).transform == "ring",
          "the r6 encode takes the ring schedule")
    r6_parity = hold_xor(data, r6_st, "r6 encode, main shape", r6.matrix)
    lrc = reg.factory("lrc", {"k": "4", "m": "2", "l": "3"})
    lrc_avail = tuple(range(1, 8))
    lrc_dm, lrc_ms = lrc._decode_composite(lrc_avail, (0,))
    lrc_st = xor_static(lrc_ms)
    lrc_surv = torch.from_numpy(rng.integers(
        0, 256, (BATCH, 7, LRC_CHUNK), dtype=np.uint8)).to(dev)
    hold_xor(lrc_surv, lrc_st, "lrc local repair (0,), 64 x 1 MiB", lrc_dm)
    shec = reg.factory("shec", {"k": "4", "m": "3", "c": "2"})
    n_shec = shec.k + shec.m
    shec_xor = []
    for e in range(n_shec):
        avail = tuple(i for i in range(n_shec) if i != e)
        plan = shec._plan(avail, (e,))
        dm, dm_static = shec._plan_static(plan)
        sched = preferred_schedule(dm_static, 8, mxu_min=MXU_MATRIX_MIN)
        if sched is None:
            continue
        shec_xor.append(e)
        x = torch.from_numpy(rng.integers(0, 256, (8, len(plan.reads),
                                                   8192), dtype=np.uint8)
                             ).to(dev)
        hold_xor(x, sched.static, f"shec plan for erasure {e}", dm)
    check(shec_xor == [0, 1, 2, 4], f"shec XOR plans {shec_xor}")
    n_rand = 0
    for i, (lead, c) in enumerate(itertools.product(((3,), ()),
                                                    (4096 + 4, 8192))):
        for kind in ("sparse", "monomial"):
            r, s = 3, 6
            if kind == "sparse":
                m_r = rng.integers(0, 256, (r, s)) * (rng.random((r, s)) < 0.4)
            else:
                m_r = (1 << rng.integers(0, 8, (r, s))) \
                    * (rng.random((r, s)) < 0.7)
            m_r[0, 0] = 1
            st = build_schedule(matrix_to_static(m_r)).static
            xh = rng.integers(0, 256, lead + (s + 1, c), dtype=np.uint8)
            x = torch.from_numpy(xh).to(dev)[..., :s, :]   # strided slice
            hold_xor(x, st, f"random {kind} lead={lead} C={c}", m_r)
            n_rand += 1
    print(f"phase 2: XOR-schedule kernel equal in both layouts on the r6 "
          f"encode (64, 8, {CHUNK}), an lrc repair (64, 7, {LRC_CHUNK}), "
          f"the shec plans of erasures {shec_xor} and {n_rand} random "
          f"sparse/monomial schedules (strided slices, C=4100, no batch "
          f"dim), and to the host ground truth")

    # the ragged kernel (bytes and packed wrappers): the serving pool
    # shape, (512 pages, 8 rows, 4096 bytes), under a scattered half-live
    # mask, all-dead and all-live, for the RS encode matrix and random
    # r in {1, 3, 11}; against the plain version and against the dense
    # kernel on mask_pages(pool); dead pages zero
    rag_host = rng.integers(0, 256, (RAG_PAGES, K, PAGE), dtype=np.uint8)
    rag_pool = torch.from_numpy(rag_host).to(dev)
    rag_words = pack_chunks(rag_pool)
    rag_masks = {
        "half-live": torch.from_numpy(
            (rng.random(RAG_PAGES) < 0.5).astype(np.uint8)).to(dev),
        "all-dead": torch.zeros(RAG_PAGES, dtype=torch.uint8, device=dev),
        "all-live": torch.ones(RAG_PAGES, dtype=torch.uint8, device=dev)}
    rag_mats = {"rs encode": ms}
    for r in (1, 3, 11):
        m_r = rng.integers(0, 256, (r, K))
        m_r[rng.random((r, K)) < 0.25] = 0
        rag_mats[f"random r={r}"] = matrix_to_static(m_r)
    for (mname, m_s), (kind, mk) in itertools.product(rag_mats.items(),
                                                      rag_masks.items()):
        what = f"{mname}, {kind} mask, {tuple(rag_pool.shape)}"
        got = apply_matrix_cuda_ragged(rag_pool, m_s, mk)
        err.hold("apply_matrix_cuda_ragged", got,
                 apply_matrix_ragged_torch(rag_pool, m_s, mk), what)
        err.hold("apply_matrix_cuda_ragged", got,
                 apply_matrix_cuda(mask_pages(rag_pool, mk), m_s),
                 f"{what} vs the dense kernel on the masked pool")
        check(not got[mk == 0].any(), f"{what}: dead pages are zero")
        gotp = apply_matrix_cuda_packed_ragged(rag_words, m_s, mk)
        err.hold("apply_matrix_cuda_packed_ragged", gotp,
                 apply_matrix_packed_ragged_torch(rag_words, m_s, mk), what)
        err.hold("apply_matrix_cuda_packed_ragged", unpack_chunks(gotp), got,
                 f"{what}, packed == bytes")
    print(f"phase 2: both ragged wrappers equal their plain versions and "
          f"the dense kernel on the masked pool at ({RAG_PAGES}, {K}, "
          f"{PAGE}), {len(rag_mats)} matrices x {len(rag_masks)} masks; "
          f"dead pages zero")

    # the "mxu" row's column-walk kernel (bytes and packed wrappers),
    # held to its plain version over the same kernel data
    # (apply_matrix_walk_torch) and to the reference's MXU twin
    # (apply_matrix_mxu_torch): the clay k=8 m=4 d=11 encode composite at
    # its main shape, a (64, 704) decode composite at 4 stripes, with and
    # without the column split, random matrices with zeros, r over one row
    # tile, C off the word and the tile, no batch dim, strided slices
    clay = reg.factory("clay", dict(CLAY))
    check(clay.device.type == "cuda", f"clay runs on {clay.device}")
    sub = clay.get_sub_chunk_count()
    clay_chunk = clay.get_chunk_size(1 << 20)
    check((sub, clay_chunk) == (64, CHUNK), f"clay geometry {sub} "
          f"sub-chunks of a {clay_chunk} byte chunk")
    sc = clay_chunk // sub
    n_clay = clay.k + clay.m
    t0 = time.perf_counter()
    clay_enc, clay_enc_ms = clay._encode_composite()
    clay_probe_s = {"encode": time.perf_counter() - t0}
    e1_clay = (0,)
    a1_clay = tuple(i for i in range(n_clay) if i not in e1_clay)
    t0 = time.perf_counter()
    clay_dec, clay_dec_ms = clay._decode_composite(a1_clay, e1_clay)
    clay_probe_s["decode (0,)"] = time.perf_counter() - t0
    check(clay_enc.shape == (256, 512) and clay_dec.shape == (64, 704),
          f"clay composites {clay_enc.shape} {clay_dec.shape}")
    clay_host = rng.integers(0, 256, (BATCH, clay.k, clay_chunk),
                             dtype=np.uint8)
    clay_data = torch.from_numpy(clay_host).to(dev)
    clay_x = clay_data.reshape(BATCH, clay.k * sub, sc)     # (64, 512, 2048)

    def hold_walk(x, mat_s, what, packed=True):
        """The column walk on x (both layouts when C is whole rows)
        against its plain version and the MXU twin; returns it and the
        column splits it took."""
        z = walk_splits(int(np.prod(x.shape[:-2])), x.shape[-1], mat_s, dev)
        got = apply_matrix_mxu_cuda(x, mat_s)
        want = apply_matrix_walk_torch(x, walk_data(mat_s), len(mat_s))
        err.hold("apply_matrix_mxu_cuda", got, want, f"{what}, plain walk")
        err.hold("apply_matrix_mxu_cuda", got, apply_matrix_mxu_torch(
            x, mat_s), f"{what}, MXU twin")
        if packed and x.shape[-1] % 512 == 0:
            err.hold("apply_matrix_mxu_cuda_packed", unpack_chunks(
                apply_matrix_mxu_cuda_packed(pack_chunks(x), mat_s)), want,
                f"{what}, packed")
        return got, z

    got, z = hold_walk(clay_x, clay_enc_ms,
                       f"clay encode composite, {tuple(clay_x.shape)}")
    taken = {"clay encode": z}
    check(np.array_equal(got[:2].cpu().numpy(), regionops.matrix_encode(
        clay_host[:2].reshape(2, clay.k * sub, sc), clay_enc, 8)),
        "column walk == numpy ground truth, 2 stripes")
    clay_parity = got.reshape(BATCH, clay.m, clay_chunk)
    clay_full = torch.cat([clay_data[:DECODE_BATCH],
                           clay_parity[:DECODE_BATCH]], dim=1)
    dec_x = clay_full[:, list(a1_clay)].reshape(DECODE_BATCH,
                                                len(a1_clay) * sub, sc)
    got, z = hold_walk(dec_x, clay_dec_ms,
                       f"clay decode (0,), {tuple(dec_x.shape)}")
    taken["clay decode (0,)"] = z
    check(z > 1, "the 4-stripe decode splits its columns")
    check(torch.equal(got.reshape(DECODE_BATCH, clay_chunk),
                      clay_full[:, 0]), "the (0,) composite recovers")
    # the same decode at BATCH stripes fills the card: no split
    dec_wide = torch.cat([clay_x, torch.flip(clay_x, (0,))[:, :192]], dim=1)
    _, z = hold_walk(dec_wide, clay_dec_ms,
                     f"clay decode (0,), {tuple(dec_wide.shape)}")
    taken[f"clay decode (0,) at {BATCH} stripes"] = z
    check(z == 1, f"the {BATCH}-stripe decode takes no column split")
    n_mxu, rand_splits = 0, []
    for r, s_, c, lead in (
            (16, 48, 8192, (3,)),
            (64, 176, 2048 + 4, (2,)),
            (64, 704, 2048, ()),
            (16, 176, 4096, ()),
            (64, 48, 1000, (5,)),
            (16, 704, 512, (2,)),
            (300, 40, 1003, (2,)),                    # 2 row tiles, C % 4
            (513, 24, 4096, (2,)),                    # 3 row tiles
            (600, 256, 4096, (2,))):                  # 3 row tiles, split
        m_r = rng.integers(0, 256, (r, s_))
        m_r[rng.random((r, s_)) < 0.7] = 0
        mr = matrix_to_static(m_r)
        xh = rng.integers(0, 256, lead + (s_ + 1, c), dtype=np.uint8)
        x = torch.from_numpy(xh).to(dev)[..., :s_, :]        # strided slice
        want, z = hold_walk(x, mr, f"column walk r={r} s={s_} C={c} "
                            f"lead={lead}")
        rand_splits.append(z)
        flat = xh[..., :s_, :].reshape((-1, s_, c))[:2]
        check(np.array_equal(want.reshape((-1, r, c))[:2].cpu().numpy(),
                             np.stack([regionops.matrix_encode(f, m_r, 8)
                                       for f in flat])),
              f"column walk r={r} s={s_} == numpy ground truth")
        n_mxu += 1
    check(min(rand_splits) == 1 < max(rand_splits),
          f"random matrices with and without the column split: "
          f"{rand_splits}")
    print(f"phase 2: column-walk kernel equal to its plain walk and the MXU "
          f"twin in both layouts on the clay encode composite and the "
          f"(64, 704) decode (0,), column splits taken {taken}, and "
          f"{n_mxu} random matrices (r in 16, 64, 300, 513, 600: up to 3 "
          f"row tiles; s in 24 to 704; C = 2052, 1000, 1003; no batch dim; "
          f"strided slices; column splits {rand_splits}), and to the host "
          f"ground truth")

    # the dense kernel's table variant: the four (64, 704) parity repairs
    # of clay (45056 coefficients, above the 2048 taken by value), dense
    # and ragged, bytes and packed
    big = []
    for e in range(clay.k, n_clay):
        avail = tuple(i for i in range(n_clay) if i != e)
        dm, dm_ms = clay._decode_composite(avail, (e,))
        check(len(dm_ms) * len(dm_ms[0]) > 2048, "a table above 2048")
        check(select_matrix_engine(8, dev, shape=(DECODE_BATCH, 704, sc),
                                   matrix_t=dm_ms) == "cuda",
              f"the repair of chunk {e} routes to the dense kernel")
        x = clay_full[:, list(avail)].reshape(DECODE_BATCH, 704, sc)
        want = apply_matrix_torch(x, dm_ms, 8)
        got = apply_matrix_cuda(x, dm_ms)
        err.hold("apply_matrix_cuda", got, want, f"table variant, repair {e}")
        check(torch.equal(got.reshape(DECODE_BATCH, clay_chunk),
                          clay_full[:, e]), f"repair {e} recovers")
        err.hold("apply_matrix_cuda_packed", unpack_chunks(
            apply_matrix_cuda_packed(pack_chunks(x), dm_ms)), want,
            f"table variant packed, repair {e}")
        mk = torch.tensor([1, 0, 1, 1], dtype=torch.uint8, device=dev)
        err.hold("apply_matrix_cuda_ragged", apply_matrix_cuda_ragged(
            x, dm_ms, mk), apply_matrix_ragged_torch(x, dm_ms, mk),
            f"table variant ragged, repair {e}")
        err.hold("apply_matrix_cuda_packed_ragged",
                 apply_matrix_cuda_packed_ragged(pack_chunks(x), dm_ms, mk),
                 apply_matrix_packed_ragged_torch(pack_chunks(x), dm_ms, mk),
                 f"table variant packed ragged, repair {e}")
        big.append((e, dm, dm_ms, avail))
    check(np.array_equal(got[:2].cpu().numpy(), regionops.matrix_encode(
        clay_full[:2, list(big[-1][3])].reshape(2, 704, sc).cpu().numpy(),
        big[-1][1], 8)), "table variant == numpy ground truth, 2 stripes")
    print(f"phase 2: the dense kernel's table variant equal on the 4 clay "
          f"(64, 704) parity repairs at ({DECODE_BATCH}, 704, {sc}), dense "
          f"and ragged, bytes and packed, and to the host ground truth")

    # the roofline probes' kernels on one 64 MiB slab
    slab_host = rng.integers(0, 1 << 32, (BATCH, K, CHUNK // 512, 128),
                             dtype=np.uint32)
    slab = torch.from_numpy(slab_host).to(dev)
    err.hold("copy_slab_cuda", copy_slab_cuda(slab), copy_slab_torch(slab),
             f"copy {tuple(slab.shape)}")
    fold_got = fold_slab_cuda(slab)
    err.hold("fold_slab_cuda", fold_got, fold_slab_torch(slab),
             f"fold {tuple(slab.shape)}")
    check(np.array_equal(fold_got[:2].cpu().numpy(), np.bitwise_xor.reduce(
        slab_host[:2], axis=1, keepdims=True)),
        "fold == numpy ground truth, 2 stripes")
    check(np.array_equal(copy_slab_cuda(slab)[:2].cpu().numpy(),
                         slab_host[:2]), "copy == the slab, 2 stripes")
    print(f"phase 2: copy and fold kernels equal their plain versions on "
          f"{tuple(slab.shape)} and the numpy ground truth")

    phase_done(2)

    # -- phase 3: the paths, through the user's entry points ----------------
    counts, reset = launch_counts, reset_launch_counts
    n = K + M
    patterns = [e for t in range(1, M + 1)
                for e in itertools.combinations(range(n), t)]
    check(len(patterns) == 231, f"{len(patterns)} patterns")
    results = {}

    def rs_path():
        parity = ec.encode_chunks_torch(data)
        torch.cuda.synchronize()
        check(torch.equal(parity, plain), "encode_chunks_torch parity")
        n0 = counts()["apply_matrix_cuda"]
        check(n0 >= 1, "encode_chunks_torch launched the bytes kernel")
        parity_host = ec.encode_chunks_batch(host)
        check(np.array_equal(parity_host, parity.cpu().numpy()),
              "encode_chunks_batch parity")
        check(counts()["apply_matrix_cuda"] > n0,
              "encode_chunks_batch launched the bytes kernel")
        parity_packed = ec.encode_chunks_packed_torch(pack_chunks(data))
        torch.cuda.synchronize()
        check(torch.equal(unpack_chunks(parity_packed), parity),
              "encode_chunks_packed_torch parity")
        check(counts()["apply_matrix_cuda_packed"] >= 1,
              "packed encode launched the packed kernel")
        full = torch.cat([data[:DECODE_BATCH], parity[:DECODE_BATCH]],
                         dim=1)
        before = counts()
        for erased in patterns:
            avail = tuple(i for i in range(n) if i not in erased)
            idx = torch.tensor(avail, device=dev)
            want = full[:, list(erased)]
            rec = ec.decode_chunks_torch(full.index_select(1, idx), avail,
                                         erased)
            check(torch.equal(rec, want), f"decode {erased}")
            recp = ec.decode_chunks_packed_torch(
                pack_chunks(full.index_select(1, idx)), avail, erased)
            check(torch.equal(unpack_chunks(recp), want),
                  f"packed decode {erased}")
        mid = counts()
        per_call = {name: (mid[name] - before[name]) / len(patterns)
                    for name in ("apply_matrix_cuda",
                                 "apply_matrix_cuda_packed")}
        print(f"  RS decodes: {len(patterns)} calls per layout at "
              f"{DECODE_BATCH} stripes, launches per call {per_call}")
        check(per_call == {"apply_matrix_cuda": 1.0,
                           "apply_matrix_cuda_packed": 1.0},
              f"one dense launch per decode call: {per_call}")
        for erased in ((3,), (0, 9), (1, 5, 10)):
            avail = tuple(i for i in range(n) if i not in erased)
            host_full = full.cpu().numpy()
            rec = ec.decode_chunks_batch(host_full[:, list(avail)], avail,
                                         erased)
            check(np.array_equal(rec, host_full[:, list(erased)]),
                  f"decode_chunks_batch {erased}")
        after = counts()
        check(after["apply_matrix_cuda"] - before["apply_matrix_cuda"]
              >= len(patterns), "every decode launched the bytes kernel")
        check(after["apply_matrix_cuda_packed"]
              - before["apply_matrix_cuda_packed"] >= len(patterns),
              "every packed decode launched the packed kernel")
        isa = reg.factory("isa", {"technique": "reed_sol_van", "k": str(K),
                                  "m": str(M)})
        n1 = counts()["apply_matrix_cuda"]
        isa_parity = isa.encode_chunks_torch(data)
        check(np.array_equal(isa_parity[:2].cpu().numpy(),
                             regionops.matrix_encode(host[:2], isa.matrix,
                                                     8)),
              "isa encode == numpy ground truth")
        isa_full = torch.cat([data[:DECODE_BATCH],
                              isa_parity[:DECODE_BATCH]], dim=1)
        erased = (2, 7, 9)
        avail = tuple(i for i in range(n) if i not in erased)
        rec = isa.decode_chunks_torch(
            isa_full.index_select(1, torch.tensor(avail, device=dev)),
            avail, erased)
        check(torch.equal(rec, isa_full[:, list(erased)]), "isa decode")
        check(counts()["apply_matrix_cuda"] > n1, "isa launched the kernel")

    results["rs"] = drive("RS k=8 m=3 (64 x 1 MiB encode via tensor, "
                          "numpy and packed entries; 231 decode patterns x "
                          "2 layouts; isa)", counts, reset, rs_path,
                          ("apply_matrix_cuda", "apply_matrix_cuda_packed"))
    check(results["rs"]["apply_matrix_xor_cuda"] == 0
          and results["rs"]["apply_matrix_xor_cuda_packed"] == 0,
          "reed_sol_van k=8 m=3 routes no pattern to the XOR kernel")

    def cauchy_path():
        parity = cg.encode_chunks_torch(data)
        torch.cuda.synchronize()
        check(torch.equal(parity, gots), "cauchy_good encode_chunks_torch")
        n0 = counts()["apply_bitmatrix_xor_cuda"]
        check(n0 >= 1, "cauchy_good encode launched the schedule kernel")
        check(np.array_equal(cg.encode_chunks_batch(host),
                             parity.cpu().numpy()),
              "cauchy_good encode_chunks_batch")
        check(counts()["apply_bitmatrix_xor_cuda"] > n0,
              "encode_chunks_batch launched the schedule kernel")
        full = torch.cat([data[:DECODE_BATCH], parity[:DECODE_BATCH]],
                         dim=1)
        before = counts()
        t0 = time.perf_counter()
        for erased in patterns:
            avail = tuple(i for i in range(n) if i not in erased)
            rec = cg.decode_chunks_torch(
                full.index_select(1, torch.tensor(avail, device=dev)),
                avail, erased)
            check(torch.equal(rec, full[:, list(erased)]),
                  f"cauchy_good decode {erased}")
        after = counts()
        plain_n = (after["apply_bitmatrix_cuda"]
                   - before["apply_bitmatrix_cuda"])
        sched_n = (after["apply_bitmatrix_xor_cuda"]
                   - before["apply_bitmatrix_xor_cuda"])
        check(plain_n == 9 and sched_n == 222,
              f"cauchy_good decodes: {plain_n} plain, {sched_n} scheduled")
        print(f"  cauchy_good: 231 patterns decoded in "
              f"{time.perf_counter() - t0:.2f} s host clock (first use: "
              f"decode matrix and CSE per pattern); {plain_n} plain, "
              f"{sched_n} scheduled")

    results["cauchy_good"] = drive(
        "cauchy_good k=8 m=3 (64 x 1 MiB encode via tensor and numpy "
        "entries; 231 decode patterns)", counts, reset, cauchy_path,
        ("apply_bitmatrix_cuda", "apply_bitmatrix_xor_cuda"))
    # a warm repeat of the 231 decodes: the kernel data is cached per
    # (matrix, row groups), so it sets up nothing; each decode still
    # recovers the erased chunks
    setups, before = tel.kernel_setups(), counts()
    full = torch.cat([data[:DECODE_BATCH], gots[:DECODE_BATCH]], dim=1)
    for erased in patterns:
        avail = tuple(i for i in range(n) if i not in erased)
        rec = cg.decode_chunks_torch(full.index_select(
            1, torch.tensor(avail, device=dev)), avail, erased)
        check(torch.equal(rec, full[:, list(erased)]),
              f"warm cauchy_good decode {erased}")
    torch.cuda.synchronize()
    after = counts()
    warm = (after["apply_bitmatrix_cuda"] - before["apply_bitmatrix_cuda"],
            after["apply_bitmatrix_xor_cuda"]
            - before["apply_bitmatrix_xor_cuda"])
    check(warm == (9, 222) and tel.kernel_setups() == setups,
          f"warm cauchy_good decodes: {warm} launches, "
          f"{tel.kernel_setups() - setups} kernel setups")
    print(f"phase 3: warm repeat of the 231 cauchy_good decodes: {warm[0]} "
          f"plain and {warm[1]} scheduled launches, no kernel setup")

    def density_path():
        for prof, erased in (
                ({"technique": "liberation", "k": "7", "w": "7"}, (0, 8)),
                ({"technique": "blaum_roth", "k": "6", "w": "6"}, (0, 7)),
                ({"technique": "liber8tion", "k": "8"}, (3, 9))):
            code = reg.factory("jerasure", dict(prof))
            kk, nn = code.k, code.k + code.m
            c = code.get_chunk_size(kk * CHUNK)
            xh = rng.integers(0, 256, (DECODE_BATCH, kk, c), dtype=np.uint8)
            x = torch.from_numpy(xh).to(dev)
            par = code.encode_chunks_torch(x)
            check(np.array_equal(par[:2].cpu().numpy(),
                                 regionops.bitmatrix_encode(
                                     xh[:2], code.bitmatrix, code.w,
                                     code.packetsize)),
                  f"{prof['technique']} encode == numpy ground truth")
            full = torch.cat([x, par], dim=1)
            avail = tuple(i for i in range(nn) if i not in erased)
            rec = code.decode_chunks_torch(full[:, list(avail)], avail,
                                           erased)
            check(torch.equal(rec, full[:, list(erased)]),
                  f"{prof['technique']} decode {erased}")

    results["minimal_density"] = drive(
        "liberation k=7 w=7 / blaum_roth k=6 w=6 / liber8tion k=8 "
        "(encode + decode each)", counts, reset, density_path,
        ("apply_bitmatrix_cuda", "apply_bitmatrix_xor_cuda"))

    def words_path():
        for w, wc in wide_codes.items():
            wh, x = word_data[w]
            par = wc.encode_chunks_torch(x.view(torch.uint8))
            want = apply_matrix_torch(x, matrix_to_static(wc.matrix), w)
            check(torch.equal(par, want.view(torch.uint8)),
                  f"reed_sol_van w={w} encode")
            full = torch.cat([x.view(torch.uint8)[:DECODE_BATCH],
                              par[:DECODE_BATCH]], dim=1)
            erased = (1, 5, 10)
            avail = tuple(i for i in range(n) if i not in erased)
            rec = wc.decode_chunks_torch(full[:, list(avail)], avail,
                                         erased)
            check(torch.equal(rec, full[:, list(erased)]),
                  f"reed_sol_van w={w} decode {erased}")

    results["words"] = drive(
        "reed_sol_van w=16 / w=32 k=8 m=3 (encode + 3-erasure decode "
        "each)", counts, reset, words_path, ("apply_matrix_cuda_words",))

    def erasures(n, most):
        return [e for t in range(1, most + 1)
                for e in itertools.combinations(range(n), t)]

    def decode_both(code, full, erased, want_xor):
        """Decode ``erased`` from the rest of ``full`` through the tensor
        and packed entries; require the XOR-schedule kernel in both
        layouts when ``want_xor``, the dense kernel otherwise."""
        avail = tuple(i for i in range(full.shape[1]) if i not in erased)
        surv = full.index_select(1, torch.tensor(avail, device=dev))
        before = counts()
        rec = code.decode_chunks_torch(surv, avail, erased)
        recp = code.decode_chunks_packed_torch(pack_chunks(surv), avail,
                                               erased)
        torch.cuda.synchronize()
        after = counts()
        want = full[:, list(erased)]
        check(torch.equal(rec, want), f"decode {erased}")
        check(torch.equal(unpack_chunks(recp), want),
              f"packed decode {erased}")
        ran = {k: after[k] - before[k] for k in after}
        if want_xor:
            check(ran["apply_matrix_xor_cuda"] == 1
                  and ran["apply_matrix_xor_cuda_packed"] == 1,
                  f"decode {erased} took the XOR kernel: {ran}")
        else:
            check(ran["apply_matrix_cuda"] >= 1
                  and ran["apply_matrix_cuda_packed"] >= 1
                  and ran["apply_matrix_xor_cuda"] == 0,
                  f"decode {erased} took the dense kernel: {ran}")

    def routes_xor(code, avail, erased, ms=None):
        if ms is None:
            ms = code._decode_composite(avail, erased)[1]
        return preferred_schedule(ms, 8, mxu_min=MXU_MATRIX_MIN) is not None

    lrc_host = rng.integers(0, 256, (BATCH, LRC_K, LRC_CHUNK),
                            dtype=np.uint8)
    lrc_data = torch.from_numpy(lrc_host).to(dev)

    def lrc_path():
        parity = lrc.encode_chunks_torch(lrc_data)
        parity_p = lrc.encode_chunks_packed_torch(pack_chunks(lrc_data))
        torch.cuda.synchronize()
        check(torch.equal(unpack_chunks(parity_p), parity),
              "lrc packed encode")
        check(np.array_equal(parity[:2].cpu().numpy(),
                             lrc.encode_chunks_batch(lrc_host[:2])),
              "lrc encode == encode_chunks_batch (host schedule)")
        n_lrc = lrc.get_chunk_count()
        full = torch.empty((DECODE_BATCH, n_lrc, LRC_CHUNK),
                           dtype=torch.uint8, device=dev)
        dpos = lrc.data_positions
        ppos = [p for p in range(n_lrc) if p not in dpos]
        full[:, dpos] = lrc_data[:DECODE_BATCH]
        full[:, ppos] = parity[:DECODE_BATCH]
        n_xor = 0
        for erased in erasures(n_lrc, 2):
            avail = tuple(i for i in range(n_lrc) if i not in erased)
            xor = routes_xor(lrc, avail, erased)
            n_xor += xor
            decode_both(lrc, full, erased, xor)
        check(n_xor == 29, f"lrc: {n_xor} of 36 patterns on the XOR kernel")

    results["lrc"] = drive(
        "lrc k=4 m=2 l=3 (64 x 1 MiB encode via tensor and packed "
        "entries; 36 decode patterns x 2 layouts, 29 scheduled)", counts,
        reset, lrc_path, ("apply_matrix_cuda", "apply_matrix_cuda_packed",
                          "apply_matrix_xor_cuda",
                          "apply_matrix_xor_cuda_packed"))

    def r6_path():
        parity = r6.encode_chunks_torch(data)
        parity_p = r6.encode_chunks_packed_torch(pack_chunks(data))
        torch.cuda.synchronize()
        check(torch.equal(parity, r6_parity), "r6 encode_chunks_torch")
        check(torch.equal(unpack_chunks(parity_p), parity),
              "r6 packed encode")
        check(counts()["apply_matrix_xor_cuda"] == 1
              and counts()["apply_matrix_xor_cuda_packed"] == 1,
              "the r6 encode took the XOR kernel in both layouts")
        n6 = r6.k + r6.m
        full = torch.cat([data[:DECODE_BATCH], parity[:DECODE_BATCH]],
                         dim=1)
        on_xor = []
        for erased in erasures(n6, 2):
            avail = tuple(i for i in range(n6) if i not in erased)
            dm_static = r6._decode_matrix(avail, erased)[1]
            xor = routes_xor(r6, avail, erased, dm_static)
            if xor:
                on_xor.append(erased)
            decode_both(r6, full, erased, xor)
        check(on_xor == [(9,), (8, 9)], f"r6 XOR decodes {on_xor}")

    results["r6"] = drive(
        "reed_sol_r6_op k=8 m=2 (64 x 1 MiB encode via tensor and packed "
        "entries on the XOR kernel; 55 decode patterns x 2 layouts)",
        counts, reset, r6_path,
        ("apply_matrix_cuda", "apply_matrix_cuda_packed",
         "apply_matrix_xor_cuda", "apply_matrix_xor_cuda_packed"))

    shec_chunk = shec.get_chunk_size(LRC_K * LRC_CHUNK)
    shec_host = rng.integers(0, 256, (BATCH, shec.k, shec_chunk),
                             dtype=np.uint8)

    def shec_path():
        x = torch.from_numpy(shec_host).to(dev)
        parity = shec.encode_chunks_torch(x)
        check(np.array_equal(parity[:2].cpu().numpy(),
                             regionops.matrix_encode(shec_host[:2],
                                                     shec.matrix, 8)),
              "shec encode == numpy ground truth")
        full = torch.cat([x[:DECODE_BATCH], parity[:DECODE_BATCH]], dim=1)
        done = refused = n_xor = 0
        for erased in erasures(n_shec, 3):
            avail = tuple(i for i in range(n_shec) if i not in erased)
            try:
                shec.minimum_to_decode(set(erased), set(avail))
            except IOError:
                refused += 1
                continue
            plan = shec._plan(avail, erased)
            xor = routes_xor(shec, avail, erased,
                             shec._plan_static(plan)[1])
            n_xor += xor
            decode_both(shec, full, erased, xor)
            done += 1
        check(done + refused == 63 and n_xor == 4,
              f"shec: {done} decoded, {refused} undecodable, {n_xor} "
              f"scheduled")
        print(f"  shec: {done} patterns decoded ({n_xor} on the XOR "
              f"kernel), {refused} undecodable (IOError, as the "
              f"reference)")

    results["shec"] = drive(
        "shec k=4 m=3 c=2 (64 x 1 MiB encode; every 1-3 erasure pattern x "
        "2 layouts)", counts, reset, shec_path,
        ("apply_matrix_cuda", "apply_matrix_cuda_packed",
         "apply_matrix_xor_cuda", "apply_matrix_xor_cuda_packed"))

    def clay_path():
        parity = clay.encode_chunks_torch(clay_data)
        torch.cuda.synchronize()
        check(torch.equal(parity, clay_parity), "clay encode_chunks_torch")
        check(counts()["apply_matrix_mxu_cuda"] == 1,
              "the clay encode took the column-walk kernel")
        check(np.array_equal(clay.encode_chunks_batch(clay_host),
                             parity.cpu().numpy()),
              "clay encode_chunks_batch")
        check(counts()["apply_matrix_mxu_cuda"] == 2,
              "encode_chunks_batch took the column-walk kernel")
        parity_p = clay.encode_chunks_packed_torch(pack_chunks(clay_data))
        torch.cuda.synchronize()
        check(torch.equal(unpack_chunks(parity_p), parity),
              "clay packed encode")
        check(counts()["apply_matrix_mxu_cuda_packed"] == 1,
              "the packed encode took the column-walk kernel")
        full = torch.cat([clay_data[:DECODE_BATCH], parity[:DECODE_BATCH]],
                         dim=1)
        t0 = time.perf_counter()
        for erased in erasures(n_clay, 2):
            avail = tuple(i for i in range(n_clay) if i not in erased)
            clay._decode_composite(avail, erased)
        clay_probe_s["all 78 decodes (2 built above)"] = \
            time.perf_counter() - t0
        on_mxu = on_dense = 0
        for erased in erasures(n_clay, 2):
            avail = tuple(i for i in range(n_clay) if i not in erased)
            surv = full.index_select(1, torch.tensor(avail, device=dev))
            before = counts()
            rec = clay.decode_chunks_torch(surv, avail, erased)
            recp = clay.decode_chunks_packed_torch(pack_chunks(surv), avail,
                                                   erased)
            torch.cuda.synchronize()
            ran = {k: v - before[k] for k, v in counts().items()}
            want = full[:, list(erased)]
            check(torch.equal(rec, want), f"clay decode {erased}")
            check(torch.equal(unpack_chunks(recp), want),
                  f"clay packed decode {erased}")
            if ran["apply_matrix_mxu_cuda"] == 1 \
                    and ran["apply_matrix_mxu_cuda_packed"] == 1:
                on_mxu += 1
            elif ran["apply_matrix_cuda"] >= 1 \
                    and ran["apply_matrix_cuda_packed"] >= 1:
                on_dense += 1
                check(len(erased) == 1 and erased[0] >= clay.k,
                      f"only the parity repairs take the dense kernel, "
                      f"not {erased}")
            else:
                check(False, f"clay decode {erased} launched {ran}")
        check((on_mxu, on_dense) == (74, 4),
              f"clay decodes: {on_mxu} on the column-walk kernel, {on_dense} "
              f"on the dense kernel")
        # one single-chunk repair through the dict API: the d helpers'
        # sub-chunk runs only
        host_full = full[:1].cpu().numpy()
        lost = 2
        avail = set(range(n_clay)) - {lost}
        need = clay.minimum_to_decode({lost}, avail)
        check(len(need) == clay.d and all(
            sum(n for _, n in runs) == sub // clay.q
            for runs in need.values()), f"repair reads {need}")
        reads = {c: b"".join(host_full[0, c, off * sc:(off + n) * sc]
                             .tobytes() for off, n in runs)
                 for c, runs in need.items()}
        got = clay.decode({lost}, reads, clay_chunk)
        check(got[lost] == host_full[0, lost].tobytes(),
              "clay dict repair from partial reads")
        small = reg.factory("clay", {"k": "4", "m": "2", "d": "5"})
        sh = rng.integers(0, 256, (DECODE_BATCH, 4, small.get_chunk_size(
            1 << 20)), dtype=np.uint8)
        sx = torch.from_numpy(sh).to(dev)
        sp = small.encode_chunks_torch(sx)
        check(np.array_equal(sp.cpu().numpy(),
                             small.encode_chunks_batch(sh)),
              "clay k=4 m=2 d=5 encode")
        sfull = torch.cat([sx, sp], dim=1)
        erased = (1, 4)
        avail = (0, 2, 3, 5)
        check(torch.equal(small.decode_chunks_torch(sfull[:, list(avail)],
                                                    avail, erased),
                          sfull[:, list(erased)]),
              "clay k=4 m=2 d=5 decode (1, 4)")
        print(f"  clay: 78 decode patterns x 2 layouts ({on_mxu} on the "
              f"column-walk kernel, {on_dense} on the dense kernel's table "
              f"variant); dict repair of chunk {lost} from "
              f"{len(need)} helpers' sub-chunk runs; k=4 m=2 d=5 ok")

    results["clay"] = drive(
        "clay k=8 m=4 d=11 (64 x 1 MiB encode via tensor, numpy and packed "
        "entries; 78 decode patterns x 2 layouts; dict repair; k=4 m=2 "
        "d=5)", counts, reset, clay_path,
        ("apply_matrix_mxu_cuda", "apply_matrix_mxu_cuda_packed",
         "apply_matrix_cuda", "apply_matrix_cuda_packed"))

    # the serving plane: one closed-loop stream of 512 requests, dense
    # (the rung ladder) and paged (512 pages of 4096 bytes per queue),
    # through run_serving_scenario on the real clock
    serve_runs = {}

    def serve_path(paged):
        def fn():
            run = run_serving_scenario(serving_spec(paged))
            bad = verify_results(run.results)
            check(len(run.results) == SERVE_REQUESTS and not bad,
                  f"{len(run.results)} served, {len(bad)} wrong")
            check(run.report["stream_compiles"] == 0,
                  f"stream_compiles {run.report['stream_compiles']}")
            if paged:
                ps = run.batcher.pool_stats()
                check(ps["used_pages"] == 0
                      and ps["allocs"] == ps["reclaims"] > 0,
                      f"pools drained: {ps}")
            serve_runs["paged" if paged else "dense"] = run
        return fn

    results["serve_dense"] = drive(
        f"serving, dense rung ladder 1/4/16/64 ({SERVE_REQUESTS} requests: "
        f"RS k=8 m=3 at 64 KiB / 1 MiB / 4 MiB, shec k=6 m=3 c=2 at "
        f"1 MiB, clay k=8 m=4 d=11 at 1 MiB)", counts,
        reset, serve_path(False), ("apply_matrix_cuda",
                                   "apply_matrix_mxu_cuda"))
    check(results["serve_dense"]["apply_matrix_cuda_ragged"] == 0,
          "the dense run launches no ragged kernel")
    results["serve_paged"] = drive(
        f"serving, paged ({SERVE_POOL_PAGES} pages of {PAGE} bytes per "
        f"queue; same stream)", counts, reset, serve_path(True),
        ("apply_matrix_cuda_ragged", "apply_matrix_mxu_cuda"))
    for mode, run in serve_runs.items():
        st = run.batcher.padding_stats()
        print(f"  serving {mode}: {len(run.batcher.dispatch_log)} fires, "
              f"{st['warmup_dispatches']} warmup dispatches, "
              f"{st['cached_programs']} programs, padding overhead "
              f"{st['padding_overhead']}, stream_compiles "
              f"{run.report['stream_compiles']}"
              + (f", pools {st['pool']}" if mode == "paged" else ""))

    def packed_ragged_path():
        mk = rag_masks["half-live"]
        got = apply_matrix_packed_best_ragged(rag_words, ms, mk)
        check(torch.equal(got, apply_matrix_packed_ragged_torch(
            rag_words, ms, mk)), "apply_matrix_packed_best_ragged")

    results["packed_ragged"] = drive(
        f"apply_matrix_packed_best_ragged (the packed ragged ops entry, "
        f"{tuple(rag_words.shape)} words, half-live)", counts, reset,
        packed_ragged_path, ("apply_matrix_cuda_packed_ragged",))

    def roofline_path():
        for name in roofline.PROBES:
            row = roofline.probe(name, ROOF_MIB, ROOF_LOOP, "packed")
            check(row["input_gbps"] > 0 and row["traffic_mult"]
                  == roofline.traffic_mult(name), f"roofline row {row}")
            print(f"  roofline {json.dumps(row)}")

    results["roofline"] = drive(
        f"roofline tool (the five probes, {ROOF_MIB} MiB slabs, loop "
        f"{ROOF_LOOP})", counts, reset, roofline_path,
        ("copy_slab_cuda", "fold_slab_cuda", "apply_matrix_cuda_packed"))
    # every coding kernel; the CRUSH rule kernel is driven and required
    # in phase 6
    launches = {name: sum(r[name] for r in results.values())
                for name in counts() if name != "crush_rule_cuda"}
    for name, cnt in launches.items():
        check(cnt >= 1, f"{name} launched on the driven paths")
    print(f"phase 3: all paths ok; launches {launches}")

    phase_done(3)

    # -- phase 4: times at the main shape ----------------------------------------
    words = pack_chunks(data)
    t_bytes, h_bytes = time_ms(lambda: apply_matrix_cuda(data, ms), 50)
    t_packed, h_packed = time_ms(lambda: apply_matrix_cuda_packed(words, ms),
                                 50)
    t_plain, h_plain = time_ms(lambda: apply_matrix_torch(data, ms, 8), 5,
                               warmup=1)
    t_plain_packed, h_plain_packed = time_ms(
        lambda: pack_chunks(apply_matrix_torch(unpack_chunks(words), ms,
                                               8)), 5, warmup=1)
    t_copy, h_copy = time_ms(lambda: data.clone(), 50)
    in_bytes = data.numel()
    words_per_chunk = in_bytes // K // 4
    moved = in_bytes * (K + M) // K
    bound, bound_by = bound_ms(analytic_kernel_cost(BATCH, M, K, CHUNK,
                                                    sm90_op_floor(ms)))
    print(f"bound of the encode: {moved} bytes moved, "
          f"{sm90_op_floor(ms)} int32 ops per word position (the floor: "
          f"chain per column {sm90_op_count(ms)}, per row "
          f"{sm90_row_op_count(ms)}; the dense kernel's program "
          f"{program_op_count(ms)}; reference dense cost model: "
          f"{dense_op_count(ms)}) x {words_per_chunk} word positions -> "
          f"{bound:.6f} ms, by {bound_by}")

    # decode e=2 at the main shape, through the user's entry point: the
    # survivors of all 64 stripes (a strided slice) -> the 2 lost chunks
    erased = (3, 9)
    avail = tuple(i for i in range(n) if i not in erased)
    surv = torch.cat([data, plain], dim=1).index_select(
        1, torch.tensor(avail, device=dev))
    dm = matrix_to_static(regionops.matrix_decode_matrix(
        mat, K, list(avail[:K]), list(erased)))
    t_dec, h_dec = time_ms(
        lambda: ec.decode_chunks_torch(surv, avail, erased), 50)
    dbound, dbound_by = bound_ms(analytic_kernel_cost(
        BATCH, len(erased), K, CHUNK, sm90_op_floor(dm)))
    print(f"bound of decode e=2 {erased}: {sm90_op_floor(dm)} int32 ops "
          f"per word position (chain per column {sm90_op_count(dm)}, per "
          f"row {sm90_row_op_count(dm)}; the dense kernel's program "
          f"{program_op_count(dm)}; reference dense cost model: "
          f"{dense_op_count(dm)}) -> {dbound:.6f} ms, by {dbound_by}")
    # the numpy entry point end to end (host clock: copies included), and
    # one 1 MiB stripe through the tensor entry point (dispatch-bound)
    t0 = time.perf_counter()
    for _ in range(3):
        ec.encode_chunks_batch(host)
    t_batch = (time.perf_counter() - t0) * 1e3 / 3
    print(f"time encode_chunks_batch, 64 MiB numpy in and out: "
          f"{t_batch:.6f} ms host clock, {in_bytes / t_batch / 1e6:.3f} "
          f"GB/s of input")
    one = data[:1].contiguous()
    t_one, h_one = time_ms(lambda: ec.encode_chunks_torch(one), 200)
    print(f"time encode_chunks_torch, one 1 MiB stripe: {t_one:.6f} ms "
          f"device, {h_one:.6f} ms host issue per call")

    # the bitmatrix kernels at the cauchy_good k=8 m=3 main shape
    t_bm, h_bm = time_ms(
        lambda: apply_bitmatrix_cuda(data, rows, 8, PACKETSIZE), 50)
    t_bm_plain, h_bm_plain = time_ms(
        lambda: apply_bitmatrix_torch(data, rows, 8, PACKETSIZE), 5,
        warmup=1)
    t_xs, h_xs = time_ms(lambda: apply_bitmatrix_xor_cuda(
        data, enc_sched.static, 8, PACKETSIZE), 50)
    t_xs_plain, h_xs_plain = time_ms(lambda: apply_bitmatrix_xor_torch(
        data, enc_sched.static, 8, PACKETSIZE), 5, warmup=1)
    t_cg_enc, h_cg_enc = time_ms(lambda: cg.encode_chunks_torch(data), 50)
    t_cg_dec, h_cg_dec = time_ms(
        lambda: cg.decode_chunks_torch(e2_surv, e2_avail, e2), 50)
    e1 = (3,)
    e1_avail = tuple(i for i in range(n) if i not in e1)
    e1_surv = cg_full.index_select(1, torch.tensor(e1_avail, device=dev))
    _, e1_rows, _, e1_sched = cg._decode_bitmatrix(e1_avail, e1)
    check(e1_sched is None, "cauchy_good decode e=1 (3,) is plain")
    t_cg_dec1, h_cg_dec1 = time_ms(
        lambda: cg.decode_chunks_torch(e1_surv, e1_avail, e1), 50)
    bm_bound, bm_by = bound_ms(analytic_bitmatrix_cost(
        BATCH, M, K, CHUNK, bitmatrix_op_count(rows), 8))
    xs_bound, xs_by = bound_ms(analytic_bitmatrix_cost(
        BATCH, M, K, CHUNK, schedule_op_count(enc_sched.static), 8))
    dec2_bound, dec2_by = bound_ms(analytic_bitmatrix_cost(
        BATCH, 2, K, CHUNK, schedule_op_count(e2_sched.static), 8))
    dec1_bound, dec1_by = bound_ms(analytic_bitmatrix_cost(
        BATCH, 1, K, CHUNK, bitmatrix_op_count(e1_rows), 8))
    print(f"bound of the cauchy_good encode: {moved} bytes moved; plain "
          f"{bitmatrix_op_count(rows)} int32 ops per word position, "
          f"scheduled {schedule_op_count(enc_sched.static)} ({enc_sched.xor_ops}"
          f" XORs, {enc_sched.naive_xor_ops} naive) x "
          f"{words_per_chunk // 8} word positions -> plain "
          f"{bm_bound:.6f} ms by {bm_by}, scheduled {xs_bound:.6f} ms by "
          f"{xs_by}; decode e=2 {e2} {e2_sched.xor_ops} XORs -> "
          f"{dec2_bound:.6f} ms by {dec2_by}; decode e=1 {e1} plain -> "
          f"{dec1_bound:.6f} ms by {dec1_by}")

    # the word kernel at (64, 8, 65536) words
    word_times = {}
    for w, wc in wide_codes.items():
        _, x = word_data[w]
        wms = matrix_to_static(wc.matrix)
        t_w, h_w = time_ms(lambda: apply_matrix_cuda_words(x, wms, w), 20)
        t_wp, h_wp = time_ms(lambda: apply_matrix_torch(x, wms, w), 3,
                             warmup=1)
        w_bytes = x.numel() * (w // 8)
        w_pos = w_bytes // K // 4
        wb, wb_by = bound_ms(analytic_kernel_cost(
            x.shape[0], M, K, x.shape[-1] * (w // 8), sm90_op_floor(wms, w)))
        word_times[w] = (t_w, h_w, t_wp, h_wp, wb, wb_by)
        print(f"bound of reed_sol_van w={w} encode at (64, 8, {WORDS}) "
              f"words: {w_bytes * (K + M) // K} bytes moved, "
              f"{sm90_op_floor(wms, w)} int32 ops per word position (per "
              f"column {sm90_op_count(wms, w)}, per row "
              f"{sm90_row_op_count(wms, w)}; the kernel's program "
              f"{program_op_count(wms, w)}) x "
              f"{w_pos}"
              f" -> {wb:.6f} ms, by {wb_by}")

    # the dense kernel's two ways of taking its row program, on the RS k=8
    # m=3 encodes at the main shape (w=8 bytes, w=16 words): by value (a
    # kernel parameter, up to BY_VALUE_MAX_PROG words) and from a device
    # buffer (any size, the clay repairs' way).  One call of the library
    # each, timed in the order value, table, table, value; both outputs
    # held against the plain version first
    lib_gf = gf_kernels._lib()
    for w, x, wms, want in (
            (8, data, ms, plain),
            (16, word_data[16][1], matrix_to_static(wide_codes[16].matrix),
             None)):
        prog = dense_program(wms, w)
        table = gf_kernels._device_program(wms, w, dev).data_ptr()
        nb = x.shape[-1] * x.element_size()
        out_w = torch.empty((x.shape[0], M) + x.shape[2:], dtype=x.dtype,
                            device=dev)
        geom = (x.data_ptr(), out_w.data_ptr(), x.shape[0], nb, K * nb, nb,
                M * nb, nb, M, K)

        def via(tab, w=w, geom=geom, prog=prog, x=x):
            def fn():
                e = (lib_gf.gf8_matrix_apply(*geom, prog.ctypes.data, tab,
                                             None, *device_and_stream(x))
                     if w == 8 else
                     lib_gf.gfw_matrix_apply(*geom, w, prog.ctypes.data, tab,
                                             *device_and_stream(x)))
                check(e == 0, f"the dense kernel launched (error {e})")
            return fn
        if want is None:
            want = apply_matrix_torch(x, wms, w)
        for tab in (None, table):
            out_w.zero_()
            via(tab)()
            check(torch.equal(out_w, want),
                  f"w={w} dense kernel, {'table' if tab else 'by value'}")
        got_t = {"by value": [], "table": []}
        for name, tab in (("by value", None), ("table", table),
                          ("table", table), ("by value", None)):
            got_t[name].append((kernel_ms(via(tab), "gf_matrix", iters=50),
                                time_ms(via(tab), 50)[0]))
        print(f"time RS k=8 m=3 encode w={w} at {tuple(x.shape)}, dense "
              f"kernel per call (profiler ms, events ms), in the order "
              f"value, table, table, value: by value {got_t['by value']}, "
              f"table {got_t['table']}")

    # the dense kernel at the shapes of tools/dense_times.py (the encode,
    # the decodes at 4 and 64 stripes, clay's (64, 704) repair through the
    # device program, w=16/32, the ragged pool at 25/50/100 % live): its
    # profiler time per call beside the bound, the instructions per word
    # position its row program spends against the floor, and its plan
    for name, wrapper, fn, cost, mat_s, w, dims in dense_times.shapes(
            args.seed):
        k_t = kernel_ms(fn, "gf_matrix", iters=50)
        b, b_by = bound_ms(analytic_kernel_cost(
            *cost[:4], sm90_op_floor(mat_s, w), live=cost[4]))
        plan = dense_plan(*dims, mat_s, dev) if w == 8 else None
        print(f"time dense kernel, {name} via {wrapper}: profiler "
              + ("not measured" if k_t is None else f"{k_t:.6f} ms, "
                 f"{b / k_t:.4f} of bound")
              + f"; bound {b:.6f} ms by {b_by}; {program_op_count(mat_s, w)}"
              f" instructions per word position in its program (floor "
              f"{sm90_op_floor(mat_s, w)}); grid {plan}")

    # the packet kernel at the shapes of tools/packet_times.py (the
    # cauchy_good encode plain and scheduled, the scheduled decode (3, 9)
    # at 4 and 64 stripes, the plain decode (3,) at 4, a random w=7
    # bitmatrix at packetsize 32): its profiler time per call beside the
    # bound, and the plan it launched
    for name, kind, key, n_in, w, ps, x, r in packet_times.shapes(
            args.seed):
        fn = ((lambda x=x, key=key, w=w, ps=ps:
               apply_bitmatrix_cuda(x, key, w, ps)) if kind == "plain" else
              (lambda x=x, key=key, w=w, ps=ps:
               apply_bitmatrix_xor_cuda(x, key, w, ps)))
        b, b_by = bound_ms(packet_times.work(gf_kernels, kind, key, n_in,
                                             w, ps, x, r))
        k_t = kernel_ms(fn, "gf2_packet_kernel", iters=50)
        plan = gf_kernels.packet_launch_plan(x, r, w, ps, kind, key, n_in)
        print(f"time packet kernel, {name}, {kind}: profiler "
              + ("not measured" if k_t is None else f"{k_t:.6f} ms, "
                 f"{b / k_t:.4f} of bound")
              + f"; bound {b:.6f} ms by {b_by}; plan {plan}")

    for name, t, h, b, nbytes in (
            ("bytes kernel", t_bytes, h_bytes, bound, in_bytes),
            ("packed kernel", t_packed, h_packed, bound, in_bytes),
            ("plain torch (bytes)", t_plain, h_plain, bound, in_bytes),
            ("plain torch (packed)", t_plain_packed, h_plain_packed, bound,
             in_bytes),
            ("copy floor (clone of the input)", t_copy, h_copy, bound,
             in_bytes),
            ("decode e=2 via decode_chunks_torch", t_dec, h_dec, dbound,
             in_bytes),
            ("cauchy_good encode, plain packet kernel", t_bm, h_bm,
             bm_bound, in_bytes),
            ("cauchy_good encode, plain torch (packets)", t_bm_plain,
             h_bm_plain, bm_bound, in_bytes),
            ("cauchy_good encode, schedule kernel", t_xs, h_xs, xs_bound,
             in_bytes),
            ("cauchy_good encode, plain torch (schedule)", t_xs_plain,
             h_xs_plain, xs_bound, in_bytes),
            ("cauchy_good encode via encode_chunks_torch", t_cg_enc,
             h_cg_enc, xs_bound, in_bytes),
            ("cauchy_good decode e=2 via decode_chunks_torch (schedule)",
             t_cg_dec, h_cg_dec, dec2_bound, in_bytes),
            ("cauchy_good decode e=1 via decode_chunks_torch (plain)",
             t_cg_dec1, h_cg_dec1, dec1_bound, in_bytes),
            *((f"reed_sol_van w={w} encode, word kernel", v[0], v[1], v[4],
               BATCH * K * WORDS * w // 8) for w, v in word_times.items()),
            *((f"reed_sol_van w={w} encode, plain torch", v[2], v[3], v[4],
               BATCH * K * WORDS * w // 8) for w, v in word_times.items())):
        print(f"time {name}: {t:.6f} ms device, {h:.6f} ms host issue, "
              f"{nbytes / t / 1e6:.3f} GB/s of input, {b / t:.4f} of "
              f"bound")

    # the XOR-schedule kernel: the r6 encode at the main shape and the lrc
    # local repair, both layouts, against the bytes each one must move
    def read_chunks(st):
        """The input chunks the schedule reads (the kernel loads no
        other)."""
        return {idx for leaves, _, _ in word_program(st)[1]
                for mem, idx, _, _ in leaves if mem}

    def xor_bound(st, x, r):
        cost = analytic_kernel_cost(x.shape[0], r, len(read_chunks(st)),
                                    x.shape[-1], xor_schedule_op_count(st))
        return bound_ms(cost) + (int(cost["bytes accessed"]),)

    xor_times = {}
    for label, x, st, mat_s in (
            ("r6 encode", data, r6_st, r6_ms),
            ("lrc local repair (0,)", lrc_surv, lrc_st, lrc_ms)):
        xw = pack_chunks(x)
        r = st[2]
        t_x, h_x = time_ms(lambda: apply_matrix_xor_cuda(x, st), 50)
        t_xp, h_xp = time_ms(lambda: apply_matrix_xor_cuda_packed(xw, st),
                             50)
        t_pl, h_pl = time_ms(lambda: apply_matrix_xor_torch(x, st), 5,
                             warmup=1)
        t_plp, h_plp = time_ms(lambda: pack_chunks(apply_matrix_xor_torch(
            unpack_chunks(xw), st)), 5, warmup=1)
        read = sorted(read_chunks(st))
        src = x[:, read]
        t_cp, h_cp = time_ms(lambda: src.clone(), 50)
        k_x = kernel_ms(lambda: apply_matrix_xor_cuda(x, st),
                        "gf8_xor_kernel")
        k_xp = kernel_ms(lambda: apply_matrix_xor_cuda_packed(xw, st),
                         "gf8_xor_kernel")
        # the dense kernel on the same matrix: what the schedule is for
        k_dense = kernel_ms(lambda: apply_matrix_cuda(x, mat_s),
                            "gf_matrix_kernel")
        b, b_by, moved = xor_bound(st, x, r)
        xor_times[label] = (k_x or t_x, k_xp or t_xp, t_pl, t_plp, b, b_by)
        print(f"bound of the {label} {tuple(x.shape)} -> {r} rows: reads "
              f"chunks {read}, {moved} bytes moved, "
              f"{xor_schedule_op_count(st)} int32 ops per word position "
              f"-> {b:.6f} ms, by {b_by}")
        for name, t, h, nbytes in (
                ("XOR-schedule kernel (bytes)", t_x, h_x, moved),
                ("XOR-schedule kernel (packed)", t_xp, h_xp, moved),
                ("plain torch schedule (bytes)", t_pl, h_pl, moved),
                ("plain torch schedule (packed)", t_plp, h_plp, moved),
                (f"copy floor (clone of the {len(read)} chunks read)", t_cp,
                 h_cp, 2 * src.numel())):
            print(f"time {label}, {name}: {t:.6f} ms device, {h:.6f} ms "
                  f"host issue, {nbytes / t / 1e6:.3f} GB/s moved, "
                  f"{b / t:.4f} of bound")
        for name, k_t in (("XOR-schedule kernel (bytes)", k_x),
                          ("XOR-schedule kernel (packed)", k_xp),
                          ("dense kernel on the same matrix", k_dense)):
            print(f"time {label}, {name}, profiler device time per "
                  f"launch: "
                  + ("not measured (no kernel in the trace)" if k_t is None
                     else f"{k_t:.6f} ms, {b / k_t:.4f} of bound"))
    t_r6e, h_r6e = time_ms(lambda: r6.encode_chunks_torch(data), 50)
    t_lrd, h_lrd = time_ms(lambda: lrc.decode_chunks_torch(
        lrc_surv, lrc_avail, (0,)), 50)
    print(f"time r6 encode via encode_chunks_torch: {t_r6e:.6f} ms device, "
          f"{h_r6e:.6f} ms host issue; lrc repair (0,) via "
          f"decode_chunks_torch: {t_lrd:.6f} ms device, {h_lrd:.6f} ms "
          f"host issue")

    # the ragged kernel at the serving pool shape, 25 / 50 / 100 % live,
    # beside the dense kernel on the same bytes; its bound counts the
    # reads of live pages, the writes of every page and the integer work
    # of live pages
    k_dense_main = kernel_ms(lambda: apply_matrix_cuda(data, ms),
                             "gf_matrix_kernel")
    print("dense encode at the main shape, profiler device time per "
          "launch: " + ("not measured" if k_dense_main is None
                        else f"{k_dense_main:.6f} ms")
          + f", beside {EARLIER_DENSE_MS} ms for the chain per column "
          f"it replaced ({EARLIER_CARD})")
    rag_times = {}
    for share in (0.25, 0.5, 1.0):
        live = np.zeros(RAG_PAGES, np.uint8)
        live[rng.permutation(RAG_PAGES)[:int(RAG_PAGES * share)]] = 1
        mk = torch.from_numpy(live).to(dev)
        n_live = int(live.sum())
        b, b_by = bound_ms(analytic_kernel_cost(
            RAG_PAGES, M, K, PAGE, sm90_op_floor(ms), live=n_live))
        k_r = kernel_ms(lambda: apply_matrix_cuda_ragged(rag_pool, ms, mk),
                        "gf_matrix_kernel")
        k_rp = kernel_ms(lambda: apply_matrix_cuda_packed_ragged(
            rag_words, ms, mk), "gf_matrix_kernel")
        t_r, _ = time_ms(lambda: apply_matrix_cuda_ragged(rag_pool, ms, mk),
                         50)
        t_rpk, _ = time_ms(lambda: apply_matrix_cuda_packed_ragged(
            rag_words, ms, mk), 50)
        t_rp, _ = time_ms(lambda: apply_matrix_ragged_torch(rag_pool, ms,
                                                             mk), 5,
                          warmup=1)
        t_rpp, _ = time_ms(lambda: apply_matrix_packed_ragged_torch(
            rag_words, ms, mk), 5, warmup=1)
        rag_times[share] = (k_r or t_r, k_rp or t_rpk, t_rp, t_rpp, b, b_by)
        print(f"time ragged kernel, RS encode over ({RAG_PAGES}, {K}, "
              f"{PAGE}), {n_live} live pages ({share:.0%}): profiler "
              + ("not measured" if k_r is None else f"{k_r:.6f} ms")
              + " bytes, " + ("not measured" if k_rp is None
                              else f"{k_rp:.6f} ms") + " packed; events "
              f"{t_r:.6f} / {t_rpk:.6f} ms; plain {t_rp:.6f} / {t_rpp:.6f} "
              f"ms; bound {b:.6f} ms by {b_by}")
    k_pool_dense = kernel_ms(lambda: apply_matrix_cuda(rag_pool, ms),
                             "gf_matrix_kernel")
    pd_bound, pd_by = bound_ms(analytic_kernel_cost(
        RAG_PAGES, M, K, PAGE, sm90_op_floor(ms)))
    print(f"time dense kernel on the same ({RAG_PAGES}, {K}, {PAGE}) "
          f"bytes: profiler "
          + ("not measured" if k_pool_dense is None
             else f"{k_pool_dense:.6f} ms") + f"; bound {pd_bound:.6f} ms "
          f"by {pd_by}")

    # the host-to-device copy of one pool, as a fire makes it (pageable
    # numpy buffer, dead pages included)
    t0 = time.perf_counter()
    for _ in range(10):
        torch.from_numpy(rag_host).to(dev)
    torch.cuda.synchronize()
    t_copy_pool = (time.perf_counter() - t0) * 1e3 / 10
    print(f"time host-to-device copy of one {rag_host.nbytes} byte pool "
          f"({RAG_PAGES}, {K}, {PAGE}): {t_copy_pool:.6f} ms host clock, "
          f"{rag_host.nbytes / t_copy_pool / 1e6:.3f} GB/s")

    # the serving runs: GB/s, GB/s under SLO, p50/p99 per op, and the
    # mean service time of a fire (copy in, kernels, copy out, demux)
    for mode, run in serve_runs.items():
        rep = run.report
        fires = {(res.completed, res.service) for res in run.results}
        mean_fire = sum(sv for _, sv in fires) / len(fires) * 1e3
        per_op = "; ".join(
            f"{op} {row['requests']} req p50 {row['p50_ms']} ms p99 "
            f"{row['p99_ms']} ms miss {row['deadline_miss_rate']}"
            for op, row in sorted(rep["op_classes"].items()))
        print(f"serving {mode}: {rep['requests']} requests, {rep['bytes']} "
              f"bytes in {rep['elapsed_s']} s: {rep['gbps']} GB/s, "
              f"{rep['gbps_under_slo']} GB/s under SLO, p50 "
              f"{rep['p50_ms']} ms, p99 {rep['p99_ms']} ms; {len(fires)} "
              f"fires, mean service {mean_fire:.6f} ms; {per_op}")

    # where a fire's time goes: 16 RS k=8 m=3 1 MiB encodes, staged into
    # a full pool of the paged run's warm queue and stacked at rung 16 in
    # the dense run's warm bucket, each step of the fire timed on its own
    # (host clock, synchronised): copy in, the call, copy out, demux
    rs_1m = serving_spec(True).codecs[1]
    staged = [EcRequest(op="encode", plugin=rs_1m.plugin,
                        profile=rs_1m.profile, stripe_size=rs_1m.stripe_size,
                        payload=rng.integers(0, 256, (K, CHUNK),
                                             dtype=np.uint8), req_id=i)
              for i in range(16)]
    q = serve_runs["paged"].batcher._queue_for(staged[0])
    for r in staged:
        q.pool.write(r.req_id, r.payload)
    check(q.pool.free_pages() == 0, "16 x 1 MiB fill the pool")
    page_mask = q.pool.mask()
    pcall = serve_dispatch_ragged(q.ec, "encode", pages=q.pool.pages,
                                  page_size=q.page_size)
    bk = serve_runs["dense"].batcher._bucket_for(staged[0])
    stack = np.stack([r.payload for r in staged])
    dcall = serve_dispatch_call(bk.ec, "encode")
    anatomy = {}
    for mode in ("paged", "dense"):
        steps = {"copy in": 0.0, "call": 0.0, "copy out": 0.0,
                 "demux": 0.0}
        reps = 5
        for rep in range(reps + 1):
            t = [time.perf_counter()]
            if mode == "paged":
                args = (torch.from_numpy(q.pool.buf).to(dev),
                        torch.from_numpy(page_mask).to(dev))
                call = pcall
            else:
                args = (torch.from_numpy(stack).to(dev),)
                call = dcall
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            out = call(*args)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            host_out = out.cpu().numpy()
            t.append(time.perf_counter())
            got = ([q.pool.read(r.req_id, host_out) for r in staged]
                   if mode == "paged" else list(host_out))
            t.append(time.perf_counter())
            if rep == 0:
                continue           # the first round warms the allocator
            for name, a, b in zip(steps, t, t[1:]):
                steps[name] += (b - a) * 1e3 / reps
        anatomy[mode] = (steps, got, kernel_ms(lambda: call(*args),
                                               "gf_matrix_kernel"))
    check(all(np.array_equal(a, b) for a, b in zip(anatomy["paged"][1],
                                                   anatomy["dense"][1])),
          "paged and dense fires give the same parity")
    for r in staged:
        q.pool.reclaim(r.req_id)
    for mode, (steps, _, k_t) in anatomy.items():
        print(f"serving {mode}, where a fire's time goes (16 x 1 MiB RS "
              f"encodes, " + ("a full pool of 512 pages" if mode == "paged"
                              else "rung 16") + "): "
              + ", ".join(f"{n} {v:.6f} ms" for n, v in steps.items())
              + f", total {sum(steps.values()):.6f} ms; the kernels' "
              f"profiler time in the call "
              + ("not measured" if k_t is None else f"{k_t:.6f} ms"))

    # the column-walk kernel on the clay matrices, beside the dense kernel
    # on the same matrices and the library GEMM (torch._int_mm, else a
    # bf16 matmul) on the materialised bit-planes.  Its bound is the
    # function's: the same GF(2^8) matrix apply the dense kernel bounds,
    # the bytes or sm90_op_floor at the INT32 peak, the larger; the dense
    # GEMM over the whole bitmatrix at the int8 tensor-core peak (the
    # reference MXU form's cost) is printed beside it as the GEMM bound.
    # The (8,) repair routes to the dense kernel; the walk is timed on it
    # too.  "earlier" is the bit-plane kernel this one replaced (a constant
    # from its last run, printed beside this run's times).  A shape whose
    # blocks fill less than a wave splits its columns; the same matrix at
    # BATCH stripes, which takes no split, is timed beside it.
    def planes_of(x):
        """(b, s, C) uint8 -> (8s, b*C) int8 LSB-first bit-planes."""
        b_, s_, c_ = x.shape
        pl = torch.arange(8, dtype=torch.uint8, device=dev)
        bits = (x[:, :, None, :] >> pl[:, None]) & 1
        return bits.reshape(b_, 8 * s_, c_).permute(1, 0, 2).reshape(
            8 * s_, b_ * c_).to(torch.int8).contiguous()

    def library_gemm(bm, xp):
        try:
            torch._int_mm(bm, xp)
            return (lambda: torch._int_mm(bm, xp)), "torch._int_mm"
        except RuntimeError:
            bf, xf = bm.to(torch.bfloat16), xp.to(torch.bfloat16)
            return (lambda: torch.matmul(bf, xf)), "torch.matmul bf16"

    rep_e, rep_dm, rep_ms, rep_avail = big[0]
    rep_x = clay_full[:, list(rep_avail)].reshape(DECODE_BATCH, 704, sc)
    mxu_times = {}
    for label, x, mat_s in (
            ("clay encode", clay_x, clay_enc_ms),
            ("clay decode (0,)", dec_x, clay_dec_ms),
            (f"clay repair ({rep_e},)", rep_x, rep_ms)):
        r_, s_ = len(mat_s), len(mat_s[0])
        b_, _, c_ = x.shape
        xw = pack_chunks(x)
        z_m = walk_splits(b_, c_, mat_s, dev)
        k_m = kernel_ms(lambda: apply_matrix_mxu_cuda(x, mat_s),
                        walk_kernels(z_m))
        k_mp = kernel_ms(lambda: apply_matrix_mxu_cuda_packed(xw, mat_s),
                         walk_kernels(z_m))
        k_m1 = None
        if z_m > 1:
            xb = x.repeat(BATCH // b_, 1, 1)
            check(walk_splits(BATCH, c_, mat_s, dev) == 1,
                  f"{label} at {BATCH} stripes takes no column split")
            k_m1 = kernel_ms(lambda: apply_matrix_mxu_cuda(xb, mat_s),
                             walk_kernels(1))
            del xb
        t_m, h_m = time_ms(lambda: apply_matrix_mxu_cuda(x, mat_s), 10)
        t_pl, h_pl = time_ms(lambda: apply_matrix_walk_torch(
            x, walk_data(mat_s), r_), 1, warmup=1)
        k_d = kernel_ms(lambda: apply_matrix_cuda(x, mat_s), "gf_matrix",
                        iters=5)
        bm_host = mxu_bitmatrix(mat_s)
        bm = torch.from_numpy(bm_host.astype(np.int8)).to(dev)
        lib_fn, lib_name = library_gemm(bm, planes_of(x))
        k_lib = kernel_ms(lib_fn, "", iters=5)
        fn_ops = sm90_op_floor(mat_s)
        moved_x = b_ * (s_ + r_) * c_
        b, b_by = bound_ms(analytic_walk_cost(b_, r_, s_, c_, fn_ops))
        gemm_ops = 2 * (8 * r_) * (8 * s_) * b_ * c_
        # the dense GEMM: 2 x (8r) x (8s) int8 operations a byte column,
        # 512 r s a 32-bit word position
        gemm_b, _ = bound_ms(analytic_kernel_cost(b_, r_, s_, c_,
                                                  512 * r_ * s_),
                             INT8_OPS_PER_S)
        mxu_times[label] = (k_m or t_m, k_mp or t_m, t_pl, b, b_by, k_lib,
                            k_d, gemm_b)
        wd = walk_data(mat_s)
        print(f"bound of the {label} {tuple(x.shape)} -> {r_} rows: "
              f"{moved_x} bytes moved, {fn_ops} int32 ops per word position "
              f"x {b_ * c_ // 4} word positions -> {b:.6f} ms, by {b_by}; "
              f"as a dense GEMM {gemm_ops} int8 operations -> "
              f"{gemm_b:.6f} ms ({np.count_nonzero(mat_s)} nonzero of "
              f"{r_ * s_} coefficients; column-walk data {wd.size * 4} "
              f"bytes, {int(wd[0])} row tile(s), "
              f"{int(np.count_nonzero(np.asarray(mat_s).any(axis=0)))} "
              f"nonzero columns; {int(bm_host.sum())} ones of the "
              f"bitmatrix)")
        for name, k_t in (
                (f"column-walk kernel (bytes, {z_m} column splits)", k_m),
                ("column-walk kernel (packed)", k_mp),
                ("dense kernel on the same matrix", k_d),
                (f"{lib_name} on the materialised planes", k_lib)):
            print(f"time {label}, {name}, profiler device time per call: "
                  + ("not measured" if k_t is None
                     else f"{k_t:.6f} ms, {b / k_t:.4f} of bound, "
                          f"{gemm_b / k_t:.4f} of the GEMM bound"))
        if z_m > 1:
            print(f"time {label} at {BATCH} stripes, column-walk kernel "
                  f"(bytes, no column split), profiler device time per "
                  f"call: " + ("not measured" if k_m1 is None else
                               f"{k_m1:.6f} ms, {k_m1 * b_ / BATCH:.6f} ms "
                               f"per {b_} stripes"))
        print(f"time {label}, column-walk kernel events {t_m:.6f} ms "
              f"device, {h_m:.6f} ms host issue; plain walk {t_pl:.6f} ms; "
              f"earlier (the bit-plane kernel, {EARLIER_CARD}) "
              f"{EARLIER_MXU_MS[label]} ms")
    # the host's issue time per call through the entry points a user
    # calls (the engine table, the kernel-data caches, the launch)
    rep_surv = clay_full[:, list(rep_avail)]
    dec_surv = clay_full[:, list(a1_clay)]
    for name, fn in (
            ("encode_chunks_torch (64 x 1 MiB)",
             lambda: clay.encode_chunks_torch(clay_data)),
            ("decode_chunks_torch (0,) (4 stripes)",
             lambda: clay.decode_chunks_torch(dec_surv, a1_clay, e1_clay)),
            (f"decode_chunks_torch ({rep_e},) (4 stripes)",
             lambda: clay.decode_chunks_torch(rep_surv, rep_avail,
                                              (rep_e,)))):
        t_e, h_e = time_ms(fn, 20)
        print(f"time clay {name}: {t_e:.6f} ms device, {h_e:.6f} ms host "
              f"issue per call")
    for what, sec in clay_probe_s.items():
        print(f"time clay composite probe, {what}: {sec:.6f} s host clock")

    # the roofline probes' kernels on one 64 MiB slab.  The copy kernel
    # beside copy_ into a buffer allocated once (the library copy) and
    # clone (copy_ into a fresh tensor, as the wrapper allocates its
    # output), in turns: copy_, clone, kernel, kernel, clone, copy_
    copy_buf = torch.empty_like(slab.view(torch.int32))
    copies = {"copy_": (lambda: copy_buf.copy_(slab.view(torch.int32)), ""),
              "clone": (lambda: slab.view(torch.int32).clone(), ""),
              "copy kernel": (lambda: copy_slab_cuda(slab), "probe_copy")}
    turns = {name: [] for name in copies}
    for name in ("copy_", "clone", "copy kernel", "copy kernel", "clone",
                 "copy_"):
        turns[name].append(kernel_ms(*copies[name], iters=50))
    for name, ts in turns.items():
        print(f"time {name} on {tuple(slab.shape)}, profiler ms in turns: "
              + ", ".join("not measured" if t is None else f"{t:.6f}"
                          for t in ts))
    k_copy, k_copy_lib, k_clone = (
        None if None in turns[n] else sum(turns[n]) / len(turns[n])
        for n in ("copy kernel", "copy_", "clone"))
    k_fold = kernel_ms(lambda: fold_slab_cuda(slab), "probe_fold")
    t_copy, _ = time_ms(lambda: copy_slab_cuda(slab), 10)
    t_fold, _ = time_ms(lambda: fold_slab_cuda(slab), 10)
    t_copy_pl, _ = time_ms(lambda: copy_slab_torch(slab), 10)
    t_fold_pl, _ = time_ms(lambda: fold_slab_torch(slab), 10)
    # the copy: one slab in, one out; the fold: K slices in, one out,
    # K - 1 XORs a word position
    copy_b, copy_by = bound_ms(analytic_kernel_cost(1, 1, 1,
                                                    slab.numel() * 4, 0))
    fold_b, fold_by = bound_ms(analytic_kernel_cost(
        1, 1, K, slab.numel() * 4 // K, K - 1))
    for name, k_t, b in (("copy kernel", k_copy, copy_b),
                         ("fold kernel", k_fold, fold_b),
                         ("copy_ (the library copy)", k_copy_lib, copy_b),
                         ("clone (copy_ into a fresh tensor)", k_clone,
                          copy_b)):
        moved = 2 * slab.numel() * 4 if "copy" in name \
            else slab.numel() * 4 * (K + 1) // K
        print(f"time {name} on {tuple(slab.shape)}: "
              + ("not measured" if k_t is None else
                 f"{k_t:.6f} ms, {moved / k_t / 1e6:.3f} GB/s moved, "
                 f"{b / k_t:.4f} of bound"))

    # each kernel's "ms" is its own device time per launch from the
    # profiler (the event times above include the host's issue pace where
    # that is the slower); the event time where the trace has no kernel
    w16 = word_data[16][1]
    w16_ms = matrix_to_static(wide_codes[16].matrix)
    prof = {name: kernel_ms(fn, kernel) for name, fn, kernel in (
        ("apply_matrix_cuda", lambda: apply_matrix_cuda(data, ms),
         "gf_matrix_kernel"),
        ("apply_matrix_cuda_packed",
         lambda: apply_matrix_cuda_packed(words, ms), "gf_matrix_kernel"),
        ("apply_matrix_cuda_words",
         lambda: apply_matrix_cuda_words(w16, w16_ms, 16),
         "gf_matrix_kernel"),
        ("apply_bitmatrix_cuda",
         lambda: apply_bitmatrix_cuda(data, rows, 8, PACKETSIZE),
         "gf2_packet_kernel"),
        ("apply_bitmatrix_xor_cuda", lambda: apply_bitmatrix_xor_cuda(
            data, enc_sched.static, 8, PACKETSIZE), "gf2_packet_kernel"))}
    for name, k_t in prof.items():
        print(f"time {name} at its main shape, profiler device time per "
              f"launch: " + ("not measured (no kernel in the trace)"
                             if k_t is None else f"{k_t:.6f} ms"))
    kernels = []
    for name, t, tp, b, b_by, source, line in (
            ("apply_matrix_cuda", prof["apply_matrix_cuda"] or t_bytes,
             t_plain, bound, bound_by, "gf8_matrix.cu", 195),
            ("apply_matrix_cuda_packed",
             prof["apply_matrix_cuda_packed"] or t_packed, t_plain_packed,
             bound, bound_by, "gf8_matrix.cu", 350),
            ("apply_matrix_cuda_words",
             prof["apply_matrix_cuda_words"] or word_times[16][0],
             word_times[16][2], word_times[16][4], word_times[16][5],
             "gf8_matrix.cu", 283),
            ("apply_bitmatrix_cuda", prof["apply_bitmatrix_cuda"] or t_bm,
             t_bm_plain, bm_bound, bm_by, "gf2_bitmatrix.cu", 559),
            ("apply_bitmatrix_xor_cuda",
             prof["apply_bitmatrix_xor_cuda"] or t_xs, t_xs_plain, xs_bound,
             xs_by, "gf2_bitmatrix.cu", 782),
            ("apply_matrix_xor_cuda", xor_times["r6 encode"][0],
             xor_times["r6 encode"][2], xor_times["r6 encode"][4],
             xor_times["r6 encode"][5], "gf8_xor_schedule.cu", 623),
            ("apply_matrix_xor_cuda_packed", xor_times["r6 encode"][1],
             xor_times["r6 encode"][3], xor_times["r6 encode"][4],
             xor_times["r6 encode"][5], "gf8_xor_schedule.cu", 664),
            ("apply_matrix_cuda_ragged", rag_times[0.5][0], rag_times[0.5][2],
             rag_times[0.5][4], rag_times[0.5][5], "gf8_matrix.cu", 1253),
            ("apply_matrix_cuda_packed_ragged", rag_times[0.5][1],
             rag_times[0.5][3], rag_times[0.5][4], rag_times[0.5][5],
             "gf8_matrix.cu", 1294)):
        kernels.append({
            "name": name, "route": "cuda", "source": SRC + source,
            "replaces": f"ceph_tpu/ops/pallas_gf.py:{line}",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": t, "plain_ms": tp, "bound_ms": b, "bound_by": b_by,
            "library_ms": None, "ok": True})
    enc_t = mxu_times["clay encode"]
    for name, t, tp, b, b_by, lib_t, source, replaces in (
            ("apply_matrix_mxu_cuda", enc_t[0], enc_t[2], enc_t[3],
             enc_t[4], enc_t[5], "gf8_column_walk.cu",
             "ceph_tpu/ops/xla_ops.py:241"),
            ("apply_matrix_mxu_cuda_packed", enc_t[1], enc_t[2], enc_t[3],
             enc_t[4], enc_t[5], "gf8_column_walk.cu",
             "ceph_tpu/ops/xla_ops.py:241"),
            ("copy_slab_cuda", k_copy or t_copy, t_copy_pl, copy_b,
             copy_by, k_copy_lib, "roofline_probes.cu",
             "tools/roofline.py:79"),
            ("fold_slab_cuda", k_fold or t_fold, t_fold_pl, fold_b,
             fold_by, None, "roofline_probes.cu", "tools/roofline.py:106")):
        kernels.append({
            "name": name, "route": "cuda", "source": SRC + source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": t, "plain_ms": tp,
            "bound_ms": b, "bound_by": b_by, "library_ms": lib_t,
            "ok": True})
    phase_done(4)

    def phase_line(n: int, key: str, blob: dict) -> dict:
        phase_done(n)
        blob["seconds"] = phase_s[n]
        print(json.dumps({key: blob}))
        return blob

    # -- phase 5: the bench line's rows and the corpus, on the card ---------
    bench = phase_line(5, "bench", bench_phase(kernel_ms))
    # -- phase 6: CRUSH on the card ------------------------------------------
    crush = phase_line(6, "crush", crush_phase(seed, err))
    kern = crush["kernel"]
    kernels.append({
        "name": "crush_rule_cuda", "route": "cuda",
        "source": SRC + "crush_rule.cu", "replaces": None,
        "launches": crush["kernel_launches"],
        "max_abs_err": err["crush_rule_cuda"],
        "ms": kern["kernel_ms"] or kern["kernel_event_ms"],
        "plain_ms": kern["eager_device_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": "operations", "library_ms": None, "ok": True})
    # -- phase 7: scrub -> repair -> recover on the card ---------------------
    phase_line(7, "recovery", recovery_phase(seed))
    # -- phase 8: the supervised dispatch plane on the card ------------------
    phase_line(8, "supervisor", supervisor_phase(seed))
    # -- phase 9: the data plane on the card ---------------------------------
    phase_line(9, "data_plane", data_plane_phase(seed))
    # -- phase 10: the profiler, the tuning table, the registry audit -----
    phase_line(10, "profiler", profiler_phase(seed))
    # -- phase 11: the cluster plane and the scenarios -------------------
    phase_line(11, "cluster_scenario", cluster_scenario_phase(seed))
    # -- phase 12: the repo-root tools and demos -------------------------
    phase_line(12, "tools", tools_phase(seed, err, crush["A"], bench))
    # -- phase 13: plugin=cuda, the native bridge, and the lint tiers ----
    phase_line(13, "bridge", bridge_phase(err))
    print(json.dumps({"phase_seconds": phase_s,
                      "total_s": sum(phase_s.values())}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
