"""The bounded declarative config space the autotuner sweeps — a port
of ``ceph_tpu/tune/space.py``.

One dict per tunable *kind*: parameter name -> the candidate tuple, in
deterministic sweep order.  Bounded by construction — the sweep cost
is the cartesian product of a kind's candidate lists, and every list
here is a handful of values bracketing today's hand-picked constant
(which is always a candidate, so the sweep can never do worse than
the status quo on its own model).

The kinds map 1:1 onto the consultation seams:

======================  ================================================
kind                    consulted by
======================  ================================================
``engine-select``       ops/gf_kernels.py::select_matrix_engine (the
                        mxu row's nonzero cutover) + ops/xor_schedule.py::
                        preferred_schedule (the XOR/dense cutover)
``xor-schedule``        ops/xor_schedule.py greedy-CSE candidate
                        horizon (CSE_TOPK)
``serve-ladder``        serve/batcher.py::ContinuousBatcher (the batch
                        rung ladder)
``stripe-pool``         serve/pool.py::tuned_pool_config (paged-mode
                        page size + pool page count)
``ragged-cutover``      ops/gf_kernels.py::tuned_ragged_cutover (min
                        pool pages before the page-skipping kernel
                        beats mask-multiply + the dense tier)
``mesh-fanout``         parallel/plane.py::_build_plane (auto-plane
                        shard fan-out width)
``matrix-engine``       select_matrix_engine per-matrix tier pin
                        (profile slot = ``m:<matrix digest>``)
======================  ================================================

Two deliberate differences from the reference.  ``row-tile`` is gone:
its cap is a TPU VMEM fact, and the dense kernel's grid
(``gf_kernels.dense_plan``) takes no such knob.  ``matrix-engine``
names the port's tiers: ``xor`` (the XOR-schedule kernel), ``mxu`` (the
column walk), ``cuda`` (the dense kernel; the reference's ``pallas``)
and ``torch`` (the plain torch tier, CPU tensors only; the reference's
``xla``).

Pure data plus a couple of accessors, so the host-only analytic sweep
and the audit tooling import it anywhere.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, Tuple

# the hand-picked defaults the candidates bracket (duplicated here as
# DATA so this module stays import-light; tests/test_torch_tune.py
# holds them to the live constants, so drift fails a test, not a user)
DEFAULTS: Dict[str, dict] = {
    "engine-select": {"mxu_matrix_min": 2048, "xor_cutover": (3, 4)},
    "xor-schedule": {"cse_topk": 128},
    "serve-ladder": {"ladder": (1, 4, 16, 64)},
    "stripe-pool": {"page_size": 512, "pool_pages": 64},
    "ragged-cutover": {"min_pages": 2},
    "mesh-fanout": {"n_devices": 0},      # 0 = every visible device
    "matrix-engine": {"engine": None},    # None = the heuristic table
}

SPACES: Dict[str, Dict[str, Tuple]] = {
    # mxu cutover (nonzeros above which a composite rides the column
    # walk)
    # x the XOR/dense cutover ratio (schedule must undercut num/den of
    # the dense model's op count)
    "engine-select": {"mxu_matrix_min": (1024, 2048, 4096),
                      "xor_cutover": ((1, 2), (3, 4), (7, 8))},
    # greedy-CSE candidate horizon: wider scans find more sharing,
    # cost more scheduler time (bounded either way)
    "xor-schedule": {"cse_topk": (64, 128, 256)},
    # batch rung ladders: |ladder| programs per bucket vs padding waste
    "serve-ladder": {"ladder": ((1, 4, 16, 64),
                                (1, 8, 64),
                                (1, 2, 8, 32),
                                (1, 4, 16, 64, 256))},
    # paged-pool geometry: smaller pages cut tail padding, cost more
    # page-table entries; more pages co-batch more before a fire but
    # grow the device-resident pool (pages * rows * page_size per queue)
    "stripe-pool": {"page_size": (256, 512, 1024),
                    "pool_pages": (32, 64, 128)},
    # pool page count above which the page-skipping kernel beats
    # mask-multiply feeding the dense tier
    "ragged-cutover": {"min_pages": (1, 2, 8)},
    # auto-plane shard fan-out width (capped at the visible devices)
    "mesh-fanout": {"n_devices": (1, 2, 4, 8)},
    # per-matrix engine-tier pin: every tier is byte-identical by
    # construction, so pinning the measured winner is always safe
    "matrix-engine": {"engine": ("xor", "mxu", "cuda", "torch")},
}


def kinds() -> List[str]:
    return sorted(SPACES)


def space(kind: str) -> Dict[str, Tuple]:
    if kind not in SPACES:
        raise KeyError(f"unknown tuning kind {kind!r} "
                       f"(kinds: {kinds()})")
    return dict(SPACES[kind])


def default_config(kind: str) -> dict:
    if kind not in DEFAULTS:
        raise KeyError(f"unknown tuning kind {kind!r}")
    return dict(DEFAULTS[kind])


def candidates(kind: str) -> Iterable[dict]:
    """Deterministic cartesian product of a kind's candidate lists —
    the bounded sweep order every mode shares."""
    sp = space(kind)
    names = sorted(sp)
    for combo in itertools.product(*(sp[n] for n in names)):
        yield dict(zip(names, combo))


def n_candidates(kind: str) -> int:
    out = 1
    for vals in space(kind).values():
        out *= len(vals)
    return out


__all__ = ["DEFAULTS", "SPACES", "candidates", "default_config",
           "kinds", "n_candidates", "space"]
