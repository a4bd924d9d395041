"""Profiler-driven config search — the two sweep modes; a port of
``ceph_tpu/tune/sweep.py``.

The tuner owns no measurement machinery of its own: it reuses the two
modes the program profiler (telemetry/profiler.py) owns —

- **analytic** (``analytic_sweep``): the GF(2^8) cost models priced
  through a roofline — modeled time = max(memory time, op time at the
  tier's modeled op rate) — with no device touched, so it runs anywhere
  and inside the ``tune.sweep`` host-tier audit entry.  Deterministic
  given the seed.  The ``"cpu"`` model constants are the reference's
  (so the CPU tables equal the reference's, ``row-tile`` aside); the
  ``"cuda"`` ones are the card's (below).
- **timed** (``timed_sweep``): real dispatches of every candidate tier
  the device can run — on the card the dense kernel (``cuda``), the
  XOR-schedule kernel (``xor``, where the probe finds a schedule that
  fits the kernel) and the column walk (``mxu``); on a CPU device the
  torch tier alone — each the min of N device times read with CUDA
  events after a warm-up, with the stream held busy so a pair reads the
  kernels, not the host's issue.  Byte identity with the default tier's
  output is asserted in the sweep: a mismatch raises, and so does a
  kernel that fails to build or launch.

Both modes emit **before/after rows through
``ProgramProfiler.attribution_rows()``** and persist winners in a
:class:`~ceph_tpu_torch.tune.table.BestConfigTable` (tune/table.py)
keyed per (plugin profile, pattern kind, engine tier, layout,
device_count, batch rung).  The work-unit corpus comes from the
registry's representative profiles (analysis/entrypoints.py).

No ``row-tile`` step: its cap is a TPU VMEM fact and the dense kernel's
grid takes no such knob (tune/space.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..telemetry.profiler import (CARD_INT32_OPS_PER_S, H100,
                                  ProgramProfiler, analytic_matrix_cost,
                                  analytic_xor_schedule_cost,
                                  resolve_peak_gbps)
from . import space as tspace
from .table import (BestConfigTable, current_env, key_str, matrix_digest,
                    profile_str, tuning_key, validate_table)

# ----------------------------------------------------------------------
# the roofline model's op-rate constants (G byte-ops/s).  These are
# MODEL constants, not kernel claims: the sweep only ever compares
# candidates under ONE consistent model, so the decisions depend on the
# ratios.  Override with the env knobs.
#
# "cpu": the reference's.  "cuda": the NVIDIA H100 80GB HBM3 (700 W
# power limit) of PERF.md §3 and §6 — its INT32 peak, 132 SMs x 64
# lanes x 1.98 GHz = 16.7 Tops/s, an op on 4 bytes (66908 G byte-ops/s),
# times each kernel's measured share of its bound at the north-star
# shape: the dense kernel 0.027545 / 0.041319 ms (VPU_BYTE_GOPS), the
# XOR-schedule kernel on the r6 encode 0.025041 / 0.046222 ms
# (XOR_BYTE_GOPS), the column walk on clay's encode 0.033338 / 0.225564
# ms (MXU_BYTE_GOPS, in the dense model's op count: the walk's bound is
# the function's, sm90_op_floor).  On "cuda" every tier is priced in
# the dense model's op count, so a kernel's share is the only thing
# that tells two tiers apart, as on the card.
CARD_BYTE_GOPS = 4 * CARD_INT32_OPS_PER_S[H100] / 1e9
VPU_BYTE_GOPS: Dict[str, float] = {
    "cpu": 512.0, "cuda": CARD_BYTE_GOPS * 0.027545 / 0.041319}
XOR_BYTE_GOPS: Dict[str, float] = {
    "cpu": 512.0, "cuda": CARD_BYTE_GOPS * 0.025041 / 0.046222}
MXU_BYTE_GOPS: Dict[str, float] = {
    "cpu": 4096.0, "cuda": CARD_BYTE_GOPS * 0.033338 / 0.225564}
# the plain torch tier materializes doubling planes between ops —
# modeled as an op-rate penalty (the reference's XLA penalty)
TORCH_DENSE_PENALTY = 2.0
# modeled per-dispatch overhead (the mesh fan-out model)
DISPATCH_OVH_S = 2e-4


def _env_float(knob: str, default: float) -> float:
    try:
        return float(os.environ.get(knob, "") or default)
    except ValueError:
        return default


def vpu_gops(platform: str) -> float:
    return _env_float("CEPH_TPU_TUNE_VPU_GOPS",
                      VPU_BYTE_GOPS.get(platform, 512.0))


def xor_gops(platform: str) -> float:
    return _env_float("CEPH_TPU_TUNE_VPU_GOPS",
                      XOR_BYTE_GOPS.get(platform, 512.0))


def mxu_gops(platform: str) -> float:
    return _env_float("CEPH_TPU_TUNE_MXU_GOPS",
                      MXU_BYTE_GOPS.get(platform, 4096.0))


def modeled_time_s(ops: float, bytes_accessed: float, peak_gbps: float,
                   gops: float) -> float:
    """Roofline: the program takes the longer of its memory stream and
    its op stream."""
    return max(bytes_accessed / (peak_gbps * 1e9), ops / (gops * 1e9))


# ----------------------------------------------------------------------
# the work-unit corpus (from the registry's representative profiles —
# every tuned row names an audited entry-point family)

@dataclasses.dataclass(frozen=True)
class WorkUnit:
    """One tunable program family: a static matrix + its workload
    coordinates (the same slots the tuning key speaks)."""
    name: str              # "jerasure.decode_chunks_jax" style
    profile: str           # tune.table.profile_str form
    kind: str              # "serve-encode" | "serve-decode"
    matrix: tuple          # the static (r, s) GF(2^8) matrix
    chunk: int
    batch: int


def _corpus_instance(family: str):
    """A corpus plugin instance on the CPU pinned to the host tier (the
    analytic sweep touches no device; the impulse probes underneath are
    tiny and ride the numpy tier anyway)."""
    from ..analysis.entrypoints import REPRESENTATIVE_PROFILES
    from ..codes.registry import ErasureCodePluginRegistry
    plugin, profile = REPRESENTATIVE_PROFILES[family]
    ec = ErasureCodePluginRegistry.instance().factory(
        plugin, dict(profile), device="cpu")
    ec.min_xla_bytes = float("inf")
    return ec, plugin, profile


def corpus(families: Sequence[str] = ("jerasure", "shec", "lrc",
                                      "clay"),
           chunk: int = 4096, batch: int = 16) -> List[WorkUnit]:
    """Representative work units: each family's encode matrix and its
    single-erasure decode matrix (the patterns the audit registry's
    builders exercise).  Families whose matrix surfaces are not
    probeable host-side are skipped loudly (returned corpus is still
    deterministic)."""
    from ..codes.engine import decode_matrix_static
    from ..ops.torch_ops import matrix_to_static
    units: List[WorkUnit] = []
    for family in families:
        try:
            ec, plugin, profile = _corpus_instance(family)
        except Exception:  # noqa: BLE001 — a missing family shrinks
            continue       # the corpus, never kills the sweep
        prof = profile_str(plugin, profile)
        enc = getattr(ec, "matrix", None)
        if enc is None:
            probe = getattr(ec, "_probe_encode_matrix", None)
            if probe is not None:
                try:
                    out = probe()
                    enc = out[0] if isinstance(out, tuple) else out
                except Exception:  # noqa: BLE001
                    enc = None
        if enc is not None and getattr(ec, "w", 8) == 8:
            units.append(WorkUnit(
                name=f"{family}.encode_chunks_jax", profile=prof,
                kind="serve-encode", matrix=matrix_to_static(enc),
                chunk=chunk, batch=batch))
        n = ec.get_chunk_count()
        available = tuple(i for i in range(n) if i != 1)
        try:
            ms = decode_matrix_static(ec, available, (1,))
        except Exception:  # noqa: BLE001
            ms = None
        if ms is not None:
            units.append(WorkUnit(
                name=f"{family}.decode_chunks_jax", profile=prof,
                kind="serve-decode", matrix=ms, chunk=chunk,
                batch=batch))
    return units


# ----------------------------------------------------------------------
# per-tier cost model (the analytic side of the matrix-engine sweep)

def _fits_xor(matrix: tuple) -> bool:
    """The xor row's conditions on a matrix: the probe finds a schedule
    and its program fits the XOR-schedule kernel
    (``gf_kernels.xor_program_fits``)."""
    from ..ops.gf_kernels import xor_program_fits
    from ..ops.xor_schedule import probe_schedule
    sched = probe_schedule(matrix, 8)
    return sched is not None and xor_program_fits(sched.static)


def tier_cost(matrix: tuple, tier: str, batch: int, chunk: int,
              platform: str,
              topk: Optional[int] = None
              ) -> Optional[Tuple[float, float, float]]:
    """(ops, bytes_accessed, gops) for one tier running one matrix, or
    None when the tier cannot run it.  ops/bytes speak the profiler's
    analytic-model currency, gops the tier's modeled op rate.  On
    "cuda" every tier is priced in the dense model's op count (the
    function's work) at its kernel's measured rate; ``torch`` runs only
    off the card."""
    from ..ops.xor_schedule import build_schedule, dense_vpu_cost
    r, s = len(matrix), len(matrix[0])
    bytes_acc = analytic_matrix_cost(batch, r, s, chunk)[
        "bytes accessed"]
    dense_ops = float(dense_vpu_cost(matrix)) * chunk * batch
    if tier == "xor":
        from ..ops.xor_schedule import probe_schedule
        sched = probe_schedule(matrix, 8)
        if sched is None or not _fits_xor(matrix):
            return None
        if topk is not None:
            sched = build_schedule(matrix, 8, topk=topk)
        if platform == "cuda":
            return dense_ops, bytes_acc, xor_gops(platform)
        ops = analytic_xor_schedule_cost(batch, r, s, chunk,
                                         sched.vpu_ops)["flops"]
        return ops, bytes_acc, xor_gops(platform)
    if tier == "mxu":
        if platform == "cuda":
            return dense_ops, bytes_acc, mxu_gops(platform)
        # the bit-sliced GF(2) matmul: an (8r x 8s) contraction per
        # byte — 2*64*r*s ops/byte at the MXU's modeled rate
        ops = 2.0 * 64 * r * s * chunk * batch
        return ops, bytes_acc, mxu_gops(platform)
    if tier == "cuda":
        return dense_ops, bytes_acc, vpu_gops(platform)
    if tier == "torch" and platform != "cuda":
        return dense_ops, bytes_acc, vpu_gops(platform) / TORCH_DENSE_PENALTY
    return None


def heuristic_tier(matrix: tuple, platform: str,
                   mxu_min: Optional[int] = None,
                   cutover: Optional[Tuple[int, int]] = None) -> str:
    """The tier today's hand-picked heuristics route ``matrix`` to on
    ``platform`` — the sweep's baseline (mirrors select_matrix_engine's
    xor/mxu/cuda/torch rows under an explicit threshold override)."""
    from ..ops.gf_kernels import MXU_MATRIX_MIN
    from ..ops.xor_schedule import XOR_DENSE_CUTOVER, probe_schedule
    mxu_min = MXU_MATRIX_MIN if mxu_min is None else mxu_min
    num, den = XOR_DENSE_CUTOVER if cutover is None else cutover
    nnz = sum(1 for row in matrix for v in row if v)
    sched = probe_schedule(matrix, 8)
    if sched is not None and sched.vpu_ops * den <= num * sched.dense_vpu_ops \
            and _fits_xor(matrix):
        if not (nnz >= mxu_min and sched.vpu_ops >= nnz):
            return "xor"
    if platform == "cuda":
        return "mxu" if nnz >= mxu_min else "cuda"
    return "torch"


# ----------------------------------------------------------------------
# the sweep report

@dataclasses.dataclass
class SweepReport:
    """One sweep's output: the best-config table plus the before/after
    utilization rows (the instrument's own attribution rows underneath
    in ``attribution``)."""
    mode: str
    seed: int
    platform: str
    device_count: int
    table: BestConfigTable
    rows: List[dict] = dataclasses.field(default_factory=list)
    attribution: List[dict] = dataclasses.field(default_factory=list)
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def improved(self) -> List[dict]:
        return [r for r in self.rows
                if (r.get("improvement_pct") or 0) > 0]

    def headline(self) -> Optional[dict]:
        """The most-improved row (the bench autotune row's payload)."""
        rows = self.improved
        if not rows:
            return None
        return max(rows, key=lambda r: (r["improvement_pct"], r["name"]))

    def to_dict(self) -> dict:
        errors = validate_table(self.table.to_dict())
        return {
            "mode": self.mode,
            "seed": self.seed,
            "platform": self.platform,
            "device_count": self.device_count,
            "tuned_keys": sorted(self.table.entries),
            "table": self.table.to_dict(),
            "table_valid": not errors,
            "rows": self.rows,
            "attribution": self.attribution,
            "notes": sorted(self.notes),
        }


def _ba_row(prof: ProgramProfiler, unit_name: str, key: Tuple,
            kind: str, before: dict, after: dict) -> dict:
    """One before/after row, utilization read back FROM the profiler's
    attribution join (never recomputed here)."""
    util = {}
    for row in prof.attribution_rows():
        util[(row["name"], row.get("phase"))] = row
    b = util.get((unit_name, "before"), {})
    a = util.get((unit_name, "after"), {})
    t0 = before.get("modeled_ms") or before.get("p50_ms")
    t1 = after.get("modeled_ms") or after.get("p50_ms")
    imp = None
    if t0 and t1 and t0 > 0:
        imp = round(100.0 * (t0 - t1) / t0, 2)
    return {
        "name": unit_name,
        "key": key_str(key),
        "kind": kind,
        "before": {**before,
                   "utilization_pct": b.get("utilization_pct")},
        "after": {**after,
                  "utilization_pct": a.get("utilization_pct")},
        "improvement_pct": imp,
    }


# ----------------------------------------------------------------------
# analytic mode

def analytic_sweep(seed: int = 0, platform: Optional[str] = None,
                   device_count: Optional[int] = None,
                   chunk: int = 4096, batch: int = 16,
                   families: Sequence[str] = ("jerasure", "shec",
                                              "lrc", "clay"),
                   ) -> SweepReport:
    """The host-only sweep: no device touched, byte-identical output
    from one seed.  Sweeps every kind in tune/space.py against the
    representative corpus under the roofline model and returns the
    table + before/after rows.  A ``"cuda"`` platform prices the card's
    model (module constants) and stamps the card it describes."""
    env = current_env()
    platform = platform or env["platform"]
    device_count = device_count if device_count is not None \
        else env["device_count"]
    stamp = {**env, "platform": platform, "device_count": device_count}
    if platform == "cuda":
        stamp["device_name"] = H100
    peak = resolve_peak_gbps(platform, stamp["device_name"]) or 64.0
    table = BestConfigTable(env=stamp)
    prof = ProgramProfiler(clock=_NullClock())
    report = SweepReport(mode="analytic", seed=seed, platform=platform,
                         device_count=device_count, table=table)
    units = corpus(families, chunk=chunk, batch=batch)
    if not units:
        report.notes.append("empty corpus")
        return report

    # -- per-matrix engine pins (kind: matrix-engine) -------------------
    for unit in units:
        cands = {}
        for tier in tspace.space("matrix-engine")["engine"]:
            if tier in ("cuda", "mxu") and platform != "cuda":
                continue
            tc = tier_cost(unit.matrix, tier, unit.batch, unit.chunk,
                           platform)
            if tc is None:
                continue
            ops, byts, gops = tc
            cands[tier] = (modeled_time_s(ops, byts, peak, gops),
                           ops, byts)
        if not cands:
            continue
        base_tier = heuristic_tier(unit.matrix, platform)
        if base_tier not in cands:
            base_tier = min(sorted(cands), key=lambda t: cands[t][0])
        # ties keep the baseline: a pin must WIN, not reshuffle equals
        best_tier = min(sorted(cands),
                        key=lambda t: (cands[t][0], t != base_tier, t))
        key = tuning_key("m:" + matrix_digest(unit.matrix),
                         "matrix-engine", "*", "bytes", device_count,
                         0)
        for phase, tier in (("before", base_tier), ("after", best_tier)):
            t, ops, byts = cands[tier]
            pk = (unit.name, phase)
            prof.capture(pk, name=unit.name, platform=platform,
                         cost={"flops": ops, "bytes accessed": byts},
                         arg_bytes=unit.batch * len(unit.matrix[0])
                         * unit.chunk,
                         plugin=unit.profile, kind=unit.kind,
                         engine=tier, phase=phase, devices=1,
                         source_mode="analytic")
            prof.observe(pk, t)
        gain = cands[base_tier][0] / cands[best_tier][0]
        if best_tier != base_tier and gain >= 1.05:
            table.set(key, {"engine": best_tier}, mode="analytic",
                      score=cands[best_tier][0],
                      baseline_score=cands[base_tier][0],
                      baseline_config={"engine": base_tier})
        report.rows.append(_ba_row(
            prof, unit.name, key, "matrix-engine",
            {"engine": base_tier,
             "modeled_ms": round(cands[base_tier][0] * 1e3, 6)},
            {"engine": best_tier,
             "modeled_ms": round(cands[best_tier][0] * 1e3, 6)}))

    # -- global thresholds (kind: engine-select) ------------------------
    def routing_cost(cfg: dict) -> float:
        total = 0.0
        for unit in units:
            tier = heuristic_tier(unit.matrix, platform,
                                  mxu_min=cfg["mxu_matrix_min"],
                                  cutover=tuple(cfg["xor_cutover"]))
            tc = tier_cost(unit.matrix, tier, unit.batch, unit.chunk,
                           platform)
            if tc is None:
                tc = tier_cost(unit.matrix,
                               "cuda" if platform == "cuda" else "torch",
                               unit.batch, unit.chunk, platform)
            ops, byts, gops = tc
            total += modeled_time_s(ops, byts, peak, gops)
        return total

    default_sel = tspace.default_config("engine-select")
    base_cost = routing_cost(default_sel)
    best_sel, best_cost = default_sel, base_cost
    for cand in tspace.candidates("engine-select"):
        c = routing_cost(cand)
        if c < best_cost:
            best_sel, best_cost = cand, c
    sel_key = tuning_key("*", "engine-select", "*", "*", device_count, 0)
    if best_sel != default_sel:
        table.set(sel_key,
                  {"mxu_matrix_min": best_sel["mxu_matrix_min"],
                   "xor_cutover": list(best_sel["xor_cutover"])},
                  mode="analytic", score=best_cost,
                  baseline_score=base_cost,
                  baseline_config={
                      "mxu_matrix_min": default_sel["mxu_matrix_min"],
                      "xor_cutover": list(default_sel["xor_cutover"])})
    report.rows.append({
        "name": "engine-select", "key": key_str(sel_key),
        "kind": "engine-select",
        "before": {"config": {k: list(v) if isinstance(v, tuple) else v
                              for k, v in default_sel.items()},
                   "modeled_ms": round(base_cost * 1e3, 6)},
        "after": {"config": {k: list(v) if isinstance(v, tuple) else v
                             for k, v in best_sel.items()},
                  "modeled_ms": round(best_cost * 1e3, 6)},
        "improvement_pct": round(100.0 * (base_cost - best_cost)
                                 / base_cost, 2) if base_cost else None,
    })

    # -- CSE candidate horizon (kind: xor-schedule) ---------------------
    from ..ops.xor_schedule import CSE_TOPK, build_schedule
    sched_units = [u for u in units
                   if tier_cost(u.matrix, "xor", u.batch, u.chunk,
                                platform) is not None]
    if sched_units:
        def topk_ops(topk: int) -> int:
            return sum(build_schedule(u.matrix, 8, topk=topk).vpu_ops
                       for u in sched_units)

        base_ops = topk_ops(CSE_TOPK)
        best_topk, best_ops = CSE_TOPK, base_ops
        for cand in tspace.candidates("xor-schedule"):
            ops = topk_ops(cand["cse_topk"])
            if ops < best_ops or (ops == best_ops
                                  and cand["cse_topk"] < best_topk):
                best_topk, best_ops = cand["cse_topk"], ops
        topk_key = tuning_key("*", "xor-schedule", "*", "*",
                              device_count, 0)
        if best_topk != CSE_TOPK and best_ops < base_ops:
            table.set(topk_key, {"cse_topk": best_topk},
                      mode="analytic", score=float(best_ops),
                      baseline_score=float(base_ops),
                      baseline_config={"cse_topk": CSE_TOPK})
        report.rows.append({
            "name": "xor-schedule.cse_topk", "key": key_str(topk_key),
            "kind": "xor-schedule",
            "before": {"config": {"cse_topk": CSE_TOPK},
                       "vpu_ops": base_ops},
            "after": {"config": {"cse_topk": best_topk},
                      "vpu_ops": best_ops},
            "improvement_pct": round(100.0 * (base_ops - best_ops)
                                     / base_ops, 2) if base_ops else None,
        })

    # -- serve batch rung ladder (kind: serve-ladder) -------------------
    rng = np.random.default_rng(seed)
    top = max(max(lad) for lad in
              tspace.space("serve-ladder")["ladder"])
    occupancies = [int(v) for v in
                   rng.integers(1, top + 1, size=256)]

    def ladder_score(ladder: Tuple[int, ...]) -> Tuple[float, float]:
        stripes = padded = 0
        for occ in occupancies:
            n = occ
            while n > 0:
                take = min(n, ladder[-1])
                rung = next(r for r in ladder if take <= r)
                stripes += take
                padded += rung - take
                n -= take
        frac = padded / (stripes + padded)
        # |ladder| warm programs per bucket is a (small) modeled cost
        return frac + 0.002 * len(ladder), \
            round(100.0 * stripes / (stripes + padded), 4)

    default_lad = tuple(tspace.default_config("serve-ladder")["ladder"])
    base_score, base_util = ladder_score(default_lad)
    best_lad, best_score, best_util = default_lad, base_score, base_util
    for cand in tspace.candidates("serve-ladder"):
        lad = tuple(cand["ladder"])
        sc, ut = ladder_score(lad)
        if sc < best_score:
            best_lad, best_score, best_util = lad, sc, ut
    lad_key = tuning_key("*", "serve-ladder", "*", "*", device_count, 0)
    if best_lad != default_lad:
        table.set(lad_key, {"ladder": list(best_lad)},
                  mode="analytic", score=best_score,
                  baseline_score=base_score,
                  baseline_config={"ladder": list(default_lad)})
    report.rows.append({
        "name": "serve-ladder", "key": key_str(lad_key),
        "kind": "serve-ladder",
        "before": {"config": {"ladder": list(default_lad)},
                   "utilization_pct": base_util},
        "after": {"config": {"ladder": list(best_lad)},
                  "utilization_pct": best_util},
        "improvement_pct": round(100.0 * (base_score - best_score)
                                 / base_score, 2)
        if base_score else None,
    })

    # -- paged stripe-pool geometry (kind: stripe-pool) -----------------
    # page-tail padding fraction over a seeded mixed chunk-size day,
    # plus a small modeled cost for fire count (small pools fire more
    # often) and pool HBM footprint (pages * page_size)
    chunk_mix = [int(v) for v in rng.choice(
        np.array([512, 1024, 2048, 4096, 6144, 10240]), size=128)]

    def pool_score(cfg: dict) -> Tuple[float, float]:
        ps, pp = int(cfg["page_size"]), int(cfg["pool_pages"])
        tail = sum((-c) % ps for c in chunk_mix)
        data = sum(chunk_mix)
        frac = tail / (data + tail)
        pages_needed = sum((c + ps - 1) // ps for c in chunk_mix)
        fires = max(1.0, pages_needed / pp)
        return (frac + 0.0005 * fires + 1e-9 * pp * ps,
                round(100.0 * data / (data + tail), 4))

    pool_default = tspace.default_config("stripe-pool")
    base_sc, base_ut = pool_score(pool_default)
    best_cfg, best_sc, best_ut = dict(pool_default), base_sc, base_ut
    for cand in tspace.candidates("stripe-pool"):
        sc, ut = pool_score(cand)
        if sc < best_sc:
            best_cfg, best_sc, best_ut = dict(cand), sc, ut
    pool_key = tuning_key("*", "stripe-pool", "*", "*", device_count, 0)
    if best_cfg != pool_default:
        table.set(pool_key, best_cfg, mode="analytic", score=best_sc,
                  baseline_score=base_sc,
                  baseline_config=dict(pool_default))
    report.rows.append({
        "name": "stripe-pool", "key": key_str(pool_key),
        "kind": "stripe-pool",
        "before": {"config": dict(pool_default),
                   "utilization_pct": base_ut},
        "after": {"config": dict(best_cfg),
                  "utilization_pct": best_ut},
        "improvement_pct": round(100.0 * (base_sc - best_sc)
                                 / base_sc, 2) if base_sc else None,
    })

    # -- mesh fan-out width (kind: mesh-fanout) -------------------------
    if device_count > 1:
        s_rep, r_rep = 8, 3          # the north-star RS shape
        rep_bytes = 64 * (s_rep + r_rep) * (1 << 18)

        def fanout_time(n: int) -> float:
            return DISPATCH_OVH_S + rep_bytes / (n * peak * 1e9)

        cands_n = [n for c in tspace.candidates("mesh-fanout")
                   for n in (c["n_devices"],) if n <= device_count]
        if cands_n:
            best_n = min(sorted(cands_n), key=fanout_time)
            fan_key = tuning_key("*", "mesh-fanout", "mesh", "*",
                                 device_count, 0)
            base_t, best_t = fanout_time(device_count), \
                fanout_time(best_n)
            if best_n != device_count:
                table.set(fan_key, {"n_devices": best_n},
                          mode="analytic", score=best_t,
                          baseline_score=base_t,
                          baseline_config={"n_devices": device_count})
            report.rows.append({
                "name": "mesh-fanout", "key": key_str(fan_key),
                "kind": "mesh-fanout",
                "before": {"config": {"n_devices": device_count},
                           "modeled_ms": round(base_t * 1e3, 6)},
                "after": {"config": {"n_devices": best_n},
                          "modeled_ms": round(best_t * 1e3, 6)},
                "improvement_pct": round(100.0 * (base_t - best_t)
                                         / base_t, 2),
            })

    report.attribution = prof.attribution_rows()
    return report


class _NullClock:
    """The analytic profiler never reads a clock (observations are
    modeled times); a zero clock keeps the report byte-identical."""

    def monotonic(self) -> float:
        return 0.0


# ----------------------------------------------------------------------
# timed mode (min-of-N device times of every dispatchable tier)

def _device_times(fn, n: int, device) -> List[float]:
    """Seconds of each of ``n`` calls of ``fn``: CUDA event pairs on
    the device's current stream, queued behind a spin that holds the
    stream while the host issues them, each less the pair's own cost
    (the host clock elsewhere)."""
    import time

    import torch
    if device.type != "cuda":
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
        return out
    from ..telemetry.profiler import event_pair_overhead, hold_stream
    overhead = event_pair_overhead(device)
    stream = torch.cuda.current_stream(device)
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    hold_stream(device, n)
    for start, end in pairs:
        start.record(stream)
        fn()
        end.record(stream)
    pairs[-1][1].synchronize()
    return [max(start.elapsed_time(end) / 1e3 - overhead, 0.0)
            for start, end in pairs]


def candidate_tiers(matrix: tuple, chunk: int, platform: str) -> List[str]:
    """The tiers a timed sweep measures for ``matrix`` on chunks of
    ``chunk`` bytes: on the card the dense kernel, the XOR-schedule
    kernel (where the probe finds a schedule that fits it and the chunk
    is word-aligned) and the column walk; on the CPU the torch tier
    alone (a forced torch tier raises for a CUDA tensor)."""
    from ..ops.gf_kernels import xor_program_fits
    from ..ops.xor_schedule import probe_schedule
    if platform != "cuda":
        return ["torch"]
    cands = ["cuda"]
    sched = probe_schedule(matrix, 8)
    if (sched is not None and chunk % 4 == 0
            and xor_program_fits(sched.static)):
        cands.append("xor")
    cands.append("mxu")
    return cands


def timed_sweep(plugin: str = "jerasure",
                profile: Optional[Dict[str, str]] = None,
                size: int = 1 << 18, batch: int = 16,
                repeats: int = 3, seed: int = 42,
                device=None) -> SweepReport:
    """Measure the candidate tiers with real dispatches on ``device``
    (default: the card; NoDeviceError without one): for the encode
    matrix and the matrix one decode pattern dispatches
    (``engine.dispatched_matrix_static``, which its pin keys on), every
    tier the device can dispatch — ``cuda`` (the dense kernel), ``xor``
    (where the probe finds a schedule that fits the kernel and the chunk
    is word-aligned) and ``mxu`` (the column walk) on the card, ``torch``
    on a CPU device — each the min of ``repeats`` device times after a
    warm-up.  Every candidate's bytes must equal the default tier's
    (AssertionError otherwise); a kernel that fails to build or launch
    raises."""
    import torch

    from ..codes.engine import dispatched_matrix_static
    from ..codes.registry import ErasureCodePluginRegistry
    from ..ops import gf_kernels
    from ..ops.fallback import resolve_device
    from ..ops.torch_ops import matrix_to_static

    dev = resolve_device(device)
    if profile is None:
        profile = {"technique": "reed_sol_van", "k": "4", "m": "2"}
    ec = ErasureCodePluginRegistry.instance().factory(
        plugin, dict(profile), device=dev)
    platform = dev.type
    device_count = torch.cuda.device_count() if platform == "cuda" else 1
    prof = ProgramProfiler()
    report = SweepReport(mode="timed", seed=seed, platform=platform,
                         device_count=device_count,
                         table=BestConfigTable())
    pstr = profile_str(plugin, profile)
    n = ec.get_chunk_count()
    chunk = ec.get_chunk_size(size)
    available = tuple(i for i in range(n) if i != 1)
    units = [WorkUnit(f"{plugin}.encode_chunks_jax", pstr,
                      "serve-encode", matrix_to_static(ec.matrix),
                      chunk, batch)]
    ms = dispatched_matrix_static(ec, available, (1,))
    if ms is not None:
        units.append(WorkUnit(f"{plugin}.decode_chunks_jax", pstr,
                              "serve-decode", ms, chunk, batch))

    rng = np.random.default_rng(seed)
    for unit in units:
        s = len(unit.matrix[0])
        shape = (unit.batch, s, unit.chunk)
        x = torch.from_numpy(rng.integers(
            0, 256, size=shape, dtype=np.uint8)).to(dev)
        cands = candidate_tiers(unit.matrix, unit.chunk, platform)
        timings: Dict[str, float] = {}
        outputs: Dict[str, bytes] = {}
        # the columns read: a widened shec decode's zero columns are not
        reads = int(np.count_nonzero(np.asarray(unit.matrix).any(axis=0)))
        cost = analytic_matrix_cost(unit.batch, len(unit.matrix), reads,
                                    unit.chunk)
        for tier in cands:
            def fn(_t=tier, _m=unit.matrix):
                return gf_kernels._run_matrix_bytes(x, _m, 8, _t)
            outputs[tier] = fn().cpu().numpy().tobytes()    # warm
            pk = (unit.name, tier)
            prof.capture(pk, (x,), name=unit.name, platform=platform,
                         cost=cost, plugin=unit.profile, kind=unit.kind,
                         engine=tier, phase=tier, devices=device_count,
                         source_mode="timed")
            times = _device_times(fn, max(2, repeats), dev)
            for dt in times:
                prof.observe(pk, dt)
            timings[tier] = min(times)
        base_tier = gf_kernels.select_matrix_engine(
            8, dev, shape=shape, matrix_t=unit.matrix, mesh=0)
        if base_tier not in timings:
            base_tier = min(sorted(timings), key=lambda t: timings[t])
        # byte-identity across every candidate tier — a tuned config
        # may only ever change WHERE the bytes are computed
        for tier, out in sorted(outputs.items()):
            if out != outputs[base_tier]:
                raise AssertionError(
                    f"{unit.name}: tier {tier} diverged from "
                    f"{base_tier} — tuned configs must be "
                    f"byte-identical")
        # ties keep the baseline: a pin must WIN, not reshuffle equals
        best_tier = min(sorted(timings),
                        key=lambda t: (timings[t], t != base_tier, t))
        key = tuning_key("m:" + matrix_digest(unit.matrix),
                         "matrix-engine", "*", "bytes", device_count,
                         0)
        # re-key the winner/baseline pair into before/after rows so
        # attribution_rows() carries the same phases as analytic mode
        for phase, tier in (("before", base_tier), ("after", best_tier)):
            pk = (unit.name, "ba", phase)
            prof.capture(pk, (x,), name=unit.name, platform=platform,
                         cost=cost, plugin=unit.profile, kind=unit.kind,
                         engine=tier, phase=phase, devices=device_count,
                         source_mode="timed")
            prof.observe(pk, timings[tier])
        gain = timings[base_tier] / timings[best_tier]
        if best_tier != base_tier and gain >= 1.05:
            report.table.set(key, {"engine": best_tier}, mode="timed",
                             score=timings[best_tier],
                             baseline_score=timings[base_tier],
                             baseline_config={"engine": base_tier})
        report.rows.append(_ba_row(
            prof, unit.name, key, "matrix-engine",
            {"engine": base_tier,
             "p50_ms": round(timings[base_tier] * 1e3, 6)},
            {"engine": best_tier,
             "p50_ms": round(timings[best_tier] * 1e3, 6)}))
        report.rows[-1]["candidates_ms"] = {
            t: round(v * 1e3, 6) for t, v in sorted(timings.items())}

    report.attribution = prof.attribution_rows()
    return report


# ----------------------------------------------------------------------
# the host-tier audit workload (analysis/entrypoints.py tune.sweep)

def tune_sweep_selftest() -> dict:
    """The ``tune.sweep`` host-tier audit entry: a seeded analytic
    sweep over the two numpy-cheapest corpus families, twice, with the
    results pinned byte-identical and the emitted table schema-valid —
    no device touched."""
    import json

    kwargs = dict(seed=7, platform="cpu", device_count=1,
                  chunk=2048, batch=4, families=("jerasure", "shec"))
    rep1 = analytic_sweep(**kwargs)
    rep2 = analytic_sweep(**kwargs)
    d1, d2 = rep1.to_dict(), rep2.to_dict()
    if json.dumps(d1, sort_keys=True) != json.dumps(d2, sort_keys=True):
        raise AssertionError("analytic sweep is not deterministic")
    errors = validate_table(rep1.table.to_dict())
    if errors:
        raise AssertionError(f"sweep table invalid: {errors}")
    if not rep1.rows:
        raise AssertionError("analytic sweep produced no rows")
    for row in rep1.rows:
        if "before" not in row or "after" not in row:
            raise AssertionError(f"row missing before/after: {row}")
    roundtrip = BestConfigTable.from_dict(rep1.table.to_dict())
    if roundtrip.to_json() != rep1.table.to_json():
        raise AssertionError("table does not round-trip")
    return d1


__all__ = [
    "MXU_BYTE_GOPS", "SweepReport", "VPU_BYTE_GOPS", "WorkUnit",
    "XOR_BYTE_GOPS", "analytic_sweep", "candidate_tiers", "corpus",
    "heuristic_tier", "modeled_time_s", "tier_cost", "timed_sweep",
    "tune_sweep_selftest",
]
