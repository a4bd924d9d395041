"""Seeded traffic generation + the closed/open-loop scenario loop.

``LoadGenerator`` turns a declarative :class:`TrafficSpec` — codec
mix, op mix, stripe sizes, arrival process, per-op deadlines — into a
deterministic request stream: same seed ⇒ the same requests with the
same payload bytes, the same erasure patterns, the same arrival
offsets, forever.  Ground truth (``expect``) rides every request, so
any consumer can verify served bytes against the encode that produced
them.

A port of ``ceph_tpu/serve/loadgen.py``.  ``run_serving_scenario`` is
the entry every consumer shares (``chip_smoke.py``, the tests): queue
→ batcher → SLO recorder wired on one injectable clock.  A
``TrafficSpec`` JSON written by the reference's ``to_dict`` loads here
and drives the same stream, and the reverse.

- **closed loop**: a fixed concurrency window; a completion admits the
  next request (the classic closed-loop load generator — measures the
  system at a stable occupancy).
- **open loop**: seeded-Poisson arrival offsets replayed on the clock
  regardless of completions (arrival-rate pressure; queue waits and
  rejections are the signal).

With a FakeClock + a deterministic ``service_model`` the whole run is
a simulation: batch compositions, latencies and the SLO report are
byte-identical across runs from one seed, and equal to the
reference's.  With the real clock and no model, latencies are
wall-clock truth.  :func:`default_spec` is the reference's canonical
mix (RS : shec : clay = 3 : 2 : 1).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .batcher import LADDER, ContinuousBatcher
from .queue import AdmissionQueue, EcRequest, EcResult


@dataclass(frozen=True)
class CodecSpec:
    """One (plugin, profile, stripe size) the mix draws from."""

    name: str
    plugin: str
    profile: Dict[str, str]
    stripe_size: int
    weight: float = 1.0

    def to_dict(self) -> dict:
        return {"name": self.name, "plugin": self.plugin,
                "profile": dict(self.profile),
                "stripe_size": self.stripe_size, "weight": self.weight}

    @classmethod
    def from_dict(cls, d: dict) -> "CodecSpec":
        return cls(name=d["name"], plugin=d["plugin"],
                   profile=dict(d["profile"]),
                   stripe_size=d["stripe_size"], weight=d["weight"])


@dataclass
class TrafficSpec:
    """Declarative serving scenario (replayable from ``seed``)."""

    seed: int = 42
    n_requests: int = 256
    codecs: List[CodecSpec] = field(default_factory=list)
    op_mix: Dict[str, float] = field(
        default_factory=lambda: {"encode": 0.5, "decode": 0.35,
                                 "repair": 0.15})
    deadlines: Dict[str, float] = field(
        default_factory=lambda: {"encode": 0.2, "decode": 0.2,
                                 "repair": 0.5})
    arrival: str = "closed"          # "closed" | "open"
    rate: float = 2000.0             # open loop: mean req/s (Poisson)
    concurrency: int = 64            # closed loop: in-flight window
    erasures: int = 1
    ladder: Tuple[int, ...] = LADDER
    queue_capacity: int = 4096
    pool: int = 8                    # distinct stripes per codec
    # paged serving: ragged queues over a page pool instead of shape
    # buckets over the rung ladder; None = the default pool geometry
    # (serve/pool.py::tuned_pool_config)
    paged: bool = False
    page_size: Optional[int] = None
    pool_pages: Optional[int] = None
    # multi-tenant weeks (the reference's scenario/week.py): the tenant
    # every request in this stream bills against ("" = legacy
    # single-tenant), and the diurnal open-loop arrival modulation —
    # rate(t) = rate * (min_frac + (1 - min_frac) * half-cosine over
    # ``diurnal_period_s``), so ``diurnal_min_frac=0.1`` is the 10x
    # trough-to-peak traffic swing.  None/1.0 = the flat Poisson
    # process.
    tenant: str = ""
    diurnal_period_s: Optional[float] = None
    diurnal_min_frac: float = 1.0

    def __post_init__(self) -> None:
        if self.arrival not in ("closed", "open"):
            raise ValueError(f"arrival {self.arrival!r} must be "
                             f"closed|open")
        if not self.codecs:
            raise ValueError("spec needs at least one CodecSpec")

    def to_dict(self) -> dict:
        """JSON-ready spec (ScenarioSpec round-trips through this)."""
        return {
            "seed": self.seed, "n_requests": self.n_requests,
            "codecs": [c.to_dict() for c in self.codecs],
            "op_mix": dict(self.op_mix),
            "deadlines": dict(self.deadlines),
            "arrival": self.arrival, "rate": self.rate,
            "concurrency": self.concurrency, "erasures": self.erasures,
            "ladder": list(self.ladder),
            "queue_capacity": self.queue_capacity, "pool": self.pool,
            "paged": self.paged, "page_size": self.page_size,
            "pool_pages": self.pool_pages,
            "tenant": self.tenant,
            "diurnal_period_s": self.diurnal_period_s,
            "diurnal_min_frac": self.diurnal_min_frac,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TrafficSpec":
        return cls(
            seed=d["seed"], n_requests=d["n_requests"],
            codecs=[CodecSpec.from_dict(c) for c in d["codecs"]],
            op_mix=dict(d["op_mix"]), deadlines=dict(d["deadlines"]),
            arrival=d["arrival"], rate=d["rate"],
            concurrency=d["concurrency"], erasures=d["erasures"],
            ladder=tuple(d["ladder"]),
            queue_capacity=d["queue_capacity"], pool=d["pool"],
            paged=bool(d.get("paged", False)),
            page_size=d.get("page_size"),
            pool_pages=d.get("pool_pages"),
            tenant=d.get("tenant", ""),
            diurnal_period_s=d.get("diurnal_period_s"),
            diurnal_min_frac=d.get("diurnal_min_frac", 1.0))


def default_spec(seed: int = 42, n_requests: int = 256,
                 stripe_size: int = 1 << 16,
                 arrival: str = "closed",
                 erasures: int = 1, **overrides) -> TrafficSpec:
    """The canonical mixed scenario: RS + shec + clay, encode-heavy
    with a decode/repair tail — the reference's ``default_spec``, the
    same codecs, weights, seed and defaults."""
    codecs = [
        CodecSpec("rs_k8_m3", "jerasure",
                  {"technique": "reed_sol_van", "k": "8", "m": "3"},
                  stripe_size, weight=3.0),
        CodecSpec("shec_k6_m3_c2", "shec",
                  {"k": "6", "m": "3", "c": "2"}, stripe_size,
                  weight=2.0),
        CodecSpec("clay_k8_m4_d11", "clay",
                  {"k": "8", "m": "4", "d": "11"}, stripe_size,
                  weight=1.0),
    ]
    return TrafficSpec(seed=seed, n_requests=n_requests, codecs=codecs,
                       arrival=arrival, erasures=erasures, **overrides)


# ----------------------------------------------------------------------
# generation

class _CodecState:
    """Prepared per-codec material: plugin instance, a pool of
    encoded stripes, and the decodable erasure patterns the stream
    draws from."""

    def __init__(self, codec: CodecSpec, seed: int,
                 erasures: int, pool: int) -> None:
        from ..codes.registry import ErasureCodePluginRegistry

        self.codec = codec
        ec = ErasureCodePluginRegistry.instance().factory(
            codec.plugin, dict(codec.profile), device="cpu")
        # payload prep is host bookkeeping: the numpy surfaces on a CPU
        # instance, never a device
        ec.min_xla_bytes = float("inf")
        self.ec = ec
        self.k = ec.get_data_chunk_count()
        self.n = ec.get_chunk_count()
        self.chunk = ec.get_chunk_size(codec.stripe_size)
        rng = np.random.default_rng(seed)
        self.data = rng.integers(0, 256, (pool, self.k, self.chunk),
                                 dtype=np.uint8)
        self.parity = np.asarray(ec.encode_chunks_batch(self.data))
        # place data/parity at their global shard positions (lrc
        # scatters data; everything else is identity)
        mapping = ec.get_chunk_mapping()
        data_pos = list(mapping) if mapping else list(range(self.k))
        parity_pos = [p for p in range(self.n)
                      if p not in set(data_pos)]
        self.allchunks = np.empty((pool, self.n, self.chunk), np.uint8)
        self.allchunks[:, data_pos] = self.data
        self.allchunks[:, parity_pos] = self.parity
        self.patterns = self._decodable_patterns(erasures)

    def _decodable_patterns(self, erasures: int,
                            cap: int = 8) -> List[tuple]:
        pats = []
        for combo in itertools.combinations(range(self.n), erasures):
            try:
                self.ec.minimum_to_decode(
                    set(combo), set(range(self.n)) - set(combo))
            except IOError:
                continue
            pats.append(combo)
            if len(pats) >= cap:
                break
        if not pats:
            raise IOError(
                f"{self.codec.name}: no decodable {erasures}-erasure "
                f"pattern (k={self.k}, n={self.n})")
        return pats


def diurnal_rate(spec: TrafficSpec, t: float) -> float:
    """Instantaneous open-loop arrival rate at stream offset ``t``: the
    base rate shaped by the spec's diurnal half-cosine (trough at t=0,
    peak at half period)."""
    lam = spec.rate
    if spec.diurnal_period_s and spec.diurnal_min_frac < 1.0:
        frac = 0.5 * (1.0 - np.cos(
            2.0 * np.pi * t / spec.diurnal_period_s))
        lam *= (spec.diurnal_min_frac
                + (1.0 - spec.diurnal_min_frac) * frac)
    return float(lam)


class LoadGenerator:
    """Deterministic request-stream factory for a TrafficSpec.  (The
    reference's week-scale options — shared payloads, a burst-boost
    rate multiplier — come with its scenario/week.py.)"""

    def __init__(self, spec: TrafficSpec) -> None:
        self.spec = spec
        self.states = [
            _CodecState(c, seed=spec.seed + 7919 * i,
                        erasures=spec.erasures, pool=spec.pool)
            for i, c in enumerate(spec.codecs)]

    def generate(self) -> Tuple[List[EcRequest], Optional[List[float]]]:
        """(requests, arrival offsets).  Offsets are cumulative
        seconds from stream start for open-loop arrival, None for
        closed loop.  Request ids are 0..n-1 (stream order) so two
        runs of one seed log identical batch compositions."""
        spec = self.spec
        rng = np.random.default_rng(spec.seed)
        ops = sorted(spec.op_mix)
        opw = np.array([spec.op_mix[o] for o in ops], dtype=float)
        opw = opw / opw.sum()
        cw = np.array([c.weight for c in spec.codecs], dtype=float)
        cw = cw / cw.sum()
        reqs: List[EcRequest] = []
        for i in range(spec.n_requests):
            st = self.states[int(rng.choice(len(self.states), p=cw))]
            op = ops[int(rng.choice(len(ops), p=opw))]
            j = int(rng.integers(st.data.shape[0]))
            reqs.append(self._make(st, op, j,
                                   int(rng.integers(len(st.patterns))),
                                   req_id=i))
        offsets = None
        if spec.arrival == "open":
            if spec.diurnal_period_s and spec.diurnal_min_frac < 1.0:
                # inhomogeneous Poisson via sequential gap scaling:
                # gap_i = Exp(1) / rate(t_i) — deterministic from the
                # same rng stream
                unit = rng.exponential(1.0, size=spec.n_requests)
                offsets = []
                t = 0.0
                for g in unit:
                    lam = max(diurnal_rate(spec, t), 1e-9)
                    t += float(g) / lam
                    offsets.append(t)
            else:
                gaps = rng.exponential(1.0 / spec.rate,
                                       size=spec.n_requests)
                offsets = list(np.cumsum(gaps))
        return reqs, offsets

    def _make(self, st: _CodecState, op: str, j: int, pat_idx: int,
              req_id: int) -> EcRequest:
        codec = st.codec
        work = st.k * st.chunk
        if op == "encode":
            return EcRequest(
                op=op, plugin=codec.plugin, profile=codec.profile,
                stripe_size=codec.stripe_size,
                payload=st.data[j].copy(), req_id=req_id,
                work_bytes=work, expect=st.parity[j],
                tenant=self.spec.tenant)
        erased = st.patterns[pat_idx]
        available = tuple(x for x in range(st.n) if x not in erased)
        survivors = np.ascontiguousarray(
            st.allchunks[j, list(available), :])
        rec_expect = st.allchunks[j, list(erased), :]
        expect = (rec_expect if op == "decode"
                  else (rec_expect, st.parity[j]))
        return EcRequest(
            op=op, plugin=codec.plugin, profile=codec.profile,
            stripe_size=codec.stripe_size, payload=survivors,
            available=available, erased=erased, req_id=req_id,
            work_bytes=work, expect=expect,
            tenant=self.spec.tenant)


# ----------------------------------------------------------------------
# verification + service models

def verify_results(results: List[EcResult]) -> List[int]:
    """Request ids whose served output differs from the generator's
    ground truth (empty = byte-identical stream)."""
    bad = []
    for res in results:
        exp = res.request.expect
        if exp is None:
            continue
        if res.request.op == "repair":
            rec, parity = res.output
            ok = (np.array_equal(rec, exp[0])
                  and np.array_equal(parity, exp[1]))
        else:
            ok = np.array_equal(res.output, exp)
        if not ok:
            bad.append(res.request.req_id)
    return bad


def throughput_service_model(gbps: float = 10.0,
                             overhead_s: float = 2e-4):
    """Deterministic sim service time: dispatch overhead plus padded
    bytes over a modeled device bandwidth (FakeClock scenarios)."""

    def model(bucket, rung: int) -> float:
        nbytes = rung * bucket.rows * bucket.chunk_size
        return overhead_s + nbytes / (gbps * 1e9)

    return model


# ----------------------------------------------------------------------
# the scenario entry

@dataclass
class ServingRun:
    """One scenario's artifacts: per-request results, the SLO report,
    and the live queue/batcher for deeper inspection."""

    results: List[EcResult]
    report: dict
    queue: AdmissionQueue
    batcher: ContinuousBatcher
    stream_compiles: Optional[int] = None


def run_serving_scenario(spec: TrafficSpec, clock=None,
                         executor: str = "device",
                         service_model=None,
                         warmup: bool = True,
                         requests: Optional[List[EcRequest]] = None,
                         offsets: Optional[List[float]] = None,
                         device=None) -> ServingRun:
    """Drive ``spec``'s stream through queue → batcher → SLO ledger.

    Thin wrapper over the scenario runner's serving event loop
    (scenario/runner.py).  ``executor="device"`` runs the stream on
    ``device`` (default: the card; ``device="cpu"`` asks for the CPU)
    and reports ``stream_compiles`` — kernel setups after warmup
    (``telemetry.metrics.KERNEL_SETUPS``), 0 on a warm stream.

    ``requests`` (with ``offsets`` for open-loop arrival) substitutes
    a pre-built request list for the generator's.
    """
    from ..scenario.runner import run_serving_scenario as _drive

    return _drive(spec, clock=clock, executor=executor,
                  service_model=service_model, warmup=warmup,
                  requests=requests, offsets=offsets, device=device)
