"""The persisted best-config table — what the autotuner writes and the
engine consults; a port of ``ceph_tpu/tune/table.py``.

The autotuner (tune/sweep.py + tools/autotune.py) sweeps a bounded
declarative space (tune/space.py) with the two measurement modes the
profiler owns and persists the winners here, in a **versioned,
schema-validated JSON table**: tuned once, reused by every later
process.

Keying.  One entry per *tuning key* ``(plugin profile, pattern kind,
engine tier, layout, device_count, batch rung)`` — the coordinates the
PatternCache and the profiler's attribution rows speak.  Process-wide
parameters (the rung ladder, the cutover thresholds) use ``"*"``
wildcards in the slots they do not discriminate on; per-matrix engine
pins carry a digest of the static matrix in the profile slot
(``m:<sha1-12>``).

Staleness guard.  Every entry records the environment it was tuned on
— ``{platform, device_count, torch_version, cuda_version, device_name,
table_schema_version}`` (the reference keys on ``jax_version``; the
port on the torch build, its CUDA version and the card's name) — and
:meth:`BestConfigTable.lookup` ignores it (with a ``tune_config_stale``
counter and a once-per-key ``tune_config_stale`` event) when any of
them differs from the current process: a table tuned on one card can
never configure another.  Missing/stale entries fall back to today's
hand-picked constants byte-identically (every consultation seam treats
``None`` as "use the default").  The environment probe never
initialises CUDA: it peeks with ``torch.cuda.is_initialized()``, so a
host-only path stays host-only, and before CUDA is live the process
reads as ``platform="cpu"``.

Consultation happens where the reference's does (the engine table per
dispatch, the batcher and pool at construction, the schedule probe per
matrix), and ``install_table`` clears the PatternCache and the
schedule-probe cache, so callables built under the old config are
rebuilt once under the new one.

``CEPH_TPU_TUNE_TABLE=<path>`` auto-loads a table at first
consultation.  With no table installed, :func:`consult` is one
module-global read.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

from ..utils.locks import make_lock

TABLE_SCHEMA_VERSION = 1
ENV_KNOB = "CEPH_TPU_TUNE_TABLE"

# the tuning-key slots, in serialization order
KEY_FIELDS = ("profile", "kind", "engine", "layout", "device_count",
              "rung")

# entry-env fields the staleness guard compares
ENV_FIELDS = ("platform", "device_count", "torch_version",
              "cuda_version", "device_name", "table_schema_version")


def tuning_key(profile: str = "*", kind: str = "", engine: str = "*",
               layout: str = "*", device_count: int = 1,
               rung: int = 0) -> Tuple:
    """The hashable tuning key: ``(plugin profile, pattern
    kind, engine tier, layout, device_count, batch rung)``."""
    if not kind:
        raise ValueError("tuning key needs a kind")
    return (str(profile), str(kind), str(engine), str(layout),
            int(device_count), int(rung))


def key_str(key: Tuple) -> str:
    """JSON dict-key serialization of a tuning key."""
    return "|".join(str(p) for p in key)


def parse_key(s: str) -> Tuple:
    parts = s.split("|")
    if len(parts) != len(KEY_FIELDS):
        raise ValueError(f"tuning key {s!r} must have "
                         f"{len(KEY_FIELDS)} |-separated slots")
    return (parts[0], parts[1], parts[2], parts[3], int(parts[4]),
            int(parts[5]))


def key_hash(key: Tuple) -> str:
    """Short stable digest of one tuning key (bench-row provenance)."""
    return hashlib.sha1(key_str(key).encode()).hexdigest()[:12]


@functools.lru_cache(maxsize=512)
def matrix_digest(matrix_t: tuple) -> str:
    """Digest of a static matrix tuple — the profile-slot identity for
    per-matrix engine pins (``m:<digest>``).  lru-cached because the
    engine-selection table consults it per dispatch."""
    return hashlib.sha1(repr(matrix_t).encode()).hexdigest()[:12]


def profile_str(plugin: str, profile: Dict[str, str]) -> str:
    """Canonical plugin-profile string for the profile slot."""
    body = ",".join(f"{k}={v}" for k, v in
                    sorted((str(k), str(v)) for k, v in profile.items()))
    return f"{plugin}:{body}"


# ----------------------------------------------------------------------
# current-environment probe (what the staleness guard compares against)

_env_lock = make_lock("tune.table._env_lock")
_env_cache: Optional[dict] = None


def current_env() -> dict:
    """The CURRENT process environment the staleness guard compares
    entries against.  Never initialises CUDA (a host path must stay
    host-only): the platform, device count and card name are read only
    when CUDA is already initialised, else the host defaults."""
    global _env_cache
    with _env_lock:
        if _env_cache is not None:
            return dict(_env_cache)
    import torch
    platform, device_count, device_name = "cpu", 1, None
    live = torch.cuda.is_initialized()
    if live:
        platform = "cuda"
        device_count = torch.cuda.device_count()
        device_name = torch.cuda.get_device_name()
    env = {"platform": platform, "device_count": device_count,
           "torch_version": torch.__version__,
           "cuda_version": torch.version.cuda,
           "device_name": device_name,
           "table_schema_version": TABLE_SCHEMA_VERSION}
    if live:
        # cache only once CUDA is live: before, a later initialisation
        # can still change the answer (a host-tier consult must not
        # freeze "cpu" into a process about to use the card)
        with _env_lock:
            _env_cache = env
    return dict(env)


def _invalidate_env_cache() -> None:
    global _env_cache
    with _env_lock:
        _env_cache = None


# ----------------------------------------------------------------------
# the table

def validate_table(d: object) -> List[str]:
    """Schema errors for a table dict ([] = valid).  Shares the
    stdlib-validator spirit of telemetry/schema.py: loud, specific,
    no external deps."""
    errors: List[str] = []
    if not isinstance(d, dict):
        return [f"table must be a dict, got {type(d).__name__}"]
    if d.get("table_schema_version") != TABLE_SCHEMA_VERSION:
        errors.append(
            f"table_schema_version {d.get('table_schema_version')!r} "
            f"!= {TABLE_SCHEMA_VERSION}")
    entries = d.get("entries")
    if not isinstance(entries, dict):
        return errors + ["entries must be a dict"]
    for ks, entry in entries.items():
        try:
            parse_key(ks)
        except (ValueError, TypeError) as e:
            errors.append(f"bad key {ks!r}: {e}")
            continue
        if not isinstance(entry, dict):
            errors.append(f"{ks}: entry must be a dict")
            continue
        if not isinstance(entry.get("config"), dict):
            errors.append(f"{ks}: missing config dict")
        env = entry.get("env")
        if not isinstance(env, dict):
            errors.append(f"{ks}: missing env dict")
        else:
            for f in ENV_FIELDS:
                if f not in env:
                    errors.append(f"{ks}: env missing {f}")
        if entry.get("mode") not in ("analytic", "timed"):
            errors.append(f"{ks}: mode must be analytic|timed")
    return errors


class BestConfigTable:
    """The versioned best-config table: tuning key -> winning config,
    with per-entry environment stamps and scores.

    Thread-safe for the read path (``lookup`` — the dispatch seams);
    writers (the sweeps) are single-threaded by construction."""

    def __init__(self, env: Optional[dict] = None) -> None:
        self.entries: Dict[str, dict] = {}
        self._env = dict(env) if env is not None else None
        self._stale_warned: set = set()
        self._lock = make_lock("tune.table.BestConfigTable._lock")

    def env(self) -> dict:
        """The environment NEW entries are stamped with (the declared
        sweep environment, or the current process env)."""
        # current_env() is probed OUTSIDE the lock (it may ask torch
        # for the card's name); first memoized writer wins
        if self._env is None:
            probed = current_env()
            with self._lock:
                if self._env is None:
                    self._env = probed
        with self._lock:
            return dict(self._env)

    # -- write ----------------------------------------------------------

    def set(self, key: Tuple, config: dict, *, mode: str,
            score: Optional[float] = None,
            baseline_score: Optional[float] = None,
            baseline_config: Optional[dict] = None) -> None:
        if mode not in ("analytic", "timed"):
            raise ValueError(f"mode {mode!r} must be analytic|timed")
        entry = {
            "config": dict(config),
            "env": self.env(),
            "mode": mode,
            "score": score,
            "baseline_score": baseline_score,
        }
        if baseline_config is not None:
            entry["baseline_config"] = dict(baseline_config)
        with self._lock:
            self.entries[key_str(key)] = entry

    # -- read (the consultation seam) -----------------------------------

    def lookup(self, key: Tuple) -> Optional[dict]:
        """The entry's config when its environment stamp matches the
        current process, else None — counted and evented as
        ``tune_config_stale`` so a topology mismatch is observable,
        never silent (the staleness guard)."""
        ks = key_str(key)
        with self._lock:
            entry = self.entries.get(ks)
        if entry is None:
            return None
        env = entry.get("env") or {}
        now = current_env()
        mismatched = [f for f in ENV_FIELDS if env.get(f) != now.get(f)]
        if mismatched:
            from ..telemetry import metrics as tel
            tel.counter("tune_config_stale")
            with self._lock:
                first = ks not in self._stale_warned
                self._stale_warned.add(ks)
            if first:
                tel.event("tune_config_stale", key=ks,
                          mismatched=",".join(mismatched),
                          entry_env=json.dumps(env, sort_keys=True),
                          current_env=json.dumps(now, sort_keys=True))
            return None
        return dict(entry["config"])

    # -- persistence -----------------------------------------------------

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "table_schema_version": TABLE_SCHEMA_VERSION,
                "entries": {k: json.loads(json.dumps(v))
                            for k, v in sorted(self.entries.items())},
            }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=1)

    @classmethod
    def from_dict(cls, d: dict) -> "BestConfigTable":
        errors = validate_table(d)
        if errors:
            raise ValueError("invalid best-config table: "
                             + "; ".join(errors[:5]))
        t = cls()
        with t._lock:
            t.entries = {str(k): dict(v)
                         for k, v in d["entries"].items()}
        return t

    def save(self, path: str) -> None:
        """Atomic write: a temporary file, then a rename."""
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(self.to_json())
            f.write("\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "BestConfigTable":
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def content_hash(self) -> Optional[str]:
        """Digest of the tuned key set + configs (bench-row
        provenance: the ``tune_key_hash`` field)."""
        with self._lock:
            if not self.entries:
                return None
        return hashlib.sha1(self.to_json().encode()).hexdigest()[:12]

    def __len__(self) -> int:
        with self._lock:
            return len(self.entries)


# ----------------------------------------------------------------------
# the process-wide installed table (what the seams consult)

_lock = make_lock("tune.table._lock")
_active: Optional[BestConfigTable] = None
_env_resolved = False
_generation = 0


def _clear_consult_caches() -> None:
    """Callables built under the OLD config must rebuild under the new
    one: clear the PatternCache (the engine's program identity space)
    and the schedule-probe cache.  Best-effort — a half-imported
    process just skips the missing ones."""
    try:
        from ..codes.engine import global_pattern_cache
        global_pattern_cache().clear()
    except Exception:  # noqa: BLE001 — cache clearing is best-effort
        pass
    try:
        from ..ops import xor_schedule
        xor_schedule.probe_schedule.cache_clear()
    except Exception:  # noqa: BLE001
        pass


def install_table(table: Optional[BestConfigTable],
                  clear_caches: bool = True
                  ) -> Optional[BestConfigTable]:
    """Install (or, with None, uninstall) the process best-config
    table; returns the previous one.  Bumps the consultation
    generation and (by default) clears the program caches, so tuned
    configs land at the next build — after which the warm path sets
    up nothing."""
    global _active, _env_resolved, _generation
    with _lock:
        prev = _active
        _active = table
        _env_resolved = True
        _generation += 1
    _invalidate_env_cache()
    if clear_caches:
        _clear_consult_caches()
    return prev


def active_table() -> Optional[BestConfigTable]:
    """The installed table, resolving the ``CEPH_TPU_TUNE_TABLE`` env
    knob on first call (a load failure logs + counts, never raises —
    the engine must keep running on defaults)."""
    global _active, _env_resolved
    if _env_resolved:       # resolved: one module-global read
        return _active
    with _lock:
        if _env_resolved:
            return _active
        _env_resolved = True
    path = os.environ.get(ENV_KNOB, "").strip()
    if not path:
        return _active
    try:
        table = BestConfigTable.load(path)
    except (OSError, ValueError) as e:
        from ..telemetry import metrics as tel
        from ..utils.log import dout
        dout("ec", 1, f"tune table {path!r} unusable "
                      f"({type(e).__name__}: {e}); running on defaults")
        tel.counter("tune_table_load_errors")
        tel.event("tune_table_load_error", path=path,
                  error=f"{type(e).__name__}: {e}")
        return _active
    with _lock:
        _active = table
    return table


def generation() -> int:
    with _lock:
        return _generation


def consult(kind: str, profile: str = "*", engine: str = "*",
            layout: str = "*", rung: int = 0,
            device_count: Optional[int] = None) -> Optional[dict]:
    """THE consultation seam: the tuned config for one key, or None
    (= use today's constant, byte-identically).  Cheap by design — one
    module-global read with no table, else a dict lookup plus the env
    compare — because the engine-selection table calls it per
    dispatch."""
    table = active_table()
    if table is None:
        return None
    dc = device_count if device_count is not None \
        else current_env()["device_count"]
    return table.lookup(tuning_key(profile, kind, engine, layout,
                                   dc, rung))


def active_source() -> Tuple[str, Optional[str]]:
    """``("tuned", <table content hash>)`` when a non-empty table is
    installed, else ``("default", None)`` — every bench workload row
    carries this pair."""
    table = active_table()
    if table is None or not len(table):
        return "default", None
    return "tuned", table.content_hash()


@dataclasses.dataclass
class _Override:
    prev: Optional[BestConfigTable]


class scoped_table:
    """Context manager installing a table for a block (the timed
    sweep's candidate evaluation; tests) and restoring the previous
    one — including "nothing installed"."""

    def __init__(self, table: Optional[BestConfigTable],
                 clear_caches: bool = True) -> None:
        self.table = table
        self.clear_caches = clear_caches
        self._ov: Optional[_Override] = None

    def __enter__(self) -> Optional[BestConfigTable]:
        self._ov = _Override(install_table(self.table,
                                           self.clear_caches))
        return self.table

    def __exit__(self, *exc) -> None:
        install_table(self._ov.prev, self.clear_caches)


__all__ = [
    "BestConfigTable", "ENV_FIELDS", "ENV_KNOB", "KEY_FIELDS",
    "TABLE_SCHEMA_VERSION", "active_source", "active_table", "consult",
    "current_env", "generation", "install_table", "key_hash",
    "key_str", "matrix_digest", "parse_key", "profile_str",
    "scoped_table", "tuning_key", "validate_table",
]
