"""dout-style leveled debug logging — src/common/dout.h +
src/common/subsys.h role.  A copy of ``ceph_tpu/utils/log.py``.

Per-subsystem gather levels: a message at level L prints when L <= the
subsystem's configured level.  Configure via
``CEPH_TPU_DEBUG="crush=10,ec=5"`` (the `debug_crush = 10` conf
analog), ``set_level()``, or the global ``log_level`` option default.

    from ceph_tpu_torch.utils.log import dout
    dout("crush", 10, f"descend to {bucket_id}")
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, Optional, TextIO

from .locks import make_lock

SUBSYS = ("ec", "crush", "bench", "bridge", "registry",
          "telemetry")  # subsys.h role; telemetry: span enter/exit at
                        # level 20 (CEPH_TPU_DEBUG=telemetry=20 gives a
                        # live trace of the span tree as it opens)

_levels: Dict[str, int] = {}
_lock = make_lock("utils.log._lock")
_stream: TextIO = sys.stderr


def _default_level() -> int:
    try:
        from .config import global_config
        return int(global_config().get("log_level"))
    except Exception:  # pragma: no cover - config never raises today
        return 1


def _parse_env() -> Dict[str, int]:
    out: Dict[str, int] = {}
    spec = os.environ.get("CEPH_TPU_DEBUG", "")
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, lvl = part.partition("=")
        try:
            out[name.strip()] = int(lvl)
        except ValueError:
            pass
    return out


def get_level(subsys: str) -> int:
    with _lock:
        if subsys in _levels:
            return _levels[subsys]
    env = _parse_env()
    if subsys in env:
        return env[subsys]
    return _default_level()


def set_level(subsys: str, level: int) -> None:
    with _lock:
        _levels[subsys] = int(level)


def set_stream(stream: Optional[TextIO]) -> None:
    """Redirect log output (tests); None restores stderr."""
    global _stream
    _stream = stream if stream is not None else sys.stderr


def dout(subsys: str, level: int, msg: str) -> None:
    """dout.h -> ldout(cct, level) << ...: print when enabled."""
    if level <= get_level(subsys):
        _stream.write(f"{time.strftime('%F %T')} {level:2d} "
                      f"{subsys}: {msg}\n")
