"""Typed options + erasure-code profile store — a port of
``ceph_tpu/utils/config.py``.

- ``Option`` / ``Config`` — the src/common/options.cc role: a typed
  option schema (type, default, min/max, description) with values
  layered default < environment (``CEPH_TPU_<NAME>``) < explicit set.
  The option names and defaults are the reference's; ``compile_cache``
  names the port's kernel build-cache directory
  (utils/compile_cache.py).
- ``ErasureCodeProfileStore`` — the OSDMonitor erasure-code-profile
  surface, validated on set by instantiating the plugin through the
  port's registry on its ``device``: the card unless the caller asks
  for the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .locks import make_lock


@dataclass
class Option:
    """options.cc -> Option: typed schema entry."""

    name: str
    type: type = str
    default: Any = None
    minimum: Optional[float] = None
    maximum: Optional[float] = None
    desc: str = ""

    def cast(self, value):
        if self.type is bool and isinstance(value, str):
            v = value.strip().lower()
            if v in ("1", "true", "yes", "on"):
                return True
            if v in ("0", "false", "no", "off"):
                return False
            raise ValueError(f"{self.name}: {value!r} is not a bool")
        v = self.type(value)
        if self.minimum is not None and v < self.minimum:
            raise ValueError(f"{self.name}: {v} < min {self.minimum}")
        if self.maximum is not None and v > self.maximum:
            raise ValueError(f"{self.name}: {v} > max {self.maximum}")
        return v


# the framework's option schema: the reference's names and defaults
OPTIONS: List[Option] = [
    Option("erasure_code_dir", str, "",
           desc="directory the native registry dlopens libec_*.so from"),
    Option("ec_min_device_bytes", int, 1 << 20, minimum=0,
           desc="batch size below which the numpy host path runs"),
    Option("crush_bulk_tries", int, 8, minimum=1, maximum=64,
           desc="device-unrolled attempts before host fallback"),
    Option("debug_verify", bool, False,
           desc="re-verify device results against host ground truth"),
    Option("log_level", int, 1, minimum=0, maximum=20,
           desc="default dout level (per-subsystem via CEPH_TPU_DEBUG)"),
    Option("compile_cache", str, "",
           desc="directory of the kernel build cache "
                "(utils/compile_cache.py; empty = the package's own "
                "ops/build/)"),
]


class Config:
    """md_config_t role: schema-validated values with env layering."""

    def __init__(self, options: Optional[List[Option]] = None) -> None:
        self._schema = {o.name: o for o in (options or OPTIONS)}
        self._values: Dict[str, Any] = {}
        self._lock = make_lock("utils.config.Config._lock")

    def get(self, name: str):
        opt = self._schema.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name!r}")
        with self._lock:
            if name in self._values:
                return self._values[name]
        env = os.environ.get(f"CEPH_TPU_{name.upper()}")
        if env is not None:
            return opt.cast(env)
        return opt.default

    def set(self, name: str, value) -> None:
        opt = self._schema.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name!r}")
        v = opt.cast(value)
        with self._lock:
            self._values[name] = v

    def dump(self) -> Dict[str, Any]:
        return {name: self.get(name) for name in self._schema}


_GLOBAL_CONFIG = Config()


def global_config() -> Config:
    return _GLOBAL_CONFIG


@dataclass
class ErasureCodeProfileStore:
    """`ceph osd erasure-code-profile` surface (OSDMonitor.cc role).

    Profiles are free-form string maps; ``set`` validates by
    instantiating the named plugin through the registry — a profile the
    plugins reject never gets stored (the monitor's behavior)."""

    profiles: Dict[str, Dict[str, str]] = field(default_factory=dict)
    # where instantiated codes run: None = the card, "cpu" = the CPU
    device: Optional[str] = None

    DEFAULT = {"plugin": "jerasure", "technique": "reed_sol_van",
               "k": "2", "m": "1"}

    def set(self, name: str, profile: Dict[str, str],
            force: bool = False) -> None:
        if name in self.profiles and not force:
            raise ValueError(
                f"profile {name!r} already exists (use force=True, "
                "matching the CLI's --force)")
        profile = {str(k): str(v) for k, v in profile.items()}
        # validation = instantiation; raises on a bad profile.  The
        # full profile (crush-* keys included) goes to the plugin, as
        # the monitor does — plugins ignore what they don't parse, and
        # create_rule/lrc read the crush-* keys from it.
        self._factory(profile)
        self.profiles[name] = profile

    def get(self, name: str) -> Dict[str, str]:
        if name == "default" and name not in self.profiles:
            return dict(self.DEFAULT)
        return dict(self.profiles[name])

    def rm(self, name: str) -> None:
        if name not in self.profiles:
            raise KeyError(f"no erasure-code profile {name!r}")
        del self.profiles[name]

    def ls(self) -> List[str]:
        names = set(self.profiles) | {"default"}
        return sorted(names)

    def instantiate(self, name: str):
        """Profile -> live ErasureCodeInterface (ECUtil's path)."""
        return self._factory(self.get(name))

    def _factory(self, profile: Dict[str, str]):
        from ..codes.registry import ErasureCodePluginRegistry
        plugin = profile.get("plugin", "jerasure")
        payload = {k: v for k, v in profile.items()
                   if k not in ("plugin", "directory")}
        return ErasureCodePluginRegistry.instance().factory(
            plugin, payload, device=self.device)
