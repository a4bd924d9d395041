"""Erasure-code profile store — the part of ``ceph_tpu.utils.config``
the port needs (``ErasureCodeProfileStore``, the monitor's
``ceph osd erasure-code-profile`` surface).  The rest of that module
(the typed option registry) comes with ROADMAP Queue A item 6.

The store instantiates codes through the port's registry on its
``device``: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


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
