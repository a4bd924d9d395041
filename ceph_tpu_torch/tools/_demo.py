"""What the port's demos and tools share: the ``--device host|cuda|cpu``
rule, the codes made for it, and the checks the chaos demos read.

- ``cuda`` (every tool's default): the card; without one
  ``NoDeviceError`` — no tool drops to the CPU on its own;
- ``cpu``: the same device path on CPU tensors (the torch tier);
- ``host``: the host arm — a CPU instance pinned to the numpy region ops
  (``min_xla_bytes = inf``), the host executor and host recoveries.
"""

from __future__ import annotations

DEVICES = ("host", "cuda", "cpu")


def torch_device(device: str):
    """The torch device a ``--device`` runs on (the CPU for host and
    cpu; the card for cuda, ``NoDeviceError`` without one)."""
    from ..ops.fallback import resolve_device
    return resolve_device("cpu" if device == "host" else device)


def run_kwargs(device: str) -> dict:
    """``executor=`` and ``device=`` of the scenario runners
    (``run_scenario``, ``run_tenant_week``, ``run_serving_scenario``)
    for a ``--device``: the host executor, or the device executor on
    that device."""
    if device == "host":
        return {"executor": "host"}
    return {"executor": "device", "device": torch_device(device)}


def instance(plugin: str, profile: dict, device: str):
    """A configured erasure code for ``--device``; a host instance is
    pinned to the numpy region ops."""
    from ..codes.registry import ErasureCodePluginRegistry

    ec = ErasureCodePluginRegistry.instance().factory(
        plugin, dict(profile), device=torch_device(device))
    if device == "host":
        ec.min_xla_bytes = float("inf")
    return ec


def map_device(device: str) -> str:
    """Where an OSDMap's bulk path runs for ``--device``."""
    return str(torch_device(device))


def stores_identical(a, b) -> bool:
    for sa, sb in zip(a, b):
        if sorted(sa.shards) != sorted(sb.shards):
            return False
        for s in sa.shards:
            if bytes(sa.shards[s]) != bytes(sb.shards[s]):
                return False
    return True


def dump_triggers() -> list:
    from ..telemetry import recorder
    return [d["trigger"] for d in
            recorder.global_flight_recorder().to_dict()["dumps"]]
