"""The launch counts of every kernel wrapper in ``ops``, and the device
and stream a launch goes to.

Each wrapper that launches a CUDA kernel is registered here
(:func:`register`) and adds to its ``.launches`` where it launches, and
nowhere else.  :func:`launch_counts` reads every wrapper of the kernel
modules (``KERNEL_MODULES``, imported on first read so the set does not
depend on what the caller imported), :func:`reset_launch_counts` sets
them all to 0.
"""

from __future__ import annotations

import importlib

import torch

# the modules whose wrappers launch CUDA kernels
KERNEL_MODULES = ("gf_kernels", "probe_kernels", "crush_kernels")

_wrappers: list = []


def register(*fns) -> tuple:
    """Count launches on each of ``fns`` (``fn.launches``, from 0)."""
    for fn in fns:
        fn.launches = 0
        if fn not in _wrappers:
            _wrappers.append(fn)
    return fns


def wrappers() -> tuple:
    """Every registered wrapper of the kernel modules, in module order."""
    for name in KERNEL_MODULES:
        importlib.import_module(f"{__package__}.{name}")
    return tuple(_wrappers)


def launch_counts() -> dict:
    """{wrapper name: kernel launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in wrappers()}


def reset_launch_counts() -> None:
    for fn in wrappers():
        fn.launches = 0


def device_and_stream(x: torch.Tensor) -> tuple[int, int]:
    """(device index, current stream handle) of CUDA tensor ``x``: where
    a launch on its data goes."""
    index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    return index, torch.cuda.current_stream(x.device).cuda_stream


__all__ = ["KERNEL_MODULES", "device_and_stream", "launch_counts",
           "register", "reset_launch_counts", "wrappers"]
