"""The roofline tool's two streaming kernels: wrappers and plain versions.

Counterpart of the two Pallas kernels of ``tools/roofline.py`` in the
JAX package, ``_pallas_copy_fn`` and ``_pallas_fold_fn``; the CUDA
source is ``csrc/roofline_probes.cu``.  Both take a (b, s, R, 128)
uint32 slab, the packed layout of ``gf_kernels.pack_chunks``:

- :func:`copy_slab_cuda` — the identity copy (the 2-stream probe:
  every byte read once and written once);
- :func:`fold_slab_cuda` — the s-way XOR fold to (b, 1, R, 128) (the
  pure-read probe: every byte read once, 1/s of it written).

On a CPU tensor a wrapper runs its plain version (:func:`copy_slab_torch`,
:func:`fold_slab_torch`); on a CUDA tensor it launches the kernel or
raises.  Each wrapper counts its launches in ``.launches``, read with
every other kernel wrapper's through ``ops/launches.py``.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load
from .launches import device_and_stream, register
from ..utils.errors import KernelLaunchError

LANE = 128

_lib_state = None


def _lib():
    global _lib_state
    if _lib_state is None:
        lib = load("roofline_probes")
        ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        lib.probe_copy.argtypes = [vp, vp, ll, i, vp]
        lib.probe_copy.restype = i
        lib.probe_fold.argtypes = [vp, vp, ll, i, ll, i, vp]
        lib.probe_fold.restype = i
        lib.probe_error_string.argtypes = [i]
        lib.probe_error_string.restype = ctypes.c_char_p
        _lib_state = lib
    return _lib_state


def _check_slab(tiles: torch.Tensor) -> None:
    if tiles.dtype != torch.uint32 or tiles.dim() != 4 \
            or tiles.shape[-1] != LANE:
        raise ValueError(f"need a (b, s, R, {LANE}) uint32 slab, got "
                         f"{tuple(tiles.shape)} {tiles.dtype}")


def _raise_on(fn, lib, err: int) -> None:
    if err:
        raise KernelLaunchError(
            f"{fn.__name__} failed: CUDA error {err} "
            f"({lib.probe_error_string(err).decode()})")


def copy_slab_torch(tiles: torch.Tensor) -> torch.Tensor:
    """The plain identity copy of a slab, on an int32 view (torch has
    few uint32 ops)."""
    _check_slab(tiles)
    return tiles.view(torch.int32).clone().view(torch.uint32)


def fold_slab_torch(tiles: torch.Tensor) -> torch.Tensor:
    """The plain s-way XOR fold: (b, s, R, 128) -> (b, 1, R, 128), on
    an int32 view (torch has few uint32 ops)."""
    _check_slab(tiles)
    words = tiles.view(torch.int32)
    acc = words[:, 0].clone()
    for j in range(1, words.shape[1]):
        acc ^= words[:, j]
    return acc.unsqueeze(1).view(torch.uint32)


def copy_slab_cuda(tiles: torch.Tensor) -> torch.Tensor:
    """Identity copy of a contiguous (b, s, R, 128) uint32 slab."""
    _check_slab(tiles)
    if tiles.device.type == "cpu":
        return copy_slab_torch(tiles)
    if tiles.device.type != "cuda" or not tiles.is_contiguous():
        raise ValueError(f"the copy kernel takes a contiguous CUDA slab, "
                         f"got one on {tiles.device}")
    out = torch.empty_like(tiles)
    if out.numel() == 0:
        return out
    lib = _lib()
    _raise_on(copy_slab_cuda, lib, lib.probe_copy(
        tiles.data_ptr(), out.data_ptr(), tiles.numel() // 4,
        *device_and_stream(tiles)))
    copy_slab_cuda.launches += 1
    return out


def fold_slab_cuda(tiles: torch.Tensor) -> torch.Tensor:
    """XOR-fold each stripe's s chunks of a contiguous (b, s, R, 128)
    uint32 slab into one: -> (b, 1, R, 128)."""
    _check_slab(tiles)
    if tiles.device.type == "cpu":
        return fold_slab_torch(tiles)
    if tiles.device.type != "cuda" or not tiles.is_contiguous():
        raise ValueError(f"the fold kernel takes a contiguous CUDA slab, "
                         f"got one on {tiles.device}")
    b, s, rows, _ = tiles.shape
    out = torch.empty((b, 1, rows, LANE), dtype=tiles.dtype,
                      device=tiles.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    _raise_on(fold_slab_cuda, lib, lib.probe_fold(
        tiles.data_ptr(), out.data_ptr(), b, s, rows * LANE // 4,
        *device_and_stream(tiles)))
    fold_slab_cuda.launches += 1
    return out


WRAPPERS = register(copy_slab_cuda, fold_slab_cuda)

__all__ = ["WRAPPERS", "copy_slab_cuda", "copy_slab_torch", "fold_slab_cuda",
           "fold_slab_torch"]
