"""Erasure-code plugin framework (mirrors src/erasure-code/).

- ``interface``  — ErasureCodeInterface contract + ErasureCodeProfile.
- ``base``       — ErasureCode base class: padding, defaults, device.
- ``registry``   — ErasureCodePluginRegistry + dynamic plugin loading.
- ``techniques`` — MatrixCodeMixin, the GF(2^w) matrix compute paths.
- ``linear``     — minimum-read decode plans of sparse linear codes.
- ``plugins/``   — jerasure, isa, shec, lrc and example equivalents.
"""

from .interface import ErasureCodeInterface, ErasureCodeProfile
from .base import ErasureCode
from .registry import ErasureCodePluginRegistry, ErasureCodePlugin
from .linear import DecodePlan, decode_plan
