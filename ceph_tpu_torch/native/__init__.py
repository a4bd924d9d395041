"""ceph_tpu_torch.native — the native tree that reaches the card.

``plugins/cuda.cc`` is ``plugin=cuda``: a plugin of the C++ registry
(``native/src/plugin.cc``) that embeds CPython and forwards every
encode, decode and ``minimum_to_decode`` to this package's codes, so an
unmodified native consumer (``ceph_erasure_code_benchmark``,
``ceph_erasure_code``; ECBackend's role upstream) selects the card by
name.  ``build.py`` compiles it, the registry, the AVX2 ``rs`` plugin
and the tools with ``c++``; ``tools/bridge_mt.cc`` drives the bridge
from three threads and prints the port's counters.
"""
