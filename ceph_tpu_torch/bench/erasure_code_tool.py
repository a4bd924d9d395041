"""ceph_erasure_code-equivalent CLI — src/test/erasure-code/
ceph_erasure_code.cc: load a plugin from a profile and report whether
it initializes (the tool the mon's profile validation mirrors and QA
scripts use to probe plugin availability).  A port of
``ceph_tpu/bench/erasure_code_tool.py``.

  python -m ceph_tpu_torch.bench.erasure_code_tool --plugin_exists jerasure
  python -m ceph_tpu_torch.bench.erasure_code_tool \\
      --plugin jerasure --parameter k=4 --parameter m=2 \\
      --parameter technique=reed_sol_van [--all] [--device cuda|cpu]

--all additionally exercises an encode/decode round-trip (the
reference gates on init only; the round-trip is this framework's
sanity extension, off by default for CLI-compat).  The code runs on
the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..codes.registry import ErasureCodePluginRegistry
from .erasure_code_benchmark import _parse_parameters


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ceph_erasure_code",
                                description=__doc__.split("\n")[0])
    p.add_argument("--plugin_exists", metavar="NAME",
                   help="exit 0 iff the named plugin can be loaded")
    p.add_argument("-p", "--plugin", default="jerasure")
    p.add_argument("-P", "--parameter", action="append", default=[],
                   help="profile key=value (repeatable)")
    p.add_argument("--all", action="store_true",
                   help="also run an encode/decode round-trip")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the code runs: the card (default) or the "
                        "CPU")
    a = p.parse_args(argv)

    reg = ErasureCodePluginRegistry.instance()
    if a.plugin_exists:
        try:
            reg.load(a.plugin_exists)
        except Exception as e:  # noqa: BLE001 - CLI reports any failure
            print(f"plugin {a.plugin_exists}: {e}", file=sys.stderr)
            return 1
        print(f"plugin {a.plugin_exists} exists")
        return 0

    profile = _parse_parameters(a.parameter)
    try:
        ec = reg.factory(a.plugin, profile, device=a.device)
    except Exception as e:  # noqa: BLE001
        print(f"failed to initialize {a.plugin} with profile "
              f"{profile}: {e}", file=sys.stderr)
        return 1
    k, m_ = ec.get_data_chunk_count(), ec.get_coding_chunk_count()
    print(f"plugin {a.plugin} initialized: k={k} m={m_} "
          f"chunk_count={ec.get_chunk_count()} "
          f"sub_chunks={ec.get_sub_chunk_count()}")
    if a.all:
        size = k * ec.get_chunk_size(k * 4096)
        data = np.random.default_rng(0).integers(
            0, 256, size=size, dtype=np.uint8).tobytes()
        n = ec.get_chunk_count()
        enc = ec.encode(set(range(n)), data)
        avail = {i: enc[i] for i in range(1, n)}       # erase chunk 0
        dec = ec.decode({0}, avail, len(enc[0]))
        if dec[0] != enc[0]:
            print("round-trip FAILED", file=sys.stderr)
            return 1
        print("round-trip ok (1 erasure)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
