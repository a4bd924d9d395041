"""The benchmark of ceph_tpu_torch on one cell:

    python3 benchmarks/run.py --workload CELL --seed N --seconds S --trace 0|1

run from the root of a checkout.  It sets up the cell of
``BENCHMARK.json`` named CELL from the seed, measures for S seconds,
compares what the timed path produced with the plain reference, and
prints one JSON line: ``correct``, ``attempted``, ``failed``, the
cell's end-to-end metrics (``--trace 0``) or per-layer metrics
(``--trace 1``, from a ``torch.profiler`` window), ``device`` and the
numbers compared.  Without the CUDA devices the cell asks for it exits
2 and prints no result.  Kernel build caches go to
``benchmarks/build_cache/`` inside the checkout.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "build_cache")
os.environ["CEPH_TPU_COMPILE_CACHE"] = os.path.join(CACHE, "kernels")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [ROOT, HERE]

from yardstick import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
