"""ceph_tpu_torch.tune — the autotuner, a port of ``ceph_tpu/tune``.

Profiler-driven config search over a bounded declarative space
(tune/space.py), persisting winners in a versioned, schema-validated
best-config table (tune/table.py) the consultation seams read.  Two
measurement modes (tune/sweep.py): host-only analytic (no device — the
``tune.sweep`` audit entry) and timed min-of-N dispatch with CUDA
events on the card.  ``python -m ceph_tpu_torch.tools.autotune`` is the
CLI.
"""

from .table import (BestConfigTable, active_source, active_table,
                    consult, install_table, key_hash, key_str,
                    matrix_digest, profile_str, scoped_table,
                    tuning_key, validate_table)

__all__ = [
    "BestConfigTable", "active_source", "active_table", "consult",
    "install_table", "key_hash", "key_str", "matrix_digest",
    "profile_str", "scoped_table", "tuning_key", "validate_table",
]
