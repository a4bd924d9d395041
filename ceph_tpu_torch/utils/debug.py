"""Device-result verification — the part of ``ceph_tpu.utils.debug`` the
port needs.

With ``CEPH_TPU_VERIFY=1`` in the environment, the codec mixins
(``codes/techniques.py``) re-check every device result of their batch
entries against the host ground truth (``ops/regionops.py``) and raise
:class:`DeviceVerificationError` on a difference, as the reference does.
The reference's ``debug_mode`` (jax NaN checks) has no counterpart: the
port's math is integer.
"""

from __future__ import annotations

import os


class DeviceVerificationError(AssertionError):
    """Device compute path disagreed with the host ground truth."""


def verification_enabled() -> bool:
    """True when ``CEPH_TPU_VERIFY=1``: device results are re-checked."""
    return os.environ.get("CEPH_TPU_VERIFY") == "1"


__all__ = ["DeviceVerificationError", "verification_enabled"]
