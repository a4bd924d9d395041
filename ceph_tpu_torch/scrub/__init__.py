"""ceph_tpu_torch.scrub — deep-scrub / repair / remap pipeline; the port
of ``ceph_tpu.scrub``.

The PGScrubber + ECBackend-recovery analog over a ShardStore: batch
crc32c verification against HashInfo, clean/missing/corrupt
classification, plan-driven reconstruction with re-encode + CRC
re-verification, OSDMap feedback so CRUSH remaps away from bad
devices, and a degraded-mode read that raises structured
UnrecoverableError (with exact lost extents) instead of ever
returning garbage.  The batched repair runs its fused decode →
re-encode on the code's device (the card's kernels by default).
"""

from .deep_scrub import (  # noqa: F401
    CRC_SEED,
    BatchRepairReport,
    RemapReport,
    RepairReport,
    ScrubReport,
    ShardState,
    ShardVerdict,
    apply_osd_feedback,
    deep_scrub,
    read_degraded,
    repair,
    repair_batched,
    scrub_and_repair,
    unrecoverable_extents,
)
from ..utils.errors import ScrubError, UnrecoverableError  # noqa: F401
