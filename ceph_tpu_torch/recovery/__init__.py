"""ceph_tpu_torch.recovery — epoch-aware, crash-consistent repair; the
port of ``ceph_tpu.recovery``, its modules copies of the reference's.

The peering/recovery discipline above the scrub pipeline: scrub
findings become epoch-stamped RecoveryOps, decode dispatch and
write-back are both fenced against the CURRENT OSDMap epoch (stale
plans re-plan instead of writing to down/out devices), write-back
goes through a write-ahead IntentJournal (intent → write → verify →
commit → clear) so a crash at any named chaos.CRASH_SITES site
resumes idempotently, and per-OSD write admissions are bounded by
OsdRecoveryThrottle with deadline-carrying retries.
"""

from .journal import (  # noqa: F401
    IntentJournal,
    IntentRecord,
    IntentState,
    ReplayStats,
    payload_digest,
)
from .orchestrator import (  # noqa: F401
    RecoveryOp,
    RecoveryOrchestrator,
    RecoveryReport,
    WriteRecord,
    healed,
    recover_to_completion,
)
from .throttle import OsdRecoveryThrottle  # noqa: F401
from ..chaos.adversaries import CRASH_SITES  # noqa: F401
from ..utils.errors import InjectedCrash  # noqa: F401
