"""ceph_tpu_torch.chaos — deterministic fault injection; the port of
``ceph_tpu.chaos``, its modules copies of the reference's.

Seeded, composable injectors that damage stored shards (erasure,
bit-flips, truncation, stripe zeroing, torn write-backs) and the read
path (transient backend errors), over an ObjectStore-like ShardStore —
plus the orchestrator-level adversaries (named crash sites, seeded
OSDMap churn through epoch-ordered incrementals) the recovery
orchestrator must survive, and the device-plane DispatchFault family
(chaos/dispatch.py: transient/OOM/backend-loss/hang/corrupt armed per
(seam, Nth call)) the supervised dispatch plane (ops/supervisor.py)
must classify and absorb, and the host-domain adversaries
(chaos/hosts.py: HostLoss/HostFlap/HostPartition) the host-aware data
plane must survive with a host-granular reshrink and journal-backed
re-dispatch.  The scrub pipeline (ceph_tpu_torch.scrub), the
recovery orchestrator (ceph_tpu_torch.recovery) and the degraded
benchmark rows all drive the same adversaries, so every robustness
claim replays from a (seed, scenario) pair — and replays the
reference's: the same seeds give the same faults, event logs and
firing tables in both packages.  The dispatch plans' consumer is the
supervised dispatch plane (ops/supervisor.py); the host plans are
polled there too, and answered by the data plane's host-granular
reshrink (parallel/plane.py).
"""

from .adversaries import (  # noqa: F401
    CRASH_SITES,
    CrashPoint,
    InjectedCrash,
    MapChurn,
    Straggler,
)
from .dispatch import (  # noqa: F401
    DISPATCH_FAULT_KINDS,
    DispatchFault,
    DispatchFaultPlan,
    dispatch_faults,
)
from .hosts import (  # noqa: F401
    HOST_FAULT_KINDS,
    HostFault,
    HostFaultPlan,
    HostFlap,
    HostLoss,
    HostPartition,
    host_faults,
)
from .injectors import (  # noqa: F401
    BitFlip,
    Compose,
    Fault,
    Injector,
    ShardErasure,
    TornWrite,
    TransientErrors,
    Truncate,
    ZeroStripe,
    damaged_shards,
    inject,
    random_injectors,
)
from .store import ShardStore, ensure_store  # noqa: F401
