"""ceph_tpu_torch.cluster — the 10k-OSD cluster plane; a port of
``ceph_tpu/cluster/``.  The maps it builds run their bulk CRUSH
evaluation on the card unless the caller asks for the CPU.

Makes "10k OSDs, millions of PGs" a first-class workload over the
existing device stack:

- :mod:`topology` — seeded synthetic clusters (root→rack→host→osd
  straw2, capacity tiers, device classes, replicated + EC rules)
  producing real CrushMap/OSDMap objects from a :class:`ClusterSpec`;
- :mod:`balance`  — the balancer loop closed on device: one bulk
  CRUSH evaluation per pool, incremental host rounds, a convergence
  report (iterations, max-deviation trajectory, remap fraction);
- :mod:`storms`   — MapChurn storms through the incremental path with
  full-cluster remap convergence measured per epoch on the bulk
  evaluator, plus the incremental ≡ rebuilt ≡ catch_up equivalence
  gate;
- :mod:`rateless` — straggler-tolerant recovery (arXiv 1804.10331):
  over-plan decode units across the mesh shards with redundancy r,
  take the first-k completions, feed the measured completion skew
  back into the recovery throttle as per-OSD weights.

The bench CLI's ``--workload cluster`` drives storm → balance →
recover end to end from one seed.
"""

from .balance import BalanceReport, balance_cluster  # noqa: F401
from .rateless import (  # noqa: F401
    RatelessReport,
    Schedule,
    plan_assignments,
    rateless_dispatch_call,
    rateless_recover,
    shard_weights,
    simulate_first_k,
)
from .storms import (  # noqa: F401
    StormReport,
    run_churn_storm,
    verify_storm_equivalence,
)
from .topology import (  # noqa: F401
    EC_POOL,
    REPLICATED_POOL,
    ClusterSpec,
    build_cluster,
    topology_summary,
)

__all__ = [
    "BalanceReport", "ClusterSpec", "EC_POOL", "RatelessReport",
    "REPLICATED_POOL", "Schedule", "StormReport", "balance_cluster",
    "build_cluster", "plan_assignments", "rateless_dispatch_call",
    "rateless_recover", "run_churn_storm", "shard_weights",
    "simulate_first_k", "topology_summary", "verify_storm_equivalence",
]
