"""EC pool creation — the monitor's `ceph osd pool create … erasure
<profile>` surface.

Reference: src/mon/OSDMonitor.cc → OSDMonitor::prepare_new_pool +
crush_rule_create_erasure: resolve the erasure-code profile, validate
it by instantiating the plugin through the registry, let the plugin
emit its placement rule (ErasureCodeInterface::create_ruleset — the
default indep rule, or lrc's locality geometry), then create the pool
with size = chunk count and the EC min_size formula.
"""

from __future__ import annotations

from typing import Optional

from .builder import CrushBuilder
from .osdmap import OSDMap, PGPool


def crush_rule_create_erasure(builder: CrushBuilder, name: str,
                              ec, rule_id: Optional[int] = None) -> int:
    """OSDMonitor.cc → crush_rule_create_erasure: reuse an existing
    rule of the same name, else ask the plugin for its rule."""
    for rid, rule in builder.map.rules.items():
        if rule.name == name:
            return rid
    return ec.create_rule(builder, rule_id=rule_id, name=name)


def create_erasure_pool(m: OSDMap, store, profile_name: str,
                        pool_id: int, pg_num: int,
                        rule_name: str = "") -> PGPool:
    """OSDMonitor.cc → prepare_new_pool (erasure branch): profile →
    validated plugin → placement rule → pool.

    - size = plugin chunk count (k + m [+ locality parities]);
    - min_size = k + min(1, m - 1) (the monitor's EC default: one
      coding chunk of slack when m >= 2, none when m == 1);
    - the rule goes into the OSDMap's own crush hierarchy (wrapped
      with CrushBuilder.from_map) and the pool references it.
    """
    if pool_id in m.pools:
        # OSDMonitor::prepare_new_pool refuses duplicates; silently
        # replacing a pool would destroy its definition
        raise ValueError(f"pool {pool_id} already exists")
    ec = store.instantiate(profile_name)
    builder = CrushBuilder.from_map(m.crush)
    rid = crush_rule_create_erasure(builder, rule_name or profile_name,
                                    ec)
    n = ec.get_chunk_count()
    k = ec.get_data_chunk_count()
    pool = PGPool(pool_id=pool_id, pg_num=pg_num, size=n,
                  min_size=k + min(1, n - k - 1), crush_rule=rid,
                  erasure=True)
    m.pools[pool_id] = pool
    return pool
