"""ceph_tpu_torch.analysis — the port's analysis tables.

Only the lock-order registry (``lockmodel.py``) is here so far: the
runtime lock-order validator (``utils/locks.py``) reads its ranks.  The
static tiers of ``ceph_tpu.analysis`` (the lint rules, the concurrency
and determinism passes) come with ROADMAP Queue A item 8.
"""
