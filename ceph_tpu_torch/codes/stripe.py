"""The part of ``ceph_tpu/codes/stripe.py`` (the ECUtil analog) the
serving plane needs: ``_chunk_mapping``.  The stripe geometry, the
whole-object transforms, crc32c and HashInfo come with ROADMAP Queue A
item 4.
"""

from __future__ import annotations

from typing import List


def _chunk_mapping(ec) -> List[int]:
    """get_chunk_mapping(), defaulting to identity (ErasureCode.cc:
    an empty mapping means chunk i lives on shard i).

    Codes whose mapping names only the k DATA positions (lrc) are
    completed with the parity positions in ascending order — exactly
    the order encode_chunks_batch emits parity rows — so mapping[i]
    is the shard of data chunk i for i < k and of parity j for
    i == k + j, for every plugin."""
    n = ec.get_chunk_count()
    mapping = list(ec.get_chunk_mapping() or [])
    if not mapping:
        return list(range(n))
    if len(mapping) < n:
        data = set(mapping)
        mapping = mapping + [p for p in range(n) if p not in data]
    return mapping
