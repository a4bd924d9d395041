"""Multi-device parallelism over torch devices: meshes, the data plane,
sharded erasure-code compute and sharded CRUSH — the port of
``ceph_tpu/parallel/``.

The reference keeps a stripe batch on a ``jax.sharding.Mesh`` and lets
XLA insert the collectives; the port shards eagerly over
``torch.device`` members (``utils/shard.py``):

- stripe axis ("dp"): stripes are independent -> pure data parallelism,
  no cross-member traffic beyond the scatter and the gather;
- chunk axis ("tp"): the k data chunks of a stripe spread across
  members; parity is the XOR of the members' partial parities
  (``sharded_codes.sharded_encode``).

An active :mod:`~ceph_tpu_torch.parallel.plane` DataPlane makes
``select_matrix_engine`` return "mesh", the engine's fused-repair and
serving callables build sharded variants, and CRUSH bulk shards the x
axis.  On one card a plane forms over virtual members
(``CEPH_TPU_TORCH_VIRTUAL_DEVICES``, parallel/mesh.py).
"""

from .mesh import Mesh, make_mesh, visible_devices  # noqa: F401
from .plane import (  # noqa: F401
    DataPlane,
    activate,
    data_plane,
    deactivate,
    mesh_plane,
    plane_topology,
    resolve_plane,
    set_data_plane,
)
from .sharded_codes import sharded_encode, sharded_roundtrip_step  # noqa: F401
from .sharded_crush import default_crush_mesh, sharded_bulk_do_rule  # noqa: F401
