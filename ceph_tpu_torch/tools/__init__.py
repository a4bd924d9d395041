"""ceph_tpu_torch.tools — command-line tools of the port (``python -m
ceph_tpu_torch.tools.roofline``)."""
