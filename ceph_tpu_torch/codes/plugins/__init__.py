"""Erasure-code plugins (mirrors src/erasure-code/{jerasure,isa,shec,lrc}).

Each module follows the __erasure_code_init__ contract documented in
ceph_tpu_torch.codes.registry (the dlopen/__erasure_code_init ABI
equivalent).
"""
