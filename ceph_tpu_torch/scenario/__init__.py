"""ceph_tpu_torch.scenario — the scenario runner (so far its serving
event loop, ``runner.run_serving_scenario``)."""
