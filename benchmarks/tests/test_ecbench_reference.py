"""The benchmark's plain reference against ceph_tpu_torch at small sizes
on the CPU: parity, rebuilt chunks, and up sets under seeded churn."""

import itertools

import numpy as np
import pytest
import torch

from yardstick import churn, gf256, placement, spec
from yardstick.kinds import osdmap_churn

PROFILES = {
    "rs_k8_m3": {"plugin": "jerasure", "technique": "reed_sol_van",
                 "k": "8", "m": "3"},
    "shec_k6_m3_c2": {"plugin": "shec", "technique": "multiple",
                      "k": "6", "m": "3", "c": "2"},
}


def program_code(profile):
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    args = {k: v for k, v in profile.items() if k != "plugin"}
    return ErasureCodePluginRegistry.instance().factory(
        profile["plugin"], args, device="cpu")


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_configs_state_these_profiles(name):
    cfg = spec.cell(next(w["name"] for w in spec.load_benchmark()
                         ["workloads"] if w["config"] == name)).config
    assert cfg["profile"] == PROFILES[name]


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_matrices_match_the_program(name):
    code = program_code(PROFILES[name])
    assert np.array_equal(gf256.coding_matrix(PROFILES[name]), code.matrix)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_encode_matches_the_program(name):
    profile = PROFILES[name]
    code = program_code(profile)
    k = int(profile["k"])
    g = torch.Generator().manual_seed(7)
    data = torch.randint(0, 256, (3, k, 512), dtype=torch.uint8, generator=g)
    want = gf256.encode(data, gf256.coding_matrix(profile))
    assert torch.equal(code.encode_chunks_torch(data), want)


@pytest.mark.parametrize("name,lost_count", [("rs_k8_m3", 1),
                                             ("rs_k8_m3", 2),
                                             ("shec_k6_m3_c2", 1)])
def test_decode_matches_the_program(name, lost_count):
    profile = PROFILES[name]
    code = program_code(profile)
    k, m = int(profile["k"]), int(profile["m"])
    matrix = gf256.coding_matrix(profile)
    g = torch.Generator().manual_seed(11)
    data = torch.randint(0, 256, (2, k, 256), dtype=torch.uint8, generator=g)
    full = torch.cat([data, gf256.encode(data, matrix)], dim=1)
    for lost in itertools.combinations(range(k), lost_count):
        avail = tuple(c for c in range(k + m) if c not in lost)
        surv = full[:, list(avail)].contiguous()
        want = data[:, list(lost)]
        assert torch.equal(code.decode_chunks_torch(surv, avail, lost), want)
        assert torch.equal(gf256.decode(surv, matrix, avail, lost), want)


def test_up_sets_match_the_program_under_churn(tiny):
    cell = tiny(spec.cell("rs_k8_m3.remap"))
    cluster = cell.config["cluster"]
    n = cluster["hosts"] * cluster["osds_per_host"]
    osdmap, pid = osdmap_churn.build(cell.config, torch.device("cpu"))
    ref = placement.Placement(cluster, cluster["pool"])
    states = churn.OsdStates(n)
    from ceph_tpu_torch.crush.incremental import apply_incremental
    for ev in itertools.islice(churn.events(5, n, cell.traffic), 6):
        apply_incremental(osdmap, osdmap_churn.incremental(
            ev, osdmap.epoch + 1))
        states.apply(ev)
        up, primary = osdmap.pg_to_up_bulk(pid)
        for ps in range(cluster["pool"]["pg_num"]):
            want_up, want_primary = ref.up(ps, states.up, states.weight)
            assert list(up[ps]) == want_up
            assert int(primary[ps]) == want_primary


def test_churn_is_seeded_and_bounded(tiny):
    traffic = dict(tiny(spec.cell("rs_k8_m3.remap")).traffic, max_down=3)
    a = list(itertools.islice(churn.events(2**31 + 9, 40, traffic), 200))
    b = list(itertools.islice(churn.events(2**31 + 9, 40, traffic), 200))
    assert a == b
    states = churn.OsdStates(40)
    for ev in a:
        states.apply(ev)
        assert len(states.down()) <= 3
        assert ev.op != "reweight" or 0x8000 <= ev.weight <= 0x10000
    assert {ev.op for ev in a} == {"down_out", "revive", "reweight"}
    other = list(itertools.islice(churn.events(12, 40, traffic), 200))
    assert [ev.op for ev in other] == [ev.op for ev in a]
    assert [ev.osd for ev in other] != [ev.osd for ev in a]
