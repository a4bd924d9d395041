"""The frozen cost arithmetic against the program's own
(telemetry/profiler.py, ops/gf_kernels.py) at the cells' shapes."""

import pytest

from yardstick import costs, gf256


@pytest.mark.parametrize("profile,stripes,reads,writes,chunk", [
    ({"plugin": "jerasure", "technique": "reed_sol_van", "k": "8",
      "m": "3"}, 1024, 8, 3, 131072),
    ({"plugin": "shec", "technique": "multiple", "k": "6", "m": "3",
      "c": "2"}, 512, 6, 3, 174784),
])
def test_encode_cost_matches_the_profiler(profile, stripes, reads, writes,
                                          chunk):
    from ceph_tpu_torch.ops.gf_kernels import sm90_op_floor
    from ceph_tpu_torch.ops.torch_ops import matrix_to_static
    from ceph_tpu_torch.telemetry import profiler
    matrix = gf256.coding_matrix(profile)
    ops_per_word = sm90_op_floor(matrix_to_static(matrix))
    assert costs.gf_op_floor(matrix) == ops_per_word
    mine = costs.gf_apply_cost(stripes, reads, writes, chunk, matrix)
    theirs = profiler.analytic_kernel_cost(stripes, writes, reads, chunk,
                                           ops_per_word)
    assert mine["bytes"] == theirs["bytes accessed"]
    assert mine["ops"] == theirs["flops"]
    t, by = costs.roofline_s(mine)
    ms, by_p = profiler.roofline_ms(theirs)
    assert t * 1e3 == pytest.approx(ms, rel=1e-12) and by == by_p


@pytest.mark.parametrize("stripes,reads,writes,chunk", [
    (1024, 8, 2, 131072), (512, 4, 1, 174784)])
def test_decode_bytes_match_the_profiler(stripes, reads, writes, chunk):
    from ceph_tpu_torch.telemetry import profiler
    mine = costs.gf_apply_cost(stripes, reads, writes, chunk)
    theirs = profiler.analytic_kernel_cost(stripes, writes, reads, chunk,
                                           0)
    assert mine["bytes"] == theirs["bytes accessed"]
    assert costs.roofline_s(mine)[1] == "bytes"


def test_min_reads():
    rs = {"plugin": "jerasure", "technique": "reed_sol_van", "k": "8",
          "m": "3"}
    shec = {"plugin": "shec", "technique": "multiple", "k": "6", "m": "3",
            "c": "2"}
    assert costs.min_reads(rs, (0, 5)) == 8
    assert [costs.min_reads(shec, (j,)) for j in range(6)] == [4] * 6


def test_peaks_match_the_profiler():
    from ceph_tpu_torch.telemetry import profiler
    assert costs.HBM_BYTES_PER_S == profiler.CARD_PEAK_GBPS[profiler.H100] \
        * 1e9
    assert costs.INT32_OPS_PER_S == \
        profiler.CARD_INT32_OPS_PER_S[profiler.H100]
