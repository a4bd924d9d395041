"""The bulk evaluator's ladder and seams against the host mapper alone
(no reference evaluator here; tests/test_torch_crush_bulk.py holds the
cases run through ``ceph_tpu.crush.bulk``): randomized maps of every
bucket algorithm with reweights and choose_args, ties, x near 2^32,
small blocks, the CEPH_TPU_VERIFY re-check, and the NoDeviceError of the
default device without a card.  Every comparison is exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ceph_tpu_torch.crush import bulk
from ceph_tpu_torch.utils.errors import NoDeviceError

from test_torch_crush import (N, PORT, gen_map, host_rows as _host, pin,
                              steps, two_level)


def test_ties_resolve_to_the_first_slot():
    """All draws of a bucket equal (choose_args ids all alike, equal
    weights), and all-zero weight sets: the first slot wins, as the host
    mapper's `draw > high_draw` scan decides."""
    T = PORT.types
    b, root = two_level(PORT, 4, 3)
    b.add_rule(0, steps(PORT, "chooseleaf_indep", root))
    args = {bid: T.ChooseArg(weight_set=[[0x10000] * bk.size],
                             ids=[77] * bk.size)
            for bid, bk in b.map.buckets.items()}
    xs = np.arange(96)
    pin(b.map, None, 0, 3, choose_args=args, xs=xs, against_ref=False)
    args[root] = T.ChooseArg(weight_set=[[0] * 4])
    pin(b.map, None, 0, 3, choose_args=args, xs=xs, against_ref=False)


def test_x_near_2_32_and_repeated_lanes():
    b, root = two_level(PORT, 6, 2)
    b.add_rule(0, steps(PORT, "chooseleaf_firstn", root))
    b.add_rule(1, steps(PORT, "ec_canonical", root))
    xs = np.array([2 ** 32 - 1, 2 ** 32 - 2, 2 ** 31, 2 ** 31 - 1, 0, 1,
                   2 ** 32 - 1, 2 ** 32 + 5, 12345])
    for rule in (0, 1):
        pin(b.map, None, rule, 4, xs=xs, against_ref=False)


@pytest.mark.parametrize("seed", [0, 2, 3, 6])
def test_randomized_maps_against_the_host_mapper(seed):
    """tests/test_crush_mapper_kat.py's generator (every algorithm,
    reweights, choose_args on seeds divisible by 3), rules 0-5."""
    cmap, rules, w, ca = gen_map(PORT, seed, bulk_ok=True)
    for rule in rules:
        multi = ca is not None and any(
            a.weight_set and len(a.weight_set) > 1 for a in ca.values())
        # multi-position weight sets with firstn send every short lane to
        # the host mapper (the exact_budget note): fewer lanes there
        xs = np.arange(64 if multi and rule in (0, 2, 4) else 256)
        pin(cmap, None, rule, 6, weight=w, choose_args=ca, xs=xs,
            against_ref=False, host_lanes=24)


def test_small_blocks_give_the_same_lanes(monkeypatch):
    b, root = two_level(PORT, 8, 2)
    b.add_rule(0, steps(PORT, "ec_canonical", root))
    want, _ = bulk.bulk_do_rule(b.map, 0, np.arange(N), 6, device="cpu")
    monkeypatch.setattr(bulk, "BLOCK_BYTES", 1)      # 1024-lane blocks
    monkeypatch.setattr(bulk, "MAX_BLOCK", 100)
    assert bulk.block_lanes(bulk.CompiledCrushMap(b.map, device="cpu"),
                            0, 6, 8) == 1024
    got, _ = bulk.bulk_do_rule(b.map, 0, np.arange(3000), 6, device="cpu")
    np.testing.assert_array_equal(got[:N], want)
    np.testing.assert_array_equal(
        got[2500:2600], _host(b.map, 0, np.arange(2500, 2600), 6))


def test_verify_mode_rechecks_every_lane(monkeypatch):
    from ceph_tpu_torch.utils.debug import DeviceVerificationError
    b, root = two_level(PORT)
    b.add_rule(0, steps(PORT, "chooseleaf_firstn", root))
    monkeypatch.setenv("CEPH_TPU_VERIFY", "1")
    bulk.bulk_do_rule(b.map, 0, np.arange(64), 3, device="cpu")
    real = bulk.compile_rule

    def flipped(*a, **k):
        fn = real(*a, **k)

        def g(*args):
            out, cnt, need = fn(*args)
            out = out.clone()
            out[5, 0] = out[5, 1]
            return out, cnt, need
        return g
    monkeypatch.setattr(bulk, "compile_rule", flipped)
    with pytest.raises(DeviceVerificationError, match="x=5"):
        bulk.bulk_do_rule(b.map, 0, np.arange(64), 3, device="cpu")


def test_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b, root = two_level(PORT)
    b.add_rule(0, steps(PORT, "chooseleaf_firstn", root))
    with pytest.raises(NoDeviceError):
        bulk.bulk_do_rule(b.map, 0, np.arange(8), 3)
    with pytest.raises(NoDeviceError):
        bulk.CompiledCrushMap(b.map)


def test_compile_rule_fn_takes_a_weight_vector():
    """compile_rule's fn(xs, weight_vec): the lanes it does not flag are
    the host mapper's, with and without the all-in hint; an empty
    weight vector leaves every device out."""
    b, root = two_level(PORT, 4, 3)
    b.add_rule(0, steps(PORT, "chooseleaf_firstn", root))
    cm = bulk.CompiledCrushMap(b.map, device="cpu")
    fn = bulk.compile_rule(cm, 0, 3, 8)
    xs = np.arange(200)
    w = np.full(12, 0x10000)
    w[4] = 0x6000
    for all_in in (None, False):
        out, cnt, need = fn(torch.from_numpy(xs), torch.from_numpy(w),
                            all_in)
        keep = ~need.numpy()
        assert keep.sum() > 150
        np.testing.assert_array_equal(
            out.numpy()[keep], _host(b.map, 0, xs[keep], 3, list(w)))
        np.testing.assert_array_equal(cnt.numpy()[keep],
                                      (out.numpy()[keep] != 0x7FFFFFFF
                                       ).sum(1))
    out, cnt, need = fn(torch.from_numpy(xs), torch.zeros(0,
                                                          dtype=torch.long))
    assert (out == 0x7FFFFFFF).all() and (cnt == 0).all()
    np.testing.assert_array_equal(
        bulk.bulk_do_rule(cm, 0, xs[:20], 3, weight=[])[0],
        _host(b.map, 0, xs[:20], 3, []))
