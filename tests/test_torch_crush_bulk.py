"""The port's bulk CRUSH evaluator (``ceph_tpu_torch.crush.bulk`` with
``device="cpu"``) against the reference's (``ceph_tpu.crush.bulk``, a
jitted XLA program on the CPU) and the host mapper, mapping for mapping:
regular two-level maps, the canonical EC rule with and without
reweights, chained ``choose … 1`` steps, choose_args (weight sets and
ids), the legacy straw / list / tree / uniform buckets and a mixed map,
a tree bucket with node weights near 2^32, and every gate's ValueError.

Each case runs 1024 lanes through the port, and through the reference
where ``pin``'s ``against_ref`` holds (its jit compiles take 2-6 s a
rung program on the CPU, so the cases the reference's own tests pin
hardest run against the host mapper alone), and holds a seeded subset
(and the lanes the port's first rung flagged) to the host mapper.  This
is the one test file that imports ``ceph_tpu.crush.bulk`` (it turns on
``jax_enable_x64`` at import); tests/test_torch_crush_ladder.py holds
the ladder's host-only cases.
"""

from __future__ import annotations

import numpy as np
import pytest

from ceph_tpu.crush import bulk as ref_bulk
from ceph_tpu_torch.crush import bulk

from test_torch_crush import PORT, REF, alg_map, pin as _pin, steps, two_level

def pin(*args, **kw):
    """test_torch_crush.pin with the reference evaluator."""
    return _pin(*args, ref_bulk=ref_bulk.bulk_do_rule, **kw)


def both(fn, *args):
    """fn over the port's package and the reference's."""
    return fn(PORT, *args), fn(REF, *args)


@pytest.mark.parametrize("shape", ["chooseleaf_firstn", "chooseleaf_indep",
                                   "choose_firstn_dev", "choose_indep_dev"])
def test_regular_two_level(shape):
    def make(P):
        b, root = two_level(P, seed=1)
        b.add_rule(0, steps(P, shape, root))
        return b.map
    pin(*both(make), 0, 3, against_ref=shape.startswith("chooseleaf"))


@pytest.mark.parametrize("reweight", [False, True])
def test_canonical_ec_rule(reweight):
    """set_chooseleaf_tries 5, set_choose_tries 100, chooseleaf indep 0:
    6 shards over 8 hosts, with and without device reweights."""
    def make(P):
        b, root = two_level(P, 8, 2)
        b.add_rule(0, steps(P, "ec_canonical", root))
        return b.map
    w = None
    if reweight:
        w = [0x10000] * 16
        w[0], w[3], w[9], w[12] = 0, 0x4000, 0x8000, 0
    pin(*both(make), 0, 6, weight=w)


def three_level(P, racks=4, hosts=2, devs=2):
    b = P.builder.CrushBuilder()
    b.add_type(1, "host")
    b.add_type(2, "rack")
    b.add_type(3, "root")
    rk, d = [], 0
    for _ in range(racks):
        hs = []
        for _ in range(hosts):
            hs.append(b.add_bucket("straw2", "host", [d + i
                                                      for i in range(devs)]))
            d += devs
        rk.append(b.add_bucket("straw2", "rack", hs))
    return b, b.add_bucket("straw2", "root", rk)


@pytest.mark.parametrize("shape", ["indep_chain", "firstn_chain",
                                   "indep_to_osd"])
def test_chained_choose_one(shape):
    def make(P):
        T = P.types
        b, root = three_level(P)
        b.add_rule(0, {
            "indep_chain": [T.step_take(root), T.step_choose_indep(0, 2),
                            T.step_chooseleaf_indep(1, 1), T.step_emit()],
            "firstn_chain": [T.step_take(root), T.step_choose_firstn(0, 2),
                             T.step_chooseleaf_firstn(1, 1), T.step_emit()],
            "indep_to_osd": [T.step_take(root), T.step_choose_indep(0, 2),
                             T.step_choose_indep(1, 1),
                             T.step_choose_indep(1, 0), T.step_emit()],
        }[shape])
        return b.map
    w = [0x10000] * 16
    w[2], w[11] = 0, 0x6000
    pin(*both(make), 0, 3, weight=w, against_ref=shape != "indep_to_osd")


def _choose_args(P, cmap, seed, with_ids, positions=3):
    rng = np.random.default_rng(seed)
    args = {}
    for bid, bk in cmap.buckets.items():
        ws = [[int(w) for w in rng.integers(0x4000, 0x30000, bk.size)]
              for _ in range(positions)]
        ids = ([int(i) for i in rng.integers(0, 100000, bk.size)]
               if with_ids else None)
        args[bid] = P.types.ChooseArg(weight_set=ws, ids=ids)
    return args


@pytest.mark.parametrize("shape,with_ids,positions", [
    ("chooseleaf_firstn", True, 3), ("chooseleaf_indep", True, 3),
    ("chooseleaf_firstn", False, 1), ("choose_indep_dev", False, 2)])
def test_choose_args(shape, with_ids, positions):
    def make(P):
        b, root = two_level(P, 5, 3)
        b.add_rule(0, steps(P, shape, root))
        return b.map
    port, ref = both(make)
    pin(port, ref, 0, 3,
        choose_args=_choose_args(PORT, port, 17, with_ids, positions),
        ref_choose_args=_choose_args(REF, ref, 17, with_ids, positions),
        against_ref=with_ids)


@pytest.mark.parametrize("alg", ["straw", "list", "tree", "uniform"])
def test_legacy_bucket_algorithms(alg):
    port, ref = both(alg_map, alg)
    pin(port.map, ref.map, 0, 3)
    pin(port.map, ref.map, 1, 3, against_ref=False)


def test_mixed_algorithms_with_reweights():
    """A straw2 root over straw, list, straw2, tree and uniform hosts."""
    def make(P):
        b = P.builder.CrushBuilder()
        b.add_type(1, "host")
        b.add_type(2, "root")
        hs = [b.add_bucket("straw", "host", [0, 1, 2],
                           [0x10000, 0x18000, 0x8000]),
              b.add_bucket("list", "host", [3, 4], [0x10000, 0x20000]),
              b.add_bucket("straw2", "host", [5, 6, 7],
                           [0x10000, 0x10000, 0x18000]),
              b.add_bucket("tree", "host", [8, 9, 10],
                           [0x14000, 0xc000, 0x10000]),
              b.add_bucket("uniform", "host", [11, 12, 13], [0x10000] * 3)]
        root = b.add_bucket("straw2", "root", hs)
        b.add_rule(0, steps(P, "chooseleaf_firstn", root))
        b.add_rule(1, steps(P, "chooseleaf_indep", root))
        return b.map
    port, ref = both(make)
    w = port.device_weights()
    w[3], w[9] = 0x4000, 0
    pin(port, ref, 0, 3, weight=w)
    pin(port, ref, 1, 3, weight=w, against_ref=False)


def test_tree_bucket_weights_near_2_32():
    """(hash * node_weight) >> 32 with node weights just under 2^32: the
    product passes 2^63, so the port splits it; equal to the reference's
    uint64 product and the host mapper's Python ints."""
    def make(P):
        b = P.builder.CrushBuilder()
        b.add_type(1, "host")
        b.add_type(2, "root")
        hs = [b.add_bucket("tree", "host", [3 * h, 3 * h + 1, 3 * h + 2],
                           [0x7FFF0000 - h, 0x7FFEFFFF, 0x10000 + h])
              for h in range(3)]
        root = b.add_bucket("straw2", "root", hs)
        b.add_rule(0, steps(P, "chooseleaf_firstn", root))
        return b.map
    port, ref = both(make)
    assert max(max(bk.node_weights) for bk in port.buckets.values()
               if bk.alg == 3) > 0xF0000000
    pin(port, ref, 0, 2)


def test_gates_raise_the_reference_errors():
    """Maps and rules outside the evaluator's envelope raise the
    reference's ValueErrors (the host engine handles them)."""
    def cases(P):
        T = P.types
        out = []
        b, root = two_level(P)
        b.add_rule(0, [T.step_take(root), T.step_choose_firstn(2, 1),
                       T.step_choose_firstn(2, 0), T.step_emit()])
        out.append((b.map, 0))                            # chained n > 1
        for tun in (T.Tunables.legacy(), T.Tunables(chooseleaf_vary_r=2),
                    T.Tunables(chooseleaf_stable=2),
                    T.Tunables(chooseleaf_descend_once=0)):
            b, root = two_level(P)
            b.map.tunables = tun
            b.add_rule(0, steps(P, "chooseleaf_firstn", root))
            out.append((b.map, 0))                        # tunables
        b = P.builder.CrushBuilder()
        b.add_type(1, "host")
        b.add_type(2, "root")
        h1 = b.add_bucket("straw2", "host", [0, 1])
        root = b.add_bucket("straw2", "root", [h1, 2], [0x20000, 0x10000])
        b.add_rule(0, steps(P, "chooseleaf_firstn", root))
        out.append((b.map, 0))                            # irregular
        for op in (T.CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
                   T.CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
                   T.CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
                   T.CRUSH_RULE_SET_CHOOSELEAF_STABLE):
            b, root = two_level(P)
            b.add_rule(0, [(op, 2, 0)] + steps(P, "chooseleaf_indep", root))
            out.append((b.map, 0))                        # SET_* gates
        b, root = two_level(P)
        b.map.buckets[-1].node_weights = [1 << 32]
        b.map.buckets[-1].alg = 3                         # tree > u32
        b.add_rule(0, steps(P, "chooseleaf_firstn", root))
        out.append((b.map, 0))
        return out

    for (pm, rule), (rm, _) in zip(cases(PORT), cases(REF)):
        with pytest.raises(ValueError) as want:
            ref_bulk.bulk_do_rule(rm, rule, np.arange(4), 3)
        with pytest.raises(ValueError) as got:
            bulk.bulk_do_rule(pm, rule, np.arange(4), 3, device="cpu")
        assert str(got.value) == str(want.value)
