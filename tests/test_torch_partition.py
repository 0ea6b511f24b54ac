"""The port's partition planner (parallel/partition.py) against the JAX
package's, on the CPU: the eight cases of tests/test_partition.py.

The planner is NumPy in both packages, so every field of the plan must be
bit-identical (`_same_plan`): the class, option and existing-node shard
maps, the residual classes and pods, the group count, the per-shard loads
and the imbalance by ==.  Each case also keeps the reference test's own
assertions on the port's plan."""

import numpy as np
import pytest

from helpers import cpu_pod
from karpenter_tpu.api import labels as wk
from karpenter_tpu.api.objects import NodePool
from karpenter_tpu.api.requirements import IN, Requirement, Requirements
from karpenter_tpu.ops import tensorize
from karpenter_tpu.parallel import plan_partition as ref_plan
from karpenter_tpu.parallel import partition as ref_partition
from karpenter_tpu_torch import convert
from karpenter_tpu_torch.parallel import partition as port_partition
from test_partition import pinned_pods, zoned_catalog

FIELDS = ("n_shards", "class_shard", "option_shard", "existing_shard",
          "residual_classes", "residual_pods", "total_pods", "n_groups",
          "imbalance", "shard_pods")


def _same_plan(got, want):
    if want is None:
        assert got is None
        return
    assert got is not None
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


def _plans(prob, n, **kw):
    """(port plan, reference plan) of the same problem."""
    want = ref_plan(prob, n, **kw)
    got = port_partition.plan_partition(convert.problem_from_arrays(prob), n,
                                        **kw)
    _same_plan(got, want)
    return got, want


def test_defaults_match_the_reference():
    assert port_partition.MIN_PODS_DEFAULT == ref_partition.MIN_PODS_DEFAULT
    assert (port_partition.MAX_RESIDUAL_FRAC_DEFAULT
            == ref_partition.MAX_RESIDUAL_FRAC_DEFAULT)


def test_pinned_classes_partition_by_zone():
    prob = tensorize(pinned_pods(), zoned_catalog(), [NodePool()])
    plan, _ = _plans(prob, 8, min_pods=1)
    assert plan.residual_pods == 0 and (plan.class_shard >= 0).all()
    for ci in range(prob.num_classes):
        opts = np.nonzero(prob.class_compat[ci])[0]
        assert (plan.option_shard[opts] == plan.class_shard[ci]).all()


def test_lpt_balance_and_imbalance_metric():
    prob = tensorize(pinned_pods(per_zone=64), zoned_catalog(), [NodePool()])
    plan, _ = _plans(prob, 8, min_pods=1)
    assert plan.imbalance == pytest.approx(1.0)
    plan4, _ = _plans(prob, 4, min_pods=1)
    assert len(set(plan4.class_shard.tolist())) == 4


def test_deterministic_across_calls():
    prob = tensorize(pinned_pods(per_zone=17), zoned_catalog(), [NodePool()])
    a, _ = _plans(prob, 4, min_pods=1)
    b, _ = _plans(prob, 4, min_pods=1)
    _same_plan(a, b)


def test_free_pods_become_residual():
    pods = pinned_pods(per_zone=30) + [cpu_pod(cpu_m=300, mem_mib=128)
                                       for _ in range(9)]
    prob = tensorize(pods, zoned_catalog(), [NodePool()])
    plan, _ = _plans(prob, 8, min_pods=1)
    assert plan.residual_pods == 9
    assert (plan.class_shard[plan.residual_classes] == -1).all()


def test_two_zone_classes_merge_groups():
    zones = ("zone-a", "zone-b", "zone-c", "zone-d")
    pods = pinned_pods(per_zone=20, zones=zones)
    bridge = [cpu_pod(cpu_m=400, mem_mib=256,
                      required_affinity_terms=[Requirements.of(
                          Requirement(wk.ZONE, IN, ["zone-a", "zone-b"]))])
              for _ in range(10)]
    prob = tensorize(pods + bridge, zoned_catalog(zones), [NodePool()])
    plan, _ = _plans(prob, 4, min_pods=1)
    assert plan.residual_pods == 0
    assert plan.n_groups == 3          # zone-a and zone-b merged


def test_refuses_without_structure():
    one = tensorize(pinned_pods(per_zone=50, zones=("zone-a",)),
                    zoned_catalog(("zone-a",)), [NodePool()])
    assert _plans(one, 8, min_pods=1)[0] is None
    few = tensorize(pinned_pods(per_zone=2), zoned_catalog(), [NodePool()])
    assert _plans(few, 8, min_pods=512)[0] is None
    prob = tensorize(pinned_pods(), zoned_catalog(), [NodePool()])
    assert _plans(prob, 1, min_pods=1)[0] is None


def test_refuses_on_residual_blowup():
    pods = ([cpu_pod(cpu_m=300, mem_mib=128) for _ in range(100)]
            + pinned_pods(per_zone=5))
    prob = tensorize(pods, zoned_catalog(), [NodePool()])
    assert _plans(prob, 8, min_pods=1, max_residual_frac=0.2)[0] is None


def test_existing_nodes_join_their_zone_group():
    prob = tensorize(pinned_pods(per_zone=25), zoned_catalog(), [NodePool()])
    Z = len(prob.zones)
    E = 8
    ex_zone = np.arange(E, dtype=np.int64) % Z
    zone_1hot = np.zeros((prob.num_options, Z), bool)
    zone_1hot[np.arange(prob.num_options), prob.option_zone] = True
    ec = ((prob.class_compat @ zone_1hot) > 0)[:, ex_zone]
    plan, _ = _plans(prob, 8, existing_compat=ec, existing_zone=ex_zone,
                     min_pods=1)
    assert (plan.existing_shard >= 0).all()
    for e in range(E):
        cls_e = np.nonzero(ec[:, e])[0]
        assert (plan.class_shard[cls_e] == plan.existing_shard[e]).all()
