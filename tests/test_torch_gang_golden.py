"""The gang cell `provision-gang-50k` on the JAX package: the headline's
50 000 pods with 1024 gangs of 4 (tier 1, zone), 64 gangs short of a
member, 4 gangs split over two zones and 4 gangs at tier 0 with a member
no type holds, through `Provisioner(gang_scheduling=True)` on the default
guided path (8192 slots a round); then PROVISION_ROUND2's 20 000 pods with
256 gangs of 8 (tier 2, hostname) against the launched fleet; then one
DisruptionController reconcile with the Provisioner's plan queue as its
`gang_source`, which executes the first preemption plan.  It must produce
`workloads.GOLDEN_GANG`, and its seeded 5000-pod copy
(`workloads.GANG_SMALL_SCALE`) `workloads.GOLDEN_GANG_SMALL`, which the
port reproduces on the CPU (tests/test_torch_gang_cell.py) and
`chip_smoke.py` phase 17 on the card.  The full cell takes minutes on one CPU
worker, most of it the audits' preemption planning, which walks every
bound pod of a domain for each rejected gang of tier 1 or more.

    PYTHONPATH=.:tests python tests/test_torch_gang_golden.py   # print both
"""

import sys
from types import SimpleNamespace

import bench
from torch_cases import clear_lp_caches
from karpenter_tpu.api.objects import NodePool
from karpenter_tpu.catalog.generate import generate_catalog
from karpenter_tpu.cloud import CloudProvider, FakeCloud
from karpenter_tpu.controllers import Provisioner
from karpenter_tpu.controllers.disruption import DisruptionController
from karpenter_tpu.state import Cluster
from karpenter_tpu_torch import workloads

REF_KIT = SimpleNamespace(FakeCloud=FakeCloud, CloudProvider=CloudProvider,
                          Cluster=Cluster, Provisioner=Provisioner,
                          DisruptionController=DisruptionController,
                          NodePool=NodePool)


def reference_replay(scale=1):
    clear_lp_caches("karpenter_tpu")
    try:
        env = workloads.gang_env(
            REF_KIT, generate_catalog(workloads.PROVISION_TYPES))
        return workloads.gang_replay(env, bench.build_pods, scale=scale)
    finally:
        clear_lp_caches("karpenter_tpu")


def _reasons(got):
    return {reason for r in got["rounds"] for reason in r["audits"]["rejected"]}


def test_jax_package_gang_cell_produces_golden_gang():
    got = reference_replay()
    assert got == workloads.GOLDEN_GANG
    assert _reasons(got) == {"incomplete", "partial", "straddle"}
    assert got["tick"]["action"] == ["preempt", "gang"]
    assert got["tick"]["evicted"] and got["registry"]["preempted"]


def test_jax_package_gang_copy_produces_golden_gang_small():
    got = reference_replay(workloads.GANG_SMALL_SCALE)
    assert got == workloads.GOLDEN_GANG_SMALL
    assert _reasons(got) == {"incomplete", "partial", "straddle"}
    assert got["tick"]["action"] == ["preempt", "gang"]
    assert got["tick"]["evicted"]


if __name__ == "__main__":
    print("GOLDEN_GANG =", repr(reference_replay()))
    print("GOLDEN_GANG_SMALL =",
          repr(reference_replay(workloads.GANG_SMALL_SCALE)))
    sys.exit(0)
