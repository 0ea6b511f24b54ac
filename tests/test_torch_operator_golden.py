"""The operator cell `operator-live-50k-20k` on the JAX package: its default
`Operator(Options())` with the full-width `generate_catalog(600)`, its fake
cloud seeded by `workloads.seed_operator_cloud`, `build_controllers`, the
live cell's two bursts (HEADLINE with seed 0, then PROVISION_ROUND2 with
seed 5) provisioned by the operator's Provisioner, and one reconcile of its
DisruptionController 10 000 s after the launches, must produce
`workloads.GOLDEN_OPERATOR`, which the port reproduces on the CPU
(tests/test_torch_operator_cell.py); `chip_smoke.py` phase 14(c) replays
its tenth on the card (tests/test_torch_operator_small.py).  About two
minutes on one CPU worker (most of it the CreateFleet batcher's 35 ms
window a launch), so the cell's two halves are files of their own.

    python tests/test_torch_operator_golden.py    # print GOLDEN_OPERATOR
"""

import sys
from types import SimpleNamespace

import bench
from torch_cases import clear_lp_caches
from karpenter_tpu.cloud.fake import ImageInfo, SecurityGroupInfo, SubnetInfo
from karpenter_tpu.operator import Operator, Options, build_controllers
from karpenter_tpu_torch import workloads

REF_KIT = SimpleNamespace(Operator=Operator, Options=Options,
                          build_controllers=build_controllers,
                          SubnetInfo=SubnetInfo,
                          SecurityGroupInfo=SecurityGroupInfo,
                          ImageInfo=ImageInfo)


def reference_replay():
    clear_lp_caches("karpenter_tpu")
    try:
        return workloads.operator_replay(workloads.operator_env(REF_KIT),
                                         bench.build_pods)
    finally:
        clear_lp_caches("karpenter_tpu")


def test_jax_package_operator_cell_produces_golden_operator():
    got = reference_replay()
    assert got == workloads.GOLDEN_OPERATOR
    assert got["rounds"] == workloads.GOLDEN_PROVISION[
        "provision-live-50k-20k"]


if __name__ == "__main__":
    print(repr(reference_replay()))
    sys.exit(0)
