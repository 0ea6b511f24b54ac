"""The operator cell at a tenth of its depth, on both packages, on the CPU:
`Operator(Options())` at full width (`generate_catalog(600)`), its fake
cloud seeded by `workloads.seed_operator_cloud`, `build_controllers`, the
live cell's two bursts cut to 5000 and 2000 pods
(`workloads.OPERATOR_SMALL_ROUNDS`) and one DisruptionController
reconcile 10 000 s after the launches.  The JAX package must produce
`workloads.GOLDEN_OPERATOR_SMALL`, and the port (`device="cpu"`) the same,
with its arena serving round 2's gather and the tick's faces warm.
`chip_smoke.py` phase 14(c) replays this copy on the card and phase 18(b)
restores its round-1 snapshot in a successor process.

    python tests/test_torch_operator_small.py    # print the JAX package's
"""

import sys
from types import SimpleNamespace

import bench
from torch_cases import clear_lp_caches, one_torch_thread  # noqa: F401
from karpenter_tpu import operator as ref_operator
from karpenter_tpu.cloud import fake as ref_fake
from karpenter_tpu_torch import operator as port_operator
from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.cloud import fake as port_fake


def _kit(operator, fake):
    return SimpleNamespace(Operator=operator.Operator,
                           Options=operator.Options,
                           build_controllers=operator.build_controllers,
                           SubnetInfo=fake.SubnetInfo,
                           SecurityGroupInfo=fake.SecurityGroupInfo,
                           ImageInfo=fake.ImageInfo)


def reference_replay():
    clear_lp_caches("karpenter_tpu")
    try:
        return workloads.operator_replay(
            workloads.operator_env(_kit(ref_operator, ref_fake)),
            bench.build_pods,
            rounds=workloads.OPERATOR_SMALL_ROUNDS)
    finally:
        clear_lp_caches("karpenter_tpu")


def test_jax_package_operator_copy_produces_golden_operator_small():
    got = reference_replay()
    assert got == workloads.GOLDEN_OPERATOR_SMALL
    assert [r["bound_new"] + r["bound_existing"] + r["unschedulable"]
            for r in got["rounds"]] == [5000, 2000]


def test_port_operator_copy_reproduces_golden_operator_small():
    clear_lp_caches()
    try:
        env = workloads.operator_env(_kit(port_operator, port_fake),
                                     device="cpu")
        got = workloads.operator_replay(
            env, workloads.build_pods, rounds=workloads.OPERATOR_SMALL_ROUNDS)
    finally:
        clear_lp_caches()
    assert got == workloads.GOLDEN_OPERATOR_SMALL
    gathers = env.op.cluster.arena.gathers
    assert gathers["warm"] >= 2 and gathers["fallback"] == 0


if __name__ == "__main__":
    print(repr(reference_replay()))
    sys.exit(0)
