"""The operator cell `operator-live-50k-20k` on the port, on the CPU: the
port's default `Operator(Options(), device="cpu")` at full width, driven as
tests/test_torch_operator_golden.py drives the JAX package's, must
reproduce `workloads.GOLDEN_OPERATOR` — both provisioning rounds and the
disruption tick — with the cluster's arena (the IncrementalArena gate, on
by default) serving round 2's gather and the tick's consolidation faces
warm.  About two minutes on one CPU worker.
"""

from types import SimpleNamespace

from torch_cases import clear_lp_caches, one_torch_thread  # noqa: F401
from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.cloud.fake import (ImageInfo, SecurityGroupInfo,
                                            SubnetInfo)
from karpenter_tpu_torch.operator import Operator, Options, build_controllers

PORT_KIT = SimpleNamespace(Operator=Operator, Options=Options,
                           build_controllers=build_controllers,
                           SubnetInfo=SubnetInfo,
                           SecurityGroupInfo=SecurityGroupInfo,
                           ImageInfo=ImageInfo)


def test_port_operator_cell_reproduces_golden_operator():
    clear_lp_caches()
    try:
        env = workloads.operator_env(PORT_KIT, device="cpu")
        got = workloads.operator_replay(env, workloads.build_pods)
    finally:
        clear_lp_caches()
    assert got == workloads.GOLDEN_OPERATOR
    gathers = env.op.cluster.arena.gathers
    assert gathers["warm"] >= 2 and gathers["fallback"] == 0
