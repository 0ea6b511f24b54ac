"""The cell `v1-solve-headline` on the JAX package: its default operator
from the command line restarted over a launched fleet
(`workloads.v1_manager`: `Options.from_args(V1_ARGV)`, the full-width
`generate_catalog(600)`, the V1_FLEET burst provisioned, a second operator
hydrating it and its `ControllerManager` through `startup()`, whose parity
probe answers "ok"), `V1_MANIFESTS` applied through `apply_request`, then
`solve_request` on the headline's 50 000 pods (HEADLINE at seed 0) as Pod
manifests, for new capacity.  The answer's `workloads.v1_solve_digest` must
be `workloads.GOLDEN_V1_SOLVE`, which the port reproduces over HTTP on the
CPU (tests/test_torch_v1_solve_cell.py) and `chip_smoke.py` phase 15(c) on
the card.

    python tests/test_torch_v1_solve_golden.py    # print GOLDEN_V1_SOLVE
"""

import sys
from types import SimpleNamespace

import numpy as np

import bench
from torch_cases import clear_lp_caches
from karpenter_tpu.cloud.fake import ImageInfo, SecurityGroupInfo, SubnetInfo
from karpenter_tpu.operator import (ControllerManager, Operator, Options,
                                    build_controllers)
from karpenter_tpu_torch import workloads

REF_KIT = SimpleNamespace(Operator=Operator, Options=Options,
                          build_controllers=build_controllers,
                          ControllerManager=ControllerManager,
                          SubnetInfo=SubnetInfo,
                          SecurityGroupInfo=SecurityGroupInfo,
                          ImageInfo=ImageInfo)


def reference_solve():
    clear_lp_caches("karpenter_tpu")
    try:
        mgr = workloads.v1_manager(REF_KIT, bench.build_pods)
        assert mgr.probe_outcome == "ok"
        applied = mgr.apply_request({"manifests": workloads.V1_MANIFESTS})
        assert [a["kind"] for a in applied["applied"]] == ["NodePool",
                                                           "NodeClass"]
        pods = bench.build_pods(rng=np.random.default_rng(
            workloads.HEADLINE_SEED), **workloads.HEADLINE)
        resp = mgr.solve_request(workloads.v1_solve_payload(pods))
        mgr.stop()
    finally:
        clear_lp_caches("karpenter_tpu")
    return workloads.v1_solve_digest(resp)


def test_jax_package_v1_solve_produces_golden_v1_solve():
    assert reference_solve() == workloads.GOLDEN_V1_SOLVE


if __name__ == "__main__":
    print(repr(reference_solve()))
    sys.exit(0)
