"""The cell `v1-solve-headline` on the port, on the CPU and over HTTP: the
port's default operator from the command line, restarted over a launched
fleet (`workloads.v1_manager` with `device="cpu"`), its endpoints on a
free port and its `run()` loop in a thread (`workloads.start_loop`, which
keeps the exception the loop ends with: none may); `GET /readyz` answers 200 with
the parity probe "ok" (the hydrated nodes gathered warm from the arena), `POST
/v1/apply` takes `V1_MANIFESTS`, `GET /v1/nodepools` reads the pool back,
and `POST /v1/solve` of the headline's 50 000 Pod manifests must answer
`workloads.GOLDEN_V1_SOLVE`, as tests/test_torch_v1_solve_golden.py's JAX
package does.
"""

from types import SimpleNamespace

import numpy as np

from torch_cases import clear_lp_caches, one_torch_thread  # noqa: F401
from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.cloud.fake import (ImageInfo, SecurityGroupInfo,
                                            SubnetInfo)
from karpenter_tpu_torch.operator import (ControllerManager, Operator,
                                          Options, build_controllers)

PORT_KIT = SimpleNamespace(Operator=Operator, Options=Options,
                           build_controllers=build_controllers,
                           ControllerManager=ControllerManager,
                           SubnetInfo=SubnetInfo,
                           SecurityGroupInfo=SecurityGroupInfo,
                           ImageInfo=ImageInfo)


def test_port_v1_solve_over_http_reproduces_golden_v1_solve():
    clear_lp_caches()
    mgr = workloads.v1_manager(PORT_KIT, workloads.build_pods, device="cpu")
    port = mgr.serve_endpoints(metrics_port=0)
    loop, errors, _ = workloads.start_loop(mgr)
    try:
        code, ready = workloads.http_json(port, "/readyz")
        assert code == 200 and ready["ready"] and ready["probe"] == "ok"
        assert mgr.operator.cluster.nodes
        code, out = workloads.http_json(
            port, "/v1/apply", {"manifests": workloads.V1_MANIFESTS})
        assert code == 200, out
        code, listed = workloads.http_json(port, "/v1/nodepools")
        assert code == 200
        assert listed["items"][0]["spec"]["template"]["metadata"][
            "labels"] == {"team": "v1"}
        pods = workloads.build_pods(rng=np.random.default_rng(
            workloads.HEADLINE_SEED), **workloads.HEADLINE)
        code, resp = workloads.http_json(port, "/v1/solve",
                                         workloads.v1_solve_payload(pods))
        assert code == 200, resp
        assert loop.is_alive() and not errors, errors
    finally:
        mgr.stop()
        loop.join(timeout=30)
        clear_lp_caches()
    assert not loop.is_alive()
    assert not errors, errors
    assert workloads.v1_solve_digest(resp) == workloads.GOLDEN_V1_SOLVE
