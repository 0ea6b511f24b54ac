"""The gang cell on the port, on the CPU: the seeded 5000-pod copy of
`provision-gang-50k` (`workloads.GANG_SMALL_SCALE`: 5000 + 2000 pods, the
same gang mix at a tenth of the gangs), driven through the port's
`Provisioner(gang_scheduling=True, device="cpu")` and DisruptionController
as tests/test_torch_gang_golden.py drives the JAX package's, must
reproduce `workloads.GOLDEN_GANG_SMALL`: both rounds' plans and audits,
the queued preemption plans, the executed preemption and the registry.
`chip_smoke.py` phase 17 holds the same copy on the card to the same
golden; the full cell (minutes on one CPU worker) is the JAX package's
`workloads.GOLDEN_GANG` (tests/test_torch_gang_golden.py).
"""

from types import SimpleNamespace

from torch_cases import clear_lp_caches, one_torch_thread  # noqa: F401
from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.api.objects import NodePool
from karpenter_tpu_torch.catalog.generate import generate_catalog
from karpenter_tpu_torch.cloud import CloudProvider, FakeCloud
from karpenter_tpu_torch.controllers import Provisioner
from karpenter_tpu_torch.controllers.disruption import DisruptionController
from karpenter_tpu_torch.state import Cluster

PORT_KIT = SimpleNamespace(FakeCloud=FakeCloud, CloudProvider=CloudProvider,
                           Cluster=Cluster, Provisioner=Provisioner,
                           DisruptionController=DisruptionController,
                           NodePool=NodePool)


def test_port_gang_copy_reproduces_golden_gang_small():
    clear_lp_caches()
    try:
        env = workloads.gang_env(
            PORT_KIT, generate_catalog(workloads.PROVISION_TYPES),
            device="cpu")
        got = workloads.gang_replay(env, workloads.build_pods,
                                    scale=workloads.GANG_SMALL_SCALE)
    finally:
        clear_lp_caches()
    assert got == workloads.GOLDEN_GANG_SMALL
    prov = env.penv.provisioner
    assert prov.gang_registry.get("r1s-g0000").last_reason == "straddle"
    assert prov.gang_registry.get("r1h-g0000").last_reason == "partial"
