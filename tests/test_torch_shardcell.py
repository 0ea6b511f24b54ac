"""The zone-pinned provisioning cell of the ShardedSolve gate,
`provision-sharded-50k-20k`, in both packages on the CPU: the JAX package
(8 virtual devices) produces `GOLDEN_SHARDED`'s signatures, and the port's
Provisioner on an 8-shard mesh laid on the CPU reproduces them, round for
round, through the sharded rung (row 17, the slab program shard-batched:
round 1 on an empty cluster, round 2 with each shard owning its zone's
nodes).  Signatures compare claims, existing binds and unschedulable pods
by batch position; the total launch price by ==."""

import numpy as np

from karpenter_tpu import api as ref_api
from karpenter_tpu.catalog.generate import generate_catalog
from karpenter_tpu.cloud import CloudProvider, FakeCloud
from karpenter_tpu.controllers import Provisioner
from karpenter_tpu.parallel import driver as ref_driver
from karpenter_tpu.state import Cluster
from karpenter_tpu_torch import convert, workloads
from karpenter_tpu_torch.api.objects import NodePool as TNodePool
from karpenter_tpu_torch.cloud import CloudProvider as TCloudProvider
from karpenter_tpu_torch.cloud import FakeCloud as TFakeCloud
from karpenter_tpu_torch.controllers.provisioning import \
    Provisioner as TProvisioner
from karpenter_tpu_torch.ops import classpack as port_cp
from karpenter_tpu_torch.ops.decode import DecodeHealth
from karpenter_tpu_torch.ops.health import SolverHealth
from karpenter_tpu_torch.parallel import driver as port_driver
from karpenter_tpu_torch.parallel import make_pod_mesh
from karpenter_tpu_torch.state import Cluster as TCluster
from torch_cases import one_torch_thread  # noqa: F401

CELL = workloads.SHARDED_CELL


def _rounds():
    return [workloads.build_pods(rng=np.random.default_rng(seed), **kw)
            for kw, seed in workloads.PROVISION_CELLS[CELL][1]]


def _spy(monkeypatch, module):
    """Record whether each partitioned solve answered (non-None)."""
    calls = []
    orig = module.solve_partitioned

    def spy(*a, **k):
        res = orig(*a, **k)
        calls.append(res is not None)
        return res
    monkeypatch.setattr(module, "solve_partitioned", spy)
    return calls


def test_reference_produces_the_cell_golden(monkeypatch):
    calls = _spy(monkeypatch, ref_driver)
    env = workloads.provision_env(CELL, FakeCloud, CloudProvider, Cluster,
                                  Provisioner, ref_api.NodePool,
                                  generate_catalog(workloads.PROVISION_TYPES))
    for r, pods in enumerate(_rounds()):
        sig, _ = workloads.provision_round(env, pods)
        assert sig == workloads.GOLDEN_SHARDED[CELL][r]
    assert calls == [True, True]


def test_port_reproduces_the_cell_golden(monkeypatch):
    calls = _spy(monkeypatch, port_driver)
    slabs = []
    orig = port_cp.classpack_slab
    monkeypatch.setattr(port_cp, "classpack_slab",
                        lambda *a: slabs.append(1) or orig(*a))
    health, dh = SolverHealth(), DecodeHealth()
    env = workloads.provision_env(
        CELL, TFakeCloud, TCloudProvider, TCluster, TProvisioner, TNodePool,
        convert.catalog_from_objects(generate_catalog(
            workloads.PROVISION_TYPES)),
        health=health, decode_health=dh, device="cpu",
        mesh=make_pod_mesh(workloads.MESH_SHARDS, device="cpu",
                           shards_per_device=workloads.MESH_SHARDS))
    for r, pods in enumerate(_rounds()):
        sig, _ = workloads.provision_round(
            env, [convert._pod(p) for p in pods])
        assert sig == workloads.GOLDEN_SHARDED[CELL][r]
    # both rounds answered on the mesh; the single-device slab never ran
    assert calls == [True, True] and not slabs
    assert not health.transitions and dh.total_failures == 0
