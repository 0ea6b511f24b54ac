"""The port's Provisioner against the JAX package's, on the CPU.

Every case builds the same fixture in both packages — the catalog carried
across with `convert.catalog_from_objects`, the pods with `convert._pod`,
the pools and clouds from the same constructors — runs the same rounds of
`Provisioner.provision()` and compares them round by round with
`workloads.provision_signature`: the launched claims in launch order
(instance type, zone, capacity type, nodepool, request totals, the batch
positions of their pods), the pods bound to nodes that existed before the
round, the unschedulable batch positions and the total launch price (==).
Identities are batch positions: pod and claim names come from a
process-wide counter that differs between the packages.

  * the 17 cases of tests/test_provisioning.py, with their assertions on
    the port's side;
  * two rounds where the JAX package runs round 1 and its live cluster is
    carried across with `convert.cluster_from_arrays`: round 2 runs in
    both on the same state;
  * the packing ladder (tests/test_health.py's provisioning cases), the
    same `solver.pack` chaos rules armed in both packages: a poisoned
    "jax" rung lands on the native C++ packer inside the same solve (on
    the greedy rung when "native" is poisoned too), demotes after two
    strikes and recovers after the window, booking the same transitions
    as the reference; the watchdog;
  * the JAX package produces `workloads.GOLDEN_PROVISION` for the
    provision-live and provision-small cells, and the port reproduces the
    provision-small cell and provision-live's round 2 on the carried
    round-1 state (about 50 s).

    python tests/test_torch_provisioning.py      # print the four cells'
                                                 # signatures from the JAX
                                                 # package
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import bench
from helpers import cpu_pod, make_type, small_catalog
from karpenter_tpu import api as ref_api
from karpenter_tpu.api import labels as wk
from karpenter_tpu.api.resources import CPU, GPU
from karpenter_tpu.catalog.generate import generate_catalog
from karpenter_tpu.cloud import CloudProvider, FakeCloud
from karpenter_tpu.controllers import Provisioner
from karpenter_tpu.ops import lpguide as ref_lg
from karpenter_tpu.ops import lpsolve as ref_lp
from karpenter_tpu.ops.health import SolverHealth as RefHealth
from karpenter_tpu.state import Cluster
from karpenter_tpu.utils.chaos import CHAOS, ChaosRule
from karpenter_tpu_torch import api as port_api
from karpenter_tpu_torch import convert, workloads
from karpenter_tpu_torch._build import KernelError
from karpenter_tpu_torch.api.objects import NodePool as TNodePool
from karpenter_tpu_torch.cloud import CloudProvider as TCloudProvider
from karpenter_tpu_torch.cloud import FakeCloud as TFakeCloud
from karpenter_tpu_torch.controllers.provisioning import \
    Provisioner as TProvisioner
from karpenter_tpu_torch.ops import classpack as port_cp
from karpenter_tpu_torch.ops import ffd_kernels as port_fk
from karpenter_tpu_torch.ops import lpguide as port_lg
from karpenter_tpu_torch.ops import lpsolve as port_lp
from karpenter_tpu_torch.ops.health import RUNGS, SolverHealth
from karpenter_tpu_torch.state import Cluster as TCluster
from karpenter_tpu_torch.utils.chaos import CHAOS as PORT_CHAOS
from karpenter_tpu_torch.utils.chaos import ChaosRule as PortChaosRule
from karpenter_tpu_torch.utils.watchdog import (PHASES, WatchdogTimeout,
                                                run_with_deadline)
from test_partitioned import random_pinned_pods, zoned_catalog
from torch_cases import one_torch_thread  # noqa: F401


def _clear_lp_caches():
    """Both packages' guide caches (mix, stale, colgen support) and PDHG
    warm starts: the goldens were made in a fresh process, and a cache
    another test warmed may lead a guided solve to another plan."""
    for lg in (ref_lg, port_lg):
        with lg._MIX_LOCK:
            lg._MIX_CACHE.clear()
            lg._STALE_CACHE.clear()
            lg._SUPPORT_CACHE.clear()
    ref_lp.reset_caches()
    port_lp.reset_caches()


@pytest.fixture(autouse=True)
def _clean_state():
    _clear_lp_caches()
    yield
    CHAOS.reset()
    PORT_CHAOS.reset()
    _clear_lp_caches()


class Pair:
    """One fixture in both packages.  `pools(api)` builds the NodePools
    from a package's `api` module."""

    def __init__(self, catalog=None, pools=None, **kw):
        catalog = catalog if catalog is not None else small_catalog()
        pools = pools or (lambda api: [api.NodePool()])
        ref_kw, port_kw = kw.pop("ref_kw", {}), kw.pop("port_kw", {})
        self.ref_cloud = FakeCloud()
        self.ref_provider = CloudProvider(self.ref_cloud, catalog)
        self.ref = Cluster()
        self.ref_prov = Provisioner(self.ref_provider, self.ref,
                                    pools(ref_api), **ref_kw, **kw)
        self.cloud = TFakeCloud()
        self.provider = TCloudProvider(self.cloud,
                                       convert.catalog_from_objects(catalog))
        self.cluster = TCluster()
        self.prov = TProvisioner(self.provider, self.cluster,
                                 pools(port_api), device="cpu", **port_kw,
                                 **kw)

    def add(self, pods):
        self.ref.add_pods(pods)
        self.cluster.add_pods([convert._pod(p) for p in pods])

    def ice(self, pool):
        self.ref_cloud.insufficient_capacity_pools.add(pool)
        self.cloud.insufficient_capacity_pools.add(pool)

    def provision(self):
        """One round in both; the signatures must be equal.  Returns the
        port's ProvisioningResult."""
        sigs = []
        out = None
        for cluster, prov in ((self.ref, self.ref_prov),
                              (self.cluster, self.prov)):
            batch = cluster.pending_pods()
            before = list(cluster.nodes)
            out = prov.provision()
            sigs.append(workloads.provision_signature(batch, before, cluster,
                                                      out))
        assert sigs[1] == sigs[0]
        return out


# ---- the cases of tests/test_provisioning.py ----

def test_provision_single_pod():
    p = Pair()
    p.add([cpu_pod(cpu_m=500)])
    res = p.provision()
    assert len(res.launched) == 1
    assert res.launched[0].instance_type == "a.small"
    assert res.launched[0].provider_id.startswith("i-")
    assert len(p.cloud.running()) == 1
    assert not p.cluster.pending_pods()


def test_provision_batch_packs():
    p = Pair()
    p.add([cpu_pod(cpu_m=400, mem_mib=256) for _ in range(8)])
    res = p.provision()
    assert res.scheduled == 8
    assert len(res.launched) < 8
    for n in p.cluster.nodes.values():
        assert len(n.pods) >= 1


def test_second_round_uses_existing_capacity():
    p = Pair()
    p.add([cpu_pod(cpu_m=200, mem_mib=128)])
    assert len(p.provision().launched) == 1
    p.add([cpu_pod(cpu_m=200, mem_mib=128)])
    r2 = p.provision()
    assert len(r2.launched) == 0
    assert r2.bound_existing == 1
    assert len(p.cloud.running()) == 1


def test_ice_fallback_to_other_pool():
    p = Pair()
    for z in ("zone-a", "zone-b"):
        p.ice(("on-demand", "a.small", z))
    p.add([cpu_pod(cpu_m=500)])
    res = p.provision()
    assert len(res.launched) == 1
    assert res.launched[0].instance_type != "a.small"
    assert p.provider.unavailable.is_unavailable("on-demand", "a.small",
                                                 "zone-a")


def test_ice_total_leaves_pending_then_recovers():
    p = Pair([make_type("only.type", 4, 8, 0.2, zones=("zone-a",))])
    p.ice(("on-demand", "only.type", "zone-a"))
    p.add([cpu_pod(cpu_m=500)])
    res = p.provision()
    assert not res.launched and p.cluster.pending_pods()
    for cloud, provider in ((p.ref_cloud, p.ref_provider),
                            (p.cloud, p.provider)):
        cloud.insufficient_capacity_pools.clear()
        provider.unavailable.flush()
    assert len(p.provision().launched) == 1
    assert not p.cluster.pending_pods()


def test_nodepool_limits_stop_provisioning():
    p = Pair(pools=lambda api: [api.NodePool(
        limits=api.ResourceList({CPU: 2000}))])
    p.add([cpu_pod(cpu_m=1000)])
    assert len(p.provision().launched) == 1
    p.add([cpu_pod(cpu_m=4000)])
    r2 = p.provision()
    assert not r2.launched
    assert p.cluster.pending_pods()


def _heavy_and_light(api):
    heavy = api.NodePool(name="reserved", weight=100,
                         template=api.NodePoolTemplate(
                             requirements=api.Requirements.of(
                                 api.Requirement(wk.INSTANCE_FAMILY, api.IN,
                                                 ["a"]),
                                 api.Requirement(
                                     "node.kubernetes.io/instance-type",
                                     api.IN, ["a.medium"]))))
    return [heavy, api.NodePool(name="cheap")]


def test_weighted_pool_preferred_over_cheaper():
    p = Pair(pools=_heavy_and_light)
    p.add([cpu_pod(cpu_m=500)])
    res = p.provision()
    assert res.launched[0].nodepool == "reserved"
    assert res.launched[0].instance_type == "a.medium"


def test_taints_and_weighted_pools():
    p = Pair(pools=lambda api: [
        api.NodePool(name="gpu", weight=10, template=api.NodePoolTemplate(
            taints=[api.Taint("gpu")])),
        api.NodePool(name="default")])
    p.add([cpu_pod(cpu_m=500)])
    assert p.provision().launched[0].nodepool == "default"


def test_zone_selector_respected_at_launch():
    p = Pair()
    p.add([cpu_pod(cpu_m=500, node_selector={wk.ZONE: "zone-b"})])
    res = p.provision()
    assert res.launched[0].zone == "zone-b"
    assert p.cloud.running()[0].zone == "zone-b"


def test_gpu_pods_on_gpu_nodes():
    p = Pair(small_catalog() + [make_type("g.xlarge", 8, 32, 1.2,
                                          gpu_count=4)])
    p.add([ref_api.Pod(requests=ref_api.ResourceList({CPU: 500, GPU: 1}))
           for _ in range(4)])
    res = p.provision()
    assert res.scheduled == 4
    assert all(c.instance_type == "g.xlarge" for c in res.launched)
    assert len(res.launched) == 1


def test_unschedulable_pod_reported():
    p = Pair()
    p.add([cpu_pod(cpu_m=10**6)])
    res = p.provision()
    assert res.unschedulable
    assert res.unschedulable[0].uid == p.cluster.pending_pods()[0].uid


def test_spot_preferred_when_allowed():
    p = Pair([make_type("s.large", 4, 8, 0.2, spot_discount=0.7)],
             pools=lambda api: [api.NodePool(template=api.NodePoolTemplate(
                 requirements=api.Requirements.of(api.Requirement(
                     wk.CAPACITY_TYPE, api.IN, ["spot", "on-demand"]))))])
    p.add([cpu_pod(cpu_m=500)])
    assert p.provision().launched[0].capacity_type == "spot"


def test_generated_catalog_scale():
    p = Pair(generate_catalog(200))
    rng = np.random.default_rng(0)
    p.add([cpu_pod(cpu_m=int(rng.integers(100, 4000)),
                   mem_mib=int(rng.integers(128, 16384))) for _ in range(200)])
    res = p.provision()
    assert res.scheduled == 200
    assert not p.cluster.pending_pods()
    assert sum(len(n.pods) for n in p.cluster.nodes.values()) == 200


def test_node_labels_populated():
    p = Pair()
    p.add([cpu_pod(cpu_m=500)])
    p.provision()
    node = next(iter(p.cluster.nodes.values()))
    assert node.labels[wk.INSTANCE_TYPE] == "a.small"
    assert node.labels[wk.NODEPOOL] == "default"
    assert node.labels[wk.ZONE] in ("zone-a", "zone-b")
    assert wk.HOSTNAME in node.labels


def _mixed_pods(n):
    rng = np.random.default_rng(7)
    return [cpu_pod(cpu_m=int(rng.choice([100, 250, 500, 1000, 2000])),
                    mem_mib=int(rng.choice([128, 256, 512, 1024, 2048])))
            for _ in range(n)]


def test_auto_picks_classpack_above_cutover():
    from karpenter_tpu_torch.ops.ffd import NATIVE_CUTOVER_ROWS
    from karpenter_tpu_torch.ops.tensorize import tensorize
    p = Pair()
    p.add(_mixed_pods(NATIVE_CUTOVER_ROWS + 50))
    pods = p.cluster.pending_pods()
    cat = p.provider.get_instance_types()
    problem = tensorize(pods, cat, [TNodePool()])
    assert p.prov._pick_solver(problem) is p.prov._classpack
    small = tensorize(pods[:4], cat, [TNodePool()])
    assert p.prov._pick_solver(small) is p.prov._ffd
    # a batch at the cutover counts existing nodes as rows
    at = tensorize(pods[:NATIVE_CUTOVER_ROWS - 3], cat, [TNodePool()])
    assert p.prov._pick_solver(at, n_existing=3) is p.prov._ffd
    assert p.prov._pick_solver(at, n_existing=4) is p.prov._classpack


def test_classpack_provision_end_to_end():
    p = Pair()
    p.add(_mixed_pods(300))
    res = p.provision()
    assert res.scheduled == 300
    assert not res.unschedulable
    assert len(res.launched) < 300
    assert len(p.cloud.running()) == len(res.launched)
    p.add([cpu_pod(cpu_m=50, mem_mib=64) for _ in range(5)])
    assert p.provision().scheduled == 5


def test_classpack_matches_ffd_cost_envelope():
    pods = _mixed_pods(300)
    costs = {}
    for solver in ("classpack", "ffd"):
        p = Pair(solver=solver)
        p.add([ref_api.Pod(requests=x.requests) for x in pods])
        res = p.provision()
        assert res.scheduled == 300, solver
        by_name = {it.name: it for it in p.provider.get_instance_types()}
        costs[solver] = sum(by_name[c.instance_type].cheapest_offering().price
                            for c in res.launched)
    assert costs["classpack"] <= costs["ffd"] * 1.10 + 1e-6


# ---- a live cluster carried across ----

def describe(cluster):
    """The plain description `convert.cluster_from_arrays` takes, read off
    a JAX-package Cluster: pods in the cluster's order (batch positions),
    nodes in launch order, each node's pods by position, the claims."""
    pods = list(cluster.pods.values())
    pos = {id(p): i for i, p in enumerate(pods)}
    nodes = list(cluster.nodes.values())
    return dict(nodes=nodes, pods=pods,
                bound=[[pos[id(p)] for p in n.pods] for n in nodes],
                claims=list(cluster.nodeclaims.values()))


def _carried(ref_cluster):
    d = describe(ref_cluster)
    out = convert.cluster_from_arrays(**d)
    pos = {id(p): i for i, p in enumerate(out.pods.values())}
    assert [pos[id(p)] for p in out.pending_pods()] == \
        [i for i, p in enumerate(d["pods"]) if not p.node_name]
    for n, src, rows in zip(out.nodes.values(), d["nodes"], d["bound"]):
        assert [pos[id(p)] for p in n.pods] == rows
        assert all(out.pods[p.uid] is p and p.node_name == n.name
                   for p in n.pods)
        assert (n.zone, n.instance_type, dict(n.allocatable)) == \
            (src.zone, src.instance_type, dict(src.allocatable))
    return out


def test_cluster_from_arrays_reads_mappings():
    """The description may be plain mappings: a node with two bound pods,
    one pending pod; fresh port names, hostname label and node_name
    follow, positions hold."""
    taint = {"key": "dedicated", "effect": "NoSchedule", "value": ""}
    pods = [{"name": f"p{i}", "uid": f"u{i}",
             "requests": {CPU: 500 * (i + 1)}} for i in range(3)]
    node = {"name": "n-a", "zone": "zone-a", "instance_type": "a.small",
            "nodepool": "default", "allocatable": {CPU: 1900},
            "labels": {wk.HOSTNAME: "n-a", wk.ZONE: "zone-a"},
            "taints": [taint]}
    out = convert.cluster_from_arrays([node], pods, [[2, 0]])
    (n,) = out.nodes.values()
    assert n.name != "n-a" and n.labels[wk.HOSTNAME] == n.name
    assert [p.name for p in n.pods] == ["p2", "p0"]
    assert all(p.node_name == n.name for p in n.pods)
    assert [p.name for p in out.pending_pods()] == ["p1"]
    assert list(out.pods.values())[1].requests == {CPU: 1000}
    assert n.taints[0].key == "dedicated" and n.allocatable == {CPU: 1900}
    assert len({p.uid for p in out.pods.values()}) == 3


@pytest.mark.parametrize("opts", [dict(),
                                  dict(lp_guide=False, device_decode=True)])
def test_two_rounds_on_a_carried_live_cluster(opts):
    """Round 1 in the JAX package; its live cluster carried across; round
    2 (≥ DEVICE_DECODE_FLOOR pods against the existing nodes: with the
    gate on, the slab programs with E > 0) in both on the same state."""
    catalog = zoned_catalog()
    ref = Cluster()
    ref_prov = Provisioner(CloudProvider(FakeCloud(), catalog), ref,
                           [ref_api.NodePool()], **opts)
    ref.add_pods(random_pinned_pods(np.random.default_rng(21), total=600))
    ref_prov.provision()
    port = _carried(ref)
    prov = TProvisioner(TCloudProvider(TFakeCloud(),
                                       convert.catalog_from_objects(catalog)),
                        port, [TNodePool()], device="cpu", **opts)
    round2 = random_pinned_pods(np.random.default_rng(22), total=600)
    sigs = []
    for cluster, p, pods in ((ref, ref_prov, round2),
                             (port, prov, [convert._pod(x) for x in round2])):
        cluster.add_pods(pods)
        batch = cluster.pending_pods()
        before = list(cluster.nodes)
        res = p.provision()
        sigs.append(workloads.provision_signature(batch, before, cluster,
                                                  res))
    assert sigs[0] == sigs[1]
    assert sigs[0]["bound_existing"] > 0


# ---- the packing ladder ----

def _ladder_pair(clock):
    return Pair(port_kw=dict(health=SolverHealth(clock=lambda: clock[0])),
                ref_kw=dict(health=RefHealth(clock=lambda: clock[0])))


def _poison(clock, *rungs):
    """Every solve on the named rungs raises in both packages: the same
    `solver.pack` rules armed in both injectors."""
    for chaos, rule in ((CHAOS, ChaosRule), (PORT_CHAOS, PortChaosRule)):
        chaos.configure([rule("solver.pack", key=r) for r in rungs],
                        seed=0, clock=lambda: clock[0], sleep=lambda s: None)


def _poisoned_rounds(clock, rungs, want):
    """Three rounds under `_poison(rungs)` (the reference's second crosses
    demote_after=2), the fault cleared, and a round past the window: the
    probe promotes jax back.  The two ladders book the same transitions."""
    p = _ladder_pair(clock)
    _poison(clock, *rungs)
    rng = np.random.default_rng(3)
    for step in range(3):
        p.add([cpu_pod(cpu_m=int(rng.integers(200, 3000)),
                       mem_mib=int(rng.integers(256, 4096)))
               for _ in range(5)])
        p.provision()
        assert not p.cluster.pending_pods(), "the ladder failed to plan"
        clock[0] += 30.0 if step == 0 else 5.0
    health = p.prov.health
    assert health.transitions == p.ref_prov.health.transitions == want
    assert health.snapshot()["rungs"]["jax"]["total_failures"] == 2
    assert PORT_CHAOS.counts() == CHAOS.counts()
    CHAOS.reset()
    PORT_CHAOS.reset()
    clock[0] += 120.0
    p.add([cpu_pod(cpu_m=700, mem_mib=700) for _ in range(5)])
    p.provision()
    assert not p.cluster.pending_pods()
    assert health.transitions.get("jax>jax:recovered") == 1
    assert health.transitions == p.ref_prov.health.transitions
    assert health.snapshot() == p.ref_prov.health.snapshot()
    return health


def test_poisoned_jax_rung_binds_via_greedy_and_recovers():
    """"jax" and "native" poisoned in both packages: each solve walks
    jax → native → greedy, and the host greedy rung binds every pod."""
    health = _poisoned_rounds([10_000.0], ("jax", "native"),
                              {"jax>native:error": 1,
                               "native>greedy:error": 1})
    assert health.snapshot()["rungs"]["native"]["total_failures"] == 2


def test_poisoned_jax_rung_binds_via_native_and_recovers():
    """"jax" alone poisoned in both packages: the native C++ packer
    answers inside the same solve, and after two strikes it is the rung
    the ladder starts on."""
    health = _poisoned_rounds([10_000.0], ("jax",), {"jax>native:error": 1})
    assert health.snapshot()["rungs"]["native"]["total_failures"] == 0


def test_happy_path_ladder_is_invisible():
    clock = [10_000.0]
    p = _ladder_pair(clock)
    p.add(_mixed_pods(40))
    p.provision()
    assert not p.cluster.pending_pods()
    health = p.prov.health
    assert health.transitions == {}
    assert all(r["total_failures"] == 0
               for r in health.snapshot()["rungs"].values())
    assert set(health.snapshot()["rungs"]) == set(RUNGS)


@pytest.mark.parametrize("module,kernel,n_pods,fault", [
    (port_fk, "ffd_scan", 5, KernelError),          # row 11 (small batch)
    (port_cp, "classpack_slab", 600, KernelError),  # rows 7-8 (DeviceDecode)
    (port_cp, "classpack_scan", 600, torch.cuda.OutOfMemoryError),
], ids=["ffd_scan", "classpack_slab", "classpack_scan"])
def test_a_kernel_fault_is_raised_not_demoted(monkeypatch, module, kernel,
                                              n_pods, fault):
    """A kernel that fails to build or launch raises out of provision()
    with a SolverHealth wired: the ladder books nothing and no greedy
    (host) solve answers for the card."""
    def broken(*a, **k):
        raise fault(f"{kernel}: CUDA error 700 (an illegal memory access)")
    monkeypatch.setattr(module, kernel, broken)
    health = SolverHealth(clock=lambda: 10_000.0)
    cluster = TCluster()
    prov = TProvisioner(TCloudProvider(
        TFakeCloud(), convert.catalog_from_objects(small_catalog())),
        cluster, [TNodePool()], device="cpu", health=health, lp_guide=False,
        device_decode=True)
    rungs = []
    run_rung = prov._run_rung
    prov._run_rung = lambda rung, *a: rungs.append(rung) or run_rung(rung, *a)
    cluster.add_pods([convert._pod(cpu_pod(cpu_m=500, mem_mib=512))
                      for _ in range(n_pods)])
    with pytest.raises(fault, match=kernel):
        prov.provision()
    assert rungs == ["jax"]
    assert health.transitions == {}
    assert all(r["total_failures"] == 0
               for r in health.snapshot()["rungs"].values())
    assert len(cluster.pending_pods()) == n_pods and not cluster.nodes


def test_ladder_snapshot_round_trip_matches_the_reference():
    clock = [100.0]
    port = SolverHealth(clock=lambda: clock[0])
    ref = RefHealth(clock=lambda: clock[0])
    for h in (port, ref):
        h.report_failure("jax", reason="error")
        h.report_failure("jax", reason="error")
        h.report_failure("native", reason="timeout")
    assert port.snapshot_state() == ref.snapshot_state()
    back = SolverHealth(clock=lambda: clock[0])
    back.restore_state(port.snapshot_state())
    assert back.snapshot_state() == port.snapshot_state()
    assert back.active_rung("jax") == "greedy"
    clock[0] += 61.0
    assert back.active_rung("jax") == "jax"    # half-open probe
    back.report_success("jax")
    assert back.transitions["jax>jax:recovered"] == 1
    assert "jax>jax:recovered" not in port.transitions


def test_watchdog():
    assert PHASES == {"provision.solve", "disruption.simulate",
                      "disruption.sweep"}
    assert run_with_deadline(lambda: 7, 0.0, "provision.solve") == 7
    assert run_with_deadline(lambda: 8, 5.0, "provision.solve") == 8
    with pytest.raises(KeyError):
        run_with_deadline(lambda: {}["x"], 5.0, "provision.solve")
    gate = threading.Event()
    t0 = time.monotonic()
    with pytest.raises(WatchdogTimeout):
        run_with_deadline(gate.wait, 0.05, "provision.solve")
    assert time.monotonic() - t0 < 2.0
    gate.set()
    with pytest.raises(ValueError, match="unregistered"):
        run_with_deadline(lambda: 1, 0.0, "nope")


# ---- the port's boundaries ----

def test_provisioner_defaults_to_the_card_and_raises_without_one(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    provider = TCloudProvider(TFakeCloud(),
                              convert.catalog_from_objects(small_catalog()))
    with pytest.raises(RuntimeError, match="CUDA"):
        TProvisioner(provider, TCluster(), [TNodePool()])


# ---- the goldens ----

def reference_cell(cell, stop_before=None):
    """Run a provisioning cell in the JAX package at full width; returns
    (signatures, env).  `stop_before` = r leaves round r's pods unadded."""
    env = workloads.provision_env(cell, FakeCloud, CloudProvider, Cluster,
                                  Provisioner, ref_api.NodePool,
                                  generate_catalog(workloads.PROVISION_TYPES))
    sigs = []
    for r, (kw, seed) in enumerate(workloads.PROVISION_CELLS[cell][1]):
        if r == stop_before:
            break
        sigs.append(workloads.provision_round(
            env, bench.build_pods(rng=np.random.default_rng(seed), **kw))[0])
    return sigs, env


def test_goldens_from_the_reference_and_the_port_small():
    cell = "provision-small-3x64"
    sigs, _ = reference_cell(cell)
    assert sigs == workloads.GOLDEN_PROVISION[cell]
    env = workloads.provision_env(cell, TFakeCloud, TCloudProvider, TCluster,
                                  TProvisioner, TNodePool,
                                  convert.catalog_from_objects(
                                      generate_catalog(
                                          workloads.PROVISION_TYPES)),
                                  device="cpu")
    for r, (kw, seed) in enumerate(workloads.PROVISION_CELLS[cell][1]):
        sig, _ = workloads.provision_round(env, workloads.build_pods(
            rng=np.random.default_rng(seed), **kw))
        assert sig == workloads.GOLDEN_PROVISION[cell][r]


def test_goldens_from_the_reference_and_the_port_live_round_2():
    """provision-live-50k-20k: the JAX package's two rounds give the
    golden; its round-1 cluster, carried across, gives the port's round 2
    the same golden (the slab programs with E = 1463, K = 2048)."""
    cell = "provision-live-50k-20k"
    gold = workloads.GOLDEN_PROVISION[cell]
    sigs, env = reference_cell(cell, stop_before=1)
    assert sigs == gold[:1]
    port = _carried(env.cluster)
    kw, seed = workloads.PROVISION_CELLS[cell][1][1]
    ref_sig, _ = workloads.provision_round(
        env, bench.build_pods(rng=np.random.default_rng(seed), **kw))
    assert ref_sig == gold[1]
    tenv = workloads.ProvisionEnv(
        None, None, port, TProvisioner(
            TCloudProvider(TFakeCloud(), convert.catalog_from_objects(
                generate_catalog(workloads.PROVISION_TYPES))),
            port, [TNodePool()], device="cpu",
            **workloads.PROVISION_CELLS[cell][0]))
    sig, _ = workloads.provision_round(tenv, workloads.build_pods(
        rng=np.random.default_rng(seed), **kw))
    assert sig == gold[1]


if __name__ == "__main__":
    import json
    out = {cell: reference_cell(cell)[0] for cell in
           (sys.argv[1:] or workloads.PROVISION_CELLS)}
    print(json.dumps(out, indent=1))
