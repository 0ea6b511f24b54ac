"""The port's disruption controller, carried out, against the JAX package's.

Every case builds the same fixture in both packages — the catalog carried
across with `convert.catalog_from_objects`, the pods with `convert._pod`,
the pools, clouds, providers, clusters, provisioners and controllers from
the same constructors on one fake clock — and drives both through the same
steps.  Every `reconcile()` is compared tick by tick with
`workloads.disruption_tick`'s signature (the action, its candidates by
launch position, the launched claims, the counts deleted / rebound to
survivors / bound to new nodes / pending, the moves' digest, the running
instances and their $/h summed in launch order, compared with ==, and the
error flag), and every provisioning round with
`workloads.provision_signature`.  The port runs on the CPU (`device="cpu"`:
the kernels' plain versions).

  * the 30 cases of tests/test_disruption.py, their assertions checked on
    the port's side;
  * the port's boundaries: the options still unported raise and name
    their ROADMAP.md items, a device fault in the decision or a
    replacement solve leaves `reconcile()` as it came, the rebinds bind
    the cluster's own pods, the arena is rebuilt after an executed tick,
    a terminate failure aimed at that one API untaints for a retry;
  * the full-width cell `disruption-replay-500` (BASELINE config 4): the
    JAX package produces `workloads.GOLDEN_DISRUPTION` and the port
    reproduces it tick by tick (about 25 s each on the CPU).

    python tests/test_torch_disruption.py     # print GOLDEN_DISRUPTION as
                                              # the JAX package makes it
"""

import sys
from types import SimpleNamespace

import pytest

from helpers import cpu_pod, make_type, small_catalog
from karpenter_tpu import api as ref_api
from karpenter_tpu.api import labels as wk
from karpenter_tpu.api.objects import NodeClaim as RefNodeClaim
from karpenter_tpu.api.objects import NodeClass as RefNodeClass
from karpenter_tpu.api.objects import Pod as RefPod
from karpenter_tpu.api.objects import PodDisruptionBudget as RefPDB
from karpenter_tpu.catalog.generate import generate_catalog
from karpenter_tpu.cloud import CloudProvider, FakeCloud
from karpenter_tpu.cloud.cache import UnavailableOfferings
from karpenter_tpu.cloud.fake import CloudError as RefCloudError
from karpenter_tpu.cloud.fake import FleetOverride
from karpenter_tpu.cloud.queue import FakeQueue
from karpenter_tpu.controllers import (DisruptionController,
                                       GarbageCollectionController,
                                       InterruptionController, Provisioner,
                                       TerminationController)
from karpenter_tpu.controllers.nodeclass import static_hash as ref_hash
from karpenter_tpu.ops import classpack as ref_cp
from karpenter_tpu.ops import lpguide as ref_lg
from karpenter_tpu.ops import lpsolve as ref_lp
from karpenter_tpu.state import Cluster
from karpenter_tpu.utils.events import Recorder as RefRecorder
from karpenter_tpu_torch import api as port_api
from karpenter_tpu_torch import convert, workloads
from karpenter_tpu_torch._build import KernelError
from karpenter_tpu_torch.api.objects import NodeClaim as TNodeClaim
from karpenter_tpu_torch.api.objects import NodeClass as TNodeClass
from karpenter_tpu_torch.cloud import CloudProvider as TCloudProvider
from karpenter_tpu_torch.cloud import FakeCloud as TFakeCloud
from karpenter_tpu_torch.cloud import static_hash as port_hash
from karpenter_tpu_torch.cloud.fake import CloudError as TCloudError
from karpenter_tpu_torch.controllers import disruption as port_dmod
from karpenter_tpu_torch.controllers.disruption import DISRUPTION_TAINT
from karpenter_tpu_torch.ops import classpack as port_cp
from karpenter_tpu_torch.ops import classpack_kernels as ck
from karpenter_tpu_torch.ops import lpguide as port_lg
from karpenter_tpu_torch.ops import lpsolve as port_lp
from karpenter_tpu_torch.utils.events import Recorder as TRecorder
from torch_cases import one_torch_thread  # noqa: F401

REF_KIT = SimpleNamespace(
    FakeQueue=FakeQueue, FakeCloud=FakeCloud, FleetOverride=FleetOverride,
    CloudProvider=CloudProvider, UnavailableOfferings=UnavailableOfferings,
    Cluster=Cluster, Provisioner=Provisioner,
    TerminationController=TerminationController,
    DisruptionController=DisruptionController,
    InterruptionController=InterruptionController,
    GarbageCollectionController=GarbageCollectionController,
    NodePool=ref_api.NodePool, Pod=ref_api.Pod,
    ResourceList=ref_api.ResourceList)


def clear_lp_caches():
    """Both packages' guide caches and PDHG warm starts: the goldens were
    made in a fresh process, and a warm guide cache may change a guided
    round's plan."""
    for lg in (ref_lg, port_lg):
        with lg._MIX_LOCK:
            lg._MIX_CACHE.clear()
            lg._STALE_CACHE.clear()
            lg._SUPPORT_CACHE.clear()
    ref_lp.reset_caches()
    port_lp.reset_caches()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def step(self, dt):
        self.t += dt


def underutilized(api):
    return [api.NodePool(disruption=api.Disruption(
        consolidation_policy="WhenUnderutilized"))]


class Side:
    """One package's objects on the shared clock.  `pods` are every pod
    the case added, in order (a pod's position is its identity);
    `launch_index` numbers the nodes in launch order."""

    def __init__(self, kit, api, catalog, pools, clock, stabilization,
                 terminator, queue, recorder, **extra):
        self.clock = clock
        self.queue = kit.FakeQueue(clock) if queue else None
        self.cloud = kit.FakeCloud(clock, queue=self.queue)
        self.provider = kit.CloudProvider(self.cloud, catalog, clock=clock)
        self.cluster = kit.Cluster(clock)
        self.pools = pools(api)
        self.provisioner = kit.Provisioner(self.provider, self.cluster,
                                           self.pools, clock=clock, **extra)
        self.terminator = kit.TerminationController(self.provider,
                                                    self.cluster, clock=clock)
        self.disruption = kit.DisruptionController(
            self.provider, self.cluster, self.pools, clock=clock,
            stabilization_s=stabilization,
            terminator=self.terminator if terminator else None,
            recorder=recorder, **extra)
        self.interruption = None if queue is False else \
            kit.InterruptionController(self.queue, self.provider,
                                       self.cluster, self.terminator,
                                       clock=clock)
        self.gc = kit.GarbageCollectionController(self.provider,
                                                  self.cluster, clock=clock)
        self.pods = []
        self.launch_index = {}

    def nodes(self):
        workloads.index_nodes(self)
        return list(self.cluster.nodes.values())


class Twin:
    """One fixture in both packages: `r` the JAX package's side, `p` the
    port's.  Methods taking a reference object find the port's
    counterpart by position."""

    def __init__(self, catalog=None, pools=underutilized, stabilization=0.0,
                 terminator=False, queue=False, record=False):
        self.clock = FakeClock()
        catalog = catalog if catalog is not None else small_catalog()
        rec = (RefRecorder(clock=self.clock, log=False),
               TRecorder(clock=self.clock, log=False)) if record \
            else (None, None)
        self.r = Side(REF_KIT, ref_api, catalog, pools, self.clock,
                      stabilization, terminator, queue, rec[0])
        self.p = Side(workloads.port_kit(), port_api,
                      convert.catalog_from_objects(catalog), pools,
                      self.clock, stabilization, terminator, queue, rec[1],
                      device="cpu")
        self.sides = (self.r, self.p)

    # ---- state in both ----
    def add(self, pods):
        self.r.cluster.add_pods(pods)
        self.r.pods.extend(pods)
        twins = [convert._pod(p) for p in pods]
        self.p.cluster.add_pods(twins)
        self.p.pods.extend(twins)

    def pod(self, ref_pod):
        return self.p.pods[next(i for i, p in enumerate(self.r.pods)
                                if p is ref_pod)]

    def node(self, ref_node):
        """The port's node at `ref_node`'s launch position."""
        self.r.nodes()
        i = self.r.launch_index[ref_node.name]
        return next(n for n in self.p.nodes() if self.p.launch_index[n.name]
                    == i)

    def delete_pod(self, ref_pod):
        port_pod = self.pod(ref_pod)
        self.r.cluster.delete_pod(ref_pod)
        self.p.cluster.delete_pod(port_pod)

    def add_bound(self, ref_pod, ref_node):
        """Add `ref_pod` and bind it to `ref_node` in both."""
        self.add([ref_pod])
        port_node = self.node(ref_node)
        self.r.cluster.bind_pod(ref_pod, ref_node.name)
        self.p.cluster.bind_pod(self.pod(ref_pod), port_node.name)

    def step(self, dt):
        self.clock.step(dt)

    # ---- compared steps ----
    def provision(self, pods=None, schedulable=True):
        """One provisioning round of the pending pods (after adding `pods`)
        in both; the signatures must be equal.  Returns the port's
        ProvisioningResult."""
        if pods:
            self.add(pods)
        sigs, out = [], None
        for side in self.sides:
            batch = side.cluster.pending_pods()
            before = list(side.cluster.nodes)
            out = side.provisioner.provision()
            sigs.append(workloads.provision_signature(batch, before,
                                                      side.cluster, out))
            workloads.index_nodes(side)
        assert sigs[1] == sigs[0]
        if schedulable:
            assert not out.unschedulable
        return out

    def tick(self):
        """One `reconcile()` in both; the tick signatures must be equal.
        Returns the port's DisruptionResult."""
        sigs, out = [], None
        for side in self.sides:
            sig, out = workloads.disruption_tick(side, "tick", step=0.0)
            sigs.append(sig)
        assert sigs[1] == sigs[0]
        return out

    def candidates(self):
        """Both packages' candidates by launch position, which must agree;
        returns the port's."""
        got = []
        for side in self.sides:
            side.nodes()
            cands = side.disruption.candidates()
            got.append(([side.launch_index[c.name] for c in cands], cands))
        assert got[1][0] == got[0][0]
        return got[1][1]

    def both(self, fn):
        """fn(side) on both sides."""
        for side in self.sides:
            fn(side)


@pytest.fixture(autouse=True)
def _clean_lp_caches():
    clear_lp_caches()
    yield
    clear_lp_caches()


# ---- the cases of tests/test_disruption.py: emptiness ----

def test_empty_node_deleted_when_empty_policy():
    t = Twin(pools=lambda api: [api.NodePool(disruption=api.Disruption(
        consolidation_policy="WhenEmpty", consolidate_after_s=30))])
    t.provision([cpu_pod()])
    ref_node = next(iter(t.r.cluster.nodes.values()))
    node = t.node(ref_node)
    for p in list(ref_node.pods):
        t.delete_pod(p)
    assert t.tick().action is None           # consolidate_after not elapsed
    t.step(60)
    res = t.tick()
    assert res.action is not None and res.action.reason == "emptiness"
    assert res.deleted == [node.name]
    assert not t.p.cluster.nodes
    assert not t.p.cloud.running()


def test_all_empty_nodes_deleted_in_one_action():
    t = Twin(pools=lambda api: [api.NodePool(disruption=api.Disruption(
        consolidation_policy="WhenEmpty", consolidate_after_s=0))])
    for _ in range(3):
        t.provision([cpu_pod(cpu_m=1800, mem_mib=3500)])
    assert len(t.p.cluster.nodes) == 3
    for p in list(t.r.cluster.pods.values()):
        t.delete_pod(p)
    assert len(t.tick().deleted) == 3


# ---- consolidation ----

def test_consolidation_delete_packs_pods_onto_survivor():
    t = Twin()
    t.provision([cpu_pod(cpu_m=400)])
    t.provision([cpu_pod(cpu_m=1800, mem_mib=3000)])
    assert len(t.p.cluster.nodes) == 2
    res = t.tick()
    assert res.action is not None
    assert res.action.name == "delete/consolidation"
    assert len(t.p.cluster.nodes) == 1
    survivor = next(iter(t.p.cluster.nodes.values()))
    assert len(survivor.pods) == 2
    assert not t.p.cluster.pending_pods()
    assert len(t.p.cloud.running()) == 1


def test_consolidation_replace_with_cheaper_node():
    t = Twin()
    big = cpu_pod(cpu_m=12000, mem_mib=24000)
    tiny = cpu_pod(cpu_m=200, mem_mib=256)
    t.provision([big, tiny])
    node = next(iter(t.p.cluster.nodes.values()))
    assert node.instance_type == "a.xlarge"
    t.delete_pod(big)
    res = t.tick()
    assert res.action is not None and res.action.name == "replace/consolidation"
    assert len(res.launched) == 1
    assert len(t.p.cluster.nodes) == 1
    new = next(iter(t.p.cluster.nodes.values()))
    assert new.instance_type == "a.small"
    assert new.price < node.price
    assert [p.uid for p in new.pods] == [tiny.uid]


def _four_nearly_empty(t):
    """tests/test_disruption.py's multi-node fixture: four nodes forced
    apart by zone selectors, then one tiny pod on each."""
    zones = ("zone-a", "zone-b", "zone-c", "zone-d")
    bigs = [cpu_pod(cpu_m=1500, mem_mib=2000, node_selector={wk.ZONE: z})
            for z in zones]
    t.provision(bigs)
    assert len(t.p.cluster.nodes) == 4
    for b in bigs:
        t.delete_pod(b)
    for node in list(t.r.cluster.nodes.values()):
        t.add_bound(cpu_pod(cpu_m=100, mem_mib=128), node)


FOUR_ZONES = lambda: [make_type("a.small", 2, 4, 0.10,  # noqa: E731
                                zones=("zone-a", "zone-b", "zone-c",
                                       "zone-d"))]


def test_multinode_consolidation_binary_search():
    t = Twin(catalog=FOUR_ZONES())
    _four_nearly_empty(t)
    res = t.tick()
    assert res.action is not None and res.action.kind == "delete"
    assert len(res.deleted) == 3
    assert len(t.p.cluster.nodes) == 1
    assert len(next(iter(t.p.cluster.nodes.values())).pods) == 4


def test_consolidation_noop_when_packed():
    t = Twin()
    t.provision([cpu_pod(cpu_m=1800, mem_mib=3500)])
    assert t.tick().action is None
    assert len(t.p.cluster.nodes) == 1


def test_consolidate_after_defers_consolidation():
    t = Twin(pools=lambda api: [api.NodePool(disruption=api.Disruption(
        consolidation_policy="WhenUnderutilized", consolidate_after_s=120))])
    t.provision([cpu_pod(cpu_m=400)])
    t.provision([cpu_pod(cpu_m=1800, mem_mib=3000)])
    assert len(t.p.cluster.nodes) == 2
    assert t.tick().action is None
    t.step(180)
    assert t.tick().action is not None


# ---- blockers ----

def test_do_not_disrupt_pod_blocks():
    t = Twin()
    blocked = cpu_pod(cpu_m=400, annotations={RefPod.DO_NOT_DISRUPT: "true"})
    t.provision([blocked])
    t.provision([cpu_pod(cpu_m=1800, mem_mib=3000)])
    t.tick()
    names = [c.name for c in t.candidates()]
    assert t.pod(blocked).node_name not in names


def test_ownerless_pod_blocks():
    t = Twin()
    t.provision([cpu_pod(cpu_m=400, owner_kind="")])
    assert t.candidates() == []


def test_pdb_blocks_consolidation():
    t = Twin()
    pod = cpu_pod(cpu_m=400, labels={"app": "web"})
    t.provision([pod])
    t.provision([cpu_pod(cpu_m=400)])
    t.r.cluster.add_pdb(RefPDB(
        selector={"app": "web"}, min_available=1))
    t.p.cluster.add_pdb(port_api.PodDisruptionBudget(
        selector={"app": "web"}, min_available=1))
    names = [c.name for c in t.candidates()]
    assert t.pod(pod).node_name not in names


def test_stabilization_window_blocks_young_nodes():
    t = Twin(stabilization=300)
    t.provision([cpu_pod(cpu_m=400)])
    assert t.candidates() == []
    t.step(600)
    assert len(t.candidates()) == 1


def test_daemonset_pods_dont_block_and_dont_reschedule():
    t = Twin(pools=lambda api: [api.NodePool(disruption=api.Disruption(
        consolidation_policy="WhenEmpty", consolidate_after_s=0))])
    app = cpu_pod(cpu_m=400)
    t.provision([app])
    ref_node = next(iter(t.r.cluster.nodes.values()))
    t.add_bound(cpu_pod(cpu_m=50, owner_kind="DaemonSet"), ref_node)
    t.delete_pod(app)
    res = t.tick()             # a daemonset-only node counts as empty
    assert res.action is not None and res.action.reason == "emptiness"


def test_pdb_union_blocks_multinode_consolidation():
    zones = ("zone-a", "zone-b", "zone-c")
    catalog = [make_type("a.small", 2, 4, 0.10, zones=zones),
               make_type("a.large", 8, 16, 0.40, zones=zones)]
    t = Twin(catalog=catalog)
    t.provision([cpu_pod(cpu_m=6000, mem_mib=8000)])
    t.provision([cpu_pod(cpu_m=1500, mem_mib=2000, labels={"app": "web"},
                         node_selector={wk.ZONE: z})
                 for z in ("zone-b", "zone-c")])
    assert len(t.p.cluster.nodes) == 3
    t.r.cluster.add_pdb(RefPDB(
        selector={"app": "web"}, max_unavailable=1))
    t.p.cluster.add_pdb(port_api.PodDisruptionBudget(
        selector={"app": "web"}, max_unavailable=1))
    res = t.tick()
    if res.action is not None:
        evicted = [p for c in res.action.candidates for p in c.reschedulable
                   if p.labels.get("app") == "web"]
        assert len(evicted) <= 1


def test_daemonset_pods_die_with_node():
    t = Twin(pools=lambda api: [api.NodePool(disruption=api.Disruption(
        consolidation_policy="WhenEmpty", consolidate_after_s=0))])
    app = cpu_pod(cpu_m=400)
    t.provision([app])
    ref_node = next(iter(t.r.cluster.nodes.values()))
    node = t.node(ref_node)
    t.add_bound(cpu_pod(cpu_m=50, owner_kind="DaemonSet"), ref_node)
    t.delete_pod(app)
    res = t.tick()
    assert res.deleted == [node.name]
    # the daemonset pod must NOT be requeued as pending
    assert not t.p.cluster.pending_pods()
    assert t.provision().launched == []


def test_empty_timer_runs_from_became_empty_not_node_age():
    t = Twin(pools=lambda api: [api.NodePool(disruption=api.Disruption(
        consolidation_policy="WhenEmpty", consolidate_after_s=30))])
    pod = cpu_pod(cpu_m=400)
    t.provision([pod])
    node = t.node(next(iter(t.r.cluster.nodes.values())))
    t.step(3600)                      # the node is old…
    t.delete_pod(pod)                 # …but became empty just now
    assert t.tick().action is None
    t.step(10)
    assert t.tick().action is None
    t.step(30)
    assert t.tick().deleted == [node.name]


def test_fresh_node_nomination_blocks_disruption():
    t = Twin()
    t.provision([cpu_pod(cpu_m=400)])
    node = next(iter(t.p.cluster.nodes.values()))
    assert node.nominated_until == 0.0       # binding fulfilled it
    fresh = []
    for side, NodeClaim in ((t.r, RefNodeClaim), (t.p, TNodeClaim)):
        n = next(iter(side.cluster.nodes.values()))
        claim = next(iter(side.cluster.nodeclaims.values()))
        empty = NodeClaim(nodepool=claim.nodepool, labels=dict(claim.labels))
        empty.price = 0.1
        fresh.append(side.cluster.register_nodeclaim(empty, n.allocatable,
                                                     n.capacity))
    n2 = fresh[1]
    assert n2.nominated_until > t.clock()
    assert n2.name not in [c.name for c in t.candidates()]
    t.step(60)                        # the window lapses → fair game
    assert n2.name in [c.name for c in t.candidates()]


# ---- expiration and drift ----

def test_expiration_replaces_node():
    t = Twin(pools=lambda api: [api.NodePool(disruption=api.Disruption(
        consolidation_policy="WhenUnderutilized", expire_after_s=3600))])
    pod = cpu_pod(cpu_m=1800, mem_mib=3000)
    t.provision([pod])
    old = next(iter(t.p.cluster.nodes.values()))
    assert t.p.disruption.find_expired(t.candidates()) == []
    t.step(7200)
    res = t.tick()
    assert res.action is not None and res.action.reason == "expiration"
    assert old.name in res.deleted
    assert len(t.p.cluster.nodes) == 1
    new = next(iter(t.p.cluster.nodes.values()))
    assert new.name != old.name
    assert [p.uid for p in new.pods] == [pod.uid]
    assert len(t.p.cloud.running()) == 1


def _remove_launched_type(t):
    claim = next(iter(t.p.cluster.nodeclaims.values()))

    def drop(side):
        side.provider.instance_types.base_catalog = [
            it for it in side.provider.instance_types.base_catalog
            if it.name != claim.instance_type]
        side.provider.instance_types._memo = None
    t.both(drop)
    return claim


def test_drift_on_catalog_removal():
    t = Twin()
    t.provision([cpu_pod(cpu_m=400)])
    claim = _remove_launched_type(t)
    res = t.tick()
    assert res.action is not None and res.action.reason == "drift"
    assert len(t.p.cluster.nodes) == 1
    assert next(iter(t.p.cluster.nodes.values())).instance_type != \
        claim.instance_type


def test_drift_disabled_feature_gate():
    t = Twin()
    t.both(lambda side: setattr(side.disruption, "drift_enabled", False))
    t.provision([cpu_pod(cpu_m=400)])
    _remove_launched_type(t)
    assert t.p.disruption.find_drifted(t.candidates()) == []
    assert t.r.disruption.find_drifted(t.r.disruption.candidates()) == []


# ---- rollback ----

def test_rollback_on_failed_replacement_launch():
    t = Twin(pools=lambda api: [api.NodePool(disruption=api.Disruption(
        consolidation_policy="WhenUnderutilized", expire_after_s=3600))])
    pod = cpu_pod(cpu_m=1800, mem_mib=3000)
    t.provision([pod])
    node = next(iter(t.p.cluster.nodes.values()))
    t.step(7200)
    for side in t.sides:
        for it in side.provider.instance_types.base_catalog:
            for o in it.offerings:
                side.cloud.insufficient_capacity_pools.add(
                    (o.capacity_type, it.name, o.zone))
    res = t.tick()
    assert res.error
    assert res.launched == [] and res.deleted == []
    assert not node.marked_for_deletion
    assert DISRUPTION_TAINT not in node.taints
    assert t.pod(pod).node_name == node.name
    assert len(t.p.cluster.nodes) == 1


def test_rollback_deletes_the_replacements_already_launched():
    """A drift replacement of two nodes whose second launch fails: the
    first replacement is terminated again, the candidate untainted, and
    the result reports no launch — in both packages alike."""
    t = Twin(catalog=[make_type("a.large", 8, 16, 0.45),
                      make_type("a.xlarge", 16, 32, 0.80)])
    pods = [cpu_pod(cpu_m=7000, mem_mib=1024) for _ in range(2)]
    t.provision(pods)
    node = next(iter(t.p.cluster.nodes.values()))
    assert node.instance_type == "a.xlarge" and len(t.p.cluster.nodes) == 1
    _remove_launched_type(t)
    for side in t.sides:
        create = side.provider.create

        def first_then_ice(claim, _side=side, _create=create):
            out = _create(claim)
            for it in _side.provider.instance_types.base_catalog:
                for o in it.offerings:
                    _side.cloud.insufficient_capacity_pools.add(
                        (o.capacity_type, it.name, o.zone))
            return out
        side.provider.create = first_then_ice
    res = t.tick()
    assert res.action.name == "replace/drift"
    assert len(res.action.simulation.nodes) == 2
    assert res.error and res.launched == [] and res.deleted == []
    assert list(t.p.cluster.nodes) == [node.name]
    assert [i.id for i in t.p.cloud.running()] == [node.provider_id]
    assert not node.marked_for_deletion
    assert DISRUPTION_TAINT not in node.taints
    assert all(t.pod(p).node_name == node.name for p in pods)


def test_transient_delete_failure_untaints_for_retry():
    t = Twin()
    t.provision([cpu_pod(cpu_m=400)])
    t.provision([cpu_pod(cpu_m=1800, mem_mib=3000)])
    t.r.cloud.next_error = RefCloudError("InternalError", "transient")
    t.p.cloud.next_error = TCloudError("InternalError", "transient")
    res = t.tick()
    assert res.action is not None
    assert res.error and res.deleted == []
    doomed = res.action.candidates[0].node
    assert not doomed.marked_for_deletion
    assert DISRUPTION_TAINT not in doomed.taints
    assert len(t.p.cloud.running()) == 2
    res2 = t.tick()                   # the retry: the node is empty now
    assert res2.deleted == [doomed.name]
    assert len(t.p.cloud.running()) == 1


def test_terminate_failure_after_a_replacement_untaints_for_retry():
    """A drift replacement whose candidate's terminate call fails, the
    fault aimed at that one API (the same chaos rule on
    `cloud.api[terminate_instances]` armed in both packages): the
    replacement's CreateFleet goes through, the pods move to it, and the
    candidate is untainted so the next tick retries the delete."""
    from karpenter_tpu.utils.chaos import CHAOS, ChaosRule
    from karpenter_tpu_torch.utils import chaos as port_chaos
    t = Twin()
    pod = cpu_pod(cpu_m=400)
    t.provision([pod])
    _remove_launched_type(t)
    for inj, rule in ((CHAOS, ChaosRule),
                      (port_chaos.CHAOS, port_chaos.ChaosRule)):
        inj.configure([rule(point="cloud.api", key="terminate_instances",
                            count=1, error_code="InternalError")])
    try:
        res = t.tick()
        fired = (port_chaos.CHAOS.counts(), CHAOS.counts())
    finally:
        CHAOS.reset()
        port_chaos.CHAOS.reset()
    assert res.action.name == "replace/drift"
    assert res.error and res.deleted == [] and len(res.launched) == 1
    assert fired[0] == fired[1] == {"cloud.api/error": 1}
    doomed = res.action.candidates[0].node
    assert not doomed.marked_for_deletion
    assert DISRUPTION_TAINT not in doomed.taints
    moved = t.p.cluster.nodes[t.pod(pod).node_name]
    assert moved.provider_id == res.launched[0].provider_id
    assert len(t.p.cloud.running()) == 2
    res2 = t.tick()                   # the retry: the node is empty now
    assert res2.deleted == [doomed.name]
    assert len(t.p.cloud.running()) == 1


def test_disruption_taint_applied_during_execution():
    t = Twin()
    t.provision([cpu_pod(cpu_m=400)])
    t.provision([cpu_pod(cpu_m=1800, mem_mib=3000)])
    res = t.tick()
    assert res.action is not None
    for c in res.action.candidates:
        assert c.node.marked_for_deletion
        assert DISRUPTION_TAINT in c.node.taints


# ---- ranking ----

def test_candidates_ranked_by_disruption_cost():
    t = Twin()
    light = cpu_pod(cpu_m=100)
    t.provision([light])
    t.provision([cpu_pod(cpu_m=100, priority=1000,
                         node_selector={wk.ZONE: "zone-b"})
                 for _ in range(3)])
    cands = t.candidates()
    assert len(cands) == 2
    assert cands[0].name == t.pod(light).node_name


# ---- static-hash drift and hydration (TestStaticHashDrift) ----

def test_nodeclass_spec_change_drifts_launched_nodes():
    for NodeClass, NodeClaim, Provider, Cloud, cat, h in (
            (RefNodeClass, RefNodeClaim, CloudProvider, FakeCloud,
             small_catalog(), ref_hash),
            (TNodeClass, TNodeClaim, TCloudProvider, TFakeCloud,
             convert.catalog_from_objects(small_catalog()), port_hash)):
        nc = NodeClass(user_data="v1")
        provider = Provider(Cloud(), cat, node_classes={"default": nc})
        claim = provider.create(NodeClaim(nodepool="p"))
        assert claim.node_class_hash == h(nc)
        assert provider.is_drifted(claim) is None
        nc.user_data = "v2"
        nc.hash_annotation = h(nc)
        assert provider.is_drifted(claim) == "NodeClassHashDrifted"
    assert port_hash(TNodeClass(user_data="v2")) == \
        ref_hash(RefNodeClass(user_data="v2"))


def _hydrated(NodeClass, NodeClaim, Provider, Cloud, cat, ref="default"):
    cloud = Cloud()
    classes = {"default": NodeClass(),
               "gpu": NodeClass(name="gpu", user_data="gpu-init")}
    p1 = Provider(cloud, cat, node_classes=classes)
    claim = p1.create(NodeClaim(nodepool="p", node_class_ref=ref))
    p2 = Provider(cloud, cat, node_classes=classes)
    return p1, claim, p2, p2.list()[0]


PACKAGES = {
    "reference": lambda: (RefNodeClass, RefNodeClaim, CloudProvider,
                          FakeCloud, small_catalog()),
    "port": lambda: (TNodeClass, TNodeClaim, TCloudProvider, TFakeCloud,
                     convert.catalog_from_objects(small_catalog()))}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_hash_survives_hydration(pkg):
    p1, claim, p2, rebuilt = _hydrated(*PACKAGES[pkg]())
    assert rebuilt is not claim
    assert rebuilt.node_class_hash == claim.node_class_hash


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_non_default_nodeclass_ref_survives_hydration(pkg):
    p1, claim, p2, rebuilt = _hydrated(*PACKAGES[pkg](), ref="gpu")
    assert p1.is_drifted(claim) is None
    assert rebuilt.node_class_ref == "gpu"
    assert p2.is_drifted(rebuilt) is None  # a healthy node is NOT drifted


# ---- the spot→spot flexibility floor ----

def _spot_fleet(types, tiny_cpu_m):
    zones = tuple(f"zone-{c}" for c in "abcdefgh")
    catalog = [make_type(n, c, m, pr, zones=zones, spot_discount=0.5)
               for n, c, m, pr in types]
    t = Twin(catalog=catalog)
    big = cpu_pod(cpu_m=12000, mem_mib=24000)
    t.provision([big, cpu_pod(cpu_m=tiny_cpu_m, mem_mib=256)])
    node = next(iter(t.p.cluster.nodes.values()))
    t.delete_pod(big)
    return t, node


def test_spot_to_spot_flexibility_counts_types_not_zone_options():
    t, node = _spot_fleet([("s.big", 16, 32, 1.00), ("s.a", 4, 8, 0.40),
                           ("s.b", 4, 8, 0.44)], 200)
    assert node.instance_type == "s.big"
    assert node.capacity_type == wk.CAPACITY_TYPE_SPOT
    res = t.tick()
    assert res.action is not None and res.action.name == "replace/consolidation"
    new = next(iter(t.p.cluster.nodes.values()))
    assert new.capacity_type == wk.CAPACITY_TYPE_SPOT
    assert new.price < node.price


def test_spot_to_spot_still_blocked_below_catalog_clamp():
    t, node = _spot_fleet([("s.big", 16, 32, 1.00), ("s.a", 4, 8, 0.40)],
                          3800)
    t.both(lambda side: setattr(side.disruption, "spot_min_flexibility", 2))
    res = t.tick()
    assert res.action is not None and res.action.name == "replace/consolidation"


def test_consolidation_probes_use_batched_sweep(monkeypatch):
    """Feasibility probes run as batched arena sweeps; only the accepted
    action pays for a decoded solve — in both packages."""
    t = Twin(catalog=FOUR_ZONES())
    _four_nearly_empty(t)
    calls = {"reference": [], "port": []}
    sweeps = {"reference": [], "port": []}
    for name, side, mod in (("reference", t.r, ref_cp),
                            ("port", t.p, port_cp)):
        orig = side.disruption.simulate

        def spy(excluded, allow_new=False, max_total_price=None,
                decode=True, _orig=orig, _calls=calls[name]):
            _calls.append(decode)
            return _orig(excluded, allow_new=allow_new,
                         max_total_price=max_total_price, decode=decode)
        side.disruption.simulate = spy
        orig_sweep = mod.solve_classpack_sweep

        def sweep_spy(*a, _orig=orig_sweep, _sweeps=sweeps[name], **kw):
            res = _orig(*a, **kw)
            _sweeps.append(res.device_calls)
            return res
        monkeypatch.setattr(mod, "solve_classpack_sweep", sweep_spy)
    res = t.tick()
    assert res.action is not None and res.action.kind == "delete"
    assert len(res.deleted) == 3
    assert calls["port"] == calls["reference"] == [True]
    assert sum(sweeps["port"]) == sum(sweeps["reference"]) == 1


def test_disruption_events_published():
    t = Twin(record=True)
    t.provision([cpu_pod(cpu_m=300)])
    t.provision([cpu_pod(cpu_m=300,
                         annotations={RefPod.DO_NOT_DISRUPT: "true"})])
    res = t.tick()
    rec = t.p.disruption.recorder
    reasons = {e.reason for e in rec.events()}
    assert "Unconsolidatable" in reasons
    assert any("do-not-disrupt" in e.message
               for e in rec.events("Unconsolidatable"))
    if res.deleted:
        assert "DisruptionTerminating" in reasons
    assert sorted(e.reason for e in rec.events()) == sorted(
        e.reason for e in t.r.disruption.recorder.events())


# ---- the port's boundaries ----

def test_terminator_and_gang_source_are_wired():
    """`terminator`, and `gang_source` (the GangScheduling gate's plan
    queue, refused before gang scheduling was ported): a tick whose source
    yields a plan executes it ahead of every other method."""
    f = workloads.consolidation_fleet(n_nodes=4)
    term = object()
    ctrl = port_dmod.DisruptionController(f.provider, f.cluster, f.pools,
                                          clock=f.clock, device="cpu",
                                          terminator=term)
    assert ctrl.terminator is term and ctrl.gang_source is None
    from karpenter_tpu_torch.ops.gang import PreemptionPlan
    plans = [PreemptionPlan(gang="g", tier=1, topology="zone",
                            domain="zone-a", victims=[], total_cost=0.0)]
    ctrl = port_dmod.DisruptionController(
        f.provider, f.cluster, f.pools, clock=f.clock, device="cpu",
        terminator=term, drift_enabled=False,
        gang_source=lambda: plans.pop() if plans else None)
    action = ctrl.reconcile().action
    assert (action.kind, action.reason, action.candidates) == \
        ("preempt", "gang", [])
    assert not plans


def test_health_and_watchdog_are_wired():
    """`health` and `watchdog_timeout_s` (the reference's ladder and
    deadline) are taken as the reference takes them; with no rung failing
    the tick is the direct path's and books only successes."""
    from karpenter_tpu.ops.health import SolverHealth as RefHealth
    from karpenter_tpu_torch.ops.health import SolverHealth
    t = Twin()
    t.r.disruption.health = RefHealth(clock=t.clock)
    t.p.disruption.health = SolverHealth(clock=t.clock)
    for side in t.sides:
        side.disruption.watchdog_timeout_s = 30.0
    t.provision([cpu_pod(cpu_m=400)])
    t.provision([cpu_pod(cpu_m=1800, mem_mib=3000)])
    res = t.tick()
    assert res.action is not None
    assert t.p.disruption.health.snapshot() == \
        t.r.disruption.health.snapshot()
    assert t.p.disruption.health.transitions == {}
    f = workloads.consolidation_fleet(n_nodes=4)
    h = SolverHealth()
    ctrl = port_dmod.DisruptionController(f.provider, f.cluster, f.pools,
                                          clock=f.clock, device="cpu",
                                          health=h, watchdog_timeout_s=2.0)
    assert ctrl.health is h and ctrl.watchdog_timeout_s == 2.0


@pytest.mark.parametrize("where", ["decision", "replacement"])
def test_device_fault_propagates_out_of_reconcile(monkeypatch, where):
    """A kernel fault in the consolidation decision or in a drift
    replacement solve leaves reconcile() as it came: no action, no
    rollback, nothing caught."""
    t = Twin()
    t.provision([cpu_pod(cpu_m=400)])
    t.provision([cpu_pod(cpu_m=1800, mem_mib=3000)])
    if where == "replacement":
        _remove_launched_type(t)

    def boom(*a, **kw):
        raise KernelError("injected kernel fault")
    monkeypatch.setattr(port_dmod, "solve_classpack", boom)
    monkeypatch.setattr(port_cp, "solve_classpack_sweep", boom)
    before = workloads.fleet_state(t.p)
    with pytest.raises(KernelError):
        t.p.disruption.reconcile()
    assert workloads.fleet_state(t.p) == before
    assert not any(n.marked_for_deletion for n in t.p.cluster.nodes.values())


def test_rebinds_bind_the_clusters_own_pods():
    """The replacement's pods are the cluster's objects, never the lowered
    copies the simulation tensorized."""
    t = Twin()
    big = cpu_pod(cpu_m=12000, mem_mib=24000)
    tiny = cpu_pod(cpu_m=200, mem_mib=256)
    t.provision([big, tiny])
    t.delete_pod(big)
    res = t.tick()
    assert res.action.name == "replace/consolidation"
    new = next(iter(t.p.cluster.nodes.values()))
    assert new.pods == [t.pod(tiny)]
    assert new.pods[0] is t.p.cluster.pods[tiny.uid]


def test_arena_is_rebuilt_after_an_executed_tick():
    """Three ticks in a row: the one after an executed action decides on a
    new arena (the cluster's mutation epoch moved), the one after it
    reuses that arena — in both packages, with equal signatures."""
    t = Twin(catalog=FOUR_ZONES())
    _four_nearly_empty(t)
    arenas, actions = [], []
    for _ in range(3):
        actions.append(t.tick().action)
        arenas.append(t.p.disruption._arena_cache[1])
    assert actions[0] is not None and actions[0].kind == "delete"
    assert actions[1] is None and actions[2] is None
    assert arenas[1] is not arenas[0]
    assert arenas[2] is arenas[1]


def test_cpu_reconcile_launches_no_kernel():
    t = Twin()
    t.provision([cpu_pod(cpu_m=400)])
    t.provision([cpu_pod(cpu_m=1800, mem_mib=3000)])
    ck.reset_launches()
    assert t.tick().action is not None
    assert all(v == 0 for v in ck.LAUNCHES.values())


# ---- the full-width cell: disruption-replay-500 ----

def reference_replay():
    clear_lp_caches()
    env = workloads.disruption_env(
        REF_KIT, generate_catalog(workloads.DISRUPTION_TYPES))
    return workloads.disruption_replay(env)


def test_reference_produces_the_disruption_golden():
    got = workloads.disruption_digests(reference_replay())
    assert got == workloads.GOLDEN_DISRUPTION


def test_port_reproduces_the_disruption_golden():
    clear_lp_caches()
    env = workloads.disruption_env(
        workloads.port_kit(), convert.catalog_from_objects(
            generate_catalog(workloads.DISRUPTION_TYPES)), device="cpu")
    assert len(env.cluster.nodes) == 504
    sigs = workloads.disruption_replay(env)
    got = workloads.disruption_digests(sigs)
    for i, (g, w) in enumerate(zip(got, workloads.GOLDEN_DISRUPTION)):
        assert g == w, (i, sigs[i])
    assert len(got) == len(workloads.GOLDEN_DISRUPTION)
    # the ICE'd drift tick rolled back to the fleet before it
    drift = [s for s in sigs if s["phase"] == "drift"]
    assert drift[1]["error"] and drift[1]["kept"] and not drift[1]["launched"]


if __name__ == "__main__":
    print("GOLDEN_DISRUPTION: List[Dict] = [")
    for d in workloads.disruption_digests(reference_replay()):
        print(f"    dict({', '.join(f'{k}={v!r}' for k, v in d.items())}),")
    print("]")
    sys.exit(0)
