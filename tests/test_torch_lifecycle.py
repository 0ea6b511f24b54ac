"""The port's node lifecycle against the JAX package's: termination,
interruption, garbage collection and tagging, the nodeclaim lifecycle, the
cloud error taxonomy and drift detection.

Fixtures are built in both packages from the same constructors on one fake
clock (`test_torch_disruption.Twin`); every step runs in both and its
result is compared by position — nodes by launch position, pods by the
position the case added them at, claims by launch order — never by name
(names come from process-wide counters).  The port runs on the CPU.

  * the 7 cases of tests/test_termination.py;
  * the 13 cases of tests/test_interruption.py (the parser, spot
    interruption, state changes, redelivery, GC and tagging);
  * the 6 cases of tests/test_errors.py;
  * the lifecycle cases of tests/test_nodeclass.py (registration, the
    registration TTL, InstanceTerminated, startup and condition taints,
    initialization) and more of the same;
  * `is_drifted`'s precedence and its instance lookup, memoized once per
    claim and never after a failed lookup; the fake cloud's per-API
    faults, interruption schedule and launch-template registry.
"""

import pytest

from helpers import cpu_pod, make_type
from karpenter_tpu import api as ref_api
from karpenter_tpu.api import labels as wk
from karpenter_tpu.api.objects import PodDisruptionBudget as RefPDB
from karpenter_tpu.api.taints import Taint as RefTaint
from karpenter_tpu.catalog.generate import generate_catalog
from karpenter_tpu.cloud import errors as ref_errors
from karpenter_tpu.cloud import fake as ref_fake
from karpenter_tpu.cloud import queue as ref_queue
from karpenter_tpu.cloud.provider import CloudProvider
from karpenter_tpu.controllers.garbagecollection import \
    TaggingController as RefTagger
from karpenter_tpu.controllers.lifecycle import \
    LifecycleController as RefLifecycle
from karpenter_tpu.controllers.termination import \
    TERMINATION_TAINT as REF_TERMINATION_TAINT
from karpenter_tpu.state.cluster import Cluster
from karpenter_tpu_torch import api as port_api
from karpenter_tpu_torch import convert
from karpenter_tpu_torch.api.objects import NodeClaim as TNodeClaim
from karpenter_tpu_torch.api.objects import NodeClass as TNodeClass
from karpenter_tpu_torch.api.objects import PodDisruptionBudget as TPDB
from karpenter_tpu_torch.api.taints import Taint as TTaint
from karpenter_tpu_torch.cloud import CloudProvider as TCloudProvider
from karpenter_tpu_torch.cloud import errors as port_errors
from karpenter_tpu_torch.cloud import fake as port_fake
from karpenter_tpu_torch.cloud import queue as port_queue
from karpenter_tpu_torch.controllers import (LifecycleController,
                                             TaggingController)
from karpenter_tpu_torch.controllers.termination import TERMINATION_TAINT
from karpenter_tpu_torch.state.cluster import Cluster as TCluster
from test_torch_disruption import FakeClock, Twin
from torch_cases import one_torch_thread  # noqa: F401
from torch_refnative import reference_native_loaded  # noqa: F401


def plain_pool(api):
    return [api.NodePool()]


def spot_catalog():
    return [make_type("a.small", 2, 4, 0.10, spot_discount=0.7),
            make_type("a.medium", 4, 8, 0.20, spot_discount=0.7)]


def both_pdb(t, **kw):
    t.r.cluster.add_pdb(RefPDB(**kw))
    t.p.cluster.add_pdb(TPDB(**kw))


def term_sig(side, tres):
    """A TerminationResult by position."""
    pos = {p.uid: i for i, p in enumerate(side.pods)}
    return dict(evicted=[pos[u] for u in tres.evicted],
                terminated=[side.launch_index[n] for n in tres.terminated],
                requeued=[side.launch_index[n] for n in tres.requeued],
                errors=len(tres.errors),
                pending=len(side.cluster.pending_pods()),
                running=len(side.cloud.running()))


def terminate(t, call):
    """call(side) -> TerminationResult in both; equal by position.
    Returns the port's result."""
    sigs, out = [], None
    for side in t.sides:
        side.nodes()
        out = call(side)
        sigs.append(term_sig(side, out))
    assert sigs[1] == sigs[0]
    return out


def first_node(side):
    return next(iter(side.cluster.nodes.values()))


# ---- the cases of tests/test_termination.py ----

def test_terminate_empty_node():
    t = Twin(pools=plain_pool)
    pod = cpu_pod(cpu_m=400)
    t.provision([pod])
    node = first_node(t.p)
    t.delete_pod(pod)
    t.both(lambda s: s.terminator.request(first_node(s), "test"))
    assert node.marked_for_deletion
    assert TERMINATION_TAINT in node.taints
    assert (TERMINATION_TAINT.key, TERMINATION_TAINT.effect,
            TERMINATION_TAINT.value) == (REF_TERMINATION_TAINT.key,
                                         REF_TERMINATION_TAINT.effect,
                                         REF_TERMINATION_TAINT.value)
    res = terminate(t, lambda s: s.terminator.reconcile())
    assert res.terminated == [node.name]
    assert not t.p.cluster.nodes
    assert not t.p.cloud.running()
    assert t.p.terminator.pending == []


def test_drain_evicts_owned_pods_as_pending():
    t = Twin(pools=plain_pool)
    t.provision([cpu_pod(cpu_m=300) for _ in range(3)])
    node = first_node(t.p)
    res = terminate(t, lambda s: s.terminator.drain_sync(first_node(s)))
    assert node.name in res.terminated
    assert len(res.evicted) == 3
    assert len(t.p.cluster.pending_pods()) == 3
    assert not t.p.cloud.running()


def test_drain_deletes_ownerless_pods():
    t = Twin(pools=plain_pool)
    naked = cpu_pod(cpu_m=300, owner_kind="")
    t.provision([naked])
    node = first_node(t.p)
    res = terminate(t, lambda s: s.terminator.drain_sync(first_node(s)))
    assert node.name in res.terminated
    assert naked.uid not in t.p.cluster.pods
    assert not t.p.cluster.pending_pods()


def test_daemon_pods_die_with_node_not_evicted():
    t = Twin(pools=plain_pool)
    t.provision([cpu_pod(cpu_m=300)])
    node = first_node(t.p)
    ds = cpu_pod(cpu_m=50, owner_kind="DaemonSet")
    t.add_bound(ds, first_node(t.r))
    res = terminate(t, lambda s: s.terminator.drain_sync(first_node(s)))
    assert node.name in res.terminated
    assert ds.uid not in res.evicted
    assert ds.uid not in t.p.cluster.pods


def test_pdb_stalls_drain_until_budget_frees():
    t = Twin(pools=plain_pool)
    t.provision([cpu_pod(cpu_m=300, labels={"app": "web"})
                 for _ in range(2)])
    node = first_node(t.p)
    both_pdb(t, selector={"app": "web"}, min_available=1)
    t.both(lambda s: s.terminator.request(first_node(s)))
    r1 = terminate(t, lambda s: s.terminator.reconcile())
    assert len(r1.evicted) == 1
    assert r1.requeued == [node.name]
    assert node.name in t.p.terminator.pending
    assert len(t.p.cloud.running()) == 1
    evicted = t.p.cluster.pending_pods()[0]
    t.provision()                            # rebinds the pending pod
    assert evicted.node_name
    r2 = terminate(t, lambda s: s.terminator.reconcile())
    assert len(r2.evicted) == 1
    assert node.name in r2.terminated


def test_reconcile_drops_vanished_nodes():
    t = Twin(pools=plain_pool)
    t.provision([cpu_pod()])
    for side in t.sides:
        node = first_node(side)
        side.nodes()
        side.terminator.request(node)
        side.cluster.remove_node(node.name)
    res = terminate(t, lambda s: s.terminator.reconcile())
    assert res.terminated == [] and res.requeued == []
    assert t.p.terminator.pending == []


def test_disruption_routes_through_terminator():
    t = Twin(pools=plain_pool, terminator=True)
    t.provision([cpu_pod(cpu_m=400)])
    t.provision([cpu_pod(cpu_m=1800, mem_mib=3000)])
    assert len(t.p.cluster.nodes) == 2
    res = t.tick()
    assert res.action is not None
    assert len(res.deleted) == 1
    assert len(t.p.cluster.nodes) == 1
    assert len(t.p.cloud.running()) == 1
    assert not t.p.cluster.pending_pods()


# ---- the cases of tests/test_interruption.py: the parser ----

QUEUES = {"reference": ref_queue, "port": port_queue}


@pytest.mark.parametrize("pkg", sorted(QUEUES))
def test_parse_roundtrip_all_kinds(pkg):
    q = QUEUES[pkg]
    for kind, ids in [(q.SPOT_INTERRUPTION, ["i-1"]),
                      (q.SCHEDULED_CHANGE, ["i-1", "i-2"]),
                      (q.STATE_CHANGE, ["i-3"])]:
        ev = q.parse_event(q.make_event_body(kind, ids))
        assert ev.kind == kind
        assert ev.instance_ids == ids
        assert ref_queue.make_event_body(kind, ids, ts=5.0) == \
            port_queue.make_event_body(kind, ids, ts=5.0)


@pytest.mark.parametrize("pkg", sorted(QUEUES))
def test_parse_garbage_is_noop(pkg):
    q = QUEUES[pkg]
    assert q.parse_event("not json").kind == q.NOOP
    assert q.parse_event('{"detail-type": "Something Else"}').kind == q.NOOP


# ---- spot interruption → ICE + recycle ----

def intr_sig(side, ires):
    return dict(received=ires.received, handled=dict(ires.handled),
                recycled=[side.launch_index[n] for n in ires.recycled],
                deleted=ires.deleted_messages, queue=len(side.queue),
                pending=len(side.cluster.pending_pods()),
                nodes=len(side.cluster.nodes), ice=side.provider.unavailable.seq_num)


def interrupt(t, **kw):
    """InterruptionController.reconcile in both; equal by position.
    Returns the port's result."""
    sigs, out = [], None
    for side in t.sides:
        side.nodes()
        out = side.interruption.reconcile(**kw)
        sigs.append(intr_sig(side, out))
    assert sigs[1] == sigs[0]
    return out


def spot_twin(pools=plain_pool):
    return Twin(catalog=spot_catalog(), pools=pools, queue=True)


def test_spot_interruption_recycles_node_and_marks_ice():
    t = spot_twin()
    pod = cpu_pod(cpu_m=400)
    res = t.provision([pod])
    claim = res.launched[0]
    assert claim.capacity_type == wk.CAPACITY_TYPE_SPOT
    node_name = t.pod(pod).node_name
    t.both(lambda s: s.cloud.interrupt(
        next(iter(s.cluster.nodeclaims.values())).provider_id))
    assert len(t.p.queue) == 1
    ires = interrupt(t)
    assert ires.received == 1
    assert ires.recycled == [node_name]
    assert ires.deleted_messages == 1
    assert t.p.provider.unavailable.is_unavailable(
        wk.CAPACITY_TYPE_SPOT, claim.instance_type, claim.zone)
    assert t.p.cluster.pending_pods() == [t.pod(pod)]
    r2 = t.provision()
    assert len(r2.launched) == 1
    new = r2.launched[0]
    assert (new.instance_type, new.zone, new.capacity_type) != \
        (claim.instance_type, claim.zone, claim.capacity_type)


def test_on_demand_interruption_no_ice_marking():
    t = spot_twin(pools=lambda api: [api.NodePool(
        template=api.NodePoolTemplate(requirements=api.Requirements.of(
            api.Requirement(wk.CAPACITY_TYPE, api.IN,
                            [wk.CAPACITY_TYPE_ON_DEMAND]))))])
    res = t.provision([cpu_pod(cpu_m=400)])
    assert res.launched[0].capacity_type == wk.CAPACITY_TYPE_ON_DEMAND
    t.both(lambda s: s.cloud.interrupt(
        next(iter(s.cluster.nodeclaims.values())).provider_id))
    interrupt(t)
    assert t.p.provider.unavailable.seq_num == 0


def test_state_change_terminated_recycles():
    t = spot_twin()
    pod = cpu_pod(cpu_m=400)
    t.provision([pod])
    t.both(lambda s: s.cloud.reclaim(
        next(iter(s.cluster.nodeclaims.values())).provider_id))
    ires = interrupt(t)
    assert ires.handled.get(port_queue.STATE_CHANGE) == 1
    assert len(ires.recycled) == 1
    assert not t.p.cluster.nodes
    assert t.p.cluster.pending_pods() == [t.pod(pod)]


def test_running_state_change_is_ignored():
    t = spot_twin()
    t.provision([cpu_pod(cpu_m=400)])
    for side, q in ((t.r, ref_queue), (t.p, port_queue)):
        claim = next(iter(side.cluster.nodeclaims.values()))
        side.queue.send(q.make_event_body(q.STATE_CHANGE, [claim.provider_id],
                                          state="running"))
    ires = interrupt(t)
    assert ires.recycled == []
    assert len(t.p.cluster.nodes) == 1


def test_unknown_instance_message_deleted():
    t = spot_twin()
    for side, q in ((t.r, ref_queue), (t.p, port_queue)):
        side.queue.send(q.make_event_body(q.SPOT_INTERRUPTION,
                                          ["i-doesnotexist"]))
    ires = interrupt(t)
    assert ires.deleted_messages == 1
    assert len(t.p.queue) == 0


def test_batch_cap_and_multiple_batches():
    t = spot_twin()
    for side, q in ((t.r, ref_queue), (t.p, port_queue)):
        for i in range(25):
            side.queue.send(q.make_event_body(q.SPOT_INTERRUPTION,
                                              [f"i-{i}"]))
    assert interrupt(t, max_batches=1).received == 10   # the receive cap
    assert interrupt(t, max_batches=5).received == 15


def test_stalled_drain_retries_via_redelivery():
    t = spot_twin()
    t.provision([cpu_pod(cpu_m=300, labels={"app": "web"})
                 for _ in range(2)])
    both_pdb(t, selector={"app": "web"}, min_available=1)
    t.both(lambda s: s.cloud.interrupt(
        next(iter(s.cluster.nodeclaims.values())).provider_id))
    r1 = interrupt(t)
    assert r1.recycled == [] and r1.deleted_messages == 0
    t.provision()
    r2 = interrupt(t)                        # the redelivered message
    assert r2.received == 1
    assert len(r2.recycled) == 1
    assert len(t.p.queue) == 0


# ---- garbage collection + tagging ----

def gc_sig(side, gres):
    return dict(leaked=len(gres.leaked_instances),
                orphaned=[side.launch_index[n] for n in gres.orphaned_nodes],
                running=len(side.cloud.running()),
                pending=len(side.cluster.pending_pods()))


def collect(t):
    sigs, out = [], None
    for side in t.sides:
        side.nodes()
        out = side.gc.reconcile()
        sigs.append(gc_sig(side, out))
    assert sigs[1] == sigs[0]
    return out


def leak(t, cluster_tag):
    for side, fake in ((t.r, ref_fake), (t.p, port_fake)):
        side.cloud.create_fleet(
            [fake.FleetOverride("a.small", "zone-a", "spot", 0.03)],
            tags={"karpenter.sh/cluster": cluster_tag})


def test_gc_terminates_leaked_instance_after_grace():
    t = spot_twin()
    leak(t, "default")
    assert collect(t).leaked_instances == []   # inside the grace period
    t.step(60)
    assert len(collect(t).leaked_instances) == 1
    assert not t.p.cloud.running()


def test_gc_ignores_foreign_instances():
    t = spot_twin()
    leak(t, "SOMEONE-ELSE")
    t.step(60)
    assert collect(t).leaked_instances == []
    assert len(t.p.cloud.running()) == 1


def test_gc_removes_orphaned_node_and_requeues_pods():
    t = spot_twin()
    pod = cpu_pod(cpu_m=400)
    t.provision([pod])
    t.both(lambda s: s.cloud.terminate_instances(
        [next(iter(s.cluster.nodeclaims.values())).provider_id]))
    out = collect(t)
    assert len(out.orphaned_nodes) == 1
    assert not t.p.cluster.nodes
    assert t.p.cluster.pending_pods() == [t.pod(pod)]


def test_tagging_controller_stamps_node_name():
    t = spot_twin()
    t.provision([cpu_pod(cpu_m=400)])
    node = first_node(t.p)
    ref_tagger = RefTagger(t.r.provider, t.r.cluster)
    tagger = TaggingController(t.p.provider, t.p.cluster)
    assert len(ref_tagger.reconcile()) == 1
    assert tagger.reconcile() == [node.provider_id]
    inst = t.p.cloud.get_instance(node.provider_id)
    assert inst.tags[TaggingController.NODE_NAME_TAG] == node.name
    assert tagger.reconcile() == [] == ref_tagger.reconcile()


# ---- the cases of tests/test_errors.py ----

ERRORS = {"reference": (ref_errors, ref_fake), "port": (port_errors, port_fake)}
CODES = ("InstanceNotFound", "InvalidLaunchTemplateId.NotFound",
         "Something.NotFound", "InternalError", "EntityAlreadyExists",
         "InvalidLaunchTemplateName.AlreadyExistsException",
         "InsufficientInstanceCapacity", "MaxSpotInstanceCountExceeded",
         "RequestLimitExceeded", "Weird", "ThingNotFoundException", "")


@pytest.mark.parametrize("pkg", sorted(ERRORS))
def test_not_found_codes(pkg):
    e, f = ERRORS[pkg]
    assert e.is_not_found(f.CloudError("InstanceNotFound", "i-1"))
    assert e.is_not_found(f.CloudError("InvalidLaunchTemplateId.NotFound", "x"))
    assert e.is_not_found(f.CloudError("Something.NotFound", "x"))
    assert not e.is_not_found(f.CloudError("InternalError", "x"))
    assert not e.is_not_found(None)


@pytest.mark.parametrize("pkg", sorted(ERRORS))
def test_already_exists_codes(pkg):
    e, f = ERRORS[pkg]
    assert e.is_already_exists(f.CloudError("EntityAlreadyExists", "p"))
    assert e.is_already_exists(
        f.CloudError("InvalidLaunchTemplateName.AlreadyExistsException", "t"))
    assert not e.is_already_exists(f.CloudError("InstanceNotFound", "x"))


@pytest.mark.parametrize("pkg", sorted(ERRORS))
def test_unfulfillable_capacity_codes(pkg):
    e, f = ERRORS[pkg]
    assert e.is_unfulfillable_capacity(
        f.CloudError("InsufficientInstanceCapacity", "pool"))
    assert e.is_unfulfillable_capacity(
        f.CloudError("MaxSpotInstanceCountExceeded", ""))
    assert not e.is_unfulfillable_capacity(f.CloudError("InternalError", ""))


@pytest.mark.parametrize("pkg", sorted(ERRORS))
def test_launch_template_not_found_is_both(pkg):
    e, f = ERRORS[pkg]
    err = f.CloudError("InvalidLaunchTemplateId.NotFound", "t")
    assert e.is_launch_template_not_found(err)
    assert e.is_not_found(err)


def test_classify_covers_fleet_errors():
    for e, f in ERRORS.values():
        ov = f.FleetOverride("a.small", "zone-a", "spot", 0.1)
        assert e.classify(f.FleetError(ov, "InsufficientInstanceCapacity")) \
            == "unfulfillable_capacity"
        assert e.classify(f.CloudError("InstanceNotFound", "i")) == "not_found"
        assert e.classify(f.CloudError("EntityAlreadyExists", "p")) == \
            "already_exists"
        assert e.classify(f.CloudError("Weird", "x")) == "cloud_error"
        assert e.classify(RuntimeError("boom")) == "other"
    for code in CODES:
        want = ref_errors.classify(ref_fake.CloudError(code, ""))
        assert port_errors.classify(port_fake.CloudError(code, "")) == want
        assert port_errors.is_retryable(port_fake.CloudError(code, "")) == \
            ref_errors.is_retryable(ref_fake.CloudError(code, ""))


def test_launch_path_classifies_ice_and_feeds_cache():
    """Fleet ICE codes go through the classifier into the ICE cache; the
    launch falls through to the next-cheapest offering, in both packages
    alike."""
    catalog = generate_catalog(4)
    cheapest_it, cheapest_o = min(
        ((it, o) for it in catalog for o in it.offerings),
        key=lambda pair: pair[1].price)
    pool = (cheapest_o.capacity_type, cheapest_it.name, cheapest_o.zone)
    got = []
    for Provider, fake, cat, NodeClaim in (
            (CloudProvider, ref_fake, catalog, ref_api.NodeClaim),
            (TCloudProvider, port_fake, convert.catalog_from_objects(catalog),
             TNodeClaim)):
        cloud = fake.FakeCloud()
        cloud.insufficient_capacity_pools.add(pool)
        provider = Provider(cloud, cat)
        claim = provider.create(NodeClaim(nodepool="p"))
        assert claim.provider_id
        assert (claim.instance_type, claim.zone) != (cheapest_it.name,
                                                     cheapest_o.zone)
        assert provider.unavailable.is_unavailable(*pool)
        got.append((claim.instance_type, claim.zone, claim.capacity_type,
                    claim.price, provider.unavailable.seq_num))
    assert got[1] == got[0]


# ---- the lifecycle cases of tests/test_nodeclass.py ----

class LTwin:
    """A LifecycleController over the same catalog in both packages."""

    def __init__(self, join_delay=0.0, ttl=900.0):
        self.clock = FakeClock(1000.0)
        self.sides = []
        for fake, Provider, Clust, api, Lc, Taint, cat in (
                (ref_fake, CloudProvider, Cluster, ref_api, RefLifecycle,
                 RefTaint, generate_catalog(8)),
                (port_fake, TCloudProvider, TCluster, port_api,
                 LifecycleController, TTaint,
                 convert.catalog_from_objects(generate_catalog(8)))):
            cloud = fake.FakeCloud(clock=self.clock)
            provider = Provider(cloud, cat, clock=self.clock)
            cluster = Clust(clock=self.clock)
            pool = api.NodePool(template=api.NodePoolTemplate(
                startup_taints=[Taint("init.example.com/agent",
                                      "NoSchedule")]))
            lc = Lc(provider, cluster, nodepools={"default": pool},
                    join_delay=join_delay, registration_ttl=ttl,
                    clock=self.clock)
            self.sides.append(SimpleSide(cloud, provider, cluster, pool, lc,
                                         api, Taint))
        self.r, self.p = self.sides

    def claim(self):
        """A launched claim carrying the pool's startup taints, tracked."""
        out = []
        for s in self.sides:
            c = s.provider.create(s.api.NodeClaim(
                nodepool="default", taints=list(s.pool.template.startup_taints)))
            s.lc.track(c)
            s.claims.append(c)
            out.append(c)
        return out[1]

    def reconcile(self):
        """LifecycleController.reconcile in both, compared by position."""
        sigs, out = [], None
        for s in self.sides:
            out = s.lc.reconcile()
            cpos = {c.name: i for i, c in enumerate(s.claims)}
            npos = {n: i for i, n in enumerate(s.cluster.nodes)}
            sigs.append(dict(
                registered=[cpos[c] for c in out.registered],
                initialized=[npos[n] for n in out.initialized],
                terminated=[cpos[c] for c in out.liveness_terminated],
                nodes=[(sorted(t.key for t in n.taints),
                        n.labels.get(wk.NODE_INITIALIZED))
                       for n in s.cluster.nodes.values()],
                running=len(s.cloud.running())))
        assert sigs[1] == sigs[0]
        return out


class SimpleSide:
    def __init__(self, cloud, provider, cluster, pool, lc, api, Taint):
        self.cloud, self.provider, self.cluster = cloud, provider, cluster
        self.pool, self.lc, self.api, self.Taint = pool, lc, api, Taint
        self.claims = []


def test_async_register_then_initialize():
    t = LTwin(join_delay=30)
    claim = t.claim()
    res = t.reconcile()
    assert not res.registered                  # the kubelet has not joined
    assert not t.p.cluster.nodes
    t.clock.step(31)
    res = t.reconcile()
    assert res.registered == [claim.name]
    assert claim.registered and not claim.initialized
    node = first_node(t.p)
    res = t.reconcile()                        # startup taints cleared
    assert res.initialized == [node.name]
    assert claim.initialized
    assert node.labels[wk.NODE_INITIALIZED] == "true"
    assert not any(t_.key == "init.example.com/agent" for t_ in node.taints)


def test_registration_ttl_liveness_gc():
    t = LTwin(join_delay=float("inf"), ttl=900)
    claim = t.claim()
    t.clock.step(901)
    res = t.reconcile()
    assert res.liveness_terminated == [claim.name]
    assert claim.name not in t.p.cluster.nodeclaims
    assert not t.p.cloud.running()             # the instance terminated


def test_instance_death_before_registration():
    t = LTwin(join_delay=60)
    claim = t.claim()
    for s in t.sides:
        s.cloud.get_instance(s.claims[-1].provider_id).state = "terminated"
    res = t.reconcile()
    assert res.liveness_terminated == [claim.name]


def _registered():
    t = LTwin()
    claim = t.claim()
    t.reconcile()           # registers; the declared startup taint clears
    assert not claim.initialized
    return t, claim


def test_unreachable_blocks_and_is_not_cleared():
    t, claim = _registered()
    for s in t.sides:
        first_node(s).taints.append(s.Taint("node.kubernetes.io/unreachable",
                                            "NoExecute"))
    for _ in range(3):
        assert not t.reconcile().initialized
    assert not claim.initialized
    node = first_node(t.p)
    assert any(t_.key == "node.kubernetes.io/unreachable"
               for t_ in node.taints)
    for s in t.sides:
        n = first_node(s)
        n.taints = [t_ for t_ in n.taints
                    if t_.key != "node.kubernetes.io/unreachable"]
    t.reconcile()
    assert claim.initialized


def test_ephemeral_boot_taints_are_cleared():
    t, claim = _registered()
    for s in t.sides:
        first_node(s).taints.append(s.Taint("node.kubernetes.io/not-ready",
                                            "NoExecute"))
    t.reconcile()
    assert not any(t_.key == "node.kubernetes.io/not-ready"
                   for t_ in first_node(t.p).taints)
    t.reconcile()
    assert claim.initialized


def test_registration_waits_for_join_delay_within_ttl():
    t = LTwin(join_delay=120, ttl=900)
    claims = [t.claim() for _ in range(3)]
    t.clock.step(60)
    assert t.reconcile().registered == []
    t.clock.step(61)
    res = t.reconcile()
    assert res.registered == [c.name for c in claims]
    assert len(t.reconcile().initialized) == 3


def test_untracked_and_unlaunched_claims_are_ignored():
    t = LTwin()
    for s in t.sides:
        s.lc.track(s.api.NodeClaim(nodepool="default"))   # not launched
    res = t.reconcile()
    assert res.registered == [] and res.liveness_terminated == []
    assert not t.p.cluster.nodeclaims


# ---- drift detection: precedence and the memoized lookup ----

def drift_provider(pkg_fake, Provider, cat, NodeClass, NodeClaim):
    cloud = pkg_fake.FakeCloud()
    nc = NodeClass()
    provider = Provider(cloud, cat, node_classes={"default": nc})
    claim = provider.create(NodeClaim(nodepool="p"))
    return cloud, nc, provider, claim


DRIFT_PKGS = {
    "reference": lambda: (ref_fake, CloudProvider, generate_catalog(8),
                          ref_api.NodeClass, ref_api.NodeClaim),
    "port": lambda: (port_fake, TCloudProvider,
                     convert.catalog_from_objects(generate_catalog(8)),
                     TNodeClass, TNodeClaim)}


@pytest.mark.parametrize("pkg", sorted(DRIFT_PKGS))
def test_drift_precedence_first_hit_wins(pkg):
    fake, Provider, cat, NodeClass, NodeClaim = DRIFT_PKGS[pkg]()
    cloud, nc, provider, claim = drift_provider(fake, Provider, cat,
                                                NodeClass, NodeClaim)
    inst = cloud.get_instance(claim.provider_id)
    inst.image_id, inst.subnet_id, inst.launch_template = \
        "img-old", "subnet-old", "lt-1"
    cloud.launch_templates["lt-1"] = fake.LaunchTemplateInfo(
        name="lt-1", image_id="img-old", security_group_ids=("sg-old",))
    assert provider.is_drifted(claim) is None
    nc.status_zones = ["zone-x"]
    assert provider.is_drifted(claim) == "ZoneDrifted"
    nc.status_subnets = ["subnet-new"]
    assert provider.is_drifted(claim) == "SubnetDrifted"
    nc.status_security_groups = ["sg-new"]
    assert provider.is_drifted(claim) == "SecurityGroupDrifted"
    nc.status_images = ["img-new"]
    assert provider.is_drifted(claim) == "ImageDrifted"
    nc.user_data = "changed"
    nc.hash_annotation = ""
    assert provider.is_drifted(claim) == "NodeClassHashDrifted"
    pool = ref_api.NodePool if pkg == "reference" else port_api.NodePool
    api = ref_api if pkg == "reference" else port_api
    strict = pool(template=api.NodePoolTemplate(
        requirements=api.Requirements.of(api.Requirement(
            wk.INSTANCE_TYPE, api.IN, ["no-such-type"]))))
    assert provider.is_drifted(claim, strict) == "NodePoolDrifted"
    provider.instance_types.base_catalog = []
    assert provider.is_drifted(claim, strict) == "InstanceTypeRemoved"


@pytest.mark.parametrize("pkg", sorted(DRIFT_PKGS))
def test_drift_lookup_is_memoized_and_a_failure_is_not(pkg):
    fake, Provider, cat, NodeClass, NodeClaim = DRIFT_PKGS[pkg]()
    cloud, nc, provider, claim = drift_provider(fake, Provider, cat,
                                                NodeClass, NodeClaim)
    nc.status_images = ["img-good"]
    real = cloud.get_instance
    calls = []

    def flaky(iid):
        calls.append(iid)
        if len(calls) == 1:
            raise fake.CloudError("RequestLimitExceeded", "throttled")
        return real(iid)
    cloud.get_instance = flaky
    claim.image_id = ""
    assert provider.is_drifted(claim) is None     # lookup failed: static only
    real(claim.provider_id).image_id = "img-bad"
    assert provider.is_drifted(claim) == "ImageDrifted"   # retried
    assert provider.is_drifted(claim) == "ImageDrifted"   # memoized
    assert len(calls) == 2


def test_fake_cloud_api_errors_are_per_api_and_one_shot():
    """The fake cloud's `cloud.api` chaos seam, keyed on the API name: a
    one-shot rule on terminate_instances leaves the other APIs alone."""
    from karpenter_tpu_torch.utils.chaos import CHAOS, ChaosRule
    cloud = port_fake.FakeCloud()
    CHAOS.configure([ChaosRule("cloud.api", key="terminate_instances",
                               count=1, error_code="InternalError")])
    try:
        ov = port_fake.FleetOverride("a.small", "zone-a", "on-demand", 0.1)
        inst = cloud.create_fleet([ov]).instances[0]  # another API: untouched
        with pytest.raises(port_fake.CloudError, match="InternalError"):
            cloud.terminate_instances([inst.id])
        assert cloud.terminate_instances([inst.id]) == [inst.id]
    finally:
        CHAOS.reset()
    assert cloud.calls["terminate_instances"] == 2


def test_fake_cloud_interruption_schedule_matches_reference():
    """interrupt(at=...) schedules the warning and the reclaim on the
    clock; deliver_due fires them, publishing the same bodies."""
    fired, bodies = [], []
    for fake, q in ((ref_fake, ref_queue), (port_fake, port_queue)):
        clock = FakeClock(100.0)
        queue = q.FakeQueue(clock)
        cloud = fake.FakeCloud(clock, queue=queue)
        a, b = (cloud.create_fleet([fake.FleetOverride(
            "a.small", "zone-a", "spot", 0.03)]).instances[0].id
            for _ in range(2))
        cloud.interrupt(a, at=400.0)
        cloud.interrupt(b)                   # warns now, reclaims at +120
        got = [cloud.next_due()]
        for dt in (100.0, 100.0, 200.0):
            clock.step(dt)
            got.append([(d["action"], d.get("honored")) for d in
                        cloud.deliver_due()])
        fired.append(got)
        bodies.append([m.body for m in queue.receive(20)])
        assert not cloud.running()
    assert fired[1] == fired[0]
    assert [b.replace("i-0", "") for b in bodies[1]] == \
        [b.replace("i-0", "") for b in bodies[0]]


@pytest.mark.parametrize("pkg", sorted(DRIFT_PKGS))
def test_get_and_liveness_probe(pkg):
    """`get` answers the claim the provider launched, hydrates one it did
    not, and None for an instance that is gone; `liveness_probe` is False
    only while the circuit breaker is open."""
    fake, Provider, cat, NodeClass, NodeClaim = DRIFT_PKGS[pkg]()
    cloud, nc, provider, claim = drift_provider(fake, Provider, cat,
                                                NodeClass, NodeClaim)
    assert provider.get(claim.provider_id) is claim
    other = Provider(cloud, cat, node_classes={"default": nc})
    hydrated = other.get(claim.provider_id)
    assert hydrated is not claim and hydrated.name == claim.name
    assert (hydrated.instance_type, hydrated.zone, hydrated.price) == \
        (claim.instance_type, claim.zone, claim.price)
    provider.delete(claim)
    assert provider.get(claim.provider_id) is None
    with pytest.raises(fake.CloudError, match="InstanceNotFound"):
        provider.delete(claim)                  # already gone
    assert provider.liveness_probe()
    mod = __import__(Provider.__module__, fromlist=["ProviderCircuitBreaker"])
    provider.breaker = mod.ProviderCircuitBreaker(threshold=1,
                                                  clock=lambda: 0.0)
    assert provider.liveness_probe()
    provider.breaker.record_failure()
    assert not provider.liveness_probe()
