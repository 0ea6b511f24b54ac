"""The port's gang scheduling (karpenter_tpu_torch/ops/gang.py, the
Provisioner's admission funnel and the DisruptionController's preemption)
against the JAX package's, case by case with tests/test_gang.py's 16 cases,
on the CPU.  Each case runs on both packages and returns plain
observations that must be equal: which gang members bound where (by node
launch position), the audits, the preemption plans (victims in order), the
provenance records, the class order and the registry.

The restart case holds the invariant over the manager's ticks (every
gang fully bound or fully pending after every tick), then writes and
restores a WarmRestart snapshot (state/snapshot.py) as the reference's
does: the restored cluster and registry show the same gangs.  The gate's
A/B replay stays `slow`, as in the reference.
"""

import importlib
import itertools
import os
from types import SimpleNamespace

import numpy as np
import pytest

from helpers import make_type, small_catalog
from torch_cases import clear_lp_caches as clear_package_caches
from torch_cases import one_torch_thread  # noqa: F401
from karpenter_tpu_torch import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = dict(objects="api.objects", resources="api.resources",
               wk="api.labels", cloud="cloud", controllers="controllers",
               disruption="controllers.disruption", state="state",
               cluster_mod="state.cluster", queue="cloud.queue",
               gang="ops.gang", tz="ops.tensorize", ffd="ops.ffd",
               partition="parallel.partition", provenance="utils.provenance",
               operator="operator", fake="cloud.fake",
               gen="catalog.generate", sim="sim", report="sim.report")


def _package(name, extra, convert_catalog):
    return SimpleNamespace(name=name, extra=extra,
                           convert_catalog=convert_catalog, **{
                               k: importlib.import_module(f"{name}.{v}")
                               for k, v in MODULES.items()})


REF = _package("karpenter_tpu", {}, lambda c: c)
PORT = _package("karpenter_tpu_torch", {"device": "cpu"},
                convert.catalog_from_objects)


@pytest.fixture(autouse=True)
def _clean_caches():
    clear_package_caches("karpenter_tpu", "karpenter_tpu_torch")
    yield
    clear_package_caches("karpenter_tpu", "karpenter_tpu_torch")


def _reset(m):
    m.objects._ids = itertools.count()
    m.cluster_mod._names = itertools.count(1)
    m.queue._msg_ids = itertools.count(1)


def both(case):
    _reset(REF)
    ref = case(REF)
    _reset(PORT)
    port = case(PORT)
    assert ref == port
    return port


def catalog(m, build=small_catalog):
    return m.convert_catalog(build())


def env(m, cat=None, pools=None, provenance=None):
    cloud = m.cloud.FakeCloud()
    provider = m.cloud.CloudProvider(cloud, cat or catalog(m))
    cluster = m.state.Cluster()
    prov = m.controllers.Provisioner(provider, cluster,
                                     pools or [m.objects.NodePool()],
                                     gang_scheduling=True,
                                     provenance=provenance, **m.extra)
    return cloud, provider, cluster, prov


def cpu_pod(m, cpu_m=500, mem_mib=512, **kw):
    R = m.resources
    return m.objects.Pod(requests=R.ResourceList(
        {R.CPU: cpu_m, R.MEMORY: mem_mib * 2**20}), **kw)


def gang_pod(m, gang, size, cpu_m=500, mem_mib=512, tier=0, topology="zone",
             **kw):
    return cpu_pod(m, cpu_m, mem_mib, gang_name=gang, gang_size=size,
                   gang_tier=tier, gang_topology=topology, **kw)


def bound_by_gang(cluster):
    out = {}
    for p in cluster.pods.values():
        if p.gang_name and p.node_name:
            out.setdefault(p.gang_name, []).append(p)
    return out


def cluster_state(cluster):
    """Every pod in admission order: its gang and its node's launch
    position (-1 = pending); and every node's zone and instance type."""
    order = {n: i for i, n in enumerate(cluster.nodes)}
    return ([(p.gang_name, order.get(p.node_name, -1))
             for p in cluster.pods.values()],
            [(n.zone, n.instance_type) for n in cluster.nodes.values()])


def registry_of(prov):
    return prov.gang_registry.summary()


# ---------------------------------------------------------------------------
# all-or-nothing: the core invariant, randomized
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(24))
def test_all_or_nothing_randomized(seed):
    """A gang is either fully bound in one topology domain or not bound at
    all, on both packages alike, across tests/test_gang.py's randomized
    fleets (placeable gangs, one with a member no type holds, one that is
    incomplete, loose filler pods)."""
    def case(m):
        rng = np.random.default_rng([seed, 19])
        cloud, provider, cluster, prov = env(m)
        pods = []
        for g in range(int(rng.integers(2, 5))):
            name = f"g{seed}-{g}"
            size = int(rng.integers(2, 5))
            for _ in range(size):
                pods.append(gang_pod(m, name, size,
                                     cpu_m=int(rng.integers(200, 2000)),
                                     mem_mib=int(rng.integers(128, 2048))))
        big = f"g{seed}-big"
        pods.append(gang_pod(m, big, 3, cpu_m=64_000))
        pods.extend(gang_pod(m, big, 3, cpu_m=int(rng.integers(200, 1000)))
                    for _ in range(2))
        short = f"g{seed}-short"
        pods.extend(gang_pod(m, short, 4, cpu_m=400) for _ in range(2))
        pods.extend(cpu_pod(m, cpu_m=int(rng.integers(100, 1500)))
                    for _ in range(int(rng.integers(0, 8))))
        order = rng.permutation(len(pods))
        cluster.add_pods([pods[i] for i in order])
        prov.provision()
        by_gang = bound_by_gang(cluster)
        arrived = {}
        for p in cluster.pods.values():
            if p.gang_name:
                arrived[p.gang_name] = arrived.get(p.gang_name, 0) + 1
        for name, n in arrived.items():
            bound = by_gang.get(name, [])
            assert len(bound) in (0, n), name
            assert len({cluster.nodes[p.node_name].zone
                        for p in bound}) <= 1, name
        assert not by_gang.get(big) and not by_gang.get(short)
        return cluster_state(cluster), registry_of(prov)
    both(case)


def test_admitted_gang_binds_whole():
    def case(m):
        cloud, provider, cluster, prov = env(m)
        cluster.add_pods([gang_pod(m, "train", 3, cpu_m=700)
                          for _ in range(3)])
        prov.provision()
        bound = bound_by_gang(cluster).get("train", [])
        assert len(bound) == 3
        assert len({cluster.nodes[p.node_name].zone for p in bound}) == 1
        return cluster_state(cluster), registry_of(prov)
    both(case)


def test_rejection_strips_gang_but_not_neighbors():
    def case(m):
        cloud, provider, cluster, prov = env(m)
        cluster.add_pods([gang_pod(m, "bad", 2, cpu_m=64_000),
                          gang_pod(m, "bad", 2, cpu_m=300),
                          cpu_pod(m, cpu_m=400), cpu_pod(m, cpu_m=600)])
        prov.provision()
        assert not bound_by_gang(cluster).get("bad")
        assert {p.gang_name for p in cluster.pending_pods()} == {"bad"}
        assert all(p.node_name for p in cluster.pods.values()
                   if not p.gang_name)
        return cluster_state(cluster), registry_of(prov)
    both(case)


def test_gang_provenance_names_worst_member():
    def case(m):
        store = m.provenance.ProvenanceStore()
        cloud, provider, cluster, prov = env(m, provenance=store)
        cluster.add_pods([gang_pod(m, "half", 2, cpu_m=64_000),
                          gang_pod(m, "half", 2, cpu_m=300)])
        prov.provision()
        recs = [r for r in store.all() if r.constraint == m.provenance.GANG]
        assert recs
        rec = recs[0]
        assert rec.dimension == "partial"
        assert "gang partially placeable: 1/2" in rec.message
        assert "worst member" in rec.message
        assert rec.detail["gang"] == "half"
        assert rec.detail["worst_constraint"] == "resource"
        return [(r.constraint, r.dimension, r.message,
                 sorted(r.detail.items())) for r in recs]
    both(case)


# ---------------------------------------------------------------------------
# preemption cascade
# ---------------------------------------------------------------------------

def _node(m, name, zone, cpu_m, mem_mib, pods=()):
    R = m.resources
    alloc = R.ResourceList({R.CPU: cpu_m, R.MEMORY: mem_mib * 2**20})
    n = m.objects.Node(name=name, zone=zone, allocatable=alloc,
                       capacity=alloc, pods=list(pods))
    for p in n.pods:
        p.node_name = name
    return n


def _victimable(m, uid, cpu_m, tier=0, priority=0, **kw):
    R = m.resources
    p = m.objects.Pod(name=uid, requests=R.ResourceList(
        {R.CPU: cpu_m, R.MEMORY: 256 * 2**20}), gang_tier=tier,
        priority=priority, **kw)
    p.uid = uid
    return p


def _reqs(m, cpu_m, mem_mib, n):
    R = m.resources
    return [R.ResourceList({R.CPU: cpu_m, R.MEMORY: mem_mib * 2**20})] * n


def _plan(plan):
    if plan is None:
        return None
    return (plan.gang, plan.tier, plan.topology, plan.domain,
            [(v.uid, v.pod, v.node, v.tier, v.cost) for v in plan.victims],
            plan.total_cost)


def test_victim_cost_matches_disruption_formula():
    """ops/gang.victim_cost mirrors controllers/disruption.
    pod_disruption_cost in each package, and the two packages agree."""
    def case(m):
        rng = np.random.default_rng(7)
        out = []
        for _ in range(50):
            R = m.resources
            p = m.objects.Pod(requests=R.ResourceList({R.CPU: 100}),
                              priority=int(rng.integers(-10, 10_000)))
            p.deletion_cost = int(rng.integers(0, 1000))
            cost = m.gang.victim_cost(p)
            assert cost == m.disruption.pod_disruption_cost(p)
            out.append(cost)
        return out
    both(case)


def test_preemption_cascade_ordering_and_minimality():
    def case(m):
        victims = [_victimable(m, f"v{i:02d}", cpu_m=900, tier=i % 2,
                               priority=100 * i) for i in range(8)]
        same_tier = [_victimable(m, f"w{i:02d}", cpu_m=900, tier=2)
                     for i in range(2)]
        nodes = [_node(m, f"n{i}", "zone-a", 2000, 4096,
                       pods=[victims[2 * i], victims[2 * i + 1]])
                 for i in range(4)]
        nodes.append(_node(m, "n9", "zone-a", 2000, 4096, pods=same_tier))
        gang = m.tz.GangInfo(name="slice", size=3, tier=2, topology="zone")
        reqs = _reqs(m, 1800, 1024, 3)
        plan = m.gang.plan_preemption(gang, reqs, nodes)
        assert plan is not None and plan.victims
        assert all(v.tier < gang.tier for v in plan.victims)
        assert not any(v.uid.startswith("w") for v in plan.victims)
        keys = [(v.tier, v.cost, v.uid) for v in plan.victims]
        assert keys == sorted(keys)
        last = plan.victims[-1]
        for n in nodes:
            n.pods = [p for p in n.pods
                      if p.uid == last.uid or
                      p.uid not in {v.uid for v in plan.victims}]
        replay = m.gang.plan_preemption(gang, reqs, nodes)
        assert replay is not None
        assert [v.uid for v in replay.victims] == [last.uid]
        return _plan(plan), _plan(replay)
    both(case)


def test_preemption_spares_protected_pods():
    def case(m):
        protected = [
            _victimable(m, "daemon", 900, owner_kind="DaemonSet"),
            _victimable(m, "pinned", 900,
                        annotations={"karpenter.sh/do-not-disrupt": "true"}),
            _victimable(m, "bare", 900, owner_kind=""),
        ]
        nodes = [_node(m, "n0", "zone-a", 2000, 4096, pods=protected[:2]),
                 _node(m, "n1", "zone-a", 2000, 4096, pods=protected[2:])]
        gang = m.tz.GangInfo(name="slice", size=2, tier=1, topology="zone")
        return _plan(m.gang.plan_preemption(gang, _reqs(m, 1800, 512, 2),
                                            nodes))
    assert both(case) is None


def test_preemption_respects_pinned_domains():
    def case(m):
        nodes = [_node(m, "na", "zone-a", 2000, 4096,
                       pods=[_victimable(m, "a0", 900),
                             _victimable(m, "a1", 900)]),
                 _node(m, "nb", "zone-b", 2000, 4096,
                       pods=[_victimable(m, "b0", 1800)])]
        gang = m.tz.GangInfo(name="slice", size=2, tier=1, topology="zone")
        reqs = _reqs(m, 1700, 512, 1)
        free = m.gang.plan_preemption(gang, reqs, nodes)
        pinned = m.gang.plan_preemption(gang, reqs, nodes,
                                        pin_domains=("zone-a",))
        return _plan(free), _plan(pinned)
    free, pinned = both(case)
    assert free[3] == "zone-b" and pinned[3] == "zone-a"
    assert sorted(v[0] for v in pinned[4]) == ["a0", "a1"]


def test_preemption_is_per_node_not_aggregate():
    def case(m):
        nodes = [_node(m, f"n{i}", "zone-a", 2000, 4096,
                       pods=[_victimable(m, f"v{i}", 1000)])
                 for i in range(4)]
        gang = m.tz.GangInfo(name="slice", size=1, tier=1, topology="zone")
        return _plan(m.gang.plan_preemption(gang, _reqs(m, 1800, 512, 1),
                                            nodes))
    plan = both(case)
    assert plan is not None and len(plan[4]) == 1


# ---------------------------------------------------------------------------
# tensorize + partition fate-sharing
# ---------------------------------------------------------------------------

ZONES = tuple(f"zone-{c}" for c in "abcd")


def _zoned_catalog():
    return [make_type("a.small", 2, 4, 0.10, zones=ZONES),
            make_type("a.large", 8, 16, 0.40, zones=ZONES)]


def test_gang_never_straddles_partition_shard():
    def case(m):
        pods = [cpu_pod(m, cpu_m=500, mem_mib=256,
                        node_selector={m.wk.ZONE: z})
                for z in ZONES for _ in range(40)]
        for z in ("zone-a", "zone-b"):
            pods.append(gang_pod(m, "bridge", 2, cpu_m=500,
                                 node_selector={m.wk.ZONE: z}))
        prob = m.tz.tensorize(pods, catalog(m, _zoned_catalog),
                              [m.objects.NodePool()])
        assert prob.class_gang is not None
        plan = m.partition.plan_partition(prob, 4, min_pods=1)
        assert plan is not None
        members = np.nonzero(np.asarray(prob.class_gang) >= 0)[0]
        shards = {int(plan.class_shard[ci]) for ci in members}
        assert len(shards) == 1
        return (np.asarray(plan.class_shard).tolist(),
                np.asarray(prob.class_gang).tolist())
    both(case)


def test_class_order_groups_gang_adjacently():
    def case(m):
        pods = [cpu_pod(m, cpu_m=1900), cpu_pod(m, cpu_m=100),
                gang_pod(m, "g", 2, cpu_m=1500),
                gang_pod(m, "g", 2, cpu_m=200)]
        prob = m.tz.tensorize(pods, catalog(m), [m.objects.NodePool()])
        order = prob.class_order().tolist()
        gang_classes = np.nonzero(
            np.asarray(prob.class_gang) >= 0)[0].tolist()
        positions = sorted(order.index(ci) for ci in gang_classes)
        assert positions == list(range(positions[0],
                                       positions[0] + len(positions)))
        return order, gang_classes
    both(case)


def test_no_gang_class_order_unchanged():
    def case(m):
        rng = np.random.default_rng(3)
        pods = [cpu_pod(m, cpu_m=int(rng.integers(100, 2000)),
                        mem_mib=int(rng.integers(128, 2048)))
                for _ in range(30)]
        prob = m.tz.tensorize(pods, catalog(m), [m.objects.NodePool()])
        assert prob.class_gang is None
        norm = prob.option_alloc.mean(axis=0)
        norm = np.where(norm > 0, norm, 1.0)
        size = (prob.class_requests / norm).max(axis=1)
        np.testing.assert_array_equal(prob.class_order(),
                                      np.argsort(-size, kind="stable"))
        return prob.class_order().tolist()
    both(case)


def test_strip_pods_rebalances_result():
    def case(m):
        pods = [cpu_pod(m, cpu_m=1500, mem_mib=1024) for _ in range(3)]
        prob = m.tz.tensorize(pods, catalog(m), [m.objects.NodePool()])
        result = m.ffd.solve_ffd(prob, **m.extra)
        placed = sorted(i for d in result.nodes for i in d.pod_indices)
        assert placed == [0, 1, 2]
        before_price = result.total_price
        result.strip_pods({0, 1}, pods=prob.pods)
        left = sorted(i for d in result.nodes for i in d.pod_indices)
        assert left == [2]
        assert sorted(result.unschedulable) == [0, 1]
        assert result.total_price <= before_price
        assert all(d.pod_indices for d in result.nodes)
        return (before_price, result.total_price,
                [(d.option.instance_type, list(d.pod_indices))
                 for d in result.nodes])
    both(case)


# ---------------------------------------------------------------------------
# registry durability + admission atomicity
# ---------------------------------------------------------------------------

def test_registry_snapshot_roundtrip():
    def case(m):
        reg = m.gang.GangRegistry()
        pods = [gang_pod(m, "a", 2, cpu_m=300) for _ in range(2)]
        prob = m.tz.tensorize(pods, catalog(m), [m.objects.NodePool()])
        result = m.ffd.solve_ffd(prob, **m.extra)
        for audit in m.gang.audit_gangs(prob, result, []):
            reg.observe(audit)
        reg.record_preemption("a", 3)
        state = reg.snapshot_state()
        reg2 = m.gang.GangRegistry()
        reg2.restore_state(state)
        assert reg2.summary() == reg.summary()
        assert reg2.get("a").preempted == 3
        return state
    both(case)


def _seed_cloud(m, op):
    f = m.fake
    op.cloud.subnets = [f.SubnetInfo("s-a", "zone-a", 10_000, {}),
                        f.SubnetInfo("s-b", "zone-b", 10_000, {})]
    op.cloud.security_groups = [f.SecurityGroupInfo("sg", "nodes", {})]
    op.cloud.images = [f.ImageInfo("img-1", "std", "amd64", 1.0)]
    op.params.parameters = {
        "/karpenter-tpu/images/standard/1.28/amd64/latest": "img-1"}
    return op


def test_restart_never_surfaces_half_admitted_gang(tmp_path):
    """tests/test_gang.py's kill -9 case: the operator's manager with the
    GangScheduling and WarmRestart gates, three ticks over a placeable
    gang, a forever-partial one and loose pods.  After every tick each gang
    is fully bound or fully pending, the registry says which, and its
    snapshot round-trips into a fresh registry; a snapshot written then and
    restored into a fresh operator shows the same gangs and registry."""
    def case(m):
        O = m.operator
        clk = [1000.0]
        path = str(tmp_path / f"{m.name}.bin")

        def stack():
            opts = O.Options(interruption_queue="q", snapshot_path=path)
            opts.feature_gates["GangScheduling"] = True
            opts.feature_gates["WarmRestart"] = True
            op = _seed_cloud(m, O.Operator(
                opts, catalog=m.gen.generate_catalog(10),
                clock=lambda: clk[0], **m.extra))
            return op, O.ControllerManager(op, O.build_controllers(op),
                                           clock=lambda: clk[0])
        op, mgr = stack()
        op.cluster.add_pods(
            [gang_pod(m, "ok", 3, cpu_m=600) for _ in range(3)]
            + [gang_pod(m, "doomed", 2, cpu_m=10_000_000)]
            + [gang_pod(m, "doomed", 2, cpu_m=400)]
            + [cpu_pod(m, cpu_m=500) for _ in range(3)])
        states = []
        for _ in range(3):
            mgr.tick()
            clk[0] += 1.1
            by_gang = bound_by_gang(op.cluster)
            assert len(by_gang.get("ok", [])) in (0, 3)
            assert "doomed" not in by_gang
            states.append(cluster_state(op.cluster))
        reg = mgr.controllers["provisioning"].gang_registry
        assert reg.get("ok").admitted and not reg.get("doomed").admitted
        reg2 = m.gang.GangRegistry()
        reg2.restore_state(reg.snapshot_state())
        assert reg2.summary() == reg.summary()
        snapshot = importlib.import_module(f"{m.name}.state.snapshot")
        assert snapshot.write_snapshot(path, op, mgr)
        op2, mgr2 = stack()
        assert snapshot.restore_snapshot(path, op2, mgr2) == "restored"
        by_gang = bound_by_gang(op2.cluster)
        assert len(by_gang.get("ok", [])) == 3
        assert "doomed" not in by_gang, "restart surfaced a half-admitted gang"
        reg3 = mgr2.controllers["provisioning"].gang_registry
        assert reg3.summary() == reg.summary()
        return states, reg.summary(), cluster_state(op2.cluster)
    both(case)


# ---------------------------------------------------------------------------
# the A/B: gang-aware beats naive on time-to-full-gang
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_gang_ab_beats_naive_on_time_to_full():
    """tests/test_gang.py's A/B on both packages: gang-churn-storm with the
    gate on beats the gate-off replay on time-to-full-gang p95 and
    completes every gang it saw; the packages' numbers are equal."""
    def case(m):
        sc = m.sim.load_scenario(os.path.join(REPO, "scenarios",
                                              "gang-churn-storm.yaml"))
        on = m.sim.SimHarness(sc, seed=0, **m.extra)
        on.run()
        off = m.sim.SimHarness(sc, seed=0, gang=False, **m.extra)
        off.run()
        assert set(on._gang_full_t) == set(on._gang_arrive_t)
        p95_on = m.report.percentile(sorted(on._gang_full_t.values()), 0.95)
        p95_off = m.report.percentile(sorted(off._gang_full_t.values()), 0.95)
        assert p95_on < p95_off
        return p95_on, p95_off
    both(case)
