"""The port's ClusterArena (karpenter_tpu_torch/ops/arena.py) against the
JAX package's, case by case with tests/test_arena_delta.py.

Every case runs the same steps on a fixture built from either package's
classes (`REF` / `PORT`, the port's solves on the CPU) and, at
each checkpoint, holds the port's warm `gather` against the port's
from-scratch `Cluster.tensorize_nodes` bit for bit (the same node objects
in the same order, the same values and dtypes) and against the JAX
package's `gather` at the same checkpoint (nodes by registration position,
arrays bit for bit).  The reference's assertions are checked on the port's
side.  test_harness_gate_off_detaches_arena, which needs the simulator,
is in tests/test_torch_sim.py.

Then the goldens with the arena attached: `provision-small-3x64` against
`workloads.GOLDEN_PROVISION`, two live rounds at a small size against the
port without the arena and against the JAX package with it (eager and
behind an `IngestBatcher` flushed before each provision), and the
full-width disruption cell `disruption-replay-500` against
`workloads.GOLDEN_DISRUPTION`, each with the arena serving the gathers
warm.
"""

import copy

import numpy as np
import pytest

from torch_cases import clear_lp_caches as clear_package_caches
from torch_cases import one_torch_thread  # noqa: F401
from torch_kits import FakeClock, launch_positions, package_kit, port_kit
from torch_refnative import reference_native_loaded  # noqa: F401
from helpers import cpu_pod, small_catalog
from karpenter_tpu.api.resources import CPU, MEMORY, PODS
from karpenter_tpu.sim.harness import _reset_global_counters
from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.ops.arena import ClusterArena

REF = package_kit("karpenter_tpu", name="ref", pod=cpu_pod,
                  catalog=small_catalog, extra={},
                  reset_counters=_reset_global_counters)
PORT = port_kit(small_catalog)
KITS = (REF, PORT)


def clear_lp_caches():
    clear_package_caches("karpenter_tpu", "karpenter_tpu_torch")


@pytest.fixture(autouse=True)
def _clean_lp_caches():
    clear_lp_caches()
    yield
    clear_lp_caches()


def env(kit, catalog=None, arena_kwargs=None):
    clock = FakeClock()
    cloud = kit.FakeCloud(clock)
    provider = kit.CloudProvider(cloud, catalog or kit.catalog(), clock=clock)
    cluster = kit.Cluster(clock)
    cluster.attach_arena(**(arena_kwargs or {}))
    pools = [kit.NodePool(disruption=kit.Disruption(
        consolidation_policy="WhenUnderutilized"))]
    prov = kit.Provisioner(provider, cluster, pools, clock=clock, **kit.extra)
    ctrl = kit.DisruptionController(provider, cluster, pools, clock=clock,
                                    stabilization_s=0.0, **kit.extra)
    return clock, cloud, provider, cluster, prov, ctrl


def provision(cluster, prov, pods):
    cluster.add_pods(pods)
    res = prov.provision()
    assert not res.unschedulable
    return res


def class_reps(kit):
    """A mixed bag of pod equivalence classes: plain, selector-constrained
    (the compat row math), and tolerating (the taint row math)."""
    return [
        kit.pod(cpu_m=500, mem_mib=512),
        kit.pod(cpu_m=1500, mem_mib=2048),
        kit.pod(cpu_m=250, mem_mib=256,
                node_selector={kit.wk.INSTANCE_TYPE: "a.large"}),
        kit.pod(cpu_m=250, mem_mib=256,
                tolerations=[kit.Toleration(key="", operator="Exists")]),
    ]


def gather_checked(kit, cluster, reps, exclude=()):
    """The bit-identity contract inside one package: the warm gather equals
    a from-scratch tensorize_nodes (same node objects in the same order,
    same values, same dtypes).  Returns the gather with its nodes as
    registration positions."""
    gathered = cluster.arena.gather(reps, exclude=exclude)
    assert gathered is not None, f"{kit.name}: warm gather fell back"
    g_nodes, g_alloc, g_used, g_compat = gathered
    s_nodes, s_alloc, s_used, s_compat = cluster.tensorize_nodes(
        reps, exclude=exclude)
    assert len(g_nodes) == len(s_nodes)
    assert all(a is b for a, b in zip(g_nodes, s_nodes))
    assert g_alloc.dtype == s_alloc.dtype == np.float32
    assert g_used.dtype == s_used.dtype == np.float32
    assert g_compat.dtype == s_compat.dtype == np.bool_
    np.testing.assert_array_equal(g_alloc, s_alloc)
    np.testing.assert_array_equal(g_used, s_used)
    np.testing.assert_array_equal(g_compat, s_compat)
    return launch_positions(cluster, g_nodes), g_alloc, g_used, g_compat


def run_both(case, **env_kw):
    """Run `case(kit, env, check)` on each package; `check(exclude=(),
    reps=None)` records a checked gather.  The port's checkpoints must
    equal the JAX package's, bit for bit.  Returns the port's env."""
    seen = {}
    for kit in KITS:
        kit.reset_counters()
        e = env(kit, **env_kw)
        cps = seen[kit.name] = []
        cluster = e[3]

        def check(exclude=(), reps=None, _kit=kit, _cluster=cluster,
                  _cps=cps):
            names = sorted(_cluster.nodes)
            excl = tuple(names[i] for i in exclude)
            _cps.append(gather_checked(_kit, _cluster,
                                       reps or class_reps(_kit), excl))
        case(kit, e, check)
        port_env = e
    ref, port = seen["ref"], seen["port"]
    assert len(ref) == len(port) and port
    for (rn, ra, ru, rc), (pn, pa, pu, pc) in zip(ref, port):
        assert rn == pn
        np.testing.assert_array_equal(ra, pa)
        np.testing.assert_array_equal(ru, pu)
        np.testing.assert_array_equal(rc, pc)
    return port_env


# ---------------------------------------------------------------------------
# randomized event-stream bit-identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_randomized_event_stream_bit_identity(seed):
    def case(kit, e, check):
        clock, cloud, provider, cluster, prov, ctrl = e
        rng = np.random.default_rng(seed)
        for step in range(30):
            op = rng.integers(0, 5)
            if op == 0:
                k = int(rng.integers(1, 4))
                cluster.add_pods([kit.pod(
                    cpu_m=int(rng.integers(200, 1800)),
                    mem_mib=int(rng.integers(256, 3000))) for _ in range(k)])
                prov.provision()
            elif op == 1 and cluster.pods:
                victims = sorted(cluster.pods.values(), key=lambda p: p.uid)
                cluster.delete_pod(victims[int(rng.integers(len(victims)))])
            elif op == 2 and cluster.pods:
                bound = [p for p in cluster.pods.values() if p.node_name]
                if bound:
                    cluster.unbind_pod(bound[int(rng.integers(len(bound)))])
            elif op == 3 and len(cluster.nodes) > 1:
                names = sorted(cluster.nodes)
                cluster.remove_node(names[int(rng.integers(len(names)))])
            elif op == 4 and cluster.nodes:
                names = sorted(cluster.nodes)
                node = cluster.nodes[names[int(rng.integers(len(names)))]]
                if node.taints:
                    node.taints = []
                else:
                    node.taints = list(node.taints) + [kit.Taint(key="edited")]
                cluster.touch_node(node)
            if step % 5 == 4:
                check()
        check()
        if cluster.nodes:
            check(exclude=range(max(1, len(cluster.nodes) // 2)))
    run_both(case)


def test_bind_and_rebind_refresh_used_rows():
    def case(kit, e, check):
        clock, cloud, provider, cluster, prov, ctrl = e
        provision(cluster, prov, [kit.pod() for _ in range(4)])
        check()
        names = sorted(cluster.nodes)
        if len(names) >= 2:
            pod = next(p for p in cluster.pods.values()
                       if p.node_name == names[0])
            cluster.bind_pod(pod, names[1])
            check()
        pod = next(p for p in cluster.pods.values() if p.node_name)
        cluster.unbind_pod(pod)
        check()
    run_both(case)


# ---------------------------------------------------------------------------
# compaction and slab growth
# ---------------------------------------------------------------------------

def test_forced_compaction_preserves_bit_identity():
    def case(kit, e, check):
        clock, cloud, provider, cluster, prov, ctrl = e
        for i in range(10):
            cluster.add_node(kit.Node(
                name=f"drip-{i:03d}",
                allocatable=kit.ResourceList({CPU: 4000, MEMORY: 8 * 2 ** 30,
                                              PODS: 110}),
                labels={kit.wk.INSTANCE_TYPE: "a.medium",
                        kit.wk.ZONE: "zone-a"}))
        assert len(cluster.nodes) >= 6
        before = cluster.arena.compactions
        for name in sorted(cluster.nodes)[:-2]:
            cluster.remove_node(name)
            check()
        assert cluster.arena.compactions > before
        assert cluster.arena.tombstone_count <= max(
            cluster.arena.compact_floor, cluster.arena.live_count)
        check()
        provision(cluster, prov, [kit.pod() for _ in range(3)])
        check()
    run_both(case, arena_kwargs={"compact_floor": 2})


def test_class_table_wholesale_reset():
    def case(kit, e, check):
        clock, cloud, provider, cluster, prov, ctrl = e
        provision(cluster, prov, [kit.pod() for _ in range(2)])
        check()                    # 4 distinct classes > class_table_max
        check(reps=[kit.pod(cpu_m=333, mem_mib=333),
                    kit.pod(cpu_m=444, mem_mib=444),
                    kit.pod(cpu_m=555, mem_mib=555)])
    run_both(case, arena_kwargs={"class_table_max": 2})


# ---------------------------------------------------------------------------
# fallback contract: anything the slab can't express returns None
# ---------------------------------------------------------------------------

def test_gather_falls_back_on_extra_axes_and_custom_scales():
    def case(kit, e, check):
        clock, cloud, provider, cluster, prov, ctrl = e
        provision(cluster, prov, [kit.pod()])
        reps = class_reps(kit)
        arena = cluster.arena
        extra_axes = tuple(kit.AXES) + ("nvidia.com/gpu",)
        assert arena.gather(reps, axes=extra_axes) is None
        odd = dict(kit.SCALES)
        k = sorted(odd)[0]
        odd[k] = odd[k] * 2
        assert arena.gather(reps, scales=odd) is None
        assert arena.gather(reps, scales=dict(kit.SCALES)) is not None
        if kit is PORT:
            assert arena.gathers == {"warm": 1, "fallback": 2}
        check()
    run_both(case)


def test_gather_refuses_untracked_or_swapped_node_then_rebuilds():
    def case(kit, e, check):
        clock, cloud, provider, cluster, prov, ctrl = e
        provision(cluster, prov, [kit.pod()])
        name = sorted(cluster.nodes)[0]
        # swap the node object behind the arena's back (no delta fired):
        # the object-identity check must refuse the stale row
        cluster.nodes[name] = copy.deepcopy(cluster.nodes[name])
        assert cluster.arena.gather(class_reps(kit)) is None
        cluster.arena.rebuild()
        check()
    run_both(case)


def test_invalidate_triggers_rebuild_on_next_gather():
    def case(kit, e, check):
        clock, cloud, provider, cluster, prov, ctrl = e
        provision(cluster, prov, [kit.pod()])
        cluster.arena.invalidate("test")
        assert cluster.arena._needs_rebuild
        check()                    # gather rebuilt inline
        assert not cluster.arena._needs_rebuild
    run_both(case)


def test_epoch_advances_on_every_delta_kind():
    def case(kit, e, check):
        clock, cloud, provider, cluster, prov, ctrl = e
        epochs = [cluster.arena.epoch]
        pod = kit.pod()
        cluster.add_pod(pod)
        epochs.append(cluster.arena.epoch)
        provision(cluster, prov, [kit.pod()])
        epochs.append(cluster.arena.epoch)
        cluster.delete_pod(pod)
        epochs.append(cluster.arena.epoch)
        assert all(b > a for a, b in zip(epochs, epochs[1:]))
        seen.setdefault(kit.name, epochs)
        check()
    seen = {}
    run_both(case)
    assert seen["port"] == seen["ref"]


# ---------------------------------------------------------------------------
# disruption's fingerprint-keyed size-1 arena cache
# ---------------------------------------------------------------------------

def build_underutilized(kit, cluster, prov, rng, n_groups=5):
    for _ in range(n_groups):
        k = int(rng.integers(1, 4))
        provision(cluster, prov, [kit.pod(
            cpu_m=int(rng.integers(200, 1800)),
            mem_mib=int(rng.integers(256, 3000))) for _ in range(k)])
    all_pods = list(cluster.pods.values())
    rng.shuffle(all_pods)
    for p in all_pods[:int(len(all_pods) * 0.6)]:
        cluster.delete_pod(p)


def face_rows(cluster, side):
    return (launch_positions(cluster, side.node_list), side.alloc,
            side.used, side.compat)


def same_faces(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)


def test_arena_cache_hits_across_rebuilt_candidates():
    """Candidates are rebuilt objects every reconcile, but with an
    unchanged mutation_epoch the field-level match must reuse the cached
    SimulationArena; its delete face (gathered from the slab) equals the
    JAX package's."""
    faces = {}
    for kit in KITS:
        kit.reset_counters()
        clock, cloud, provider, cluster, prov, ctrl = env(kit)
        build_underutilized(kit, cluster, prov, np.random.default_rng(7))
        cands = ctrl.candidates()
        assert len(cands) >= 2
        a1 = ctrl._arena_for(cands)
        assert ctrl._arena_for(cands) is a1
        cands2 = ctrl.candidates()
        assert any(c2 is not c1 for c1, c2 in zip(cands, cands2))
        assert ctrl._arena_for(cands2) is a1
        faces[kit.name] = face_rows(cluster, a1.delete_side)
    same_faces(faces["ref"], faces["port"])


def test_arena_cache_invalidated_by_cluster_mutation():
    faces = {}
    for kit in KITS:
        kit.reset_counters()
        clock, cloud, provider, cluster, prov, ctrl = env(kit)
        build_underutilized(kit, cluster, prov, np.random.default_rng(9))
        a1 = ctrl._arena_for(ctrl.candidates())
        bound = sorted((p for p in cluster.pods.values() if p.node_name),
                       key=lambda p: p.uid)
        cluster.delete_pod(bound[0])
        a2 = ctrl._arena_for(ctrl.candidates())
        assert a2 is not a1
        faces[kit.name] = face_rows(cluster, a2.delete_side)
    same_faces(faces["ref"], faces["port"])


# ---------------------------------------------------------------------------
# lazy-face staleness regression
# ---------------------------------------------------------------------------

def test_sweep_faces_invalidated_by_interleaved_bind():
    """A bind between sweeps must drop the cached faces so the next sweep
    sees the new `used` rows; the refreshed face equals a from-scratch
    SimulationArena's and the JAX package's."""
    faces = {}
    for kit in KITS:
        kit.reset_counters()
        clock, cloud, provider, cluster, prov, ctrl = env(kit)
        build_underutilized(kit, cluster, prov, np.random.default_rng(11))
        cands = ctrl.candidates()
        assert len(cands) >= 2
        arena = ctrl._arena_for(cands)
        side_before = arena.delete_side
        assert arena.delete_side is side_before
        provision(cluster, prov, [kit.pod(cpu_m=300, mem_mib=256)])
        side_after = arena.delete_side
        assert side_after is not side_before
        fresh = kit.SimulationArena(cands, cluster,
                                    provider.get_instance_types(),
                                    list(ctrl.nodepools.values()),
                                    **kit.extra)
        f = fresh.delete_side
        same_faces(face_rows(cluster, side_after), face_rows(cluster, f))
        assert side_before.used.shape != f.used.shape or \
            not np.array_equal(side_before.used, f.used)
        faces[kit.name] = face_rows(cluster, side_after)
    same_faces(faces["ref"], faces["port"])


def test_warm_and_cold_faces_are_bit_identical():
    """The SimulationArena face built through the warm ClusterArena gather
    equals the face built with the arena detached (tensorize_nodes), in
    each package, and the port's equals the JAX package's."""
    faces = {}
    for kit in KITS:
        kit.reset_counters()
        clock, cloud, provider, cluster, prov, ctrl = env(kit)
        build_underutilized(kit, cluster, prov, np.random.default_rng(13))
        cands = ctrl.candidates()
        assert cands
        its = provider.get_instance_types()
        pools = list(ctrl.nodepools.values())
        if kit is PORT:
            warm_before = cluster.arena.gathers["warm"]
        w = kit.SimulationArena(cands, cluster, its, pools,
                                **kit.extra).delete_side
        if kit is PORT:
            assert cluster.arena.gathers["warm"] == warm_before + 1
        arena, cluster.arena = cluster.arena, None
        try:
            c = kit.SimulationArena(cands, cluster, its, pools,
                                    **kit.extra).delete_side
        finally:
            cluster.arena = arena
        same_faces(face_rows(cluster, w), face_rows(cluster, c))
        np.testing.assert_array_equal(w.cand_counts, c.cand_counts)
        np.testing.assert_array_equal(w.cand_cols, c.cand_cols)
        faces[kit.name] = face_rows(cluster, w) + (w.cand_counts,
                                                   w.cand_cols)
    same_faces(faces["ref"], faces["port"])


# ---------------------------------------------------------------------------
# gate plumbing
# ---------------------------------------------------------------------------

def test_options_flag_and_gate_default():
    """The IncrementalArena gate is on by default in both packages, and an
    operator built with it off carries no arena (the reference's
    `--feature-gates IncrementalArena=false` escape hatch; the port's
    command line: tests/test_torch_main.py)."""
    from karpenter_tpu.operator.options import Options as RefOptions
    from karpenter_tpu_torch.catalog.generate import generate_catalog
    from karpenter_tpu_torch.operator import Operator, Options
    ref = RefOptions.from_args(["--feature-gates", "IncrementalArena=false"])
    assert RefOptions().gate("IncrementalArena") and Options().gate(
        "IncrementalArena")
    opts = Options()
    opts.feature_gates["IncrementalArena"] = False
    assert opts.feature_gates == ref.feature_gates
    assert Operator(opts, catalog=generate_catalog(5),
                    device="cpu").cluster.arena is None


# ---------------------------------------------------------------------------
# the goldens with the arena attached
# ---------------------------------------------------------------------------

def test_provision_small_cell_with_arena_reproduces_golden():
    from karpenter_tpu_torch.api.objects import NodePool
    from karpenter_tpu_torch.catalog.generate import generate_catalog
    from karpenter_tpu_torch.cloud import CloudProvider, FakeCloud
    from karpenter_tpu_torch.controllers.provisioning import Provisioner
    from karpenter_tpu_torch.state import Cluster
    cell = "provision-small-3x64"
    e = workloads.provision_env(cell, FakeCloud, CloudProvider, Cluster,
                                Provisioner, NodePool,
                                generate_catalog(workloads.PROVISION_TYPES),
                                arena=True, device="cpu")
    assert isinstance(e.cluster.arena, ClusterArena)
    for r, (kw, seed) in enumerate(workloads.PROVISION_CELLS[cell][1]):
        warm = e.cluster.arena.gathers["warm"]
        sig, _ = workloads.provision_round(e, workloads.build_pods(
            rng=np.random.default_rng(seed), **kw))
        assert sig == workloads.GOLDEN_PROVISION[cell][r]
        if r:                      # a live cluster: gathered warm
            assert e.cluster.arena.gathers["warm"] > warm
    assert e.cluster.arena.gathers["fallback"] == 0


SMALL_LIVE = [(dict(workloads.HEADLINE, spec_count=40, total=2000), 0),
              (dict(workloads.PROVISION_ROUND2, spec_count=40, total=800), 5)]


def _small_live(kit_classes, arena, ingest=False, **extra):
    FakeCloud, CloudProvider, Cluster, Provisioner, NodePool, catalog, \
        build = kit_classes
    e = workloads.provision_env("provision-live-50k-20k", FakeCloud,
                                CloudProvider, Cluster, Provisioner,
                                NodePool, catalog, arena=arena, **extra)
    if ingest:
        e.cluster.arena = ingest(e.cluster.arena)
    sigs, warm = [], []
    for kw, seed in SMALL_LIVE:
        e.cluster.add_pods(build(rng=np.random.default_rng(seed), **kw))
        if ingest:
            e.cluster.arena.flush()    # the manager's top-of-tick flush
        before = dict(getattr(e.cluster.arena, "gathers", {}))
        sigs.append(workloads.provision_pending(e)[0])
        after = getattr(e.cluster.arena, "gathers", {})
        warm.append(after.get("warm", 0) - before.get("warm", 0))
    return sigs, warm


def test_live_rounds_with_arena_match_reference_and_scratch():
    """Two live rounds (the live cell's bursts at 2000 and 800 pods over the
    full catalog, DeviceDecode on): the port with the arena, eager and
    behind an IngestBatcher flushed before each provision, equals the port
    without it and the JAX package with it; the port's round 2 is gathered
    warm."""
    import bench
    from karpenter_tpu.api.objects import NodePool as RefNodePool
    from karpenter_tpu.catalog.generate import generate_catalog as ref_gen
    from karpenter_tpu.cloud import CloudProvider as RefCloudProvider
    from karpenter_tpu.cloud import FakeCloud as RefFakeCloud
    from karpenter_tpu.controllers import Provisioner as RefProvisioner
    from karpenter_tpu.state import Cluster as RefCluster
    from karpenter_tpu_torch import convert
    from karpenter_tpu_torch.api.objects import NodePool
    from karpenter_tpu_torch.cloud import CloudProvider, FakeCloud
    from karpenter_tpu_torch.controllers.provisioning import Provisioner
    from karpenter_tpu_torch.state import Cluster
    from karpenter_tpu_torch.state.ingest import IngestBatcher
    catalog = ref_gen(workloads.PROVISION_TYPES)
    ref_kit = (RefFakeCloud, RefCloudProvider, RefCluster, RefProvisioner,
               RefNodePool, catalog, bench.build_pods)
    port_kit = (FakeCloud, CloudProvider, Cluster, Provisioner, NodePool,
                convert.catalog_from_objects(catalog), workloads.build_pods)
    runs = {}
    for name, kit, kw in (
            ("ref arena", ref_kit, dict(arena=True)),
            ("port scratch", port_kit, dict(arena=False, device="cpu")),
            ("port arena", port_kit, dict(arena=True, device="cpu")),
            ("port ingest", port_kit, dict(arena=True, device="cpu",
                                           ingest=IngestBatcher))):
        clear_lp_caches()
        runs[name] = _small_live(kit, **kw)
    want = runs["ref arena"][0]
    assert want[1]["bound_existing"] > 0
    for name in ("port scratch", "port arena", "port ingest"):
        assert runs[name][0] == want, name
    for name in ("port arena", "port ingest"):
        assert runs[name][1][1] >= 1, name     # round 2 served warm


def test_disruption_cell_with_arena_reproduces_golden():
    """The full-width cell disruption-replay-500 with the arena attached
    before the fleet is built: every tick equals GOLDEN_DISRUPTION, and the
    consolidation faces and replacement solves gathered warm."""
    from karpenter_tpu_torch.catalog.generate import generate_catalog
    clear_lp_caches()
    e = workloads.disruption_env(
        workloads.port_kit(), generate_catalog(workloads.DISRUPTION_TYPES),
        arena=True, device="cpu")
    warm = e.cluster.arena.gathers["warm"]
    sigs = workloads.disruption_replay(e)
    assert workloads.disruption_digests(sigs) == workloads.GOLDEN_DISRUPTION
    assert e.cluster.arena.gathers["warm"] > warm
    assert e.cluster.arena.gathers["fallback"] == 0
