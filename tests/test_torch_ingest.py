"""The port's IngestBatcher (karpenter_tpu_torch/state/ingest.py) against
the JAX package's, case by case with tests/test_ingest.py.

A batched event window flushed as one arena delta must stay bit-identical
in gather output to the eager per-event stream: each mutation runs on four
clusters — both packages, batched and eager, every package's name counters
restarted first so all four name their objects alike — and the four gathers
must agree (names, values, dtypes), the port's also against its own
`tensorize_nodes`.  Then the coalescing economics (N events → one delta),
the overflow that degrades to a rebuild and never drops an event, and the
gate plumbing through the port's Options and Operator.  The port's solves
run on the CPU.
"""

import numpy as np
import pytest

from torch_cases import clear_lp_caches as clear_package_caches
from torch_cases import one_torch_thread  # noqa: F401
from torch_kits import FakeClock, package_kit, plain_node, port_kit
from torch_refnative import reference_native_loaded  # noqa: F401
from helpers import cpu_pod, small_catalog
from karpenter_tpu.sim.harness import _reset_global_counters
from karpenter_tpu_torch.state.ingest import IngestBatcher

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


def env(kit, batched=True, max_events=100_000):
    clock = FakeClock()
    cloud = kit.FakeCloud(clock)
    provider = kit.CloudProvider(cloud, kit.catalog(), clock=clock)
    cluster = kit.Cluster(clock)
    cluster.attach_arena()
    if batched:
        cluster.arena = kit.IngestBatcher(cluster.arena,
                                          max_events=max_events)
    pools = [kit.NodePool(disruption=kit.Disruption(
        consolidation_policy="WhenUnderutilized"))]
    prov = kit.Provisioner(provider, cluster, pools, clock=clock, **kit.extra)
    return cluster, prov


def reps(kit):
    return [kit.pod(cpu_m=500, mem_mib=512),
            kit.pod(cpu_m=1500, mem_mib=2048)]


def assert_batched_equals_eager(mutate):
    """Run `mutate(kit, cluster, prov)` on a batched and an eager cluster of
    each package; the final gathers (the only thing the solver reads) must
    agree value for value, and the port's equal its tensorize_nodes."""
    out = []
    for kit in KITS:
        for batched in (True, False):
            kit.reset_counters()
            cluster, prov = env(kit, batched=batched)
            mutate(kit, cluster, prov)
            g = cluster.arena.gather(reps(kit))
            assert g is not None, f"{kit.name} batched={batched} fell back"
            nodes, alloc, used, compat = g
            if kit is PORT:
                s_nodes, s_alloc, s_used, s_compat = cluster.tensorize_nodes(
                    reps(kit))
                assert all(a is b for a, b in zip(nodes, s_nodes))
                for x, y in ((alloc, s_alloc), (used, s_used),
                             (compat, s_compat)):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
            out.append(([n.name for n in nodes], alloc, used, compat))
    want = out[0]
    for got in out[1:]:
        assert got[0] == want[0]
        for x, y in zip(got[1:], want[1:]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# batched ≡ eager bit-identity
# ---------------------------------------------------------------------------

def test_provision_churn_batched_equals_eager():
    def mutate(kit, cluster, prov):
        cluster.add_pods([kit.pod(cpu_m=700, mem_mib=900) for _ in range(6)])
        prov.provision()
        victims = sorted(cluster.pods.values(), key=lambda p: p.uid)
        for p in victims[:2]:
            cluster.delete_pod(p)
    assert_batched_equals_eager(mutate)


def test_node_add_remove_interleaving_batched_equals_eager():
    def mutate(kit, cluster, prov):
        for i in range(6):
            cluster.add_node(plain_node(kit, i))
        for name in sorted(cluster.nodes)[:3]:
            cluster.remove_node(name)
        for i in range(6, 9):
            cluster.add_node(plain_node(kit, i))
    assert_batched_equals_eager(mutate)


def test_taint_edit_then_remove_then_revive_batched_equals_eager():
    def mutate(kit, cluster, prov):
        for i in range(3):
            cluster.add_node(plain_node(kit, i))
        # flush so the nodes are tracked, then churn within one window
        if hasattr(cluster.arena, "flush"):
            cluster.arena.gather(reps(kit))
        node = cluster.nodes[sorted(cluster.nodes)[0]]
        node.taints = [kit.Taint(key="edited")]
        cluster.touch_node(node)
        cluster.remove_node(node.name)
        cluster.add_node(plain_node(kit, 99, name=node.name))
    assert_batched_equals_eager(mutate)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_stream_batched_equals_eager(seed):
    def mutate(kit, cluster, prov):
        rng = np.random.default_rng(seed)
        for step in range(25):
            op = rng.integers(0, 5)
            if op == 0:
                cluster.add_pods([kit.pod(
                    cpu_m=int(rng.integers(200, 1800)),
                    mem_mib=int(rng.integers(256, 3000)))])
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
                node.taints = [] if node.taints else [kit.Taint(key="edited")]
                cluster.touch_node(node)
    assert_batched_equals_eager(mutate)


# ---------------------------------------------------------------------------
# coalescing economics: the window is one delta, not N
# ---------------------------------------------------------------------------

def both(case):
    """Run `case(kit)` on each package; its returned observations must
    agree."""
    seen = []
    for kit in KITS:
        kit.reset_counters()
        seen.append(case(kit))
    assert seen[0] == seen[1]


def test_event_firehose_coalesces_to_one_delta():
    def case(kit):
        cluster, prov = env(kit)
        batcher = cluster.arena
        cluster.add_pods([kit.pod() for _ in range(4)])
        prov.provision()
        batcher.flush()
        inner = batcher._arena
        epoch0 = inner.epoch
        bound = sorted((p for p in cluster.pods.values() if p.node_name),
                       key=lambda p: p.uid)
        for _ in range(100):
            for p in bound:
                cluster.unbind_pod(p)
                cluster.bind_pod(p, sorted(cluster.nodes)[0])
        events_in_window = batcher.events_total
        assert events_in_window >= 200
        assert inner.epoch == epoch0          # nothing applied yet
        assert batcher.flush()
        assert inner.epoch == epoch0 + 1      # the whole window: ONE delta
        return events_in_window, batcher.flushes_total
    both(case)


def test_empty_window_flush_is_free():
    def case(kit):
        cluster, prov = env(kit)
        inner = cluster.arena._arena
        epoch0 = inner.epoch
        assert cluster.arena.flush() is False
        assert inner.epoch == epoch0
        return epoch0
    both(case)


def test_gather_flushes_as_safety_net():
    def case(kit):
        cluster, prov = env(kit)
        for i in range(3):
            cluster.add_node(plain_node(kit, i))
        assert cluster.arena.pending > 0
        g = cluster.arena.gather(reps(kit))
        assert g is not None
        assert cluster.arena.pending == 0
        assert len(g[0]) == 3                 # absorbed adds all visible
        return [n.name for n in g[0]], g[1].tolist(), g[3].tolist()
    both(case)


def test_removal_cancels_pending_add_entirely():
    def case(kit):
        cluster, prov = env(kit)
        batcher = cluster.arena
        node = plain_node(kit, 0)
        cluster.add_node(node)
        cluster.remove_node(node.name)        # add + remove in one window
        assert batcher.pending == 0           # cancels out: no arena work
        batcher.flush()
        assert node.name not in batcher._arena._slot_of
        return batcher.events_total
    both(case)


# ---------------------------------------------------------------------------
# overflow: degrade to rebuild, never drop
# ---------------------------------------------------------------------------

def test_overflow_degrades_to_rebuild_without_dropping():
    def case(kit):
        cluster, prov = env(kit, max_events=4)
        batcher = cluster.arena
        for i in range(8):                    # pending > max_events
            cluster.add_node(plain_node(kit, i))
        assert batcher.overflows_total >= 1
        assert batcher._arena._needs_rebuild  # degraded to full rebuild
        g = cluster.arena.gather(reps(kit))
        assert g is not None and len(g[0]) == 8
        s_nodes, s_alloc, s_used, s_compat = cluster.tensorize_nodes(
            reps(kit))
        np.testing.assert_array_equal(g[1], s_alloc)
        np.testing.assert_array_equal(g[2], s_used)
        return batcher.overflows_total, [n.name for n in g[0]]
    both(case)


def test_invalidate_clears_pending_window():
    def case(kit):
        cluster, prov = env(kit)
        cluster.add_node(plain_node(kit, 0))
        assert cluster.arena.pending == 1
        cluster.arena.invalidate("test")
        assert cluster.arena.pending == 0
        assert cluster.arena._arena._needs_rebuild
        return cluster.arena.events_total
    both(case)


# ---------------------------------------------------------------------------
# gate plumbing
# ---------------------------------------------------------------------------

def test_gate_defaults_off_and_flags():
    """IngestBatch and WarmRestart are off by default in both packages, and
    the port's Options carry the reference's pending cap; the flags that
    set them are held by tests/test_torch_main.py (the snapshot knobs
    with them)."""
    from karpenter_tpu.operator.options import Options as RefOptions
    from karpenter_tpu_torch.operator.options import Options
    for O in (RefOptions, Options):
        assert not O().gate("IngestBatch")
        assert not O().gate("WarmRestart")
    assert Options().ingest_max_events == RefOptions().ingest_max_events
    ref = RefOptions.from_args(["--ingest-batch", "--ingest-max-events",
                                "1234"])
    opts = Options(ingest_max_events=1234)
    opts.feature_gates["IngestBatch"] = True
    assert (opts.feature_gates, opts.ingest_max_events) == (
        ref.feature_gates, ref.ingest_max_events)


def test_operator_wraps_arena_under_gate():
    from karpenter_tpu_torch.catalog.generate import generate_catalog
    from karpenter_tpu_torch.operator import Operator, Options
    from karpenter_tpu_torch.ops.arena import ClusterArena
    opts = Options()
    opts.feature_gates["IngestBatch"] = True
    opts.ingest_max_events = 1234
    op = Operator(opts, catalog=generate_catalog(5), device="cpu")
    assert isinstance(op.cluster.arena, IngestBatcher)
    assert op.cluster.arena.max_events == 1234
    op2 = Operator(Options(), catalog=generate_catalog(5), device="cpu")
    assert isinstance(op2.cluster.arena, ClusterArena)
