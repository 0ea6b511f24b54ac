"""The port's tracer (karpenter_tpu_torch/utils/tracing.py) and its spans
against the JAX package's.

- test_observability.py's tracing, logging and trace-coverage cases, and
  test_concurrency.py's two tracer cases, each on both packages
  (tests/torch_suites.py): the reference's assertions hold on the port
  and the values they compare are equal.  The coverage cases hold the
  port to the reference's bound: a root's children cover at least 95% of
  its wall time.
- The deterministic part of the coverage cases on its own: one
  provisioning round and one consolidation tick on both packages give
  equal span trees — names, nesting, annotation keys and `device_calls`.
- The tracer's cost when off: `TRACER.enabled = False` gives the shared
  no-op span and records nothing.
"""

import numpy as np
import pytest

from torch_cases import clear_lp_caches
from torch_lockorder import port_lock_order  # noqa: F401
from torch_suites import Suite, four_types, package, port_on_cpu



def _reference_auto_on_the_scan(mp):
    """The reference's `solve_ffd(backend="auto")` sends batches of at most
    256 rows to its native packer (device_calls=0); the port keeps them on
    its scan kernel (K7, device_calls=1; ROADMAP.md §C).  With its native
    packer unavailable the reference keeps them on its scan too, so the
    coverage cases compare like with like."""
    import karpenter_tpu.native
    mp.setattr(karpenter_tpu.native, "available", lambda: False)


# the tracing cases order span durations: by outcome
OBSERVABILITY = Suite("test_observability",
                      bounds=("TestTracing::", "TestTraceCoverage::"),
                      ref_setup=_reference_auto_on_the_scan)
# the ids a thread reads under the hammer depend on the threads' timing
CONCURRENCY = Suite("test_concurrency", outcomes=(
    "TestTracerConcurrency::test_ring_bounded",))

TRACING_CLASSES = ("TestTracing", "TestConfigureLogging", "TestTraceCoverage")


@pytest.mark.parametrize("case", [
    p for p in OBSERVABILITY.cases()
    if p.values[0].split("::")[0] in TRACING_CLASSES])
def test_observability_tracing(case, request):
    OBSERVABILITY.both(case, request)


@pytest.mark.parametrize("case", CONCURRENCY.cases(only=(
    "test_ring_bounded_and_stacks_isolated_under_hammer",
    "test_cross_thread_attach_under_contention")))
def test_concurrency_tracing(case, request):
    CONCURRENCY.both(case, request)


# ---------------------------------------------------------------------------
# span trees, port against reference
# ---------------------------------------------------------------------------

MODULES = dict(objects="api.objects", resources="api.resources",
               fake="cloud.fake", provider="cloud.provider",
               cluster="state.cluster", provisioning="controllers.provisioning",
               disruption="controllers.disruption",
               tracing="utils.tracing", harness="sim.harness")

REF = package("karpenter_tpu", **MODULES)
PORT = package("karpenter_tpu_torch", **MODULES)


def tree(t):
    """A trace's span names, nesting, annotation keys and device_calls."""
    ann = t["annotations"]
    return (t["name"], sorted(ann), ann.get("device_calls"),
            [tree(c) for c in t["children"]])


def provision_and_consolidate(m, n_pods=300):
    """One provisioning round over `n_pods` seeded pods, then one
    consolidation tick over the thinned-out fleet; the two traces."""
    R = m.resources
    m.harness._reset_global_counters()
    clear_lp_caches(m.name)
    tr = m.tracing.TRACER
    tr.reset()
    provider = m.provider.CloudProvider(m.fake.FakeCloud(), four_types(m))
    cluster = m.cluster.Cluster()
    pools = [m.objects.NodePool(disruption=m.objects.Disruption(
        consolidation_policy="WhenUnderutilized"))]
    rng = np.random.default_rng(11)
    cluster.add_pods([m.objects.Pod(requests=R.ResourceList(
        {R.CPU: int(rng.integers(200, 1500)),
         R.MEMORY: int(rng.integers(256, 2048)) * 2 ** 20}))
        for _ in range(n_pods)])
    prov = m.provisioning.Provisioner(provider, cluster, pools)
    assert not prov.provision().unschedulable
    keep = set()
    for p in sorted(cluster.pods.values(), key=lambda p: p.name):
        if p.node_name in keep:
            cluster.delete_pod(p)
        else:
            keep.add(p.node_name)
    ctrl = m.disruption.DisruptionController(
        provider, cluster, pools, clock=lambda: 1e10, stabilization_s=0.0)
    ctrl.reconcile()
    traces = {t["name"]: t for t in tr.traces()}
    tr.reset()
    return traces["provision"], traces["disruption.reconcile"]


def test_span_trees_equal_the_reference():
    """Names, nesting, annotation keys and device_calls of one
    provisioning round (the classpack path: 300 pods) and one
    consolidation tick."""
    ref = provision_and_consolidate(REF)
    with port_on_cpu():
        port = provision_and_consolidate(PORT)
    assert [tree(t) for t in port] == [tree(t) for t in ref]
    prov, tick = port
    names = []

    def walk(t):
        names.append(t["name"])
        for c in t["children"]:
            walk(c)
    walk(prov)
    walk(tick)
    for name in ("provision.round", "solve.tensorize", "solve.pack",
                 "solve.kernel", "solve.decode", "provision.launch",
                 "disruption.candidates", "disruption.consolidation",
                 "sweep.arena", "sweep.prefix"):
        assert name in names, name


def test_disabled_tracer_records_nothing_on_the_solve_path():
    """`TRACER.enabled = False` (the cost measurement's off side): the
    same provisioning round yields the shared no-op span and no trace."""
    tr = PORT.tracing.TRACER
    try:
        tr.enabled = False
        tr.reset()
        with port_on_cpu():
            with PORT.tracing.span("provision") as sp:
                assert sp is PORT.tracing.NULL_SPAN
            m = PORT
            R = m.resources
            provider = m.provider.CloudProvider(m.fake.FakeCloud(),
                                                four_types(m))
            cluster = m.cluster.Cluster()
            cluster.add_pods([m.objects.Pod(requests=R.ResourceList(
                {R.CPU: 500, R.MEMORY: 512 * 2 ** 20})) for _ in range(20)])
            prov = m.provisioning.Provisioner(provider, cluster,
                                              [m.objects.NodePool()])
            assert not prov.provision().unschedulable
        assert tr.traces() == []
    finally:
        tr.enabled = True
        tr.reset()
