"""The port's metric registry (karpenter_tpu_torch/utils/metrics.py) and its
call sites against the JAX package's.

- tests/test_metrics_wiring.py's 12 cases, test_observability.py's
  registry, exposition, recorder, utils and batcher-wiring cases, and
  test_concurrency.py's `test_counter_histogram_totals_exact`, each on both
  packages (tests/torch_suites.py): the reference's assertions hold on the
  port and the values they compare are equal.
- The same provisioning and disruption run on both packages from fresh
  registries: the exposition texts are equal line for line, apart from
  the samples that hold wall-clock durations (their `_count` samples are
  compared all the same).
- A departure found while restoring the termination controller's
  duration metric: the drain of an ownerless pod tells the demand
  observer (the Forecast gate's series) of its removal, as the
  reference's does.
"""

import re

import numpy as np
import pytest

from torch_cases import clear_lp_caches
from torch_suites import Suite, four_types, package, port_on_cpu
from torch_refnative import reference_native_loaded  # noqa: F401

# a case whose assertions search the whole exposition text, durations
# included: its comparisons are recorded by outcome
WIRING = Suite("test_metrics_wiring",
               outcomes=("test_cluster_collector_refreshes",))
OBSERVABILITY = Suite("test_observability")
CONCURRENCY = Suite("test_concurrency")

# test_observability's cases of the registry and its callers; its tracing
# cases are in tests/test_torch_tracing.py
METRIC_CLASSES = ("TestCounter", "TestGaugeHistogram", "TestExposition",
                  "TestRecorder", "TestUtils", "TestBatcherMetricsWiring")


@pytest.mark.parametrize("case", WIRING.cases())
def test_metrics_wiring(case, request):
    WIRING.both(case, request)


@pytest.mark.parametrize("case", [
    p for p in OBSERVABILITY.cases()
    if p.values[0].split("::")[0] in METRIC_CLASSES])
def test_observability_metrics(case, request):
    OBSERVABILITY.both(case, request)


@pytest.mark.parametrize("case", CONCURRENCY.cases(
    only=("test_counter_histogram_totals_exact",)))
def test_concurrency_metrics(case, request):
    CONCURRENCY.both(case, request)


# ---------------------------------------------------------------------------
# the exposition after the same run
# ---------------------------------------------------------------------------

MODULES = dict(objects="api.objects", resources="api.resources",
               fake="cloud.fake", provider="cloud.provider",
               cluster="state.cluster", provisioning="controllers.provisioning",
               disruption="controllers.disruption",
               termination="controllers.termination",
               metrics="utils.metrics", tracing="utils.tracing",
               harness="sim.harness")

REF = package("karpenter_tpu", **MODULES)
PORT = package("karpenter_tpu_torch", **MODULES)

# families whose samples hold wall-clock durations (or rates of them)
_WALL = re.compile(r"duration|_seconds|speedup")


def run_and_expose(m):
    """Provision 300 pods, thin the fleet out and run two disruption ticks,
    from fresh registries; the exposition text."""
    R = m.resources
    m.harness._reset_global_counters()
    clear_lp_caches(m.name)
    m.metrics.REGISTRY.reset()
    m.tracing.TRACER.reset()
    m.metrics.register_parity_families()
    clock = [1000.0]
    provider = m.provider.CloudProvider(m.fake.FakeCloud(), four_types(m))
    cluster = m.cluster.Cluster(clock=lambda: clock[0])
    pools = [m.objects.NodePool(disruption=m.objects.Disruption(
        consolidation_policy="WhenUnderutilized"))]
    rng = np.random.default_rng(5)
    cluster.add_pods([m.objects.Pod(requests=R.ResourceList(
        {R.CPU: int(rng.integers(200, 1500)),
         R.MEMORY: int(rng.integers(256, 2048)) * 2 ** 20}))
        for _ in range(300)])
    prov = m.provisioning.Provisioner(provider, cluster, pools,
                                      clock=lambda: clock[0])
    res = prov.provision()
    assert not res.unschedulable
    keep = set()
    for p in sorted(cluster.pods.values(), key=lambda p: p.name):
        if p.node_name in keep:
            cluster.delete_pod(p)
        else:
            keep.add(p.node_name)
    ctrl = m.disruption.DisruptionController(
        provider, cluster, pools, clock=lambda: clock[0] + 10_000,
        stabilization_s=0.0)
    for _ in range(2):
        ctrl.reconcile()
        prov.provision()
    return m.metrics.REGISTRY.expose()


def _comparable(text):
    """The exposition's lines, the wall-clock samples reduced to their
    series (a histogram's `_count` is kept whole)."""
    out = []
    for ln in text.splitlines():
        if ln.startswith("#") or not _WALL.search(ln.split("{")[0]):
            out.append(ln)
            continue
        series, _, value = ln.rpartition(" ")
        out.append(ln if series.split("{")[0].endswith("_count")
                   else series)
    return out


def test_exposition_equals_the_reference_after_the_same_run():
    ref = run_and_expose(REF)
    with port_on_cpu():
        port = run_and_expose(PORT)
    ref_lines, port_lines = _comparable(ref), _comparable(port)
    assert [ln for ln in ref_lines if ln not in port_lines] == []
    assert port_lines == ref_lines
    # the run reached the provisioning, disruption and decode families
    for family in ("karpenter_nodes_created", "karpenter_pods_bound_duration"
                   "_seconds_count", "karpenter_nodeclaims_disrupted",
                   "karpenter_disruption_eligible_nodes",
                   "karpenter_trace_span_duration_seconds_count"):
        assert any(ln.startswith(family) for ln in port_lines
                   if not ln.startswith("#")), family


class _Observer:
    def __init__(self):
        self.calls = []

    def pod_added(self, pod):
        self.calls.append(("added", pod.name))

    def pod_removed(self, pod):
        self.calls.append(("removed", pod.name))

    def pod_bound(self, pod):
        self.calls.append(("bound", pod.name))


def test_ownerless_eviction_reaches_the_demand_observer():
    """Draining a node evicts its pods: the owned one is requeued, the
    ownerless one is gone, and the observer hears of that removal."""
    def case(m):
        R = m.resources
        m.harness._reset_global_counters()
        provider = m.provider.CloudProvider(m.fake.FakeCloud(), four_types(m))
        cluster = m.cluster.Cluster(clock=lambda: 1000.0)
        obs = _Observer()
        cluster.observer = obs
        pods = [m.objects.Pod(name=name, owner_kind=owner,
                              requests=R.ResourceList(
                                  {R.CPU: 500, R.MEMORY: 512 * 2 ** 20}))
                for name, owner in (("owned", "ReplicaSet"), ("bare", ""))]
        cluster.add_pods(pods)
        with port_on_cpu():
            prov = m.provisioning.Provisioner(provider, cluster,
                                              [m.objects.NodePool()],
                                              clock=lambda: 1000.0)
            assert not prov.provision().unschedulable
        term = m.termination.TerminationController(provider, cluster,
                                                   clock=lambda: 1000.0)
        for node in list(cluster.nodes.values()):
            term.drain_sync(node)
        return obs.calls, sorted(p.name for p in cluster.pods.values())
    ref, port = case(REF), case(PORT)
    assert ref == port
    assert ("removed", "bare") in port[0] and port[1] == ["owned"]
