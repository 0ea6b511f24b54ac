"""Namespaces of either package's classes for the arena and ingest parity
tests (tests/test_torch_arena.py, test_torch_ingest.py): the same case code
builds its fixture from `REF` (the JAX package, made by those files with
`package_kit("karpenter_tpu", ...)`) or `PORT` (the port, its solves on the
CPU), and a kit's `reset_counters` restarts its package's module-global
name counters so both sides name their objects alike.  This file imports
the port alone."""

import importlib
import itertools
from types import SimpleNamespace

from karpenter_tpu_torch import convert
from karpenter_tpu_torch.api import objects as port_objects
from karpenter_tpu_torch.api.resources import CPU, MEMORY, PODS, ResourceList

# kit attribute → (module under the package, name in it)
_CLASSES = dict(
    FakeCloud=("cloud", "FakeCloud"), CloudProvider=("cloud", "CloudProvider"),
    Cluster=("state", "Cluster"), Provisioner=("controllers", "Provisioner"),
    DisruptionController=("controllers.disruption", "DisruptionController"),
    SimulationArena=("ops.tensorize", "SimulationArena"),
    IngestBatcher=("state.ingest", "IngestBatcher"),
    NodePool=("api.objects", "NodePool"),
    Disruption=("api.objects", "Disruption"), Node=("api.objects", "Node"),
    ResourceList=("api.resources", "ResourceList"),
    Taint=("api.taints", "Taint"), Toleration=("api.taints", "Toleration"),
    AXES=("api.resources", "DEFAULT_AXES"),
    SCALES=("api.resources", "DEFAULT_SCALES"))


def package_kit(package, **own):
    """The kit of `package`: its classes by the same names in either
    package, plus `own` (name, pod, catalog, extra, reset_counters)."""
    kit = {k: getattr(importlib.import_module(f"{package}.{mod}"), attr)
           for k, (mod, attr) in _CLASSES.items()}
    kit["wk"] = importlib.import_module(f"{package}.api.labels")
    return SimpleNamespace(**kit, **own)


def port_cpu_pod(cpu_m=500, mem_mib=512, **kw):
    return port_objects.Pod(
        requests=ResourceList({CPU: cpu_m, MEMORY: mem_mib * 2**20}), **kw)


def _reset_port_counters() -> None:
    from karpenter_tpu_torch.cloud import queue
    from karpenter_tpu_torch.state import cluster
    port_objects._ids = itertools.count()
    cluster._names = itertools.count(1)
    queue._msg_ids = itertools.count(1)


def port_kit(reference_catalog):
    """The port's kit; its catalog is `reference_catalog()` carried across
    by `convert`, so both sides solve over the same instance types."""
    return package_kit(
        "karpenter_tpu_torch", name="port", pod=port_cpu_pod,
        catalog=lambda: convert.catalog_from_objects(reference_catalog()),
        extra={"device": "cpu"}, reset_counters=_reset_port_counters)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def step(self, dt):
        self.t += dt


def plain_node(kit, i, name=None):
    """tests/test_ingest.py's fixed-size node, from `kit`'s classes."""
    return kit.Node(name=name or f"ing-{i:03d}",
                    allocatable=kit.ResourceList(
                        {CPU: 4000, MEMORY: 8 * 2 ** 30, PODS: 110}),
                    labels={kit.wk.INSTANCE_TYPE: "a.medium",
                            kit.wk.ZONE: "zone-a"})


def launch_positions(cluster, nodes):
    """Each node's position in the cluster's registration order: the
    identity of a node across packages (names come from counters)."""
    order = {name: i for i, name in enumerate(cluster.nodes)}
    return [order[n.name] for n in nodes]
