"""Core API objects, trimmed to what the solve, consolidation and
provisioning paths need: Pod, PodDisruptionBudget, Node, NodeClaim,
NodePool (with its template, kubelet and disruption blocks), NodeClass,
`pool_view` and the pod-side topology terms.

A copy of the JAX package's `api/objects.py` without the serializer,
legacy and admission surfaces.  Plain dataclasses; all device-side math
happens on tensorized projections of these (karpenter_tpu_torch.ops.tensorize),
never on the objects themselves.
"""

from __future__ import annotations

import itertools
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import labels as wk
from .requirements import IN, Requirement, Requirements
from .resources import ResourceList
from .taints import Taint, Toleration

_ids = itertools.count()


def _uid(prefix: str) -> str:
    return f"{prefix}-{next(_ids):08x}"


@dataclass
class TopologySpreadConstraint:
    """K8s topologySpreadConstraint (reference scheduling surface:
    karpenter:website/content/en/docs/concepts/scheduling.md topology
    section). Only the scheduler-relevant fields."""
    topology_key: str                    # zone / hostname / capacity-type
    max_skew: int = 1
    when_unsatisfiable: str = "DoNotSchedule"  # or ScheduleAnyway
    label_selector: Dict[str, str] = field(default_factory=dict)
    min_domains: Optional[int] = None


@dataclass
class PodAffinityTerm:
    """Pod (anti-)affinity term over a topology domain."""
    topology_key: str
    label_selector: Dict[str, str] = field(default_factory=dict)
    anti: bool = False
    required: bool = True


@dataclass
class Pod:
    name: str = ""
    namespace: str = "default"
    requests: ResourceList = field(default_factory=ResourceList)
    # container limits, summed like requests (empty == none declared);
    # feeds the karpenter_nodes_total_pod_limits/_daemon_limits gauges —
    # the solver packs on requests, as the kube-scheduler does
    limits: ResourceList = field(default_factory=ResourceList)
    node_selector: Dict[str, str] = field(default_factory=dict)
    # Required node-affinity: list of OR'd terms, each term a Requirements AND-set.
    required_affinity_terms: List[Requirements] = field(default_factory=list)
    preferred_affinity_terms: List[Tuple[int, Requirements]] = field(default_factory=list)
    tolerations: List[Toleration] = field(default_factory=list)
    topology_spread: List[TopologySpreadConstraint] = field(default_factory=list)
    pod_affinities: List[PodAffinityTerm] = field(default_factory=list)
    # PV topology: zones the pod's persistent volumes restrict it to
    # (reference scheduling surface "persistent volume topology";
    # [] == unconstrained)
    volume_zones: List[str] = field(default_factory=list)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    priority: int = 0
    # gang scheduling (GangScheduling gate, ops/gang.py): pods sharing a
    # non-empty gang_name form an all-or-nothing unit of gang_size members
    # — every member binds in one solve within one topology domain
    # (gang_topology: "zone" | "hostname") or none do.  gang_tier is the
    # preemption tier: a rejected higher-tier gang may evict bound pods of
    # strictly lower tiers.  Defaults leave non-gang pods untouched.
    gang_name: str = ""
    gang_size: int = 0
    gang_tier: int = 0
    gang_topology: str = "zone"
    deletion_cost: int = 0               # pod-deletion-cost annotation analog
    owner_kind: str = "ReplicaSet"       # "" == ownerless (blocks consolidation)
    node_name: str = ""                  # bound node ("" == pending)
    uid: str = field(default_factory=lambda: _uid("pod"))
    created_at: float = field(default_factory=time.time)  # arrival (bind-latency input)

    DO_NOT_DISRUPT = "karpenter.sh/do-not-disrupt"

    def __post_init__(self):
        if not self.name:
            self.name = self.uid

    def scheduling_requirements(self) -> List[Requirements]:
        """nodeSelector ∧ (OR over required affinity terms), each branch a
        Requirements set — the pod-side input to compatibility masking."""
        base = Requirements.from_labels(self.node_selector)
        if self.volume_zones:
            base = base.union(Requirements.of(
                Requirement(wk.ZONE, IN, self.volume_zones)))
        if not self.required_affinity_terms:
            return [base]
        return [base.union(term) for term in self.required_affinity_terms]

    @property
    def do_not_disrupt(self) -> bool:
        return self.annotations.get(self.DO_NOT_DISRUPT, "") == "true"

    @property
    def is_daemon(self) -> bool:
        """DaemonSet pods are not reschedulable: they die with their node
        and never block or justify capacity decisions."""
        return self.owner_kind == "DaemonSet"


@dataclass
class PodDisruptionBudget:
    """Voluntary-disruption budget over a pod label selector — the blocker the
    reference's consolidation and termination flows honor
    (karpenter:designs/consolidation.md:44-52, eviction API drain at
    karpenter:website/content/en/docs/concepts/disruption.md:27-35).
    `min_available` / `max_unavailable` accept an absolute int or "N%"."""
    name: str = ""
    namespace: str = "default"
    selector: Dict[str, str] = field(default_factory=dict)
    min_available: Optional[object] = None
    max_unavailable: Optional[object] = None

    def __post_init__(self):
        if not self.name:
            self.name = _uid("pdb")

    def matches(self, pod: "Pod") -> bool:
        return (pod.namespace == self.namespace
                and all(pod.labels.get(k) == v for k, v in self.selector.items()))

    @staticmethod
    def _resolve(value, total: int) -> int:
        if isinstance(value, str) and value.endswith("%"):
            return math.ceil(total * float(value[:-1]) / 100.0)
        return int(value)

    def allowed_disruptions(self, matching_healthy: int, matching_total: int) -> int:
        """How many more matching pods may be voluntarily evicted right now."""
        if self.min_available is not None:
            floor = self._resolve(self.min_available, matching_total)
            return max(0, matching_healthy - floor)
        if self.max_unavailable is not None:
            cap = self._resolve(self.max_unavailable, matching_total)
            return max(0, cap - (matching_total - matching_healthy))
        return max(0, matching_healthy)  # no constraint


@dataclass
class KubeletConfiguration:
    """Pod-density knobs (karpenter-core v1beta1 KubeletConfiguration; feeds
    the max-pods math at karpenter:pkg/providers/instancetype/types.go:401-416)."""
    max_pods: Optional[int] = None
    pods_per_core: Optional[int] = None
    kube_reserved: ResourceList = field(default_factory=ResourceList)
    system_reserved: ResourceList = field(default_factory=ResourceList)
    eviction_hard: ResourceList = field(default_factory=ResourceList)
    eviction_soft: ResourceList = field(default_factory=ResourceList)
    cluster_dns: tuple = ()  # node DNS resolver list (v4 or v6), primary
                             # first; () == use the discovered kube-dns.
                             # A bare string is accepted and normalized.

    def __post_init__(self):
        if isinstance(self.cluster_dns, str):
            object.__setattr__(self, "cluster_dns",
                               (self.cluster_dns,) if self.cluster_dns else ())
        else:
            object.__setattr__(self, "cluster_dns", tuple(self.cluster_dns))

    def key(self) -> Optional[tuple]:
        """Content key of the density-affecting fields; None when every
        one is default (catalog needs no rebuild).  cluster_dns is
        bootstrap-only — it never changes packing math."""
        if (self.max_pods is None and not self.pods_per_core
                and not self.kube_reserved and not self.system_reserved
                and not self.eviction_hard):
            return None
        return (self.max_pods, self.pods_per_core,
                tuple(sorted(self.kube_reserved.items())),
                tuple(sorted(self.system_reserved.items())),
                tuple(sorted(self.eviction_hard.items())))


@dataclass
class Disruption:
    """NodePool .spec.disruption block (consolidation policy / expiry)."""
    consolidation_policy: str = "WhenUnderutilized"  # or WhenEmpty
    consolidate_after_s: Optional[float] = None       # required for WhenEmpty
    expire_after_s: Optional[float] = None            # None == Never


@dataclass
class NodeClass:
    """Provider config — the analog of EC2NodeClass
    (karpenter:pkg/apis/v1beta1/ec2nodeclass.go:30-113).  The provisioning
    path reads its boot volume (which sets the nodes' ephemeral storage) and
    hashes its launch-affecting fields; the resolved status is written by a
    nodeclass controller, which the port does not have yet."""
    name: str = "default"
    image_family: str = "standard"       # amiFamily analog
    zone_selector: List[str] = field(default_factory=list)  # [] == all zones
    subnet_selector: Dict[str, str] = field(default_factory=dict)
    security_group_selector: Dict[str, str] = field(default_factory=dict)
    # explicit image pin; empty == resolve latest published for the family
    image_selector: Dict[str, str] = field(default_factory=dict)
    role: str = ""
    user_data: str = ""
    tags: Dict[str, str] = field(default_factory=dict)
    block_device_gib: int = 20
    # full block-device surface: list of {deviceName, ebs:{volumeSize, ...}};
    # empty == the single root volume implied by block_device_gib
    block_device_mappings: List[Dict] = field(default_factory=list)
    metadata_options: Dict[str, object] = field(default_factory=dict)
    detailed_monitoring: bool = False
    instance_store_policy: str = ""      # "" | "RAID0"
    associate_public_ip: Optional[bool] = None
    # resolved status
    status_zones: List[str] = field(default_factory=list)
    status_subnets: List[str] = field(default_factory=list)
    status_security_groups: List[str] = field(default_factory=list)
    status_images: List[str] = field(default_factory=list)
    status_instance_profile: str = ""
    hash_annotation: str = ""


@dataclass
class NodePoolTemplate:
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    requirements: Requirements = field(default_factory=Requirements)
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    node_class_ref: str = "default"
    kubelet: KubeletConfiguration = field(default_factory=KubeletConfiguration)


@dataclass
class NodePool:
    name: str = "default"
    template: NodePoolTemplate = field(default_factory=NodePoolTemplate)
    disruption: Disruption = field(default_factory=Disruption)
    limits: ResourceList = field(default_factory=ResourceList)  # empty == unlimited
    weight: int = 0

    def requirements(self) -> Requirements:
        return Requirements.from_labels(self.template.labels).union(
            self.template.requirements).union(
            Requirements.of(Requirement(wk.NODEPOOL, IN, [self.name])))

    def within_limits(self, in_use: ResourceList) -> bool:
        """NodePool-level resource caps (designs/limits.md)."""
        return all(in_use.get(k, 0) < v for k, v in self.limits.items()) if self.limits else True


def pool_view(nodepools) -> Dict[str, "NodePool"]:
    """Normalize a controller's nodepools argument.  A dict is adopted BY
    REFERENCE — the single live registry shared across controllers, so
    applied pools take effect without rebuilds.  A sequence is snapshotted
    (test convenience).  This is the one place that contract lives."""
    if isinstance(nodepools, dict):
        return nodepools
    return {p.name: p for p in nodepools}


@dataclass
class NodeClaim:
    """The unit of provisioning: scheduler emits it, cloud provider fulfils it
    (consumed by Create at karpenter:pkg/cloudprovider/cloudprovider.go:92-118)."""
    nodepool: str
    requirements: Requirements = field(default_factory=Requirements)
    requests: ResourceList = field(default_factory=ResourceList)
    taints: List[Taint] = field(default_factory=list)
    node_class_ref: str = "default"
    node_class_hash: str = ""  # nodeclass static hash at launch (drift input)
    image_id: str = ""         # image the node booted from (image-drift input)
    labels: Dict[str, str] = field(default_factory=dict)
    name: str = field(default_factory=lambda: _uid("nodeclaim"))
    # lifecycle (launch → registered → initialized)
    provider_id: str = ""
    instance_type: str = ""
    zone: str = ""
    capacity_type: str = ""
    price: float = 0.0
    launched_at: float = 0.0
    created_at: float = 0.0  # stamped by the provider's injected clock
    registered: bool = False
    registered_at: float = 0.0
    initialized: bool = False
    initialized_at: float = 0.0
    terminating: bool = False

    @property
    def launched(self) -> bool:
        return bool(self.provider_id)


@dataclass
class Node:
    """Cluster-state view of a live node (karpenter-core state.Cluster node)."""
    name: str
    provider_id: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    allocatable: ResourceList = field(default_factory=ResourceList)
    capacity: ResourceList = field(default_factory=ResourceList)
    pods: List[Pod] = field(default_factory=list)
    nodepool: str = ""
    instance_type: str = ""
    zone: str = ""
    capacity_type: str = ""
    price: float = 0.0
    created_at: float = field(default_factory=time.time)
    nominated_until: float = 0.0         # in-flight pod nominations block disruption
    marked_for_deletion: bool = False

    def requested(self) -> ResourceList:
        out = ResourceList()
        for p in self.pods:
            out = out + p.requests
        return out

    def available(self) -> ResourceList:
        return (self.allocatable - self.requested()).clamp_nonnegative()
