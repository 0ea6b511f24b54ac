"""Instance-type catalog: InstanceType, Offering, overhead math.

Re-implements the semantics of the reference's instancetype provider types
(karpenter:pkg/providers/instancetype/types.go:53-416 and offering
construction at karpenter:pkg/providers/instancetype/instancetype.go:144-175):
capacity (cpu/mem/storage/pods/accelerators), overhead (kube-reserved /
system-reserved / eviction threshold), ~25 requirement labels, and per
(zone × capacity-type) priced offerings with ICE-driven availability.

A copy of the JAX package's `catalog/instancetype.py`: the dense projection
the solver kernels consume is built in karpenter_tpu_torch.ops.tensorize;
this module is the host-side source of truth.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from ..api import labels as wk
from ..api.requirements import IN, Requirement, Requirements
from ..api.resources import (CPU, EPHEMERAL_STORAGE, GPU, MEMORY, NEURON,
                             PODS, POD_ENI, ResourceList)
from ..api.objects import KubeletConfiguration

DEFAULT_MAX_PODS = 110
# Memory the hypervisor/VM steals from the advertised figure; reference
# default 7.5% (karpenter:pkg/operator/options/options.go vm-memory-overhead-percent).
VM_MEMORY_OVERHEAD_PERCENT = 0.075

MiB = 2**20
GiB = 2**30


@dataclass
class Offering:
    """One purchasable (zone × capacity-type) of an instance type
    (karpenter:pkg/providers/instancetype/instancetype.go:144-175)."""
    zone: str
    capacity_type: str  # spot | on-demand
    price: float        # $/hour
    available: bool = True

    @property
    def key(self) -> Tuple[str, str]:
        return (self.capacity_type, self.zone)


@dataclass
class InstanceTypeInfo:
    """Raw catalog row (analog of ec2.InstanceTypeInfo as consumed at
    karpenter:pkg/providers/instancetype/types.go:53-72)."""
    name: str
    cpu_m: int                     # millicores
    memory_bytes: int              # advertised memory
    arch: str = "amd64"
    os: Tuple[str, ...] = ("linux",)
    family: str = ""
    size: str = ""
    category: str = ""
    generation: int = 0
    gpu_count: int = 0
    gpu_name: str = ""
    gpu_memory_bytes: int = 0
    neuron_count: int = 0
    network_interfaces: int = 4
    ips_per_interface: int = 15
    network_bandwidth_mbps: int = 1000
    local_nvme_gib: int = 0
    hypervisor: str = "nitro"
    encryption_in_transit: bool = True
    bare_metal: bool = False
    on_demand_price: float = 0.0   # base price; offerings may override per zone

    def __post_init__(self):
        if not self.family and "." in self.name:
            self.family, self.size = self.name.split(".", 1)
        if not self.category:
            self.category = self.family[:1] if self.family else "g"


def eni_limited_pods(info: InstanceTypeInfo, reserved_enis: int = 0) -> int:
    """max_enis * (ips_per_eni - 1) + 2
    (karpenter:pkg/providers/instancetype/types.go:304-318)."""
    usable = max(info.network_interfaces - reserved_enis, 0)
    if usable == 0:
        return 0
    return usable * (info.ips_per_interface - 1) + 2


def max_pods(info: InstanceTypeInfo, kubelet: Optional[KubeletConfiguration] = None,
             eni_limited_density: bool = False, reserved_enis: int = 0) -> int:
    """Pod-capacity resolution order: kubelet.maxPods → ENI-limited formula →
    110; podsPerCore caps the result
    (karpenter:pkg/providers/instancetype/types.go:401-416)."""
    if kubelet and kubelet.max_pods is not None:
        count = kubelet.max_pods
    elif eni_limited_density:
        count = eni_limited_pods(info, reserved_enis)
    else:
        count = DEFAULT_MAX_PODS
    if kubelet and kubelet.pods_per_core:
        count = min(kubelet.pods_per_core * max(info.cpu_m // 1000, 1), count)
    return count


def kube_reserved(cpu_m: int, pod_count: int,
                  kubelet: Optional[KubeletConfiguration] = None) -> ResourceList:
    """Graduated CPU reservation + 11Mi/pod + 255Mi memory + 1Gi storage
    (karpenter:pkg/providers/instancetype/types.go:332-367)."""
    reserved_cpu = 0.0
    for start, end, pct in ((0, 1000, 0.06), (1000, 2000, 0.01),
                            (2000, 4000, 0.005), (4000, 1 << 31, 0.0025)):
        if cpu_m > start:
            reserved_cpu += (min(cpu_m, end) - start) * pct
    out = ResourceList({
        CPU: int(reserved_cpu),
        MEMORY: (11 * pod_count + 255) * MiB,
        EPHEMERAL_STORAGE: 1 * GiB,
    })
    if kubelet and kubelet.kube_reserved:
        out.update(kubelet.kube_reserved)
    return out


def system_reserved(kubelet: Optional[KubeletConfiguration] = None) -> ResourceList:
    return ResourceList(kubelet.system_reserved) if kubelet and kubelet.system_reserved else ResourceList()


def eviction_threshold(memory_bytes: int, storage_bytes: int,
                       kubelet: Optional[KubeletConfiguration] = None) -> ResourceList:
    """100Mi memory + 10% storage hard-eviction defaults, kubelet overrides
    (karpenter:pkg/providers/instancetype/types.go:370-399): the
    MAX across eviction signals (hard vs soft) per resource, and that
    maximum REPLACES the default — an operator configuring a threshold
    below 100Mi gets exactly what they configured (the old max-with-
    default rule silently kept the default; review r5 golden cases)."""
    out = ResourceList({MEMORY: 100 * MiB,
                        EPHEMERAL_STORAGE: int(math.ceil(storage_bytes / 10))})
    if kubelet:
        override = ResourceList()
        for signal in (kubelet.eviction_hard, kubelet.eviction_soft):
            for k, v in (signal or {}).items():
                override[k] = max(override.get(k, 0), v)
        out.update(override)
    return out


@dataclass
class InstanceType:
    """The solver's catalog unit (karpenter:pkg/providers/instancetype/types.go:53-72):
    name + requirements + priced offerings + capacity + overhead."""
    name: str
    requirements: Requirements
    offerings: List[Offering]
    capacity: ResourceList
    kube_reserved: ResourceList = field(default_factory=ResourceList)
    system_reserved: ResourceList = field(default_factory=ResourceList)
    eviction_threshold: ResourceList = field(default_factory=ResourceList)
    info: Optional[InstanceTypeInfo] = None

    @cached_property
    def overhead_total(self) -> ResourceList:
        return self.kube_reserved + self.system_reserved + self.eviction_threshold

    @cached_property
    def allocatable(self) -> ResourceList:
        return (self.capacity - self.overhead_total).clamp_nonnegative()

    def cheapest_offering(self, zones: Optional[set] = None,
                          capacity_types: Optional[set] = None) -> Optional[Offering]:
        best = None
        for o in self.offerings:
            if not o.available:
                continue
            if zones and o.zone not in zones:
                continue
            if capacity_types and o.capacity_type not in capacity_types:
                continue
            if best is None or o.price < best.price:
                best = o
        return best

    def available_offerings(self) -> List[Offering]:
        return [o for o in self.offerings if o.available]


def compute_requirements(info: InstanceTypeInfo, offerings: Sequence[Offering]) -> Requirements:
    """The ~25 instance labels the scheduler matches against
    (karpenter:pkg/providers/instancetype/types.go:75-155)."""
    zones = sorted({o.zone for o in offerings if o.available})
    cap_types = sorted({o.capacity_type for o in offerings if o.available})
    reqs = Requirements.of(
        Requirement(wk.INSTANCE_TYPE, IN, [info.name]),
        Requirement(wk.ARCH, IN, [info.arch]),
        Requirement(wk.OS, IN, list(info.os)),
        Requirement(wk.ZONE, IN, zones),
        Requirement(wk.CAPACITY_TYPE, IN, cap_types),
        Requirement(wk.INSTANCE_CATEGORY, IN, [info.category]),
        Requirement(wk.INSTANCE_FAMILY, IN, [info.family]),
        Requirement(wk.INSTANCE_GENERATION, IN, [str(info.generation)]),
        Requirement(wk.INSTANCE_SIZE, IN, [info.size]),
        Requirement(wk.INSTANCE_CPU, IN, [str(info.cpu_m // 1000)]),
        Requirement(wk.INSTANCE_MEMORY, IN, [str(info.memory_bytes // MiB)]),
        Requirement(wk.INSTANCE_NETWORK_BANDWIDTH, IN, [str(info.network_bandwidth_mbps)]),
        Requirement(wk.INSTANCE_HYPERVISOR, IN, [info.hypervisor]),
        Requirement(wk.INSTANCE_ENCRYPTION_IN_TRANSIT, IN, [str(info.encryption_in_transit).lower()]),
    )
    if info.gpu_count:
        reqs.add(Requirement(wk.INSTANCE_GPU_COUNT, IN, [str(info.gpu_count)]),
                 Requirement(wk.INSTANCE_GPU_NAME, IN, [info.gpu_name]),
                 Requirement(wk.INSTANCE_GPU_MEMORY, IN, [str(info.gpu_memory_bytes // MiB)]))
    if info.neuron_count:
        reqs.add(Requirement(wk.INSTANCE_ACCELERATOR_COUNT, IN, [str(info.neuron_count)]))
    if info.local_nvme_gib:
        reqs.add(Requirement(wk.INSTANCE_LOCAL_NVME, IN, [str(info.local_nvme_gib)]))
    return reqs


def apply_kubelet(it: "InstanceType",
                  kubelet: Optional[KubeletConfiguration]) -> "InstanceType":
    """Re-derive the kubelet-dependent pieces of an existing type — pod
    density, kube/system reserves, eviction thresholds — keeping every
    non-kubelet knob (VM overhead shave, block device size, ENI density
    mode) exactly as the catalog built it.  The per-NodePool analog of the
    reference rebuilding its InstanceType list per kubelet hash
    (karpenter:pkg/providers/instancetype/instancetype.go:114-124,
    types.go:53-72)."""
    if kubelet is None or kubelet.key() is None:
        return it
    base_pods = int(it.capacity.get(PODS, DEFAULT_MAX_PODS))
    cpu_m = it.info.cpu_m if it.info is not None else int(it.capacity.get(CPU, 0))
    pod_count = kubelet.max_pods if kubelet.max_pods is not None else base_pods
    if kubelet.pods_per_core:
        pod_count = min(
            kubelet.pods_per_core * max(cpu_m // 1000, 1), pod_count)
    capacity = ResourceList(it.capacity)
    capacity[PODS] = pod_count
    return InstanceType(
        name=it.name,
        requirements=it.requirements,
        offerings=it.offerings,
        capacity=capacity,
        kube_reserved=kube_reserved(cpu_m, pod_count, kubelet),
        system_reserved=system_reserved(kubelet),
        eviction_threshold=eviction_threshold(
            int(it.capacity.get(MEMORY, 0)),
            int(it.capacity.get(EPHEMERAL_STORAGE, 0)), kubelet),
        info=it.info,
    )


def root_volume_gib(nodeclass) -> Optional[int]:
    """The boot volume size a node of this nodeclass actually gets: the
    root mapping's ebs.volumeSize when blockDeviceMappings are set
    (reference derives ephemeral-storage from the mapped root volume),
    else block_device_gib; None for no nodeclass."""
    if nodeclass is None:
        return None
    for m in nodeclass.block_device_mappings:
        size = (m.get("ebs") or {}).get("volumeSize")
        if size is not None:
            from ..api.resources import EPHEMERAL_STORAGE, parse_quantity
            return max(1, int(parse_quantity(size, EPHEMERAL_STORAGE) // GiB))
    return int(nodeclass.block_device_gib)


def apply_storage(it: "InstanceType", root_gib: Optional[int]) -> "InstanceType":
    """Re-derive ephemeral-storage capacity (and its 10% hard-eviction
    share) for a different boot volume size, keeping everything else."""
    if root_gib is None or int(it.capacity.get(EPHEMERAL_STORAGE, 0)) == \
            root_gib * GiB:
        return it
    storage = root_gib * GiB
    capacity = ResourceList(it.capacity)
    capacity[EPHEMERAL_STORAGE] = storage
    eviction = ResourceList(it.eviction_threshold)
    eviction[EPHEMERAL_STORAGE] = int(math.ceil(storage / 10))
    return InstanceType(
        name=it.name, requirements=it.requirements, offerings=it.offerings,
        capacity=capacity, kube_reserved=it.kube_reserved,
        system_reserved=it.system_reserved, eviction_threshold=eviction,
        info=it.info)


def effective_instance_type(it: "InstanceType", pool,
                            nodeclass=None) -> "InstanceType":
    """The type as a node of `pool` actually presents it: boot-volume
    storage from the pool's nodeclass, then kubelet-adjusted density and
    reserves (either may be None/default — unknown pools register with the
    catalog's own math).  The one helper every registration site AND the
    solver's per-pool catalog columns share, so node allocatable always
    matches what the solver packed against."""
    it = apply_storage(it, root_volume_gib(nodeclass))
    if pool is None:
        return it
    return apply_kubelet(it, pool.template.kubelet)


def new_instance_type(info: InstanceTypeInfo, offerings: Sequence[Offering],
                      kubelet: Optional[KubeletConfiguration] = None,
                      block_device_gib: int = 20,
                      vm_memory_overhead_percent: float = VM_MEMORY_OVERHEAD_PERCENT,
                      eni_limited_density: bool = False,
                      reserved_enis: int = 0) -> InstanceType:
    """Factory mirroring NewInstanceType
    (karpenter:pkg/providers/instancetype/types.go:53-72): capacity from
    the catalog row (memory shaved by the VM overhead percent), overhead from
    the kubelet config, requirements from the labels."""
    pod_count = max_pods(info, kubelet, eni_limited_density, reserved_enis)
    storage = block_device_gib * GiB
    mem = int(info.memory_bytes * (1 - vm_memory_overhead_percent))
    capacity = ResourceList({
        CPU: info.cpu_m, MEMORY: mem, EPHEMERAL_STORAGE: storage, PODS: pod_count,
    })
    if info.gpu_count:
        capacity[GPU] = info.gpu_count
    if info.neuron_count:
        capacity[NEURON] = info.neuron_count
    if info.network_interfaces:
        capacity[POD_ENI] = max(info.network_interfaces - reserved_enis, 0)
    return InstanceType(
        name=info.name,
        requirements=compute_requirements(info, offerings),
        offerings=list(offerings),
        capacity=capacity,
        kube_reserved=kube_reserved(info.cpu_m, pod_count, kubelet),
        system_reserved=system_reserved(kubelet),
        eviction_threshold=eviction_threshold(mem, storage, kubelet),
        info=info,
    )
