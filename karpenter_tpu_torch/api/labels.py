"""Well-known scheduling labels.

Mirrors the reference's label surface (karpenter-core `apis/v1beta1` well-known
labels plus the AWS provider labels computed at
karpenter:pkg/providers/instancetype/types.go:75-155), renamed to this
framework's domain.
"""

# Core well-known labels (identical semantics to upstream Kubernetes/karpenter).
ARCH = "kubernetes.io/arch"
OS = "kubernetes.io/os"
INSTANCE_TYPE = "node.kubernetes.io/instance-type"
ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"
CAPACITY_TYPE = "karpenter.sh/capacity-type"
NODEPOOL = "karpenter.sh/nodepool"
NODE_INITIALIZED = "karpenter.sh/initialized"
DISRUPTION_TAINT_KEY = "karpenter.sh/disruption"  # value "disrupting", effect NoSchedule

# Capacity types.
CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"

# Provider (catalog) labels — analog of the karpenter.k8s.aws/* label family
# (karpenter:pkg/apis/v1beta1/labels.go).
_P = "karpenter.tpu.cloud"
INSTANCE_CATEGORY = f"{_P}/instance-category"
INSTANCE_FAMILY = f"{_P}/instance-family"
INSTANCE_GENERATION = f"{_P}/instance-generation"
INSTANCE_SIZE = f"{_P}/instance-size"
INSTANCE_CPU = f"{_P}/instance-cpu"
INSTANCE_MEMORY = f"{_P}/instance-memory"          # MiB
INSTANCE_NETWORK_BANDWIDTH = f"{_P}/instance-network-bandwidth"  # Mbps
INSTANCE_GPU_COUNT = f"{_P}/instance-gpu-count"
INSTANCE_GPU_NAME = f"{_P}/instance-gpu-name"
INSTANCE_GPU_MEMORY = f"{_P}/instance-gpu-memory"  # MiB
INSTANCE_ACCELERATOR_COUNT = f"{_P}/instance-accelerator-count"
INSTANCE_LOCAL_NVME = f"{_P}/instance-local-nvme"  # GiB
INSTANCE_HYPERVISOR = f"{_P}/instance-hypervisor"
INSTANCE_ENCRYPTION_IN_TRANSIT = f"{_P}/instance-encryption-in-transit-supported"

WELL_KNOWN = frozenset({
    ARCH, OS, INSTANCE_TYPE, ZONE, HOSTNAME, CAPACITY_TYPE, NODEPOOL,
    INSTANCE_CATEGORY, INSTANCE_FAMILY, INSTANCE_GENERATION, INSTANCE_SIZE,
    INSTANCE_CPU, INSTANCE_MEMORY, INSTANCE_NETWORK_BANDWIDTH,
    INSTANCE_GPU_COUNT, INSTANCE_GPU_NAME, INSTANCE_GPU_MEMORY,
    INSTANCE_ACCELERATOR_COUNT, INSTANCE_LOCAL_NVME, INSTANCE_HYPERVISOR,
    INSTANCE_ENCRYPTION_IN_TRANSIT,
})

# Restricted label domains users may not set directly (validation parity with
# the reference's webhook rules).
RESTRICTED_DOMAINS = ("karpenter.sh", "kubernetes.io", _P)
