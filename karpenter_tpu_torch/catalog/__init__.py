from .instancetype import (InstanceType, InstanceTypeInfo, Offering,
                           new_instance_type, compute_requirements,
                           eni_limited_pods, max_pods, kube_reserved,
                           system_reserved, eviction_threshold,
                           DEFAULT_MAX_PODS, VM_MEMORY_OVERHEAD_PERCENT, MiB, GiB)
from .generate import generate_catalog
