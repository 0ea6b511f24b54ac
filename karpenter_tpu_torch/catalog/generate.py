"""Synthetic instance-type catalog generator.

Stands in for the reference's generated data tables
(karpenter:pkg/providers/instancetype/zz_generated.vpclimits.go and the
DescribeInstanceTypes path at
karpenter:pkg/providers/instancetype/instancetype.go:241-278): a
deterministic catalog of ~600-700 types across general/compute/memory
families, burstable, storage/network variants, and accelerator families,
offered in N zones × {on-demand, spot} with size-proportional pricing.

A copy of the JAX package's generator: the same arguments give the same
catalog, so the port and the reference tensorize identical columns."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .instancetype import GiB, InstanceType, InstanceTypeInfo, Offering, new_instance_type

DEFAULT_ZONES = ("zone-a", "zone-b", "zone-c")

# family → (memory per vcpu GiB, $/vcpu-hour base)
_FAMILIES = {
    "c": (2, 0.0425),   # compute optimized
    "m": (4, 0.0480),   # general purpose
    "r": (8, 0.0630),   # memory optimized
    "i": (8, 0.0780),   # storage optimized (always local nvme)
    "x": (16, 0.1670),  # high-memory
}
_VARIANTS = {          # price multiplier, network multiplier
    "": (1.00, 1.0),
    "a": (0.90, 1.0),  # alt-silicon discount
    "d": (1.13, 1.0),  # local nvme
    "n": (1.25, 4.0),  # network optimized
    "i": (1.08, 1.0),
}
_SIZES = {             # size → vcpus
    "large": 2, "xlarge": 4, "2xlarge": 8, "4xlarge": 16,
    "8xlarge": 32, "12xlarge": 48, "16xlarge": 64, "24xlarge": 96,
    "48xlarge": 192,
}
_GENERATIONS = (4, 5, 6, 7)

# accelerator families: name → (gpus per size map, vcpu/gpu, mem GiB/gpu, $/gpu-hr, gpu name)
_GPU_FAMILIES = {
    "g5": ({"xlarge": 1, "2xlarge": 1, "4xlarge": 1, "12xlarge": 4, "24xlarge": 4, "48xlarge": 8},
           4, 16, 1.006, "a10g"),
    "p4d": ({"24xlarge": 8}, 12, 96, 4.096, "a100"),
    "p5": ({"48xlarge": 8}, 24, 128, 12.29, "h100"),
}


def generate_infos(zones: Sequence[str] = DEFAULT_ZONES) -> List[InstanceTypeInfo]:
    infos: List[InstanceTypeInfo] = []
    for fam, (mem_ratio, base) in _FAMILIES.items():
        for gen in _GENERATIONS:
            for var, (pmult, nmult) in _VARIANTS.items():
                if fam in ("i", "x") and var not in ("", "n"):
                    continue  # niche families ship fewer variants
                for size, vcpus in _SIZES.items():
                    name = f"{fam}{gen}{var}.{size}"
                    gen_mult = 1.0 - 0.02 * (7 - gen)
                    infos.append(InstanceTypeInfo(
                        name=name, cpu_m=vcpus * 1000,
                        memory_bytes=vcpus * mem_ratio * GiB,
                        family=f"{fam}{gen}{var}", size=size, category=fam,
                        generation=gen,
                        network_interfaces=min(4 + vcpus // 16, 8),
                        ips_per_interface=15,
                        network_bandwidth_mbps=int(625 * vcpus * nmult),
                        local_nvme_gib=vcpus * 75 if var == "d" or fam == "i" else 0,
                        on_demand_price=round(vcpus * base * pmult * gen_mult, 4),
                    ))
    # bare-metal flagships (filtered from launch paths unless explicitly
    # required, mirroring the reference's exotic-type filter instance.go:416-424)
    for fam, (mem_ratio, base) in _FAMILIES.items():
        infos.append(InstanceTypeInfo(
            name=f"{fam}7.metal", cpu_m=96_000, memory_bytes=96 * mem_ratio * GiB,
            family=f"{fam}7", size="metal", category=fam, generation=7,
            hypervisor="", bare_metal=True, network_interfaces=8,
            ips_per_interface=30, network_bandwidth_mbps=100_000,
            on_demand_price=round(96 * base * 1.05, 4)))
    # burstable family
    for size, vcpus in (("micro", 2), ("small", 2), ("medium", 2),
                        ("large", 2), ("xlarge", 4), ("2xlarge", 8)):
        mem = {"micro": 1, "small": 2, "medium": 4}.get(size, vcpus * 4)
        infos.append(InstanceTypeInfo(
            name=f"t3.{size}", cpu_m=vcpus * 1000, memory_bytes=mem * GiB,
            family="t3", size=size, category="t", generation=3,
            network_interfaces=3, ips_per_interface=6,
            network_bandwidth_mbps=5000,
            on_demand_price=round(0.0052 * vcpus * max(mem, 1), 4)))
    # accelerated
    for fam, (sizes, vcpu_per, mem_per, gpu_price, gpu_name) in _GPU_FAMILIES.items():
        for size, gpus in sizes.items():
            vcpus = max(int(size.rstrip("xlarge") or 1) * 4, 4)
            vcpus = max(vcpus, gpus * vcpu_per)
            infos.append(InstanceTypeInfo(
                name=f"{fam}.{size}", cpu_m=vcpus * 1000,
                memory_bytes=gpus * mem_per * GiB + vcpus * 2 * GiB,
                family=fam, size=size, category="g" if fam.startswith("g") else "p",
                generation=5, gpu_count=gpus, gpu_name=gpu_name,
                gpu_memory_bytes=24 * GiB,
                network_interfaces=8, ips_per_interface=30,
                network_bandwidth_mbps=100_000,
                on_demand_price=round(gpus * gpu_price + vcpus * 0.02, 4)))
    return infos


def zonal_price_skew(zone: str) -> float:
    """Deterministic small per-zone price variation (spot markets differ by AZ)."""
    return 1.0 + 0.015 * (sum(map(ord, zone)) % 5)


def generate_catalog(n_types: Optional[int] = None,
                     zones: Sequence[str] = DEFAULT_ZONES,
                     spot: bool = True,
                     spot_discount: float = 0.65,
                     kubelet=None) -> List[InstanceType]:
    """Build `n_types` InstanceTypes (None == all ~700)."""
    infos = generate_infos(zones)
    if n_types is not None and n_types < len(infos):
        # spread selection across the whole catalog (preserves family
        # diversity incl. the accelerator tail) deterministically
        idx = [round(i * (len(infos) - 1) / (n_types - 1)) for i in range(n_types)] \
            if n_types > 1 else [0]
        infos = [infos[i] for i in dict.fromkeys(idx)]
    out = []
    for info in infos:
        offerings = []
        for z in zones:
            offerings.append(Offering(z, "on-demand", info.on_demand_price))
            if spot:
                offerings.append(Offering(
                    z, "spot",
                    round(info.on_demand_price * (1 - spot_discount) * zonal_price_skew(z), 4)))
        out.append(new_instance_type(info, offerings, kubelet=kubelet))
    return out
