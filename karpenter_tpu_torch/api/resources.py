"""Resource quantities and resource-list arithmetic.

A copy of the JAX package's `api/resources.py`, trimmed to what the
solve path and the manifest codecs (`api/serialize.py`) need.  Every ResourceList lowers to a fixed-order dense vector
(`to_vector`) so pod batches and instance-type catalogs become `P×R` / `T×R`
matrices for the CUDA kernels in `karpenter_tpu_torch.ops`.  Canonical
integer units (millicores / bytes / counts) keep the host-side math exact.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

# Canonical resource names (K8s conventions).
CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"
GPU = "gpu.karpenter.tpu/accelerator"  # extended accelerator resource (ref: nvidia.com/gpu)
NEURON = "gpu.karpenter.tpu/inferentia"  # second accelerator class (ref: aws.amazon.com/neuron)
POD_ENI = "networking.karpenter.tpu/pod-eni"  # branch network interfaces (ref: vpc.amazonaws.com/pod-eni)

# Default dense axis order for tensorization.  The first four are always
# present on every instance type; accelerator axes are included so GPU
# bin-packing (BASELINE.json config 3) needs no axis renegotiation.
DEFAULT_AXES: Tuple[str, ...] = (CPU, MEMORY, EPHEMERAL_STORAGE, PODS, GPU, NEURON, POD_ENI)

# Device-side unit scaling: byte-valued axes are lowered in MiB so every
# tensor value stays well inside float32's exact-integer range (2^24) —
# canonical host units (bytes) would silently lose precision in the kernels.
DEFAULT_SCALES: Dict[str, float] = {MEMORY: float(2**20), EPHEMERAL_STORAGE: float(2**20)}

_QUANTITY_RE = re.compile(r"^([+-]?\d+(?:\.\d+)?)([a-zA-Z]*)$")

# Binary and decimal suffix multipliers (K8s resource.Quantity semantics).
_SUFFIX = {
    "": 1,
    "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
}


def parse_quantity(value, resource: str = MEMORY) -> int:
    """Parse a K8s-style quantity into canonical integer units.

    cpu → millicores ("1" → 1000, "100m" → 100); everything else → base units
    (bytes for memory/storage, counts for pods/accelerators).
    """
    if isinstance(value, (int, float)):
        return int(value * 1000) if resource == CPU else int(value)
    s = str(value).strip()
    m = _QUANTITY_RE.match(s)
    if not m:
        raise ValueError(f"unparseable quantity {value!r}")
    num, suffix = float(m.group(1)), m.group(2)
    if resource == CPU:
        if suffix == "m":
            return int(num)
        if suffix == "":
            return int(num * 1000)
        raise ValueError(f"unsupported cpu suffix {suffix!r}")
    if suffix == "m":  # milli-units of a count resource
        return int(num / 1000)
    if suffix not in _SUFFIX:
        raise ValueError(f"unsupported suffix {suffix!r} in {value!r}")
    return int(num * _SUFFIX[suffix])


def format_quantity(units: int, resource: str) -> str:
    if resource == CPU:
        return f"{units}m" if units % 1000 else str(units // 1000)
    if resource in (MEMORY, EPHEMERAL_STORAGE):
        for suf, mult in (("Ti", 2**40), ("Gi", 2**30), ("Mi", 2**20), ("Ki", 2**10)):
            if units and units % mult == 0:
                return f"{units // mult}{suf}"
    return str(units)


class ResourceList(dict):
    """resource name → canonical integer quantity.

    Mirrors the arithmetic the reference leans on (`resources.Merge`,
    `resources.Subtract`, `resources.Fits`) but keeps a dense-vector escape
    hatch for the device kernels.
    """

    @classmethod
    def parse(cls, spec: Mapping[str, object]) -> "ResourceList":
        return cls({k: parse_quantity(v, k) for k, v in spec.items()})

    def __missing__(self, key):  # absent resource == zero
        return 0

    def __add__(self, other: Mapping[str, int]) -> "ResourceList":
        out = ResourceList(self)
        for k, v in other.items():
            out[k] = out.get(k, 0) + v
        return out

    def __sub__(self, other: Mapping[str, int]) -> "ResourceList":
        out = ResourceList(self)
        for k, v in other.items():
            out[k] = out.get(k, 0) - v
        return out

    def clamp_nonnegative(self) -> "ResourceList":
        return ResourceList({k: max(0, v) for k, v in self.items()})

    def fits(self, allocatable: Mapping[str, int]) -> bool:
        """True iff self (requests) fits within allocatable.

        Semantics of `resources.Fits` at the reference's packing feasibility
        check (karpenter:pkg/cloudprovider/cloudprovider.go:264): every
        requested resource must exist in sufficient quantity; resources the
        node does not advertise must not be requested.
        """
        return all(v <= allocatable.get(k, 0) for k, v in self.items() if v > 0)

    def nonzero(self) -> "ResourceList":
        return ResourceList({k: v for k, v in self.items() if v != 0})

    def to_vector(self, axes: Sequence[str] = DEFAULT_AXES,
                  scales: Optional[Mapping[str, float]] = None,
                  round_up: bool = False) -> list:
        """Dense projection. With `scales`, byte axes are divided down to MiB;
        `round_up` (requests) vs floor (allocatable) keeps the integer lowering
        conservative in the solver's favor."""
        out = []
        for a in axes:
            v = float(self.get(a, 0))
            if scales and a in scales:
                v /= scales[a]
                v = math.ceil(v) if round_up else math.floor(v)
            out.append(float(v))
        return out

    @classmethod
    def from_vector(cls, vec: Iterable[float], axes: Sequence[str] = DEFAULT_AXES,
                    scales: Optional[Mapping[str, float]] = None) -> "ResourceList":
        out = {}
        for a, v in zip(axes, vec):
            if scales and a in scales:
                v *= scales[a]
            if v:
                out[a] = int(math.ceil(v))
        return cls(out)


def merge(*lists: Mapping[str, int]) -> ResourceList:
    out = ResourceList()
    for rl in lists:
        out = out + rl
    return out


def pod_requests(containers: Iterable[Mapping[str, int]],
                 init_containers: Iterable = ()) -> ResourceList:
    """Effective pod request under K8s + KEP-753 (sidecar) semantics — the
    single source of truth `serialize.pod_from_manifest` delegates to:

        max( sum(containers) + sum(sidecars),
             max_i( init_i + sidecars started before init_i ) )

    `init_containers` items are either a plain requests mapping (one-shot
    init container) or a `(requests, restart_always)` pair; items with
    `restart_always=True` are sidecars, which run for the pod's whole
    lifetime and therefore ADD to both the init-phase peak and the steady
    state, in list order."""
    def _emax(a: ResourceList, b: Mapping[str, int]) -> ResourceList:
        out = ResourceList(a)
        for k, v in b.items():
            out[k] = max(out.get(k, 0), v)
        return out

    app = merge(*containers)
    sidecars = ResourceList()   # sidecars started so far, in list order
    init_peak = ResourceList()  # element-wise max over init steps
    for ic in init_containers:
        req, always = ic if isinstance(ic, tuple) else (ic, False)
        init_peak = _emax(init_peak, sidecars + ResourceList(req))
        if always:
            sidecars = sidecars + ResourceList(req)
    return _emax(app + sidecars, init_peak)
