"""The CloudProvider seam: catalog + actuation.

A copy of the JAX package's `cloud/provider.py`, trimmed to what
provisioning reaches:
  * `InstanceTypesProvider` — the solver's catalog with ICE-masked offering
    availability and seq-num memoization
    (karpenter:pkg/providers/instancetype/instancetype.go:89-175);
  * `CloudProvider.create` — the launch path's candidate filtering, price
    ordering, 60-type cap and capacity-type choice
    (karpenter:pkg/providers/instance/instance.go:88-105,197-253,380-424),
    with the bounded retry policy and the provider circuit breaker.
Left out until a slice needs them: delete / get / list / drift, the subnet,
launch-template and pricing providers, HA fencing and the cost ledger, and
the metric families.
"""

from __future__ import annotations

import hashlib
import json
import logging
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..api import labels as wk
from ..api.objects import NodeClaim, NodeClass, NodePool
from ..catalog.instancetype import (InstanceType, Offering, apply_storage,
                                    root_volume_gib)
from .cache import UnavailableOfferings
from .fake import CloudError, FakeCloud, FleetOverride, ICE_CODE

log = logging.getLogger("karpenter_tpu_torch.cloud.provider")

# Launch action-space cap (karpenter:pkg/providers/instance/instance.go:56-57).
MAX_INSTANCE_TYPES = 60
MIN_SPOT_FLEXIBILITY = 5  # OD-flexibility warning floor

# fleet error codes that mean "this offering cannot be fulfilled right now"
# and feed the ICE cache (karpenter:pkg/errors/errors.go:83-94)
UNFULFILLABLE_CAPACITY_CODES = frozenset({
    ICE_CODE,
    "MaxSpotInstanceCountExceeded",
    "VcpuLimitExceeded",
    "UnfulfillableCapacity",
    "Unsupported",
    "InsufficientFreeAddressesInSubnet",
})

# transient faults worth an in-call retry: throttles and provider-side
# internal errors (not unfulfillable capacity — that is a state)
RETRYABLE_CODES = frozenset({
    "RequestLimitExceeded",
    "Throttling",
    "ThrottlingException",
    "RequestThrottled",
    "TooManyRequestsException",
    "InternalError",
    "InternalFailure",
    "ServiceUnavailable",
    "Unavailable",
})


class InsufficientCapacityError(Exception):
    """All candidate pools ICE'd — the caller retries with a fresh catalog
    (karpenter:pkg/errors/errors.go:56-103)."""


class NodeClassNotFoundError(InsufficientCapacityError):
    """The claim references a nodeclass that doesn't exist — a persistent
    configuration error, not a capacity shortage.  Subclasses
    InsufficientCapacityError so the launch path's retry handling still
    applies, but callers can log it distinctly."""


def _static_hash(nodeclass: NodeClass) -> str:
    """Hash of the launch-affecting nodeclass spec fields (the reference's
    controllers/nodeclass.static_hash): a change drifts every node launched
    from the old spec."""
    payload = json.dumps({
        "image_family": nodeclass.image_family,
        "image_selector": sorted(nodeclass.image_selector.items()),
        "subnet_selector": sorted(nodeclass.subnet_selector.items()),
        "security_group_selector": sorted(nodeclass.security_group_selector.items()),
        "zone_selector": sorted(nodeclass.zone_selector),
        "role": nodeclass.role,
        "user_data": nodeclass.user_data,
        "tags": sorted(nodeclass.tags.items()),
        "block_device_gib": nodeclass.block_device_gib,
        "block_device_mappings": nodeclass.block_device_mappings,
        "metadata_options": sorted(nodeclass.metadata_options.items()),
        "detailed_monitoring": nodeclass.detailed_monitoring,
        "instance_store_policy": nodeclass.instance_store_policy,
        "associate_public_ip": nodeclass.associate_public_ip,
    }, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded in-call retry for RETRYABLE cloud faults.  `attempts` is
    extra tries beyond the first call; 0 (the default) disables retry.
    Jitter is a hash of (method, attempt), not an RNG, for deterministic
    tests."""
    attempts: int = 0
    base_s: float = 0.2
    max_s: float = 5.0

    def delay(self, method: str, attempt: int) -> float:
        raw = min(self.max_s, self.base_s * 2.0 ** max(0, attempt - 1))
        h = zlib.crc32(f"{method}:{attempt}".encode()) & 0xFFFFFFFF
        return raw * (0.5 + (h / 2**32) * 0.5)


class ProviderCircuitBreaker:
    """Error-storm breaker over the whole provider: `threshold`
    consecutive retryable-class failures OPEN the circuit and launches
    fast-fail as InsufficientCapacityError for `cooldown_s`.  After the
    cooldown one call probes half-open.  threshold=0 (default) disables
    the breaker."""

    def __init__(self, threshold: int = 0, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self.failures = 0
        self.state = "closed"
        self.open_until = float("-inf")
        self.total_opens = 0

    def allow(self) -> bool:
        if self.threshold <= 0 or self.state == "closed":
            return True
        if self.clock() < self.open_until:
            return False
        self.state = "half_open"  # one probe call through
        return True

    def record_success(self) -> None:
        if self.threshold <= 0:
            return
        self.failures = 0
        if self.state != "closed":
            log.info("cloud circuit recovered (%s -> closed)", self.state)
            self.state = "closed"

    def record_failure(self) -> None:
        if self.threshold <= 0:
            return
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.threshold:
            self.open_until = self.clock() + self.cooldown_s
            if self.state != "open":
                self.total_opens += 1
                log.warning("cloud circuit OPEN after %d consecutive "
                            "failures; fast-failing launches for %.0fs",
                            self.failures, self.cooldown_s)
            self.state = "open"

    def snapshot(self) -> Dict:
        return {"state": self.state, "consecutive_failures": self.failures,
                "total_opens": self.total_opens}


@dataclass
class InstanceTypesProvider:
    """Catalog provider with ICE masking + memoization keyed on the
    unavailable-offerings sequence number (instancetype.go:114-124)."""
    base_catalog: List[InstanceType]
    unavailable: UnavailableOfferings
    _memo: Tuple[int, List[InstanceType]] = field(default=None, repr=False)

    def list(self) -> List[InstanceType]:
        key = self.unavailable.seq_num
        if self._memo is not None and self._memo[0] == key:
            return self._memo[1]
        out = []
        for it in self.base_catalog:
            offerings = [
                Offering(o.zone, o.capacity_type, o.price,
                         available=o.available and not self.unavailable.is_unavailable(
                             o.capacity_type, it.name, o.zone))
                for o in it.offerings
            ]
            if any(o.available for o in offerings):
                out.append(InstanceType(
                    name=it.name, requirements=it.requirements,
                    offerings=offerings, capacity=it.capacity,
                    kube_reserved=it.kube_reserved,
                    system_reserved=it.system_reserved,
                    eviction_threshold=it.eviction_threshold, info=it.info))
        self._memo = (key, out)
        return out


def _claim_compatible_types(claim: NodeClaim,
                            instance_types: Sequence[InstanceType]) -> List[InstanceType]:
    """Types whose requirements intersect the claim's and whose allocatable
    covers the claim's aggregate requests
    (karpenter:pkg/cloudprovider/cloudprovider.go:255-266)."""
    out = []
    for it in instance_types:
        # keys the type doesn't define (nodepool, user labels) are provided by
        # the NodePool template at node creation
        allow = [k for k in claim.requirements if k not in it.requirements]
        if not claim.requirements.compatible(it.requirements, allow_undefined=allow):
            continue
        if not claim.requests.fits(it.allocatable):
            continue
        if not any(o.available for o in it.offerings):
            continue
        out.append(it)
    return out


def _build_overrides(claim: NodeClaim, candidates: Sequence[InstanceType]) -> List[FleetOverride]:
    """Cross-product (type × zone × capacity-type) filtered by claim
    requirements, price-ordered, capped at MAX_INSTANCE_TYPES
    (karpenter:pkg/providers/instance/instance.go:327-367,395-412)."""
    zone_req = claim.requirements.get(wk.ZONE)
    cap_req = claim.requirements.get(wk.CAPACITY_TYPE)
    # capacity-type choice: spot if allowed and available, else on-demand
    allowed_caps = {wk.CAPACITY_TYPE_SPOT, wk.CAPACITY_TYPE_ON_DEMAND}
    if cap_req is not None:
        allowed_caps = {c for c in allowed_caps if cap_req.has(c)}
    spot_available = any(
        o.capacity_type == wk.CAPACITY_TYPE_SPOT and o.available
        and (zone_req is None or zone_req.has(o.zone))
        for it in candidates for o in it.offerings)
    capacity_type = (wk.CAPACITY_TYPE_SPOT
                     if wk.CAPACITY_TYPE_SPOT in allowed_caps and spot_available
                     else wk.CAPACITY_TYPE_ON_DEMAND)
    overrides = []
    for it in candidates:
        for o in it.offerings:
            if not o.available or o.capacity_type != capacity_type:
                continue
            if zone_req is not None and not zone_req.has(o.zone):
                continue
            overrides.append(FleetOverride(it.name, o.zone, o.capacity_type, o.price))
    overrides.sort(key=lambda ov: (ov.price, ov.instance_type, ov.zone))
    # cap by distinct instance types, keeping all zones of kept types
    kept_types: List[str] = []
    out = []
    for ov in overrides:
        if ov.instance_type not in kept_types:
            if len(kept_types) >= MAX_INSTANCE_TYPES:
                continue
            kept_types.append(ov.instance_type)
        out.append(ov)
    return out


class CloudProvider:
    """The CloudProvider over the (fake) cloud substrate."""

    name = "karpenter-tpu"

    def __init__(self, cloud: FakeCloud, catalog: List[InstanceType],
                 unavailable: Optional[UnavailableOfferings] = None,
                 node_classes: Optional[Dict[str, NodeClass]] = None,
                 cluster_name: str = "default",
                 clock: Callable[[], float] = time.time,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[ProviderCircuitBreaker] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.cloud = cloud
        # call hardening (both default OFF): bounded jittered retry for
        # transient API faults, provider-level circuit breaker for storms
        self.retry = retry
        self.breaker = breaker
        self.sleep = sleep
        self.unavailable = unavailable or UnavailableOfferings()
        self.instance_types = InstanceTypesProvider(catalog, self.unavailable)
        self.node_classes = node_classes or {"default": NodeClass()}
        self.cluster_name = cluster_name
        self.clock = clock
        self._claims_by_provider_id: Dict[str, NodeClaim] = {}

    # ---- catalog ----
    def get_instance_types(self, nodepool: Optional[NodePool] = None) -> List[InstanceType]:
        its = self.instance_types.list()
        if nodepool is None:
            return its
        reqs = nodepool.requirements()
        return [it for it in its
                if reqs.compatible(it.requirements, allow_undefined=[wk.NODEPOOL])]

    def _call_cloud(self, method: str, fn: Callable):
        """Run one cloud API call under the retry policy + breaker
        bookkeeping.  Only RETRYABLE faults are retried; everything else —
        and exhausted retries — propagates."""
        budget = self.retry.attempts if self.retry is not None else 0
        attempt = 0
        while True:
            try:
                out = fn()
                if self.breaker is not None:
                    self.breaker.record_success()
                return out
            except CloudError as err:
                if err.code not in RETRYABLE_CODES:
                    raise
                if self.breaker is not None:
                    self.breaker.record_failure()
                if attempt >= budget:
                    raise
                attempt += 1
                delay = self.retry.delay(method, attempt)
                log.info("retrying %s after %s (attempt %d/%d, %.2fs)",
                         method, err.code, attempt, budget, delay)
                self.sleep(delay)

    # ---- actuation ----
    def create(self, claim: NodeClaim) -> NodeClaim:
        """Launch capacity for a NodeClaim
        (karpenter:pkg/cloudprovider/cloudprovider.go:92-118 →
        karpenter:pkg/providers/instance/instance.go:88-105)."""
        if not claim.created_at:
            claim.created_at = self.clock()
        if self.breaker is not None and not self.breaker.allow():
            # fast-fail into the same path an all-ICE'd launch takes
            raise InsufficientCapacityError(
                "cloud circuit open: launches fast-fail during cooldown")
        nodeclass = self.node_classes.get(claim.node_class_ref)
        # capacity-fit validation must see the nodeclass's boot volume (the
        # solver already packed against the adjusted columns)
        types = self.instance_types.list()
        if nodeclass is not None:
            gib = root_volume_gib(nodeclass)
            types = [apply_storage(it, gib) for it in types]
        candidates = _claim_compatible_types(claim, types)
        if not candidates:
            raise InsufficientCapacityError(
                f"no compatible instance types for claim {claim.name}")
        overrides = _build_overrides(claim, candidates)
        if not overrides:
            raise InsufficientCapacityError(
                f"no available offerings for claim {claim.name}")
        # fleet tags are POOL-scoped only; claim identity goes on after the
        # launch via create_tags, as in the reference
        tags = {
            "karpenter.sh/cluster": self.cluster_name,
            "karpenter.sh/nodepool": claim.nodepool,
        }
        if claim.taints:
            tags["karpenter.sh/taints"] = json.dumps(
                [{"key": t.key, "effect": t.effect, "value": t.value}
                 for t in claim.taints])
        custom = {k: v for k, v in claim.labels.items()
                  if "kubernetes.io" not in k and not k.startswith("karpenter")}
        if custom:
            tags["karpenter.sh/labels"] = json.dumps(custom, sort_keys=True)
        tags["karpenter.sh/nodeclass"] = claim.node_class_ref
        if nodeclass is not None:
            if not nodeclass.hash_annotation:
                nodeclass.hash_annotation = _static_hash(nodeclass)
            claim.node_class_hash = nodeclass.hash_annotation
            tags["karpenter.sh/nodeclass-hash"] = nodeclass.hash_annotation
        result = self._call_cloud(
            "create_fleet",
            lambda: self.cloud.create_fleet(overrides, count=1, tags=tags))
        # feed partial failures back into the ICE cache
        # (instance.go:369-375 updateUnavailableOfferingsCache)
        for err in result.errors:
            if err.code in UNFULFILLABLE_CAPACITY_CODES:
                self.unavailable.mark_unavailable_for_fleet_err(
                    err.code, err.override.instance_type, err.override.zone,
                    err.override.capacity_type)
        if not result.instances:
            raise InsufficientCapacityError(
                f"all {len(overrides)} offerings ICE'd for claim {claim.name}")
        inst = result.instances[0]
        try:
            self.cloud.create_tags(inst.id, {
                "karpenter.sh/nodeclaim": claim.name,
                "Name": f"{claim.nodepool}/{claim.name}",
            })
        except CloudError as e:
            # instance launched; a tagging controller retries the tag
            log.warning("post-launch identity tagging failed for %s: %s",
                        inst.id, e)
        claim.provider_id = inst.id
        claim.instance_type = inst.instance_type
        claim.zone = inst.zone
        claim.capacity_type = inst.capacity_type
        claim.price = inst.price
        claim.launched_at = inst.launched_at
        claim.image_id = inst.image_id
        claim.labels.update(self._instance_labels(inst, claim))
        self._claims_by_provider_id[inst.id] = claim
        return claim

    def _instance_labels(self, inst, claim: NodeClaim) -> Dict[str, str]:
        """instance → node labels
        (instanceToNodeClaim, karpenter:pkg/cloudprovider/cloudprovider.go:307-339)."""
        labels = {
            wk.INSTANCE_TYPE: inst.instance_type,
            wk.ZONE: inst.zone,
            wk.CAPACITY_TYPE: inst.capacity_type,
            wk.NODEPOOL: claim.nodepool,
        }
        it = next((t for t in self.instance_types.base_catalog
                   if t.name == inst.instance_type), None)
        if it is not None:
            labels.update({k: v for k, v in it.requirements.labels().items()
                           if k not in (wk.ZONE, wk.CAPACITY_TYPE)})
        return labels
