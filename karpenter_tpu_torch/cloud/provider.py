"""The CloudProvider seam: catalog + actuation.

A copy of the JAX package's `cloud/provider.py`:
  * `InstanceTypesProvider` — the solver's catalog with ICE-masked offering
    availability and seq-num memoization
    (karpenter:pkg/providers/instancetype/instancetype.go:89-175);
  * `CloudProvider` — the core seam Create / Delete / Get / List /
    GetInstanceTypes / IsDrifted (karpenter:pkg/cloudprovider/
    cloudprovider.go:66-229): the launch path's candidate filtering, price
    ordering, 60-type cap and capacity-type choice
    (karpenter:pkg/providers/instance/instance.go:88-105,197-253,380-424),
    with the bounded retry policy and the provider circuit breaker;
    terminate, hydration of claims from instance tags, and drift.
The optional L2 hooks (`subnets=`, `launch_templates=`, `pricing=`; the
operator wires all three, ../providers/) put the zonal subnet choice with
in-flight IP accounting, the per-image launch templates and the live price
tables on the launch path; with all three at None the bare fleet path runs.
With a `fence` (utils/fencing.LeaseFence, attached by the controller
manager under the HAFailover gate) the launch and terminate funnels raise
`StaleFenceError` on a stale fencing epoch and touch nothing; `fence=None`
runs unfenced.  The calls feed the reference's cloud-provider, breaker,
retry and instance-type families.  The launch funnel opens a cost-ledger
entry and the terminate funnel closes it (obs/ledger.py; free while the
ledger is disarmed, as it is with the SLOEngine gate off).
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
from ..api.resources import CPU, MEMORY
from ..api.taints import Taint
from ..catalog.instancetype import (InstanceType, Offering, apply_storage,
                                    root_volume_gib)
from ..utils import metrics
from .cache import UnavailableOfferings
from .errors import classify, is_retryable, is_unfulfillable_capacity
from .fake import CloudError, FakeCloud, FleetOverride

log = logging.getLogger("karpenter_tpu_torch.cloud.provider")

# Launch action-space cap (karpenter:pkg/providers/instance/instance.go:56-57).
MAX_INSTANCE_TYPES = 60
MIN_SPOT_FLEXIBILITY = 5  # OD-flexibility warning floor


class InsufficientCapacityError(Exception):
    """All candidate pools ICE'd — the caller retries with a fresh catalog
    (karpenter:pkg/errors/errors.go:56-103)."""


class NodeClassNotFoundError(InsufficientCapacityError):
    """The claim references a nodeclass that doesn't exist — a persistent
    configuration error, not a capacity shortage.  Subclasses
    InsufficientCapacityError so the launch path's retry handling still
    applies, but callers can log it distinctly."""


def static_hash(nodeclass: NodeClass) -> str:
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
        self._set_state("half_open")  # one probe call through
        return True

    def record_success(self) -> None:
        if self.threshold <= 0:
            return
        self.failures = 0
        if self.state != "closed":
            log.info("cloud circuit recovered (%s -> closed)", self.state)
            self._set_state("closed")

    def record_failure(self) -> None:
        if self.threshold <= 0:
            return
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.threshold:
            self.open_until = self.clock() + self.cooldown_s
            if self.state != "open":
                self.total_opens += 1
                metrics.cloud_breaker_opens().inc()
                log.warning("cloud circuit OPEN after %d consecutive "
                            "failures; fast-failing launches for %.0fs",
                            self.failures, self.cooldown_s)
            self._set_state("open")

    def _set_state(self, state: str) -> None:
        if state != self.state:
            self.state = state
            metrics.cloud_breaker_state().set(
                {"closed": 0, "half_open": 1, "open": 2}[state])

    def snapshot(self) -> Dict:
        return {"state": self.state, "consecutive_failures": self.failures,
                "total_opens": self.total_opens}


@dataclass
class InstanceTypesProvider:
    """Catalog provider with ICE masking + memoization keyed on the
    unavailable-offerings sequence number (instancetype.go:114-124).
    With a pricing provider wired, offering prices come from the live
    on-demand/spot tables instead of the catalog's static values
    (createOfferings price lookup, instancetype.go:144-175)."""
    base_catalog: List[InstanceType]
    unavailable: UnavailableOfferings
    pricing: object = None  # providers.pricing.PricingProvider, optional
    _memo: Tuple[tuple, List[InstanceType]] = field(default=None, repr=False)

    def _offering_price(self, it: InstanceType, o: Offering,
                        live_od: bool, live_spot: bool) -> float:
        # until a table's first live refresh the catalog's own (zone- and
        # capacity-type-differentiated) prices are authoritative — the
        # pricing provider's fallbacks are lossy (per-type min OD, synthetic
        # spot discount); liveness is decided per table
        if o.capacity_type == wk.CAPACITY_TYPE_SPOT:
            if not live_spot:
                return o.price
            p = self.pricing.spot_price(it.name, o.zone)
        else:
            if not live_od:
                return o.price
            p = self.pricing.on_demand_price(it.name)
        return o.price if p is None else p

    def list(self) -> List[InstanceType]:
        # the pricing seqs are read once per rebuild: they key the memo and
        # decide which tables apply live, so a refresh landing mid-rebuild
        # just invalidates the next lookup instead of mixing tables
        od_seq, spot_seq = (0, 0) if self.pricing is None \
            else self.pricing.seq_num
        key = (self.unavailable.seq_num, od_seq, spot_seq)
        if self._memo is not None and self._memo[0] == key:
            return self._memo[1]
        live_od, live_spot = od_seq > 0, spot_seq > 0
        out = []
        cpu_gauge = metrics.instance_type_cpu()
        mem_gauge = metrics.instance_type_memory()
        for it in self.base_catalog:
            offerings = [
                Offering(o.zone, o.capacity_type,
                         self._offering_price(it, o, live_od, live_spot),
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
                # cpu/mem gauges (pkg/providers/instancetype/metrics.go:35-46)
                cpu_gauge.set(it.capacity.get(CPU, 0) / 1000.0,
                              {"instance_type": it.name})
                mem_gauge.set(it.capacity.get(MEMORY, 0),
                              {"instance_type": it.name})
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
        # set→set filter feeding only membership tests: order-insensitive
        # graftlint: disable=DT003
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
                 subnets=None, launch_templates=None, pricing=None,
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
        self.instance_types = InstanceTypesProvider(catalog, self.unavailable,
                                                    pricing=pricing)
        self.node_classes = node_classes or {"default": NodeClass()}
        self.cluster_name = cluster_name
        self.clock = clock
        # optional L2 wiring (providers/subnet.py, providers/launchtemplate.py);
        # None keeps the bare fleet path for unit tests and benchmarks
        self.subnets = subnets
        self.launch_templates = launch_templates
        self._claims_by_provider_id: Dict[str, NodeClaim] = {}
        # HAFailover fencing (utils/fencing.LeaseFence, attached by the
        # controller manager): None = unfenced
        self.fence = None

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
                if attempt:
                    metrics.cloud_retries().inc(
                        {"method": method, "outcome": "recovered"})
                return out
            except CloudError as err:
                if not is_retryable(err):
                    raise
                if self.breaker is not None:
                    self.breaker.record_failure()
                if attempt >= budget:
                    if budget:
                        metrics.cloud_retries().inc(
                            {"method": method, "outcome": "exhausted"})
                    raise
                attempt += 1
                metrics.cloud_retries().inc(
                    {"method": method, "outcome": "retried"})
                delay = self.retry.delay(method, attempt)
                log.info("retrying %s after %s (attempt %d/%d, %.2fs)",
                         method, err.code, attempt, budget, delay)
                self.sleep(delay)

    # ---- actuation ----
    def create(self, claim: NodeClaim) -> NodeClaim:
        t0 = time.perf_counter()
        try:
            out = self._create(claim)
            metrics.nodeclaims_created().inc({"nodepool": claim.nodepool or ""})
            metrics.nodeclaims_launched().inc({"nodepool": claim.nodepool or ""})
            return out
        finally:
            metrics.cloudprovider_duration().observe(
                time.perf_counter() - t0, {"method": "create"})

    def _create(self, claim: NodeClaim) -> NodeClaim:
        """Launch capacity for a NodeClaim
        (karpenter:pkg/cloudprovider/cloudprovider.go:92-118 →
        karpenter:pkg/providers/instance/instance.go:88-105)."""
        if not claim.created_at:
            claim.created_at = self.clock()
        if self.fence is not None and not self.fence.check("launch"):
            # deposed leader mid-tick: the new leader owns the substrate
            # now — refuse (counted), never launch a ghost node
            from ..utils.fencing import StaleFenceError
            raise StaleFenceError(
                f"stale fencing epoch: launch of {claim.name} refused")
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
        if nodeclass is None and (self.subnets is not None
                                  or self.launch_templates is not None):
            # with the L2 path wired, a dangling nodeclass ref is a config
            # error — launching without subnets/images would produce a
            # misconfigured node (cloudprovider.go:231-241)
            raise NodeClassNotFoundError(
                f"nodeclass {claim.node_class_ref!r} not found for claim "
                f"{claim.name}")
        # zonal subnet choice with in-flight IP accounting
        # (instance.go:197-253 → subnet.go ZonalSubnetsForLaunch:110-147)
        zonal_subnets = None
        if self.subnets is not None and nodeclass is not None:
            zonal_subnets = self.subnets.zonal_subnets_for_launch(nodeclass)
            if not zonal_subnets:
                raise InsufficientCapacityError(
                    f"no subnets resolve for nodeclass {nodeclass.name}")
        settled = []
        try:
            return self._launch(claim, candidates, nodeclass, zonal_subnets,
                                settled)
        finally:
            # refund predictions the fleet response never settled (launch
            # failed before/at create_fleet) so inflight counts can't leak
            if zonal_subnets is not None and not settled:
                self.subnets.update_inflight_ips([], zonal_subnets)

    def _launch(self, claim: NodeClaim, candidates: List[InstanceType],
                nodeclass: Optional[NodeClass], zonal_subnets,
                settled: List[bool]) -> NodeClaim:
        # launch-template ensure per (image × userdata) group; restricts
        # candidates to types an image covers (launchtemplate.go EnsureAll)
        lt_by_type: Dict[str, Tuple[str, str]] = {}
        if self.launch_templates is not None and nodeclass is not None:
            resolved = self.launch_templates.ensure_all(
                nodeclass, candidates, labels=dict(claim.labels),
                security_group_ids=tuple(nodeclass.status_security_groups),
                instance_profile=nodeclass.status_instance_profile)
            for rt in resolved:
                for it in rt.instance_types:
                    lt_by_type[it.name] = (rt.template.name,
                                           rt.template.image_id)
            candidates = [it for it in candidates if it.name in lt_by_type]
            if not candidates:
                raise InsufficientCapacityError(
                    f"no image covers any candidate type for claim "
                    f"{claim.name}")
        overrides = _build_overrides(claim, candidates)
        if zonal_subnets is not None:
            overrides = [ov for ov in overrides if ov.zone in zonal_subnets]
            for ov in overrides:
                ov.subnet_id = zonal_subnets[ov.zone].id
        for ov in overrides:
            if ov.instance_type in lt_by_type:
                ov.launch_template, ov.image_id = lt_by_type[ov.instance_type]
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
                nodeclass.hash_annotation = static_hash(nodeclass)
            claim.node_class_hash = nodeclass.hash_annotation
            tags["karpenter.sh/nodeclass-hash"] = nodeclass.hash_annotation
        result = self._call_cloud(
            "create_fleet",
            lambda: self.cloud.create_fleet(overrides, count=1, tags=tags))
        # settle the in-flight IP predictions against where the launch landed
        # (subnet.go UpdateInflightIPs:149)
        if zonal_subnets is not None:
            self.subnets.update_inflight_ips(
                [i.subnet_id for i in result.instances], zonal_subnets)
            settled.append(True)
        # feed partial failures back into the ICE cache
        # (instance.go:369-375 updateUnavailableOfferingsCache)
        err_counter = metrics.cloud_errors_total()
        for err in result.errors:
            err_counter.inc({"classification": classify(err)})
            if is_unfulfillable_capacity(err):
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
        # cost-ledger seam (SLOEngine gate, free when disarmed): expected
        # $/h is the cheapest offering this launch INTENDED (overrides[0],
        # price-sorted upstream); realized is what the fleet landed on —
        # they diverge exactly when ICE pushed the claim onto a pricier
        # offering, which is the drift the ledger watches
        from ..obs.ledger import LEDGER, current_trace_id
        if LEDGER.enabled:
            LEDGER.record_launch(
                inst.id, nodepool=claim.nodepool,
                pod_class=inst.instance_type,
                expected_rate=overrides[0].price,
                realized_rate=inst.price,
                at=self.clock(),
                fence_epoch=self.fence.epoch() if self.fence is not None
                else 0,
                trace_id=current_trace_id())
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

    def delete(self, claim: NodeClaim) -> None:
        t0 = time.perf_counter()
        try:
            return self._delete(claim)
        finally:
            metrics.cloudprovider_duration().observe(
                time.perf_counter() - t0, {"method": "delete"})

    def _delete(self, claim: NodeClaim) -> None:
        """Terminate the claim's instance
        (karpenter:pkg/cloudprovider/cloudprovider.go:170-185); an instance
        already gone raises CloudError("InstanceNotFound")."""
        if not claim.provider_id:
            return
        if self.fence is not None and not self.fence.check("terminate"):
            from ..utils.fencing import StaleFenceError
            raise StaleFenceError(
                f"stale fencing epoch: terminate of {claim.provider_id} "
                "refused")
        done = self.cloud.terminate_instances([claim.provider_id])
        claim.terminating = True
        # ledger close: realized lifetime ends here.  The reason is the
        # active decision context (disruption/interruption controllers
        # tag their actuation funnels); untagged deletes are terminations.
        from ..obs.ledger import LEDGER
        if LEDGER.enabled:
            LEDGER.record_close(
                claim.provider_id, at=self.clock(),
                reason=LEDGER.current_source(default="termination"))
        if not done:
            raise CloudError("InstanceNotFound", claim.provider_id)

    def get(self, provider_id: str) -> Optional[NodeClaim]:
        try:
            inst = self.cloud.get_instance(provider_id)
        except CloudError:
            return None
        return self._instance_to_claim(inst)

    def list(self) -> List[NodeClaim]:
        t0 = time.perf_counter()
        try:
            return self._list()
        finally:
            metrics.cloudprovider_duration().observe(
                time.perf_counter() - t0, {"method": "list"})

    def _list(self) -> List[NodeClaim]:
        """Every cluster-owned instance as a NodeClaim (garbage collection's
        ground truth, karpenter:pkg/controllers/nodeclaim/
        garbagecollection/controller.go:57-91)."""
        return [self._instance_to_claim(inst) for inst in self._call_cloud(
            "describe_instances",
            lambda: self.cloud.describe_instances(
                tag_filter={"karpenter.sh/cluster": self.cluster_name}))]

    def _instance_to_claim(self, inst) -> NodeClaim:
        """A claim this provider launched, or one hydrated from the
        instance's tags (cloud tags are the durable store): identity,
        labels, taints, and the nodeclass ref WITH its launch hash — without
        them a recovered node reads as drifted."""
        known = self._claims_by_provider_id.get(inst.id)
        if known is not None:
            return known
        claim = NodeClaim(nodepool=inst.tags.get("karpenter.sh/nodepool", ""))
        if inst.tags.get("karpenter.sh/nodeclaim"):
            claim.name = inst.tags["karpenter.sh/nodeclaim"]
        claim.provider_id = inst.id
        claim.instance_type = inst.instance_type
        claim.zone = inst.zone
        claim.capacity_type = inst.capacity_type
        claim.price = inst.price
        claim.launched_at = inst.launched_at
        # the boot image is on the instance record itself, so hydration
        # restores image drift's input with no extra tag
        claim.image_id = inst.image_id
        labels_json = inst.tags.get("karpenter.sh/labels")
        if labels_json:
            claim.labels.update(json.loads(labels_json))
        claim.labels.update(self._instance_labels(inst, claim))
        taints_json = inst.tags.get("karpenter.sh/taints")
        if taints_json:
            claim.taints = [Taint(d["key"], d["effect"], d.get("value", ""))
                            for d in json.loads(taints_json)]
        if inst.tags.get("karpenter.sh/nodeclass"):
            claim.node_class_ref = inst.tags["karpenter.sh/nodeclass"]
        claim.node_class_hash = inst.tags.get("karpenter.sh/nodeclass-hash", "")
        return claim

    def is_drifted(self, claim: NodeClaim,
                   nodepool: Optional[NodePool] = None) -> Optional[str]:
        """The drift reason, or None (karpenter:pkg/cloudprovider/
        drift.go:42-67), first hit wins: the instance type left the
        catalog, the NodePool no longer admits it, the nodeclass's static
        hash moved, then the live instance's image, its launch template's
        security groups and its subnet against the nodeclass's resolved
        status, and the zone."""
        it = next((t for t in self.instance_types.base_catalog
                   if t.name == claim.instance_type), None)
        if it is None:
            return "InstanceTypeRemoved"
        if nodepool is not None:
            if not nodepool.requirements().compatible(
                    it.requirements, allow_undefined=[wk.NODEPOOL]):
                return "NodePoolDrifted"
        nc = self.node_classes.get(claim.node_class_ref)
        if nc is None:
            return None
        if claim.node_class_hash:
            current = nc.hash_annotation or static_hash(nc)
            if claim.node_class_hash != current:
                return "NodeClassHashDrifted"
        # the instance attributes read here (boot image, subnet, launch
        # template) cannot change after launch, so the lookup runs once per
        # claim and is memoized on it.  A failed lookup is not memoized:
        # the next reconcile retries, and only the warning is deduplicated
        meta = getattr(claim, "_drift_instance_meta", None)
        if meta is None and claim.provider_id:
            try:
                inst = self.cloud.get_instance(claim.provider_id)
                meta = (inst.image_id, inst.subnet_id, inst.launch_template)
                claim._drift_instance_meta = meta
            except Exception as e:
                if not getattr(claim, "_drift_lookup_warned", False):
                    log.warning("drift check for %s: instance %s lookup "
                                "failed (%s); static checks only until the "
                                "lookup succeeds", claim.name,
                                claim.provider_id, e)
                    claim._drift_lookup_warned = True
        inst_image, inst_subnet, inst_lt = meta or ("", "", "")
        image = inst_image or claim.image_id
        if image and nc.status_images and image not in nc.status_images:
            return "ImageDrifted"
        if inst_lt and nc.status_security_groups:
            lt = self.cloud.launch_templates.get(inst_lt)
            if lt is not None and set(lt.security_group_ids) != \
                    set(nc.status_security_groups):
                return "SecurityGroupDrifted"
        if (inst_subnet and nc.status_subnets
                and inst_subnet not in nc.status_subnets):
            return "SubnetDrifted"
        if nc.status_zones and claim.zone not in nc.status_zones:
            return "ZoneDrifted"
        return None

    def liveness_probe(self) -> bool:
        """False while the circuit breaker is open: the substrate fails
        hard enough that the provider has stopped calling it."""
        return self.breaker is None or self.breaker.state != "open"
