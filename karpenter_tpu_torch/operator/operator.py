"""Operator: dependency wiring for the whole framework.

The port of the JAX package's `operator/operator.py`, the analog of
`operator.NewOperator` (karpenter:pkg/operator/operator.go:84-195): one
constructor that builds the cloud session, probes connectivity, resolves
the cluster endpoint and constructs all providers, exposing them as
attributes for the controller set and tests; `build_controllers` then
assembles the controller set (controllers.go:45-65).  The signature is the
reference's plus `device` ("cuda" by default; "cpu" runs the kernels' plain
versions and only when asked for), which reaches every controller that
solves.

With the default options the cluster carries the persistent delta arena
(IncrementalArena, attached before hydration), wrapped in an
`IngestBatcher` under the IngestBatch gate, and every cloud call of the
CloudProvider goes through `BatchedCloud`.

The `/v1` manifest surface (`apply`, `apply_batch`, `_admit`, `_register`)
admits manifests as the reference's does, and `state_lock` (a plain,
non-reentrant `named_lock("state")`, as the reference's) is the one lock
the controller manager's ticks and that surface share.

WarmRestart, HAFailover, FlightRecorder and SLOEngine are read by the
controller manager (operator/manager.py): its snapshot writer and restore
use `raw_cloud` (the FakeCloud under the BatchedCloud), under HAFailover it
hands its fence to `cloud_provider`, and the last two arm its flight
recorder, SLO engine and cost ledger.  The Forecast gate wires the
HeadroomController, its DemandSeries as the cluster's observer and the
spot-risk prior to the interruption controller; GangScheduling turns on
the Provisioner's gang admission and hands its preemption plans to the
DisruptionController (`gang_source`).  As in the reference, the
constructor sets the tracer's slow-span threshold (`trace_slow_ms`),
registers the parity metric families and adds the cluster's scrape-time
collector under `state_lock`.  A chaos spec
(`Options.chaos_spec`, `--chaos-spec`) arms the process-global injector
(utils/chaos.py) in the constructor, as in the reference.
`build_controllers` gives one SolverHealth ladder, with the
`solve_timeout_s` watchdog, to the Provisioner and the DisruptionController
alike.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional

from ..analysis.lockorder import named_lock
from ..api.objects import NodeClass, NodePool
from ..catalog.generate import generate_catalog
from ..catalog.instancetype import effective_instance_type
from ..cloud.batcher import BatchedCloud
from ..cloud.cache import UnavailableOfferings
from ..cloud.fake import CloudError, FakeCloud
from ..cloud.provider import (CloudProvider, ProviderCircuitBreaker,
                              RetryPolicy)
from ..cloud.queue import FakeQueue
from ..cloud.services import (FakeControlPlane, FakeIAM, FakeParameterStore,
                              FakePricingAPI)
from ..controllers.disruption import DisruptionController
from ..controllers.garbagecollection import (GarbageCollectionController,
                                             TaggingController)
from ..controllers.interruption import InterruptionController
from ..controllers.lifecycle import LifecycleController
from ..controllers.nodeclass import NodeClassController
from ..controllers.provisioning import Provisioner
from ..controllers.termination import TerminationController
from ..ops.classpack import resolve_device
from ..providers.imagefamily import ImageProvider, Resolver
from ..providers.instanceprofile import InstanceProfileProvider
from ..providers.launchtemplate import LaunchTemplateProvider
from ..providers.pricing import (PricingController, PricingProvider,
                                 static_price_table)
from ..providers.securitygroup import SecurityGroupProvider
from ..providers.subnet import SubnetProvider
from ..providers.version import VersionProvider
from ..state.cluster import Cluster
from ..utils.events import Recorder
from ..utils import metrics, tracing
from ..utils.provenance import ProvenanceStore
from ..utils.chaos import maybe_configure_from_options
from .options import Options

log = logging.getLogger("karpenter_tpu_torch.operator")

class Operator:
    """Builds the full provider graph over a cloud substrate
    (operator.go:127-169 constructs 11 providers; same inventory here)."""

    def __init__(self, options: Optional[Options] = None,
                 cloud: Optional[FakeCloud] = None,
                 catalog=None,
                 control_plane: Optional[FakeControlPlane] = None,
                 params: Optional[FakeParameterStore] = None,
                 iam: Optional[FakeIAM] = None,
                 pricing_api: Optional[FakePricingAPI] = None,
                 queue: Optional[FakeQueue] = None,
                 clock: Callable[[], float] = time.time,
                 device="cuda"):
        self.options = options or Options()
        self.device = resolve_device(device)
        self.clock = clock
        # identity check, not truthiness: FakeQueue defines __len__, so an
        # empty injected queue is falsy and `queue or ...` would swap in a
        # fresh one — splitting the publisher (cloud) from the consumer
        # (interruption controller)
        self.queue = queue if queue is not None else (
            FakeQueue(clock=clock)
            if self.options.interruption_queue else None)
        self.cloud = cloud or FakeCloud(clock=clock, queue=self.queue)
        self.raw_cloud = self.cloud
        self.batched_cloud = BatchedCloud(self.cloud)
        self.catalog = catalog if catalog is not None else generate_catalog(600)
        self.control_plane = control_plane or FakeControlPlane(
            endpoint=self.options.cluster_endpoint)
        self.params = params or FakeParameterStore()
        self.iam = iam or FakeIAM()
        self.pricing_api = pricing_api or FakePricingAPI()

        # connectivity probe (checkEC2Connectivity operator.go:206-213)
        try:
            self.cloud.describe_instances()
        except CloudError as e:
            raise RuntimeError(f"cloud connectivity probe failed: {e}") from e
        # cluster endpoint discovery (ResolveClusterEndpoint :215-227)
        if not self.options.cluster_endpoint:
            self.options.cluster_endpoint = \
                self.control_plane.describe_cluster()["endpoint"]
        # kube-dns discovery (kubeDNSIP operator.go:248-261): IPv6 clusters
        # publish a v6 service IP and nodes bootstrap with it unchanged
        if not self.options.cluster_dns:
            try:
                self.options.cluster_dns = self.control_plane.kube_dns()
            except CloudError:
                pass  # optional: bootstrap falls back to platform default

        self.recorder = Recorder(clock=clock)
        # queryable "why is this pod pending" records (utils/provenance.py)
        self.provenance = ProvenanceStore()
        # slow-span WARN threshold comes from --trace-slow-ms
        tracing.TRACER.slow_ms = float(self.options.trace_slow_ms or 0.0)
        self.unavailable = UnavailableOfferings(clock=clock)
        self.subnets = SubnetProvider(self.cloud, clock=clock)
        self.security_groups = SecurityGroupProvider(self.cloud, clock=clock)
        self.instance_profiles = InstanceProfileProvider(
            self.iam, self.options.cluster_name, clock=clock)
        self.version = VersionProvider(self.control_plane, clock=clock)
        self.images = ImageProvider(self.cloud, self.params, self.version)
        self.resolver = Resolver(self.images, self.options.cluster_name,
                                 self.options.cluster_endpoint,
                                 cluster_dns=self.options.cluster_dns)
        self.launch_templates = LaunchTemplateProvider(
            self.cloud, self.resolver, self.options.cluster_name, clock=clock)
        self.launch_templates.hydrate_cache()  # launchtemplate.go:336
        self.pricing = PricingProvider(
            pricing_api=None if self.options.isolated_network else self.pricing_api,
            cloud=self.cloud, static_fallback=static_price_table(self.catalog),
            clock=clock)

        self.cluster = Cluster(clock=clock)
        if self.options.gate("IncrementalArena"):
            # attach BEFORE hydration so restart recovery streams through
            # the delta API and the first tick gathers warm
            self.cluster.attach_arena()
            if self.options.gate("IngestBatch"):
                # wrap the arena behind the same delta surface: events
                # coalesce per node between ticks and flush as one delta
                from ..state.ingest import IngestBatcher
                self.cluster.arena = IngestBatcher(
                    self.cluster.arena,
                    max_events=int(self.options.ingest_max_events))
        # one state lock shared by the tick loop (ControllerManager) and the
        # /v1 surface: a solve must never read cluster state mid-mutation
        self.state_lock = named_lock("state")
        # pre-register every parity family so the first scrape serves the
        # complete reference schema (zero samples beat absent families)
        metrics.register_parity_families()
        # scrape-time state gauges: per-node allocatable/overhead/requests/
        # limits (pod + daemon splits), pod phases — refreshed on /metrics,
        # stale series dropped
        metrics.REGISTRY.add_collector(
            metrics.make_cluster_collector(self.cluster,
                                           lock=self.state_lock))
        self.node_classes: Dict[str, NodeClass] = {"default": NodeClass()}  # guarded-by: caller(state_lock)
        self.nodepools: Dict[str, NodePool] = {"default": NodePool()}  # guarded-by: caller(state_lock)
        # cloud-call hardening: both default off, so a stepped clock never
        # wall-sleeps in a retry loop
        retry = breaker = None
        if int(self.options.cloud_retry_attempts) > 0:
            retry = RetryPolicy(
                attempts=int(self.options.cloud_retry_attempts),
                base_s=float(self.options.cloud_retry_base_s))
        if int(self.options.cloud_breaker_threshold) > 0:
            breaker = ProviderCircuitBreaker(
                threshold=int(self.options.cloud_breaker_threshold),
                cooldown_s=float(self.options.cloud_breaker_cooldown_s),
                clock=clock)
        self.cloud_provider = CloudProvider(
            self.batched_cloud, self.catalog, unavailable=self.unavailable,
            node_classes=self.node_classes,
            cluster_name=self.options.cluster_name, clock=clock,
            subnets=self.subnets, launch_templates=self.launch_templates,
            pricing=self.pricing, retry=retry, breaker=breaker)
        # live-operator chaos arming (--chaos-spec); the sim configures the
        # injector itself so schedules ride the virtual clock
        maybe_configure_from_options(self.options)
        self.hydrate_cluster()

    def hydrate_cluster(self) -> int:
        """Restart recovery: rebuild NodeClaims + Nodes from the cloud's
        cluster-tagged instances BEFORE any controller runs — without this a
        fresh process would see its whole live fleet as leaked capacity and
        the GC sweep would terminate it.  Durable state lives in cloud tags;
        pod bindings live in the cluster API, not the cloud, so hydrated
        nodes start empty and fill as pods re-observe."""
        catalog_by_name = {it.name: it for it in self.catalog}
        n = 0
        for claim in self.cloud_provider.list():
            if self.cluster.claim_for_provider_id(claim.provider_id):
                continue
            it = catalog_by_name.get(claim.instance_type)
            if it is not None:
                it = effective_instance_type(
                    it, self.nodepools.get(claim.nodepool),
                    self.node_classes.get(claim.node_class_ref))
            allocatable = it.allocatable if it else claim.requests
            claim.created_at = claim.created_at or claim.launched_at
            node = self.cluster.register_nodeclaim(
                claim, allocatable, it.capacity if it else None,
                rehydrate=True)
            # recovered nodes keep their original age so expiry still works
            node.created_at = claim.launched_at or node.created_at
            n += 1
        if n:
            log.info("hydrated %d nodes from cloud state", n)
        return n

    def _admit(self, manifest: Dict, pending_nc: Optional[Dict] = None):
        """Admission phase 1 — the ONE shared gate behind both `apply` and
        `apply_batch` (webhook semantics, karpenter:pkg/webhooks/webhooks.go:44-63):
        legacy manifests are schema-checked against THEIR OWN kind's schema
        before conversion (a malformed Provisioner/Machine gets an error
        naming the kind the user submitted), then converted, re-validated,
        and parsed with defaulting.  NodeClass update immutability checks
        against live state or — in a batch — an earlier staged manifest of
        the same name, via `pending_nc` (a create followed by an
        immutable-field update in one batch must fail up front).  Returns
        `(kind, obj)` ready for `_register`; any admission change lands in
        both entry points automatically."""
        from ..api.admission import validate_manifest, validate_nodeclass_update
        from ..api.legacy import convert_manifest
        from ..api.serialize import (nodeclaim_from_manifest,
                                     nodeclass_from_manifest,
                                     nodepool_from_manifest)
        validate_manifest(manifest)
        manifest = convert_manifest(manifest)
        validate_manifest(manifest)
        kind = manifest.get("kind")
        if kind == "NodePool":
            return kind, nodepool_from_manifest(manifest)
        if kind == "NodeClass":
            obj = nodeclass_from_manifest(manifest)  # defaults + validates
            original = (pending_nc or {}).get(obj.name) or \
                self.node_classes.get(obj.name)
            if original is not None:
                validate_nodeclass_update(original, obj)
            if pending_nc is not None:
                pending_nc[obj.name] = obj
            return kind, obj
        if kind == "NodeClaim":
            return kind, nodeclaim_from_manifest(manifest)
        raise ValueError(f"cannot apply kind {kind!r}")

    def apply_batch(self, manifests) -> list:
        """Atomic-intent batch apply: phase 1 runs EVERY manifest through
        `_admit` — the exact admission gate `apply` uses — threading the
        batch-local `pending_nc` map so immutability is checked against
        earlier manifests in the batch as well as live state; phase 2
        registers the objects phase 1 already admitted, so admission runs
        exactly once per manifest.  A phase-1 failure means nothing was
        applied."""
        pending_nc: Dict[str, object] = {}
        staged: List = []
        for manifest in manifests:
            try:
                staged.append(self._admit(manifest, pending_nc))
            except (ValueError, KeyError, TypeError) as e:
                raise ValueError(
                    f"{manifest.get('kind')}/"
                    f"{manifest.get('metadata', {}).get('name')}: {e}") \
                    from e
        return [self._register(kind, obj) for kind, obj in staged]

    def apply(self, manifest: Dict):
        """Admission-checked manifest ingestion — the kubectl-apply analog:
        `_admit` defaults + validates (legacy alpha kinds convert first,
        karpenter-convert semantics) and `_register` records the object in
        live controller state (dicts shared with the provisioner/disruption
        controllers).  Returns the registered object."""
        kind, obj = self._admit(manifest)
        return self._register(kind, obj)

    def _register(self, kind: str, obj):
        """Admission phase 2: record an already-validated object in live
        controller state.  `apply` and `apply_batch` both end here —
        batch registration must not re-run admission (a NodeClass update
        re-validated at registration time would check against its own
        phase-1 sibling instead of pre-batch state, and would pay the
        schema walk twice)."""
        if kind == "NodePool":
            self.nodepools[obj.name] = obj
            log.info("applied NodePool %s", obj.name)
            return obj
        if kind == "NodeClass":
            self.node_classes[obj.name] = obj
            log.info("applied NodeClass %s", obj.name)
            return obj
        # NodeClaim: normally machine-created; applying one (e.g. a migrated
        # legacy Machine record) registers it into cluster state. A claim
        # with a live instance goes through the same promotion as restart
        # hydration so its capacity is schedulable and disruptable — not
        # just GC-protected.
        claim = obj
        if claim.provider_id and not self.cluster.claim_for_provider_id(
                claim.provider_id):
            it = next((t for t in self.catalog
                       if t.name == claim.instance_type), None)
            if it is not None:
                it = effective_instance_type(
                    it, self.nodepools.get(claim.nodepool),
                    self.node_classes.get(claim.node_class_ref))
            allocatable = it.allocatable if it else claim.requests
            claim.created_at = claim.created_at or claim.launched_at
            node = self.cluster.register_nodeclaim(
                claim, allocatable, it.capacity if it else None,
                rehydrate=True)
            node.created_at = claim.launched_at or node.created_at
        else:
            self.cluster.nodeclaims[claim.name] = claim
        log.info("applied NodeClaim %s", claim.name)
        return claim

    def delete(self, kind: str, name: str) -> bool:
        """Deregister a NodePool, or finalize + deregister a NodeClass
        (deletion blocked while NodeClaims reference it — the finalizer
        semantics, nodeclass/controller.go:100-126)."""
        if kind == "NodePool":
            return self.nodepools.pop(name, None) is not None
        if kind == "NodeClass":
            nc = self.node_classes.get(name)
            if nc is None:
                return False
            ctrl = NodeClassController(
                subnets=self.subnets, security_groups=self.security_groups,
                images=self.images, instance_profiles=self.instance_profiles,
                cluster=self.cluster)
            if not ctrl.finalize(nc, launch_templates=self.launch_templates):
                return False  # still referenced; caller retries
            del self.node_classes[name]
            return True
        raise ValueError(f"cannot delete kind {kind!r}")


def build_controllers(op: Operator) -> Dict[str, object]:
    """Assemble the controller set (controllers.NewControllers,
    karpenter:pkg/controllers/controllers.go:45-65 + the core registration
    in cmd/controller/main.go:47-70).  Interruption registers only when a
    queue is configured; pricing refresh only outside isolated networks.
    With both LPGuide and LPRefinery on, the provisioner gets a
    GuideRefinery so cold guide solves never block the tick.  Every
    controller that solves runs on `op.device`."""
    # DeviceLP gate: its own two-rung ladder (device_lp ──▶ highs) on the
    # operator's injected clock
    device_lp = op.options.gate("LPGuide") and op.options.gate("DeviceLP")
    lp_health = None
    if device_lp:
        from ..ops.health import lp_ladder
        lp_health = lp_ladder(clock=op.clock)
    refinery = None
    if op.options.gate("LPGuide") and op.options.gate("LPRefinery"):
        from ..ops.refinery import GuideRefinery
        # both clocks ride the operator's injected clock
        refinery = GuideRefinery(clock=op.clock, monotonic=op.clock,
                                 device_lp=device_lp, lp_health=lp_health)
    from ..ops.health import SolverHealth
    health = SolverHealth(clock=op.clock)
    solve_timeout = float(op.options.solve_timeout_s or 0.0)
    decode_health = None
    if op.options.gate("DeviceDecode"):
        from ..ops.decode import DecodeHealth
        decode_health = DecodeHealth(clock=op.clock)
    provisioner = Provisioner(
        op.cloud_provider, op.cluster, op.nodepools,
        lp_guide=op.options.gate("LPGuide"),
        refinery=refinery,
        recorder=op.recorder,
        provenance=op.provenance,
        sharded_solve=op.options.gate("ShardedSolve"),
        health=health,
        watchdog_timeout_s=solve_timeout,
        device_decode=op.options.gate("DeviceDecode"),
        decode_health=decode_health,
        device_lp=device_lp,
        lp_health=lp_health,
        gang_scheduling=op.options.gate("GangScheduling"),
        device=op.device)
    terminator = TerminationController(op.cloud_provider, op.cluster,
                                       clock=op.clock)
    out: Dict[str, object] = {
        "provisioning": provisioner,
        "termination": terminator,
        "disruption": DisruptionController(
            op.cloud_provider, op.cluster, op.nodepools,
            terminator=terminator, clock=op.clock,
            drift_enabled=op.options.gate("Drift"),
            lp_guide=op.options.gate("LPGuide"),
            recorder=op.recorder,
            sharded_solve=op.options.gate("ShardedSolve"),
            health=health,
            watchdog_timeout_s=solve_timeout,
            # gang preemption plans flow provisioner → disruption: the
            # admission funnel queues them, the disruption tick executes
            # one per round (GangScheduling gate)
            gang_source=(provisioner.take_preemption_plan
                         if op.options.gate("GangScheduling") else None),
            device=op.device),
        "lifecycle": LifecycleController(
            op.cloud_provider, op.cluster, nodepools=op.nodepools,
            recorder=op.recorder, clock=op.clock),
        "garbagecollection": GarbageCollectionController(
            op.cloud_provider, op.cluster, clock=op.clock),
        "tagging": TaggingController(op.cloud_provider, op.cluster),
        "nodeclass": NodeClassController(
            subnets=op.subnets, security_groups=op.security_groups,
            images=op.images, instance_profiles=op.instance_profiles,
            cluster=op.cluster),
    }
    if op.queue is not None:
        out["interruption"] = InterruptionController(
            op.queue, op.cloud_provider, op.cluster, terminator,
            clock=op.clock)
    if not op.options.isolated_network:
        out["pricing"] = PricingController(op.pricing, clock=op.clock)
    if op.options.gate("Forecast"):
        from ..forecast import (DemandSeries, HeadroomConfig,
                                HeadroomController, make_forecaster)
        opts = op.options
        series = DemandSeries(bucket_s=opts.forecast_bucket_s, clock=op.clock)
        # the series observes every pod mutation through the cluster hook;
        # headroom placeholders are filtered inside the series so the
        # forecaster never learns from its own output
        op.cluster.observer = series
        season_steps = max(2, int(opts.forecast_season_s /
                                  max(opts.forecast_bucket_s, 1.0)))
        forecaster = make_forecaster(opts.forecast_model,
                                     season_length=season_steps)
        cfg = HeadroomConfig(
            horizon_s=opts.forecast_horizon_s,
            lead_s=opts.forecast_lead_s,
            ttl_s=opts.forecast_ttl_s,
            bucket_s=opts.forecast_bucket_s,
            confidence=opts.forecast_confidence,
            max_cost_frac=opts.forecast_max_cost_frac,
            model=opts.forecast_model,
            season_s=opts.forecast_season_s)
        forecast = HeadroomController(
            provisioner, op.cluster, op.nodepools, series, forecaster,
            clock=op.clock, config=cfg, recorder=op.recorder)
        out["forecast"] = forecast
        # spot reclaims observed by the interruption controller feed the
        # per-pool risk prior that steers risky headroom onto on-demand
        if "interruption" in out:
            out["interruption"].on_spot_reclaim = \
                forecast.spot_prior.observe_reclaim
    return out
