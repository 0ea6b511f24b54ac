"""NodeClaim lifecycle: launch → registered → initialized, with liveness.

A copy of the JAX package's `controllers/lifecycle.py` (karpenter-core's
nodeclaim lifecycle state machine, as the AWS provider consumes its
registered / initialized status at karpenter:pkg/cloudprovider/
cloudprovider.go:307-339 and the `karpenter.sh/initialized` label):

  * **launch** — the cloud provider fulfilled the claim (`provider_id` set);
  * **registration** — the node's kubelet joined.  Here the join is the
    FakeCloud instance running plus a configurable `join_delay`; a claim
    that does not register within `registration_ttl` (15 min, core's
    liveness default) is terminated, and one whose instance died first
    fails as InstanceTerminated;
  * **initialization** — a registered node's startup taints (the pool's
    declared ones and the known ephemeral boot taints) are cleared, and
    once no condition taint is left and capacity is reported it carries
    the initialized label.

The provisioner's default path registers synchronously; this controller
is the asynchronous path.  Host-only: it takes no `device`.  It feeds the
reference's initialization, startup and liveness families.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..api import labels as wk
from ..api.objects import Node, NodeClaim
from ..catalog.instancetype import effective_instance_type
from ..cloud.provider import CloudProvider
from ..state.cluster import Cluster
from ..utils import metrics
from ..utils.events import Event, Recorder

log = logging.getLogger("karpenter_tpu_torch.lifecycle")

REGISTRATION_TTL = 15 * 60.0  # core liveness: unregistered claims die at 15m


@dataclass
class LifecycleResult:
    registered: List[str] = field(default_factory=list)     # claim names
    initialized: List[str] = field(default_factory=list)    # node names
    liveness_terminated: List[str] = field(default_factory=list)


class LifecycleController:
    """Tracks launched-but-unregistered claims and uninitialized nodes."""

    # boot-time taints whose owners (kubelet, cloud controller) remove them
    # during a normal start.  Condition taints such as
    # node.kubernetes.io/unreachable are NOT listed: clearing them would
    # hide a real node condition, so initialization waits for their owners
    EPHEMERAL_STARTUP_TAINTS = frozenset({
        "node.kubernetes.io/not-ready",
        "node.cloudprovider.kubernetes.io/uninitialized",
    })

    def __init__(self, provider: CloudProvider, cluster: Cluster,
                 nodepools: Optional[Dict[str, object]] = None,
                 recorder: Optional[Recorder] = None,
                 registration_ttl: float = REGISTRATION_TTL,
                 join_delay: float = 0.0,
                 clock: Callable[[], float] = time.time):
        self.provider = provider
        self.cluster = cluster
        self.nodepools = nodepools or {}
        self.recorder = recorder or Recorder(log=False)
        self.registration_ttl = registration_ttl
        self.join_delay = join_delay  # inf == the kubelet never joins
        self.clock = clock
        self._pending: Dict[str, NodeClaim] = {}   # claim name → claim
        self._catalog = {it.name: it
                         for it in provider.instance_types.base_catalog}

    def track(self, claim: NodeClaim) -> None:
        """Adopt a launched claim for asynchronous registration."""
        if claim.launched and not claim.registered:
            self._pending[claim.name] = claim
            self.cluster.nodeclaims[claim.name] = claim

    def reconcile(self) -> LifecycleResult:
        out = LifecycleResult()
        now = self.clock()
        for claim in list(self._pending.values()):
            inst = None
            try:
                inst = self.provider.cloud.get_instance(claim.provider_id)
            except Exception:  # noqa: BLE001 — a cloud call's failure
                pass
            if inst is None or inst.state != "running":
                # the instance died before registering: unrecoverable
                self._liveness_fail(claim, "InstanceTerminated", out)
                continue
            if now - claim.launched_at > self.registration_ttl:
                self._liveness_fail(claim, "RegistrationTimeout", out)
            elif now - claim.launched_at >= self.join_delay:
                self._register(claim, out)
        # initialization pass over registered, uninitialized nodes
        for node in self.cluster.nodes.values():
            claim = self.cluster.claim_for_provider_id(node.provider_id)
            if claim is None or not claim.registered or claim.initialized:
                continue
            self._try_initialize(node, claim, out)
        return out

    def _register(self, claim: NodeClaim, out: LifecycleResult) -> None:
        it = self._catalog.get(claim.instance_type)
        if it is not None:
            ncs = getattr(self.provider, "node_classes", None) or {}
            it = effective_instance_type(
                it, self.nodepools.get(claim.nodepool),
                ncs.get(claim.node_class_ref))
        allocatable = it.allocatable if it else claim.requests
        node = self.cluster.register_nodeclaim(
            claim, allocatable, it.capacity if it else None, initialized=False)
        # registration leaves the startup taints in place; initialization
        # clears them
        self._pending.pop(claim.name, None)
        out.registered.append(claim.name)
        self.recorder.publish(Event("NodeClaim", claim.name, "Registered",
                                    f"node {node.name} joined"))

    def _try_initialize(self, node: Node, claim: NodeClaim,
                        out: LifecycleResult) -> None:
        """Initialized == startup taints cleared ∧ capacity reported."""
        pool = self.nodepools.get(claim.nodepool)
        clearable = {t.key for t in pool.template.startup_taints} \
            if pool is not None else set()
        clearable |= {t.key for t in node.taints
                      if t.key in self.EPHEMERAL_STARTUP_TAINTS}
        present = [t for t in node.taints if t.key in clearable]
        if present:
            # the kubelet and daemons clear the declared and the known
            # ephemeral taints on this pass; initialization completes on
            # the next (clearance and readiness are separate observations)
            node.taints = [t for t in node.taints if t.key not in clearable]
            self.cluster.touch_node(node)
            return
        # any node.kubernetes.io/* taint left is a live condition owned by
        # the node controller — wait, never clear
        if any(t.key.startswith("node.kubernetes.io/") for t in node.taints):
            return
        if not node.allocatable:
            return  # capacity not reported yet
        claim.initialized = True
        claim.initialized_at = self.clock()
        if claim.registered_at:
            metrics.nodeclaim_initialization_duration().observe(
                max(0.0, claim.initialized_at - claim.registered_at))
        metrics.nodeclaims_initialized().inc({"nodepool": claim.nodepool})
        node.labels[wk.NODE_INITIALIZED] = "true"
        self.cluster.touch_node(node)
        # pods that bound while the node was still coming up reach
        # "running on a ready node" now (karpenter_pods_startup_time_seconds)
        for p_ in node.pods:
            if not p_.__dict__.get("_startup_observed"):
                p_.__dict__["_startup_observed"] = True
                metrics.pods_startup_time().observe(
                    max(0.0, self.clock() - p_.created_at))
        out.initialized.append(node.name)
        self.recorder.publish(Event("Node", node.name, "Initialized", ""))

    def _liveness_fail(self, claim: NodeClaim, reason: str,
                       out: LifecycleResult) -> None:
        log.warning("nodeclaim %s liveness failure: %s", claim.name, reason)
        try:
            self.provider.delete(claim)
        except Exception:  # noqa: BLE001 — a cloud call's failure
            pass
        self.cluster.nodeclaims.pop(claim.name, None)
        self._pending.pop(claim.name, None)
        out.liveness_terminated.append(claim.name)
        metrics.nodeclaims_terminated().inc(
            {"nodepool": claim.nodepool, "reason": reason})
        self.recorder.publish(Event("NodeClaim", claim.name, reason,
                                    "liveness failure", type="Warning"))
