"""Garbage collection: leaked cloud capacity and orphaned node objects.

A copy of the JAX package's `controllers/garbagecollection.py` (Karpenter's
nodeclaim GC, karpenter:pkg/controllers/nodeclaim/garbagecollection/
controller.go:57-115): list every cluster-owned instance, terminate any
running past the registration grace period with no matching NodeClaim (a
leak, e.g. a crash between CreateFleet and persisting the claim), and
remove Node objects whose instance is gone.  Also the tagging controller
(karpenter:pkg/controllers/nodeclaim/tagging/controller.go).  Host-only:
they take no `device`.  Each repair counts in
karpenter_consistency_errors_total{check}.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, List

from ..cloud.provider import CloudProvider
from ..state.cluster import Cluster
from ..utils import metrics

log = logging.getLogger("karpenter_tpu_torch.gc")

# an instance younger than this may not have registered yet
# (controller.go:94-115: 30 s)
REGISTRATION_GRACE_S = 30.0


@dataclass
class GCResult:
    leaked_instances: List[str] = field(default_factory=list)
    orphaned_nodes: List[str] = field(default_factory=list)


class GarbageCollectionController:
    """Singleton sweep comparing the cloud's ground truth with the
    cluster's state."""

    def __init__(self, provider: CloudProvider, cluster: Cluster,
                 clock: Callable[[], float] = time.time,
                 grace_s: float = REGISTRATION_GRACE_S):
        self.provider = provider
        self.cluster = cluster
        self.clock = clock
        self.grace_s = grace_s

    def reconcile(self) -> GCResult:
        out = GCResult()
        now = self.clock()
        known_ids = {c.provider_id for c in self.cluster.nodeclaims.values()
                     if c.provider_id}
        cloud_claims = self.provider.list()
        cloud_ids = {c.provider_id for c in cloud_claims}

        # leaked instances: capacity nobody claims, past the grace period
        for claim in cloud_claims:
            if claim.provider_id in known_ids:
                continue
            if now - claim.launched_at < self.grace_s:
                continue
            try:
                self.provider.delete(claim)
            except Exception:  # noqa: BLE001 — already gone is success
                pass
            node = self.cluster.node_for_provider_id(claim.provider_id)
            if node is not None:
                self.cluster.remove_node(node.name)
            out.leaked_instances.append(claim.provider_id)
            metrics.consistency_errors().inc({"check": "leaked_instance"})
            log.info("GC: terminated leaked instance %s", claim.provider_id)

        # orphaned nodes: the node object outlived its instance (reclaimed
        # spot capacity, a dropped event) — its pods requeue
        for node in list(self.cluster.nodes.values()):
            if node.provider_id and node.provider_id not in cloud_ids:
                claim = self.cluster.claim_for_provider_id(node.provider_id)
                if claim is not None:
                    self.cluster.nodeclaims.pop(claim.name, None)
                self.cluster.remove_node(node.name)
                out.orphaned_nodes.append(node.name)
                metrics.consistency_errors().inc({"check": "orphaned_node"})
                log.info("GC: removed orphaned node %s", node.name)
        return out


class TaggingController:
    """Post-registration instance tagging: stamps the node name onto the
    instance once it registers, and re-asserts the claim identity the
    launch path's create_tags may have missed."""

    NODE_NAME_TAG = "karpenter.sh/node-name"

    def __init__(self, provider: CloudProvider, cluster: Cluster):
        self.provider = provider
        self.cluster = cluster

    def reconcile(self) -> List[str]:
        tagged = []
        claim_by_pid = {c.provider_id: c
                        for c in self.cluster.nodeclaims.values()
                        if c.provider_id}
        for node in self.cluster.nodes.values():
            if not node.provider_id:
                continue
            try:
                inst = self.provider.cloud.get_instance(node.provider_id)
            except Exception:  # noqa: BLE001 — instance gone: GC's problem
                continue
            want = {self.NODE_NAME_TAG: node.name}
            claim = claim_by_pid.get(node.provider_id)
            if claim is not None:
                want["karpenter.sh/nodeclaim"] = claim.name
                want["Name"] = f"{claim.nodepool}/{claim.name}"
            missing = {k: v for k, v in want.items()
                       if inst.tags.get(k) != v}
            if missing:
                self.provider.cloud.create_tags(node.provider_id, missing)
                tagged.append(node.provider_id)
        return tagged
