"""NodeClass controller: selector config → resolved status.

A copy of the JAX package's `controllers/nodeclass.py`, which re-implements
karpenter:pkg/controllers/nodeclass/controller.go:
  * `reconcile` (:73-99) — resolve subnets (sorted by free IPs, most first),
    security groups, images, and the instance profile into `.status`;
    compute the static hash annotation drift detection keys off
    (`utils/nodeclass.HashAnnotation` via cloudprovider.go:116);
  * `finalize` (:100-126) — deletion is blocked while NodeClaims still
    reference the class; once unreferenced, the instance profile and this
    cluster's launch templates are garbage-collected.
`static_hash` lives beside the launch path in `cloud/provider.py` (the
port's copy of it came with drift) and is re-exported here, as are the
admission functions (`api/admission.py`).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ..api.objects import NodeClass
from ..cloud.provider import static_hash
from ..state.cluster import Cluster

log = logging.getLogger("karpenter_tpu_torch.nodeclass")

REQUEUE_INTERVAL = 5 * 60.0  # controller.go requeues ~5m


@dataclass
class NodeClassResult:
    resolved: bool = False
    requeue_after: float = REQUEUE_INTERVAL
    errors: List[str] = field(default_factory=list)


class NodeClassController:
    def __init__(self, subnets, security_groups, images, instance_profiles,
                 cluster: Optional[Cluster] = None,
                 clock: Callable[[], float] = time.time):
        self.subnets = subnets
        self.security_groups = security_groups
        self.images = images
        self.instance_profiles = instance_profiles
        self.cluster = cluster

    def reconcile(self, nodeclass: NodeClass) -> NodeClassResult:
        out = NodeClassResult()
        subnets = self.subnets.list(nodeclass)
        if not subnets:
            out.errors.append("no subnets resolved")
        # most free IPs first: the launch path prefers roomy subnets
        # (controller.go resolveSubnets sorts by available IPs)
        subnets = sorted(subnets, key=lambda s: (-s.available_ip_count, s.id))
        nodeclass.status_subnets = [s.id for s in subnets]
        nodeclass.status_zones = sorted({s.zone for s in subnets})

        groups = self.security_groups.list(nodeclass)
        if nodeclass.security_group_selector and not groups:
            out.errors.append("no security groups resolved")
        nodeclass.status_security_groups = sorted(g.id for g in groups)

        images = self.images.get(nodeclass)
        if not images:
            out.errors.append("no images resolved")
        nodeclass.status_images = [i.id for i in images]

        if nodeclass.role:
            nodeclass.status_instance_profile = \
                self.instance_profiles.create(nodeclass, tags=nodeclass.tags)

        nodeclass.hash_annotation = static_hash(nodeclass)
        out.resolved = not out.errors
        if out.errors:
            log.warning("nodeclass %s unresolved: %s", nodeclass.name, out.errors)
        return out

    def finalize(self, nodeclass: NodeClass,
                 launch_templates=None) -> bool:
        """Deletion path: refuse while any NodeClaim references the class;
        then GC the instance profile (+ this cluster's launch templates when
        a provider is passed). Returns whether finalization completed."""
        if self.cluster is not None:
            still = [c.name for c in self.cluster.nodeclaims.values()
                     if c.node_class_ref == nodeclass.name and not c.terminating]
            if still:
                log.info("nodeclass %s blocked on %d nodeclaims",
                         nodeclass.name, len(still))
                return False
        if nodeclass.role:
            self.instance_profiles.delete(nodeclass)
            nodeclass.status_instance_profile = ""
        if launch_templates is not None:
            launch_templates.delete_all(nodeclass)
        return True


# ---------------------------------------------------------------------------
# Admission: defaulting + validation live in api/admission.py (webhook
# analogs, karpenter:pkg/webhooks/webhooks.go:44-63), re-exported here as
# in the reference.
# ---------------------------------------------------------------------------

from ..api.admission import (ValidationError, default_nodeclass,  # noqa: E402,F401
                             default_nodepool, validate_nodeclass,
                             validate_nodeclass_update, validate_nodepool)
