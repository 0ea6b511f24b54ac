"""Legacy (alpha-era) API kinds and their conversion to the current API
(a copy of the JAX package's `api/legacy.py`).

The reference carries three deprecated alpha-era kinds — `Provisioner`
and `Machine` (karpenter.sh/v1alpha5) and `AWSNodeTemplate`
(karpenter:pkg/apis/v1alpha1/awsnodetemplate.go:95 + provider.go:24)
— and ships `karpenter-convert` to migrate manifests to the current API
(karpenter:tools/karpenter-convert/README.md:1-10).  This module is
both halves: the legacy manifest shapes and the conversion.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .objects import Disruption, NodeClass, NodePool, NodePoolTemplate
from .requirements import Requirements
from .resources import ResourceList
from .serialize import (nodeclass_to_manifest, nodepool_to_manifest,
                        requirement_from_dict, taint_from_dict)

LEGACY_GROUP = "karpenter.tpu"
LEGACY_VERSION = "v1alpha5"


def convert_provisioner(m: Dict) -> Dict:
    """Legacy Provisioner manifest → NodePool manifest.

    Field moves (karpenter-convert semantics):
      spec.{requirements,taints,startupTaints,labels}  → spec.template.spec/metadata
      spec.providerRef                                 → template.spec.nodeClassRef
      spec.ttlSecondsAfterEmpty                        → disruption{WhenEmpty, consolidateAfter}
      spec.consolidation.enabled                       → disruption.WhenUnderutilized
      spec.ttlSecondsUntilExpired                      → disruption.expireAfter
      spec.{limits,weight}                             → unchanged
    """
    spec = m.get("spec", {})
    template = NodePoolTemplate(
        labels=dict(spec.get("labels", {})),
        annotations=dict(spec.get("annotations", {})),
        requirements=Requirements.of(*[requirement_from_dict(r)
                                       for r in spec.get("requirements", [])]),
        taints=[taint_from_dict(t) for t in spec.get("taints", [])],
        startup_taints=[taint_from_dict(t)
                        for t in spec.get("startupTaints", [])],
        node_class_ref=spec.get("providerRef", {}).get("name", "default"),
    )
    if spec.get("consolidation", {}).get("enabled"):
        disruption = Disruption(consolidation_policy="WhenUnderutilized")
    elif "ttlSecondsAfterEmpty" in spec:
        disruption = Disruption(
            consolidation_policy="WhenEmpty",
            consolidate_after_s=float(spec["ttlSecondsAfterEmpty"]))
    else:
        disruption = Disruption(consolidation_policy="WhenUnderutilized")
    if "ttlSecondsUntilExpired" in spec:
        disruption.expire_after_s = float(spec["ttlSecondsUntilExpired"])
    limits = spec.get("limits", {})
    pool = NodePool(
        name=m.get("metadata", {}).get("name", "default"),
        template=template,
        disruption=disruption,
        limits=ResourceList.parse(limits.get("resources", limits) or {}),
        weight=int(spec.get("weight", 0)),
    )
    return nodepool_to_manifest(pool)


def convert_node_template(m: Dict) -> Dict:
    """Legacy NodeTemplate (AWSNodeTemplate analog) → NodeClass manifest.

    Field moves: amiFamily→imageFamily, {subnet,securityGroup,ami}Selector
    flat tag maps → *SelectorTerms, instanceProfile/role, userData,
    blockDeviceMappings[0] size → blockDeviceGiB."""
    spec = m.get("spec", {})
    bdm = spec.get("blockDeviceMappings", [])
    gib = 20
    if bdm:
        from .resources import EPHEMERAL_STORAGE, parse_quantity
        size = bdm[0].get("ebs", bdm[0]).get("volumeSize", "20Gi")
        if isinstance(size, (int, float)):
            gib = max(1, int(size))  # bare numbers mean GiB in EBS specs
        else:
            gib = max(1, round(parse_quantity(size, EPHEMERAL_STORAGE) / 2**30))
    family_map = {"AL2": "standard", "Bottlerocket": "config",
                  "Custom": "custom"}
    family = spec.get("amiFamily", "standard")
    nc = NodeClass(
        name=m.get("metadata", {}).get("name", "default"),
        image_family=family_map.get(family, family),
        subnet_selector=dict(spec.get("subnetSelector", {})),
        security_group_selector=dict(spec.get("securityGroupSelector", {})),
        image_selector=dict(spec.get("amiSelector", {})),
        role=spec.get("role", spec.get("instanceProfile", "")),
        user_data=spec.get("userData", ""),
        tags=dict(spec.get("tags", {})),
        block_device_gib=gib,
    )
    return nodeclass_to_manifest(nc)


def convert_machine(m: Dict) -> Dict:
    """Legacy Machine (machine-era NodeClaim, karpenter.sh/v1alpha5) →
    NodeClaim manifest.

    Field moves: the owning provisioner label → nodePoolRef,
    machineTemplateRef → nodeClassRef, requirements/taints/resources carry
    over, status.providerID and the launch metadata survive so hydrated
    fleets keep their identity.  Built through NodeClaim +
    nodeclaim_to_manifest like the sibling converters, so the wire shape
    has exactly one owner (serialize.py)."""
    from .objects import NodeClaim
    from .serialize import nodeclaim_to_manifest
    spec = m.get("spec", {})
    status = m.get("status", {})
    meta = m.get("metadata", {})
    pool = meta.get("labels", {}).get("karpenter.sh/provisioner-name",
                                      spec.get("provisionerRef", {})
                                      .get("name", "default"))
    claim = NodeClaim(
        nodepool=pool,
        node_class_ref=spec.get("machineTemplateRef", {}).get("name",
                                                              "default"),
        requirements=Requirements.of(*[requirement_from_dict(r)
                                       for r in spec.get("requirements", [])]),
        requests=ResourceList.parse(
            spec.get("resources", {}).get("requests", {}) or {}),
        taints=[taint_from_dict(t) for t in spec.get("taints", [])],
        labels=dict(meta.get("labels", {})),
    )
    if meta.get("name"):
        claim.name = meta["name"]
    # provider-created claims carry the nodepool label; migrated ones must
    # too, or pool-keyed selectors/lookups treat the node as pool-less
    from . import labels as wk
    claim.labels.setdefault(wk.NODEPOOL, pool)
    claim.provider_id = status.get("providerID", "")
    claim.instance_type = status.get("instanceType", "")
    claim.zone = status.get("zone", "")
    claim.capacity_type = status.get("capacityType", "")
    claim.image_id = status.get("imageID", "")
    claim.price = float(status.get("price", 0.0))
    claim.launched_at = float(status.get("launchedAt", 0.0))
    return nodeclaim_to_manifest(claim)


def convert_manifest(m: Dict) -> Dict:
    """Dispatch on kind; current-API kinds pass through unchanged."""
    kind = m.get("kind", "")
    if kind == "Provisioner":
        return convert_provisioner(m)
    if kind in ("NodeTemplate", "AWSNodeTemplate"):
        return convert_node_template(m)
    if kind == "Machine":
        return convert_machine(m)
    if kind in ("NodePool", "NodeClass", "NodeClaim"):
        return m
    raise ValueError(f"cannot convert kind {kind!r}")
