"""Manifest (de)serialization for the API objects.

A copy of the JAX package's `api/serialize.py`.  The reference's CRDs (karpenter:pkg/apis/crds/*.yaml) define the
wire format users write; this module is the equivalent seam: NodePool /
NodeClass / NodeClaim ↔ manifest dicts (YAML/JSON), plus generated
JSON-schema documents mirroring the CRD validation surface.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .objects import (Disruption, KubeletConfiguration, NodeClaim, NodeClass,
                      NodePool, NodePoolTemplate)
from .requirements import Requirement, Requirements
from .resources import ResourceList, format_quantity
from .taints import Taint

GROUP = "karpenter.tpu"
VERSION = "v1beta1"


# ---------------------------------------------------------------------------
# requirements / taints / resources
# ---------------------------------------------------------------------------

def requirement_to_dict(r: Requirement) -> Dict:
    if r.greater_than is not None:
        return {"key": r.key, "operator": "Gt",
                "values": [str(r.greater_than)]}
    if r.less_than is not None:
        return {"key": r.key, "operator": "Lt", "values": [str(r.less_than)]}
    if r.complement and not r.values:
        return {"key": r.key, "operator": "Exists"}
    if not r.complement and not r.values:
        return {"key": r.key, "operator": "DoesNotExist"}
    return {"key": r.key, "operator": "NotIn" if r.complement else "In",
            "values": sorted(r.values)}


def requirement_from_dict(d: Dict) -> Requirement:
    return Requirement(d["key"], d.get("operator", "In"),
                       list(d.get("values", [])))


def taint_to_dict(t: Taint) -> Dict:
    out = {"key": t.key, "effect": t.effect}
    if t.value:
        out["value"] = t.value
    return out


def taint_from_dict(d: Dict) -> Taint:
    return Taint(d["key"], d.get("effect", "NoSchedule"), d.get("value", ""))


# ---------------------------------------------------------------------------
# NodePool
# ---------------------------------------------------------------------------

def nodepool_to_manifest(pool: NodePool) -> Dict:
    t = pool.template
    spec: Dict = {
        "template": {
            "metadata": {"labels": dict(t.labels),
                         "annotations": dict(t.annotations)},
            "spec": {
                "nodeClassRef": {"name": t.node_class_ref},
                "requirements": [requirement_to_dict(r)
                                 for r in t.requirements.values()],
                "taints": [taint_to_dict(x) for x in t.taints],
                "startupTaints": [taint_to_dict(x) for x in t.startup_taints],
            },
        },
    }
    kc = t.kubelet
    if kc.key() is not None or kc.cluster_dns:
        kd: Dict = {}
        if kc.max_pods is not None:
            kd["maxPods"] = kc.max_pods
        if kc.pods_per_core:
            kd["podsPerCore"] = kc.pods_per_core
        if kc.kube_reserved:
            kd["kubeReserved"] = {k: format_quantity(v, k)
                                  for k, v in kc.kube_reserved.items()}
        if kc.system_reserved:
            kd["systemReserved"] = {k: format_quantity(v, k)
                                    for k, v in kc.system_reserved.items()}
        if kc.eviction_hard:
            kd["evictionHard"] = {k: format_quantity(v, k)
                                  for k, v in kc.eviction_hard.items()}
        if kc.eviction_soft:
            kd["evictionSoft"] = {k: format_quantity(v, k)
                                  for k, v in kc.eviction_soft.items()}
        if kc.cluster_dns:
            kd["clusterDNS"] = list(kc.cluster_dns)
        spec["template"]["spec"]["kubelet"] = kd
    spec.update({
        "disruption": _disruption_to_dict(pool.disruption),
        "weight": pool.weight,
    })
    if pool.limits:
        spec["limits"] = {k: format_quantity(v, k)
                          for k, v in pool.limits.items()}
    return {"apiVersion": f"{GROUP}/{VERSION}", "kind": "NodePool",
            "metadata": {"name": pool.name}, "spec": spec}


def _disruption_to_dict(d: Disruption) -> Dict:
    out: Dict = {"consolidationPolicy": d.consolidation_policy}
    if d.consolidate_after_s is not None:
        out["consolidateAfter"] = f"{int(d.consolidate_after_s)}s"
    out["expireAfter"] = ("Never" if d.expire_after_s is None
                          else f"{int(d.expire_after_s)}s")
    return out


def _parse_duration(v) -> Optional[float]:
    if v in (None, "Never"):
        return None
    s = str(v)
    units = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}
    if s and s[-1] in units:
        return float(s[:-1]) * units[s[-1]]
    return float(s)


def _kubelet_from_dict(d: Dict) -> KubeletConfiguration:
    """kubelet block per the reference NodePool CRD
    (karpenter:pkg/apis/crds/karpenter.sh_nodepools.yaml kubelet:
    maxPods, podsPerCore, kubeReserved, systemReserved, evictionHard)."""
    dns = d.get("clusterDNS") or []
    return KubeletConfiguration(
        max_pods=d.get("maxPods"),
        pods_per_core=d.get("podsPerCore"),
        kube_reserved=ResourceList.parse(d.get("kubeReserved", {}) or {}),
        system_reserved=ResourceList.parse(d.get("systemReserved", {}) or {}),
        eviction_hard=ResourceList.parse(d.get("evictionHard", {}) or {}),
        eviction_soft=ResourceList.parse(d.get("evictionSoft", {}) or {}),
        cluster_dns=tuple(dns),
    )


def nodepool_from_manifest(m: Dict, validate: bool = True) -> NodePool:
    """Manifest → NodePool.  With ``validate`` (the default) the admission
    webhook semantics run on the result: defaulting then object validation
    (ValidationError on rejection).  ``validate=False`` is the raw
    round-trip escape hatch."""
    spec = m.get("spec", {})
    tm = spec.get("template", {})
    tspec = tm.get("spec", {})
    template = NodePoolTemplate(
        labels=dict(tm.get("metadata", {}).get("labels", {})),
        annotations=dict(tm.get("metadata", {}).get("annotations", {})),
        requirements=Requirements.of(*[requirement_from_dict(r)
                                       for r in tspec.get("requirements", [])]),
        taints=[taint_from_dict(x) for x in tspec.get("taints", [])],
        startup_taints=[taint_from_dict(x)
                        for x in tspec.get("startupTaints", [])],
        node_class_ref=tspec.get("nodeClassRef", {}).get("name", "default"),
        kubelet=_kubelet_from_dict(tspec.get("kubelet", {})),
    )
    d = spec.get("disruption", {})
    disruption = Disruption(
        consolidation_policy=d.get("consolidationPolicy", "WhenUnderutilized"),
        consolidate_after_s=_parse_duration(d.get("consolidateAfter")),
        expire_after_s=_parse_duration(d.get("expireAfter", "Never")),
    )
    pool = NodePool(
        name=m.get("metadata", {}).get("name", "default"),
        template=template, disruption=disruption,
        limits=ResourceList.parse(spec.get("limits", {}) or {}),
        weight=int(spec.get("weight", 0)),
    )
    if validate:
        from .admission import default_nodepool, validate_nodepool
        pool = default_nodepool(pool)
        validate_nodepool(pool)
    return pool


# ---------------------------------------------------------------------------
# NodeClass
# ---------------------------------------------------------------------------

def nodeclass_to_manifest(nc: NodeClass) -> Dict:
    spec: Dict = {
        "imageFamily": nc.image_family,
        "subnetSelectorTerms": [{"tags": dict(nc.subnet_selector)}]
        if nc.subnet_selector else [],
        "securityGroupSelectorTerms": [{"tags": dict(nc.security_group_selector)}]
        if nc.security_group_selector else [],
        "imageSelectorTerms": [{"tags": dict(nc.image_selector)}]
        if nc.image_selector else [],
        "role": nc.role,
        "userData": nc.user_data,
        "tags": dict(nc.tags),
        "blockDeviceGiB": nc.block_device_gib,
    }
    if nc.block_device_mappings:
        spec["blockDeviceMappings"] = [dict(m) for m in nc.block_device_mappings]
    if nc.metadata_options:
        spec["metadataOptions"] = dict(nc.metadata_options)
    if nc.detailed_monitoring:
        spec["detailedMonitoring"] = True
    if nc.instance_store_policy:
        spec["instanceStorePolicy"] = nc.instance_store_policy
    if nc.associate_public_ip is not None:
        spec["associatePublicIPAddress"] = nc.associate_public_ip
    if nc.zone_selector:
        spec["zones"] = list(nc.zone_selector)
    out = {"apiVersion": f"{GROUP}/{VERSION}", "kind": "NodeClass",
           "metadata": {"name": nc.name}, "spec": spec}
    status = {}
    if nc.status_subnets:
        status["subnets"] = list(nc.status_subnets)
    if nc.status_security_groups:
        status["securityGroups"] = list(nc.status_security_groups)
    if nc.status_images:
        status["images"] = list(nc.status_images)
    if status:
        out["status"] = status
    return out


def _selector_from_terms(terms: List[Dict]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for term in terms or []:
        out.update(term.get("tags", {}))
        if "id" in term:
            out["id"] = term["id"]
        if "name" in term:
            out["name"] = term["name"]
    return out


def nodeclass_from_manifest(m: Dict, validate: bool = True) -> NodeClass:
    """Manifest → NodeClass.  With ``validate`` (the default) the admission
    webhook semantics run on the result: defaulting then object validation
    (ValidationError on rejection).  ``validate=False`` is the raw
    round-trip escape hatch."""
    spec = m.get("spec", {})
    nc = NodeClass(
        name=m.get("metadata", {}).get("name", "default"),
        image_family=spec.get("imageFamily", "standard"),
        zone_selector=list(spec.get("zones", [])),
        subnet_selector=_selector_from_terms(spec.get("subnetSelectorTerms")),
        security_group_selector=_selector_from_terms(
            spec.get("securityGroupSelectorTerms")),
        image_selector=_selector_from_terms(spec.get("imageSelectorTerms")),
        role=spec.get("role", ""),
        user_data=spec.get("userData", ""),
        tags=dict(spec.get("tags", {})),
        block_device_gib=int(spec.get("blockDeviceGiB", 20)),
        block_device_mappings=[dict(x)
                               for x in spec.get("blockDeviceMappings", [])],
        metadata_options=dict(spec.get("metadataOptions", {})),
        detailed_monitoring=bool(spec.get("detailedMonitoring", False)),
        instance_store_policy=spec.get("instanceStorePolicy", ""),
        associate_public_ip=spec.get("associatePublicIPAddress"),
    )
    if validate:
        from .admission import default_nodeclass, validate_nodeclass
        nc = default_nodeclass(nc)
        validate_nodeclass(nc)
    return nc


# ---------------------------------------------------------------------------
# NodeClaim (machine-created; serialized for status export / hydration dumps,
# reference CRD pkg/apis/crds/karpenter.sh_nodeclaims.yaml)
# ---------------------------------------------------------------------------

def nodeclaim_to_manifest(claim: NodeClaim) -> Dict:
    spec: Dict = {
        "nodePoolRef": {"name": claim.nodepool},
        "nodeClassRef": {"name": claim.node_class_ref},
        "requirements": [requirement_to_dict(r)
                         for r in claim.requirements.values()],
        "taints": [taint_to_dict(t) for t in claim.taints],
    }
    if claim.requests:
        spec["resources"] = {"requests": {k: format_quantity(v, k)
                                          for k, v in claim.requests.items()}}
    status: Dict = {}
    if claim.node_class_hash:
        spec["nodeClassHash"] = claim.node_class_hash
    if claim.provider_id:
        status["providerID"] = claim.provider_id
        # empty launch metadata is omitted, not emitted as "" — partially
        # populated claims (e.g. migrated legacy Machine records) must
        # still pass the CRD schema's enums
        status.update({k: v for k, v in {
            "instanceType": claim.instance_type,
            "zone": claim.zone,
            "capacityType": claim.capacity_type,
            "imageID": claim.image_id,
            "price": claim.price,
            "launchedAt": claim.launched_at}.items() if v})
    conds = []
    if claim.launched:
        conds.append({"type": "Launched", "status": "True"})
    if claim.registered:
        conds.append({"type": "Registered", "status": "True"})
    if claim.initialized:
        conds.append({"type": "Initialized", "status": "True"})
    if conds:
        status["conditions"] = conds
    out = {"apiVersion": f"{GROUP}/{VERSION}", "kind": "NodeClaim",
           "metadata": {"name": claim.name,
                        "labels": dict(claim.labels)},
           "spec": spec}
    if status:
        out["status"] = status
    return out


def nodeclaim_from_manifest(m: Dict) -> NodeClaim:
    spec = m.get("spec", {})
    status = m.get("status", {})
    claim = NodeClaim(
        nodepool=spec.get("nodePoolRef", {}).get("name", ""),
        node_class_ref=spec.get("nodeClassRef", {}).get("name", "default"),
        requirements=Requirements.of(*[requirement_from_dict(r)
                                       for r in spec.get("requirements", [])]),
        requests=ResourceList.parse(
            spec.get("resources", {}).get("requests", {}) or {}),
        taints=[taint_from_dict(t) for t in spec.get("taints", [])],
        labels=dict(m.get("metadata", {}).get("labels", {})),
    )
    if m.get("metadata", {}).get("name"):
        claim.name = m["metadata"]["name"]
    claim.node_class_hash = spec.get("nodeClassHash", "")
    claim.provider_id = status.get("providerID", "")
    claim.instance_type = status.get("instanceType", "")
    claim.zone = status.get("zone", "")
    claim.capacity_type = status.get("capacityType", "")
    claim.image_id = status.get("imageID", "")
    claim.price = float(status.get("price", 0.0))
    claim.launched_at = float(status.get("launchedAt", 0.0))
    conds = {c.get("type"): c.get("status") == "True"
             for c in status.get("conditions", [])}
    claim.registered = bool(conds.get("Registered"))
    claim.initialized = bool(conds.get("Initialized"))
    return claim


# ---------------------------------------------------------------------------
# CRD-schema generation (pkg/apis/crds analog)
# ---------------------------------------------------------------------------

def crd_schemas() -> Dict[str, Dict]:
    """JSON-schema documents for the API kinds — the validation surface the
    reference ships as CRD openAPIV3Schema blocks."""
    requirement_schema = {
        "type": "object",
        "required": ["key"],
        "properties": {
            "key": {"type": "string", "minLength": 1},
            "operator": {"enum": ["In", "NotIn", "Exists", "DoesNotExist",
                                  "Gt", "Lt"]},
            "values": {"type": "array", "items": {"type": "string"}},
        },
    }
    taint_schema = {
        "type": "object",
        "required": ["key", "effect"],
        "properties": {
            "key": {"type": "string"},
            "value": {"type": "string"},
            "effect": {"enum": ["NoSchedule", "PreferNoSchedule", "NoExecute"]},
        },
    }
    # deprecated alpha-era kinds (reference ships CRDs for its legacy
    # generations too: provisioners/machines/awsnodetemplates in
    # karpenter:pkg/apis/crds/); `tools/convert.py` migrates them and
    # `api/legacy.py` converts on apply — the schemas document the accepted
    # wire shapes
    provisioner_schema = {
        "$schema": "https://json-schema.org/draft/2020-12/schema",
        "title": f"Provisioner.{GROUP}/v1alpha5 (deprecated)",
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "properties": {
                    "requirements": {"type": "array",
                                     "items": requirement_schema},
                    "taints": {"type": "array", "items": taint_schema},
                    "startupTaints": {"type": "array", "items": taint_schema},
                    "labels": {"type": "object"},
                    "providerRef": {"type": "object"},
                    "ttlSecondsAfterEmpty": {"type": "number", "minimum": 0},
                    "ttlSecondsUntilExpired": {"type": "number", "minimum": 0},
                    "consolidation": {"type": "object"},
                    "limits": {"type": "object"},
                    "weight": {"type": "integer", "minimum": 0,
                               "maximum": 100},
                },
            },
        },
    }
    machine_schema = {
        "$schema": "https://json-schema.org/draft/2020-12/schema",
        "title": f"Machine.{GROUP}/v1alpha5 (deprecated)",
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "properties": {
                    "machineTemplateRef": {"type": "object"},
                    "requirements": {"type": "array",
                                     "items": requirement_schema},
                    "taints": {"type": "array", "items": taint_schema},
                    "resources": {"type": "object"},
                },
            },
            "status": {"type": "object"},
        },
    }
    nodetemplate_schema = {
        "$schema": "https://json-schema.org/draft/2020-12/schema",
        "title": f"NodeTemplate.{GROUP}/v1alpha5 (deprecated)",
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "properties": {
                    "amiFamily": {"type": "string"},
                    "subnetSelector": {"type": "object"},
                    "securityGroupSelector": {"type": "object"},
                    "amiSelector": {"type": "object"},
                    "instanceProfile": {"type": "string"},
                    "role": {"type": "string"},
                    "userData": {"type": "string"},
                    "tags": {"type": "object"},
                    "blockDeviceMappings": {"type": "array"},
                },
            },
        },
    }
    return {
        "Provisioner": provisioner_schema,
        "Machine": machine_schema,
        "NodeTemplate": nodetemplate_schema,
        "NodePool": {
            "$schema": "https://json-schema.org/draft/2020-12/schema",
            "title": f"NodePool.{GROUP}/{VERSION}",
            "type": "object",
            "required": ["spec"],
            "properties": {
                "spec": {
                    "type": "object",
                    "required": ["template"],
                    "properties": {
                        "template": {
                            "type": "object",
                            "properties": {
                                "spec": {
                                    "type": "object",
                                    "properties": {
                                        # pod-density / reserved overrides
                                        # (reference NodePool CRD kubelet)
                                        "kubelet": {
                                            "type": "object",
                                            "properties": {
                                                "maxPods": {
                                                    "type": "integer",
                                                    "minimum": 1},
                                                "podsPerCore": {
                                                    "type": "integer",
                                                    "minimum": 0},
                                                "kubeReserved": {
                                                    "type": "object"},
                                                "systemReserved": {
                                                    "type": "object"},
                                                "evictionHard": {
                                                    "type": "object"},
                                                "clusterDNS": {
                                                    "type": "array",
                                                    "items": {
                                                        "type": "string"}},
                                            },
                                        },
                                    },
                                },
                            },
                        },
                        "weight": {"type": "integer", "minimum": 0,
                                   "maximum": 100},
                        "limits": {"type": "object"},
                        "disruption": {
                            "type": "object",
                            "properties": {
                                "consolidationPolicy": {
                                    "enum": ["WhenUnderutilized", "WhenEmpty"]},
                                "consolidateAfter": {"type": "string"},
                                "expireAfter": {"type": "string"},
                            },
                        },
                        "requirements": {"type": "array",
                                         "items": requirement_schema},
                        "taints": {"type": "array", "items": taint_schema},
                    },
                },
            },
        },
        "NodeClaim": {
            "$schema": "https://json-schema.org/draft/2020-12/schema",
            "title": f"NodeClaim.{GROUP}/{VERSION}",
            "type": "object",
            "required": ["spec"],
            "properties": {
                "spec": {
                    "type": "object",
                    "required": ["nodePoolRef"],
                    "properties": {
                        "nodePoolRef": {
                            "type": "object",
                            "required": ["name"],
                            "properties": {"name": {"type": "string",
                                                    "minLength": 1}},
                        },
                        "nodeClassRef": {
                            "type": "object",
                            "properties": {"name": {"type": "string"}},
                        },
                        "requirements": {"type": "array",
                                         "items": requirement_schema},
                        "taints": {"type": "array", "items": taint_schema},
                        "resources": {
                            "type": "object",
                            "properties": {"requests": {"type": "object"}},
                        },
                        "nodeClassHash": {"type": "string"},
                    },
                },
                "status": {
                    "type": "object",
                    "properties": {
                        "providerID": {"type": "string"},
                        "instanceType": {"type": "string"},
                        "zone": {"type": "string"},
                        "capacityType": {"enum": ["spot", "on-demand"]},
                        "imageID": {"type": "string"},
                        "price": {"type": "number", "minimum": 0},
                        "launchedAt": {"type": "number", "minimum": 0},
                        "conditions": {"type": "array"},
                    },
                },
            },
        },
        "NodeClass": {
            "$schema": "https://json-schema.org/draft/2020-12/schema",
            "title": f"NodeClass.{GROUP}/{VERSION}",
            "type": "object",
            "required": ["spec"],
            "properties": {
                "spec": {
                    "type": "object",
                    "properties": {
                        "imageFamily": {"enum": ["standard", "config",
                                                 "custom"]},
                        "subnetSelectorTerms": {"type": "array"},
                        "securityGroupSelectorTerms": {"type": "array"},
                        "imageSelectorTerms": {"type": "array"},
                        "role": {"type": "string"},
                        "userData": {"type": "string"},
                        "blockDeviceGiB": {"type": "integer", "minimum": 1},
                        "blockDeviceMappings": {
                            "type": "array",
                            "items": {
                                "type": "object",
                                "properties": {
                                    "deviceName": {"type": "string"},
                                    "ebs": {
                                        "type": "object",
                                        "properties": {
                                            "volumeSize": {"oneOf": [
                                                {"type": "string"},
                                                {"type": "number"}]},
                                            "volumeType": {
                                                "enum": ["gp2", "gp3", "io1",
                                                         "io2", "st1", "sc1",
                                                         "standard"]},
                                            "iops": {"type": "integer"},
                                            "throughput": {"type": "integer"},
                                            "encrypted": {"type": "boolean"},
                                            "deleteOnTermination": {
                                                "type": "boolean"},
                                            "snapshotID": {"type": "string"},
                                        },
                                    },
                                },
                            },
                        },
                        "metadataOptions": {
                            "type": "object",
                            "properties": {
                                "httpEndpoint": {
                                    "enum": ["enabled", "disabled"]},
                                "httpTokens": {
                                    "enum": ["required", "optional"]},
                                "httpPutResponseHopLimit": {
                                    "type": "integer", "minimum": 1,
                                    "maximum": 64},
                                "httpProtocolIPv6": {
                                    "enum": ["enabled", "disabled"]},
                            },
                        },
                        "detailedMonitoring": {"type": "boolean"},
                        "instanceStorePolicy": {"enum": ["RAID0"]},
                        "associatePublicIPAddress": {"type": "boolean"},
                    },
                },
            },
        },
    }


# ---------------------------------------------------------------------------
# Pod (k8s PodSpec subset — what the scheduler consumes)
# ---------------------------------------------------------------------------

def pod_from_manifest(m: Dict) -> "Pod":
    """k8s Pod manifest → scheduling Pod.  Parses exactly the surface the
    solver honors (the reference's constraint inventory,
    karpenter:website/content/en/docs/concepts/scheduling.md):
    container resource requests (summed; requests default from limits as
    k8s admission does; plain init containers take the max while sidecar
    init containers — restartPolicy: Always, which run for the pod's whole
    lifetime — are summed with the app containers), nodeSelector,
    required/preferred node affinity, tolerations, topology spread, pod
    (anti-)affinity, priority, pod-deletion-cost and do-not-disrupt
    annotations, owner references."""
    from .objects import Pod, PodAffinityTerm, TopologySpreadConstraint
    meta = m.get("metadata", {})
    spec = m.get("spec", {})

    def _requests(c: Dict) -> "ResourceList":
        # kube-apiserver defaults requests from limits PER RESOURCE NAME
        # when a request is absent: a raw manifest relying on
        # that default must not under-request vs what the kubelet enforces
        res = c.get("resources", {}) or {}
        creq = ResourceList.parse(res.get("requests") or {})
        for k, v in ResourceList.parse(res.get("limits") or {}).items():
            if k not in creq:
                creq[k] = v
        return creq

    # KEP-753 effective request, delegated to the shared single source of
    # truth (resources.pod_requests): sidecars ADD to both the init-phase
    # peak and the steady state; one-shot inits only shape the peak
    from .resources import pod_requests
    req = pod_requests(
        [_requests(c) for c in spec.get("containers", [])],
        [(_requests(c), c.get("restartPolicy") == "Always")
         for c in spec.get("initContainers", [])])
    # declared limits aggregate under the same effective-request formula;
    # containers without limits contribute nothing (k8s: unlimited)
    lim = pod_requests(
        [ResourceList.parse((c.get("resources", {}) or {}).get("limits")
                            or {}) for c in spec.get("containers", [])],
        [(ResourceList.parse((c.get("resources", {}) or {}).get("limits")
                             or {}), c.get("restartPolicy") == "Always")
         for c in spec.get("initContainers", [])])

    required_terms: List[Requirements] = []
    preferred_terms: List = []
    aff = spec.get("affinity", {}) or {}
    node_aff = aff.get("nodeAffinity", {}) or {}
    hard = node_aff.get(
        "requiredDuringSchedulingIgnoredDuringExecution", {}) or {}
    for term in hard.get("nodeSelectorTerms", []):
        reqs = Requirements.of(*[requirement_from_dict(e)
                                 for e in term.get("matchExpressions", [])])
        required_terms.append(reqs)
    for pref in node_aff.get(
            "preferredDuringSchedulingIgnoredDuringExecution", []) or []:
        reqs = Requirements.of(*[
            requirement_from_dict(e)
            for e in pref.get("preference", {}).get("matchExpressions", [])])
        preferred_terms.append((int(pref.get("weight", 1)), reqs))

    def _match_labels(sel: Dict, where: str) -> Dict[str, str]:
        # the model's selectors are matchLabels maps; silently parsing an
        # expressions-based selector as {} would mean "match every pod in
        # the namespace" — refuse instead of misschedule
        if sel.get("matchExpressions"):
            raise ValueError(
                f"labelSelector.matchExpressions not supported ({where})")
        return dict(sel.get("matchLabels", {}))

    pod_affinities: List = []
    for kind, anti in (("podAffinity", False), ("podAntiAffinity", True)):
        block = aff.get(kind, {}) or {}
        for term in block.get(
                "requiredDuringSchedulingIgnoredDuringExecution", []) or []:
            pod_affinities.append(PodAffinityTerm(
                topology_key=term.get("topologyKey", ""),
                label_selector=_match_labels(
                    term.get("labelSelector", {}) or {}, kind),
                anti=anti, required=True))
        for pref in block.get(
                "preferredDuringSchedulingIgnoredDuringExecution", []) or []:
            term = pref.get("podAffinityTerm", {})
            pod_affinities.append(PodAffinityTerm(
                topology_key=term.get("topologyKey", ""),
                label_selector=_match_labels(
                    term.get("labelSelector", {}) or {}, kind),
                anti=anti, required=False))

    spreads = [TopologySpreadConstraint(
        topology_key=t.get("topologyKey", ""),
        max_skew=int(t.get("maxSkew", 1)),
        when_unsatisfiable=t.get("whenUnsatisfiable", "DoNotSchedule"),
        label_selector=_match_labels(t.get("labelSelector", {}) or {},
                                     "topologySpreadConstraints"),
        min_domains=t.get("minDomains"))
        for t in spec.get("topologySpreadConstraints", []) or []]

    annotations = dict(meta.get("annotations", {}))
    owners = meta.get("ownerReferences", []) or []
    return Pod(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        requests=req,
        limits=lim,
        node_selector=dict(spec.get("nodeSelector", {}) or {}),
        required_affinity_terms=required_terms,
        preferred_affinity_terms=preferred_terms,
        tolerations=[_toleration_from_dict(t)
                     for t in spec.get("tolerations", []) or []],
        topology_spread=spreads,
        pod_affinities=pod_affinities,
        labels=dict(meta.get("labels", {})),
        annotations=annotations,
        priority=int(spec.get("priority", 0) or 0),
        deletion_cost=int(annotations.get(
            "controller.kubernetes.io/pod-deletion-cost", 0) or 0),
        owner_kind=(owners[0].get("kind", "") if owners else ""),
    )


def _toleration_from_dict(d: Dict):
    from .taints import Toleration
    return Toleration(key=d.get("key", ""),
                      operator=d.get("operator", "Equal"),
                      value=d.get("value", ""),
                      effect=d.get("effect", ""))
