"""Admission layer: defaulting + validation for the API kinds.

A copy of the JAX package's `api/admission.py`: the analog of Karpenter's
knative admission webhooks (karpenter:pkg/webhooks/webhooks.go:44-63) and
hand-written spec validation (karpenter:pkg/apis/v1beta1/
ec2nodeclass_validation.go:1-299, karpenter:pkg/apis/v1alpha1/
provider_validation.go:1-266, plus the CEL rules baked into
karpenter:pkg/apis/crds/karpenter.sh_nodepools.yaml): NodePool and
NodeClass defaulting, object validation and update-time immutability,
and `validate_manifest`, the schema check of a manifest document that
`Operator.apply` runs before construction.  The reference skips that
check where the `jsonschema` package is missing; the port needs the
package, so a manifest is never admitted unchecked.
"""

from __future__ import annotations

import re
from typing import Dict

from . import labels as wk
from .requirements import (DOES_NOT_EXIST, EXISTS, GT, IN, LT, NOT_IN,
                           Requirements)
from .taints import Taint

VALID_OPERATORS = (IN, NOT_IN, EXISTS, DOES_NOT_EXIST, GT, LT)
VALID_TAINT_EFFECTS = ("NoSchedule", "PreferNoSchedule", "NoExecute")

# Labels users may not constrain or stamp: owned by the controller itself
# (reference karpenter-core RestrictedLabels + nodepool CEL rules).
RESTRICTED_LABELS = (
    wk.NODEPOOL,
    wk.NODE_INITIALIZED,
    wk.HOSTNAME,
)

# Tag keys the controller owns — user tags matching these patterns are
# rejected (reference RestrictedTagPatterns,
# karpenter:pkg/apis/v1beta1/ec2nodeclass_validation.go:282-293).
RESTRICTED_TAG_PATTERNS = (
    re.compile(r"^karpenter\.sh/"),
    re.compile(r"^kubernetes\.io/cluster/"),
)

_QUALIFIED_NAME = re.compile(
    r"^([a-z0-9]([a-z0-9\-._]*[a-z0-9])?/)?[A-Za-z0-9]([A-Za-z0-9\-._]*[A-Za-z0-9])?$")


class ValidationError(ValueError):
    """Admission rejection — reference-style message listing every failure."""


def _label_key_ok(key: str) -> bool:
    return bool(key) and len(key) <= 317 and bool(_QUALIFIED_NAME.match(key))


# ---------------------------------------------------------------------------
# requirements / taints
# ---------------------------------------------------------------------------

def validate_requirement_dict(d: Dict, errs: list, where: str) -> None:
    """Wire-form requirement validation (operator whitelist, value rules —
    the karpenter.sh_nodepools.yaml CEL surface)."""
    key = d.get("key", "")
    op = d.get("operator", IN)
    values = list(d.get("values", []))
    if not _label_key_ok(str(key)):
        errs.append(f"{where}: invalid requirement key {key!r}")
    if op not in VALID_OPERATORS:
        errs.append(f"{where}: unknown operator {op!r} "
                    f"(want one of {list(VALID_OPERATORS)})")
        return
    if op in (IN, NOT_IN) and not values:
        errs.append(f"{where}: operator {op} requires values")
    if op in (EXISTS, DOES_NOT_EXIST) and values:
        errs.append(f"{where}: operator {op} must not carry values")
    if op in (GT, LT):
        if len(values) != 1:
            errs.append(f"{where}: operator {op} takes exactly one value")
        else:
            try:
                if int(values[0]) < 0:
                    errs.append(f"{where}: operator {op} value must be >= 0")
            except ValueError:
                errs.append(f"{where}: operator {op} value {values[0]!r} "
                            f"is not an integer")
    if key in RESTRICTED_LABELS:
        errs.append(f"{where}: label {key} is restricted")


def validate_requirements(reqs: Requirements, errs: list, where: str) -> None:
    """Object-form requirement validation (post-parse)."""
    for key, r in reqs.items():
        if not _label_key_ok(key):
            errs.append(f"{where}: invalid requirement key {key!r}")
        if key in RESTRICTED_LABELS:
            errs.append(f"{where}: label {key} is restricted")
        if not r.complement and not r.values and r.greater_than is None \
                and r.less_than is None:
            errs.append(f"{where}: requirement on {key} matches nothing "
                        f"(empty In set)")


def validate_taint(t: Taint, errs: list, where: str) -> None:
    if not t.key or not _label_key_ok(t.key):
        errs.append(f"{where}: invalid taint key {t.key!r}")
    if t.effect not in VALID_TAINT_EFFECTS:
        errs.append(f"{where}: invalid taint effect {t.effect!r} "
                    f"(want one of {list(VALID_TAINT_EFFECTS)})")


def validate_labels(labels: Dict[str, str], errs: list, where: str) -> None:
    for k, v in labels.items():
        if not _label_key_ok(k):
            errs.append(f"{where}: invalid label key {k!r}")
        if k in RESTRICTED_LABELS:
            errs.append(f"{where}: label {k} is restricted")
        if len(str(v)) > 63:
            errs.append(f"{where}: label value for {k} exceeds 63 chars")


# ---------------------------------------------------------------------------
# NodePool
# ---------------------------------------------------------------------------

def default_nodepool(pool) -> "NodePool":
    """Defaulting webhook analog for NodePool: normalize the consolidation
    policy and nodeclass ref."""
    if not pool.disruption.consolidation_policy:
        pool.disruption.consolidation_policy = "WhenUnderutilized"
    if not pool.template.node_class_ref:
        pool.template.node_class_ref = "default"
    return pool


def validate_nodepool(pool) -> None:
    """NodePool validation (karpenter.sh_nodepools.yaml CEL rules + core
    nodepool validation): weight bounds, disruption config, limits >= 0,
    taint shapes, requirement whitelists, restricted labels."""
    errs: list = []
    if pool.weight < 0 or pool.weight > 100:
        errs.append(f"weight {pool.weight} outside [0, 100]")
    d = pool.disruption
    if d.consolidation_policy not in ("WhenUnderutilized", "WhenEmpty"):
        errs.append(f"unknown consolidation policy {d.consolidation_policy!r}")
    if d.consolidation_policy == "WhenEmpty" and d.consolidate_after_s is None:
        errs.append("WhenEmpty requires consolidate_after_s")
    if d.consolidate_after_s is not None and d.consolidate_after_s < 0:
        errs.append("consolidate_after_s must be >= 0")
    if d.expire_after_s is not None and d.expire_after_s <= 0:
        errs.append("expire_after_s must be positive")
    for k, v in (pool.limits or {}).items():
        if v < 0:
            errs.append(f"limit {k} must be >= 0, got {v}")
    validate_labels(pool.template.labels, errs, "template.labels")
    validate_requirements(pool.template.requirements, errs,
                          "template.requirements")
    for i, t in enumerate(pool.template.taints):
        validate_taint(t, errs, f"template.taints[{i}]")
    for i, t in enumerate(pool.template.startup_taints):
        validate_taint(t, errs, f"template.startupTaints[{i}]")
    kc = pool.template.kubelet
    if kc is not None:
        if kc.max_pods is not None and kc.max_pods <= 0:
            errs.append("kubelet.max_pods must be positive")
        if kc.pods_per_core is not None and kc.pods_per_core < 0:
            errs.append("kubelet.pods_per_core must be >= 0")
    if errs:
        raise ValidationError("; ".join(errs))


# ---------------------------------------------------------------------------
# NodeClass
# ---------------------------------------------------------------------------

def default_nodeclass(nodeclass) -> "NodeClass":
    """Defaulting webhook analog: fill family and block-device defaults."""
    if not nodeclass.image_family:
        nodeclass.image_family = "standard"
    if nodeclass.block_device_gib <= 0:
        nodeclass.block_device_gib = 20
    return nodeclass


def _validate_selector(sel: Dict[str, str], errs: list, where: str,
                       allow_name: bool = True) -> None:
    """Selector-term rules (ec2nodeclass_validation.go:90-137): at least one
    discriminator; `id` mutually exclusive with everything else; `name`
    mutually exclusive with tags where the reference says so; no empty tag
    keys or values."""
    for k, v in sel.items():
        if not k:
            errs.append(f"{where}: empty selector key")
        if v == "":
            errs.append(f"{where}: empty selector value for key {k!r}")
    if "id" in sel and len(sel) > 1:
        errs.append(f'{where}: "id" is mutually exclusive, cannot be set '
                    f"with a combination of other fields")
    if not allow_name and "name" in sel and len(sel) > 1:
        errs.append(f'{where}: "name" is mutually exclusive, cannot be set '
                    f"with a combination of other fields")


def validate_nodeclass(nodeclass) -> None:
    """Validation webhook analog (ec2nodeclass_validation.go): reject specs
    that cannot launch."""
    from ..providers.imagefamily import FAMILIES
    errs: list = []
    if nodeclass.image_family not in FAMILIES:
        errs.append(f"unknown image family {nodeclass.image_family!r} "
                    f"(want one of {FAMILIES})")
    if nodeclass.image_family == "custom" and not nodeclass.image_selector:
        errs.append("custom image family requires an image selector")
    if nodeclass.image_family == "config" and \
            nodeclass.user_data.lstrip().startswith("MIME-Version"):
        errs.append("config family user data must be key=value settings, "
                    "not MIME")
    if nodeclass.block_device_gib < 1:
        errs.append("block device must be >= 1 GiB")
    if nodeclass.block_device_gib > 64 * 1024:
        errs.append("block device must be <= 64 TiB")
    for i, bdm in enumerate(nodeclass.block_device_mappings):
        if not bdm.get("deviceName"):
            errs.append(f"blockDeviceMappings[{i}].deviceName required")
        ebs = bdm.get("ebs", {})
        vt = ebs.get("volumeType")
        if vt is not None and vt not in ("gp2", "gp3", "io1", "io2", "st1",
                                         "sc1", "standard"):
            errs.append(f"blockDeviceMappings[{i}].ebs.volumeType "
                        f"{vt!r} unknown")
        if vt in ("io1", "io2") and not ebs.get("iops"):
            errs.append(f"blockDeviceMappings[{i}].ebs.iops required "
                        f"for {vt}")
    mo = nodeclass.metadata_options
    if mo.get("httpTokens") not in (None, "required", "optional"):
        errs.append("metadataOptions.httpTokens must be required|optional")
    if mo.get("httpEndpoint") not in (None, "enabled", "disabled"):
        errs.append("metadataOptions.httpEndpoint must be enabled|disabled")
    hop = mo.get("httpPutResponseHopLimit")
    if hop is not None:
        try:
            ok_hop = 1 <= int(hop) <= 64
        except (TypeError, ValueError):
            ok_hop = False
        if not ok_hop:
            errs.append("metadataOptions.httpPutResponseHopLimit must be "
                        "an integer in 1-64")
    if nodeclass.instance_store_policy not in ("", "RAID0"):
        errs.append("instanceStorePolicy must be RAID0 when set")
    _validate_selector(nodeclass.subnet_selector, errs, "subnetSelectorTerms",
                       allow_name=True)
    _validate_selector(nodeclass.security_group_selector, errs,
                       "securityGroupSelectorTerms", allow_name=False)
    _validate_selector(nodeclass.image_selector, errs, "imageSelectorTerms",
                       allow_name=True)
    for k, v in nodeclass.tags.items():
        if not k:
            errs.append(f"tags: the tag with key '' and value {v!r} is "
                        f"invalid because empty tag keys aren't supported")
        for pattern in RESTRICTED_TAG_PATTERNS:
            if pattern.match(k):
                errs.append(f"tags: tag {k!r} matches restricted pattern "
                            f"{pattern.pattern!r}")
    if errs:
        raise ValidationError("; ".join(errs))


def validate_nodeclass_update(original, updated) -> None:
    """Update-time immutability (validateRoleImmutability,
    ec2nodeclass_validation.go:287-296)."""
    if original.role != updated.role:
        raise ValidationError("immutable field changed: role")


# ---------------------------------------------------------------------------
# manifest-level admission (schema + object rules)
# ---------------------------------------------------------------------------

def validate_manifest(manifest: Dict) -> None:
    """Schema-check a manifest document against the CRD schema for its kind
    (the openAPIV3Schema admission surface), raising ValidationError with
    every violation listed."""
    from .serialize import crd_schemas
    kind = manifest.get("kind", "")
    # the reference publishes AWSNodeTemplate under both spellings; one
    # schema covers both (legacy.py converts either)
    schema = crd_schemas().get(
        "NodeTemplate" if kind == "AWSNodeTemplate" else kind)
    if schema is None:
        raise ValidationError(f"unknown kind {kind!r}")
    import jsonschema
    validator = jsonschema.Draft202012Validator(schema)
    errors = sorted(validator.iter_errors(manifest), key=lambda e: list(e.path))
    if errors:
        msgs = []
        for e in errors:
            path = ".".join(str(p) for p in e.path) or "(root)"
            msgs.append(f"{path}: {e.message}")
        raise ValidationError("; ".join(msgs))
