"""Launch-template provider: ensure/cache/invalidate/hydrate.

A copy of the JAX package's `providers/launchtemplate.py`, which
re-implements karpenter:pkg/providers/launchtemplate/launchtemplate.go:
  * `ensure_all` — resolve the launch into per-image LaunchSpecs and make
    sure a stored launch template exists for each, returning
    (template, instance-types) pairs for the fleet call (EnsureAll:106-135);
  * templates are content-addressed: the name is a hash of every field that
    affects the boot, so config drift naturally creates new templates
    (ensureLaunchTemplate:200-286);
  * a TTL cache avoids re-describing; `invalidate` drops an entry when the
    cloud 404s it (Invalidate:137-146); `hydrate_cache` pre-warms from the
    cloud's stored templates at startup (hydrateCache:336).
"""

from __future__ import annotations

import hashlib
import json
import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..api.objects import NodeClass
from ..catalog.instancetype import InstanceType
from ..cloud.cache import TTLCache
from ..cloud.fake import CloudError, LaunchTemplateInfo
from .imagefamily import LaunchSpec, Resolver

log = logging.getLogger("karpenter_tpu_torch.launchtemplate")

LAUNCH_TEMPLATE_CACHE_TTL = 10 * 60.0
NAME_PREFIX = "karpenter-tpu/"


@dataclass
class ResolvedTemplate:
    template: LaunchTemplateInfo
    instance_types: List[InstanceType]


def template_name(spec: LaunchSpec, cluster_name: str,
                  nodeclass_name: str = "") -> str:
    """Content-addressed template name — hash of every boot-affecting field
    (launchtemplate.go launchTemplateName).  The owning nodeclass is part of
    the identity so per-nodeclass GC (delete_all) can never collect a
    template another nodeclass still references."""
    payload = json.dumps({
        "image": spec.image.id,
        "user_data": spec.user_data,
        "sgs": sorted(spec.security_group_ids),
        "profile": spec.instance_profile,
        "bdm": spec.block_device_gib,
        "bdms": list(spec.block_device_mappings),
        "imds": list(spec.metadata_options),
        "monitoring": spec.detailed_monitoring,
        "store_policy": spec.instance_store_policy,
        "public_ip": spec.associate_public_ip,
        "tags": sorted(spec.tags.items()),
        "cluster": cluster_name,
        "nodeclass": nodeclass_name,
    }, sort_keys=True)
    return NAME_PREFIX + hashlib.sha256(payload.encode()).hexdigest()[:16]


class LaunchTemplateProvider:
    def __init__(self, cloud, resolver: Resolver, cluster_name: str, clock=None):
        self.cloud = cloud
        self.resolver = resolver
        self.cluster_name = cluster_name
        self._cache = TTLCache(LAUNCH_TEMPLATE_CACHE_TTL,
                               **({"clock": clock} if clock else {}))

    def ensure_all(self, nodeclass: NodeClass,
                   instance_types: Sequence[InstanceType],
                   labels: Optional[Dict[str, str]] = None, taints: Sequence = (),
                   kubelet=None, max_pods: Optional[int] = None,
                   security_group_ids: Tuple[str, ...] = (),
                   instance_profile: str = "") -> List[ResolvedTemplate]:
        specs = self.resolver.resolve(
            nodeclass, instance_types, labels=labels, taints=taints,
            kubelet=kubelet, max_pods=max_pods,
            security_group_ids=security_group_ids,
            instance_profile=instance_profile)
        return [ResolvedTemplate(self._ensure(spec, nodeclass), spec.instance_types)
                for spec in specs]

    def _ensure(self, spec: LaunchSpec, nodeclass: NodeClass) -> LaunchTemplateInfo:
        name = template_name(spec, self.cluster_name, nodeclass.name)
        cached = self._cache.get(name)
        if cached is not None:
            return cached
        lt = LaunchTemplateInfo(
            name=name, image_id=spec.image.id, user_data=spec.user_data,
            security_group_ids=tuple(spec.security_group_ids),
            block_device_gib=spec.block_device_gib,
            block_device_mappings=tuple(spec.block_device_mappings),
            metadata_options=tuple(spec.metadata_options),
            detailed_monitoring=spec.detailed_monitoring,
            instance_store_policy=spec.instance_store_policy,
            associate_public_ip=spec.associate_public_ip,
            instance_profile=spec.instance_profile,
            tags={**spec.tags, "karpenter.sh/cluster": self.cluster_name,
                  "karpenter.sh/nodeclass": nodeclass.name})
        try:
            self.cloud.create_launch_template(lt)
        except CloudError as e:
            from ..cloud.errors import is_already_exists
            if not is_already_exists(e):   # create raced: template is there
                raise
            lt = self.cloud.launch_templates[name]
        self._cache.set(name, lt)
        return lt

    def invalidate(self, name: str) -> None:
        """Drop a template the cloud no longer knows — the launch path
        retries with a fresh create (Invalidate:137-146)."""
        self._cache.delete(name)

    def hydrate_cache(self) -> int:
        """Pre-warm from stored templates tagged to this cluster
        (hydrateCache:336)."""
        n = 0
        for lt in self.cloud.describe_launch_templates(
                tag_filter={"karpenter.sh/cluster": self.cluster_name}):
            self._cache.set(lt.name, lt)
            n += 1
        return n

    def delete_all(self, nodeclass: NodeClass) -> int:
        """GC this nodeclass's stored templates (nodeclass finalize path);
        other nodeclasses' templates in the same cluster are untouched."""
        n = 0
        for lt in self.cloud.describe_launch_templates(
                tag_filter={"karpenter.sh/cluster": self.cluster_name,
                            "karpenter.sh/nodeclass": nodeclass.name}):
            try:
                self.cloud.delete_launch_template(lt.name)
                self._cache.delete(lt.name)
                n += 1
            except CloudError:
                pass
        return n
