"""Instance-profile provider: identity-profile lifecycle from `spec.role`
(karpenter:pkg/providers/instanceprofile/instanceprofile.go:49-131)."""

from __future__ import annotations

import hashlib
from typing import Dict

from ..api.objects import NodeClass
from ..cloud.cache import TTLCache
from ..cloud.fake import CloudError
from ..cloud.services import FakeIAM

PROFILE_CACHE_TTL = 15 * 60.0


class InstanceProfileProvider:
    def __init__(self, iam: FakeIAM, cluster_name: str, region: str = "local",
                 clock=None):
        self.iam = iam
        self.cluster_name = cluster_name
        self.region = region
        self._cache = TTLCache(PROFILE_CACHE_TTL, **({"clock": clock} if clock else {}))

    def profile_name(self, nodeclass: NodeClass) -> str:
        """Deterministic name from cluster + nodeclass
        (instanceprofile.go GetProfileName:131)."""
        h = hashlib.sha256(f"{self.region}{nodeclass.name}".encode()).hexdigest()[:20]
        return f"{self.cluster_name}_{h}"

    def create(self, nodeclass: NodeClass, tags: Dict[str, str] = None) -> str:
        """Idempotently ensure the profile exists with the nodeclass role
        attached (instanceprofile.go Create:49-101)."""
        name = self.profile_name(nodeclass)
        if self._cache.get(name):
            return name
        try:
            profile = self.iam.get_instance_profile(name)
        except CloudError as e:
            if e.code != "NoSuchEntity":
                raise
            self.iam.create_instance_profile(name, tags or {})
            profile = self.iam.get_instance_profile(name)
        attached = profile.get("_roles", "")
        if attached and attached != nodeclass.role:
            self.iam.remove_role_from_instance_profile(name, attached)
            attached = ""
        if not attached and nodeclass.role:
            self.iam.add_role_to_instance_profile(name, nodeclass.role)
        self._cache.set(name, True)
        return name

    def delete(self, nodeclass: NodeClass) -> None:
        name = self.profile_name(nodeclass)
        try:
            profile = self.iam.get_instance_profile(name)
            if profile.get("_roles"):
                self.iam.remove_role_from_instance_profile(name, profile["_roles"])
            self.iam.delete_instance_profile(name)
        except CloudError as e:
            if e.code != "NoSuchEntity":
                raise
        self._cache.delete(name)
