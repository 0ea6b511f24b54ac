"""Security-group provider: discovery by id/name/tag selector, TTL-cached
(karpenter:pkg/providers/securitygroup/securitygroup.go:54-76)."""

from __future__ import annotations

from typing import List

from ..api.objects import NodeClass
from ..cloud.cache import TTLCache
from ..cloud.fake import SecurityGroupInfo
from . import matches_selector

SECURITY_GROUP_CACHE_TTL = 60.0


class SecurityGroupProvider:
    def __init__(self, cloud, clock=None):
        self.cloud = cloud
        self._cache = TTLCache(SECURITY_GROUP_CACHE_TTL,
                               **({"clock": clock} if clock else {}))

    def list(self, nodeclass: NodeClass) -> List[SecurityGroupInfo]:
        if not nodeclass.security_group_selector:
            return []  # reference requires an explicit selector
        key = tuple(sorted(nodeclass.security_group_selector.items()))
        cached = self._cache.get(key)
        if cached is not None:
            return list(cached)
        groups = [g for g in self.cloud.describe_security_groups()
                  if matches_selector(g.id, g.tags,
                                      nodeclass.security_group_selector,
                                      obj_name=g.name)]
        self._cache.set(key, groups)
        return list(groups)

    def reset_cache(self):
        self._cache.flush()
