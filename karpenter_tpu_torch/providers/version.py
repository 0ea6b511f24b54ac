"""Control-plane version provider, TTL-cached
(karpenter:pkg/providers/version/version.go:56)."""

from __future__ import annotations

from ..cloud.cache import TTLCache
from ..cloud.services import FakeControlPlane

VERSION_CACHE_TTL = 15 * 60.0
_KEY = "version"


class VersionProvider:
    def __init__(self, control_plane: FakeControlPlane, clock=None):
        self.control_plane = control_plane
        self._cache = TTLCache(VERSION_CACHE_TTL, **({"clock": clock} if clock else {}))

    def get(self) -> str:
        v = self._cache.get(_KEY)
        if v is None:
            v = self.control_plane.server_version()
            self._cache.set(_KEY, v)
        return v
