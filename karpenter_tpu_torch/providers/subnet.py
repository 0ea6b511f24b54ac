"""Subnet provider: placement-target discovery + in-flight IP accounting.

A copy of the JAX package's `providers/subnet.py`, which re-implements
karpenter:pkg/providers/subnet/subnet.go:
  * `list(nodeclass)` — discovery by selector terms, TTL-cached (:59);
  * `zonal_subnets_for_launch` — per-zone pick of the subnet with the most
    free IPs, predicting the IP draw of the pending launch so parallel
    launches don't oversubscribe a zone (:110-147);
  * `update_inflight_ips` — refund/settle predictions from the fleet
    response (:149).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from ..api.objects import NodeClass
from ..cloud.cache import TTLCache
from ..cloud.fake import SubnetInfo
from . import matches_selector

SUBNET_CACHE_TTL = 60.0  # reference caches subnet describes ~1m


class SubnetProvider:
    def __init__(self, cloud, clock=None):
        self.cloud = cloud
        self._cache = TTLCache(SUBNET_CACHE_TTL, **({"clock": clock} if clock else {}))
        self._lock = threading.Lock()
        # subnet id → IPs predicted-consumed by launches still in flight
        self._inflight: Dict[str, int] = {}

    def list(self, nodeclass: NodeClass) -> List[SubnetInfo]:
        """Subnets matching the nodeclass selector (empty selector ∧ no zone
        filter == all), cached per selector."""
        key = (tuple(sorted(nodeclass.subnet_selector.items())),
               tuple(nodeclass.zone_selector))
        cached = self._cache.get(key)
        if cached is not None:
            return list(cached)
        subnets = [
            s for s in self.cloud.describe_subnets()
            if matches_selector(s.id, s.tags, nodeclass.subnet_selector)
            and (not nodeclass.zone_selector or s.zone in nodeclass.zone_selector)
        ]
        self._cache.set(key, subnets)
        return list(subnets)

    def zonal_subnets_for_launch(self, nodeclass: NodeClass,
                                 zones: Optional[Sequence[str]] = None,
                                 ips_per_launch: int = 1) -> Dict[str, SubnetInfo]:
        """zone → chosen subnet (most effective free IPs), charging the
        in-flight prediction so concurrent launches spread instead of all
        landing on one nearly-full subnet (subnet.go:110-147)."""
        with self._lock:
            out: Dict[str, SubnetInfo] = {}
            for s in self.list(nodeclass):
                if zones is not None and s.zone not in zones:
                    continue
                best = out.get(s.zone)
                if best is None or self._effective_free(s) > self._effective_free(best):
                    out[s.zone] = s
            for s in out.values():
                self._inflight[s.id] = self._inflight.get(s.id, 0) + ips_per_launch
            return out

    def _effective_free(self, s: SubnetInfo) -> int:
        return s.available_ip_count - self._inflight.get(s.id, 0)

    def update_inflight_ips(self, launched_subnet_ids: Sequence[str],
                            requested: Dict[str, SubnetInfo],
                            ips_per_launch: int = 1) -> None:
        """Settle predictions after the fleet response: refund every requested
        subnet the launch did NOT land in (subnet.go UpdateInflightIPs:149)."""
        with self._lock:
            landed = set(launched_subnet_ids)
            for s in requested.values():
                if s.id not in landed:
                    self._inflight[s.id] = max(
                        0, self._inflight.get(s.id, 0) - ips_per_launch)

    def inflight(self, subnet_id: str) -> int:
        with self._lock:
            return self._inflight.get(subnet_id, 0)

    def reset_cache(self):
        self._cache.flush()
        with self._lock:
            self._inflight.clear()
