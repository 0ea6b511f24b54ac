"""TTL caches and the unavailable-offerings (ICE) cache.

A copy of the JAX package's `cloud/cache.py` (the analog of Karpenter's
pkg/cache/unavailableofferings.go:31-81 and pkg/cache/cache.go): a TTL
cache keyed `capacityType:instanceType:zone` of recently
capacity-exhausted offerings, with an atomic sequence number so downstream
memoization (the instance-type catalog) invalidates when availability
changes.  Plain `threading.Lock`s replace the reference's named locks."""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple


UNAVAILABLE_OFFERINGS_TTL = 3 * 60.0  # seconds (Karpenter: 3m, pkg/cache/cache.go)


class TTLCache:
    """Minimal expiring map (patrickmn/go-cache analog)."""

    def __init__(self, default_ttl: float, clock: Callable[[], float] = time.time):
        self.default_ttl = default_ttl
        self.clock = clock
        self._lock = threading.Lock()
        self._data: Dict[Any, Tuple[float, Any]] = {}  # guarded-by: _lock

    def set(self, key, value, ttl: Optional[float] = None):
        expires = self.clock() + (self.default_ttl if ttl is None else ttl)
        with self._lock:
            self._data[key] = (expires, value)

    def get(self, key, default=None):
        now = self.clock()
        with self._lock:
            item = self._data.get(key)
            if item is None:
                return default
            expires, value = item
            if expires < now:
                # leave removal to purge_expired() so eviction is observable
                # (seq-num bump) even when nobody re-reads this key
                return default
            return value

    def __contains__(self, key):
        return self.get(key, _SENTINEL) is not _SENTINEL

    def delete(self, key):
        with self._lock:
            self._data.pop(key, None)

    def flush(self):
        with self._lock:
            self._data.clear()

    def purge_expired(self) -> int:
        """Drop expired entries; returns how many were dropped (the OnEvicted
        analog callers use to invalidate downstream memoization)."""
        now = self.clock()
        with self._lock:
            dead = [k for k, (exp, _) in self._data.items() if exp < now]
            for k in dead:
                del self._data[k]
            return len(dead)

    def items(self):
        now = self.clock()
        with self._lock:
            return [(k, v) for k, (exp, v) in self._data.items() if exp >= now]

    def __len__(self):
        return len(self.items())


_SENTINEL = object()


class UnavailableOfferings:
    """ICE-driven offering blacklist
    (karpenter:pkg/cache/unavailableofferings.go:31-81)."""

    def __init__(self, ttl: float = UNAVAILABLE_OFFERINGS_TTL,
                 clock: Callable[[], float] = time.time):
        self._cache = TTLCache(ttl, clock)
        self._lock = threading.Lock()
        self._seq = 0                           # guarded-by: _lock

    @staticmethod
    def key(capacity_type: str, instance_type: str, zone: str) -> str:
        return f"{capacity_type}:{instance_type}:{zone}"

    @property
    def seq_num(self) -> int:
        """Monotone availability version. TTL expiry counts as a change —
        the reference bumps its seq from the cache's OnEvicted hook
        (karpenter:pkg/cache/unavailableofferings.go:37-43) so the
        memoized catalog re-admits recovered offerings."""
        expired = self._cache.purge_expired()
        if expired:
            with self._lock:
                self._seq += expired
        return self._seq

    def is_unavailable(self, capacity_type: str, instance_type: str, zone: str) -> bool:
        return self.key(capacity_type, instance_type, zone) in self._cache

    def mark_unavailable(self, reason: str, instance_type: str, zone: str,
                         capacity_type: str) -> None:
        with self._lock:
            self._seq += 1
        self._cache.set(self.key(capacity_type, instance_type, zone), reason)

    def mark_unavailable_for_fleet_err(self, err_code: str, instance_type: str,
                                       zone: str, capacity_type: str) -> None:
        self.mark_unavailable(f"fleet:{err_code}", instance_type, zone, capacity_type)

    def delete(self, instance_type: str, zone: str, capacity_type: str) -> None:
        with self._lock:
            self._seq += 1
        self._cache.delete(self.key(capacity_type, instance_type, zone))

    def flush(self):
        with self._lock:
            self._seq += 1
        self._cache.flush()

    # ---- warm restart -----------------------------------------------------
    def snapshot_state(self) -> Dict:
        """Round-trippable export: raw entries with absolute expiry stamps
        plus the sequence number.  Entries whose TTL lapsed while the
        operator was down simply read as expired after restore — the
        purge-on-read path counts them as availability changes as usual."""
        with self._cache._lock:
            data = dict(self._cache._data)
        with self._lock:
            seq = self._seq
        return {"entries": data, "seq": seq}

    def restore_state(self, data: Dict) -> None:
        with self._cache._lock:
            self._cache._data.clear()
            self._cache._data.update(data["entries"])
        with self._lock:
            self._seq = int(data["seq"])
