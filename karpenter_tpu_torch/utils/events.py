"""Event recorder + log-dedup.

A copy of the JAX package's `utils/events.py`.

The reference publishes Kubernetes Events through a recorder
(karpenter:pkg/cloudprovider/events/,
karpenter:pkg/controllers/interruption/events/events.go) and de-dupes
noisy logs with `pretty.ChangeMonitor`
(karpenter:pkg/providers/instancetype/instancetype.go:200-202).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

logger = logging.getLogger("karpenter_tpu_torch")


@dataclass(frozen=True)
class Event:
    """A normalized event: reason + involved object + message."""
    kind: str          # involved object kind (Node, NodeClaim, Pod, NodePool)
    name: str          # involved object name
    reason: str        # CamelCase reason (e.g. SpotInterrupted, Unconsolidatable)
    message: str
    type: str = "Normal"   # Normal | Warning


class Recorder:
    """In-memory event sink with de-duplication window (the reference's
    recorder drops repeats inside a flush interval)."""

    MAX_EVENTS = 4096  # retained for inspection; bounded (a daemon runs forever)

    def __init__(self, clock: Callable[[], float] = time.time,
                 dedupe_window: float = 10.0, log: bool = True):
        self.clock = clock
        self.dedupe_window = dedupe_window
        self.log = log
        self._lock = threading.Lock()
        self._events: "deque[Event]" = deque(maxlen=self.MAX_EVENTS)
        self._last_seen: Dict[Event, float] = {}

    def publish(self, event: Event) -> bool:
        """Record unless the identical event fired inside the window.
        Returns whether it was recorded."""
        now = self.clock()
        with self._lock:
            last = self._last_seen.get(event)
            if last is not None and now - last < self.dedupe_window:
                return False
            if len(self._last_seen) > 2 * self.MAX_EVENTS:
                # prune expired dedupe entries so the map stays bounded
                cutoff = now - self.dedupe_window
                self._last_seen = {e: t for e, t in self._last_seen.items()
                                   if t >= cutoff}
            self._last_seen[event] = now
            self._events.append(event)
        if self.log:
            level = logging.WARNING if event.type == "Warning" else logging.INFO
            logger.log(level, "%s/%s: %s — %s",
                       event.kind, event.name, event.reason, event.message)
        return True

    def events(self, reason: Optional[str] = None) -> List[Event]:
        with self._lock:
            if reason is None:
                return list(self._events)
            return [e for e in self._events if e.reason == reason]

    def reset(self):
        with self._lock:
            self._events.clear()
            self._last_seen.clear()


class ChangeMonitor:
    """Log-dedup helper: `has_changed(key, value)` is true only when the value
    for the key differs from the last observation (pretty.ChangeMonitor)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._seen: Dict[str, object] = {}

    def has_changed(self, key: str, value: object) -> bool:
        with self._lock:
            if key in self._seen and self._seen[key] == value:
                return False
            self._seen[key] = value
            return True
