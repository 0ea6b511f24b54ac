"""Virtual time: the injectable clock and the deterministic event heap.

A copy of the JAX package's `sim/clock.py`.  Every component of the port
(controllers, `TTLCache`, `PricingProvider`, `FakeCloud`, the manager's
batch window) takes a ``clock`` callable.  A
`VirtualClock` satisfies that contract while advancing only when the
harness says so — no wall-clock coupling, no sleeps, and a 24-hour run
costs exactly as many clock reads as the event count demands.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Any, List, Optional, Tuple


class VirtualClock:
    """A monotonically advancing simulated clock.

    Callable (``clock()``) so it drops into every ``clock=`` injection
    point in the stack.  `advance_to` refuses to move backwards — virtual
    time, like real time, only goes one way, and a backwards jump would
    silently corrupt TTL caches and batch windows built on it.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> float:
        if t < self._now:
            raise ValueError(
                f"virtual clock cannot rewind: now={self._now} target={t}")
        self._now = float(t)
        return self._now

    def advance(self, dt: float) -> float:
        return self.advance_to(self._now + dt)

    def __repr__(self) -> str:  # pragma: no cover — debug aid
        return f"VirtualClock(t={self._now:.3f})"


class EventHeap:
    """Deterministic priority queue of (time, event) pairs.

    Ties on time break on insertion order (a monotonically increasing
    sequence number), never on payload comparison — events are plain
    dataclasses with no ordering, and hash-order must never leak into
    delivery order."""

    def __init__(self):
        self._heap: List[Tuple[float, int, Any]] = []
        self._seq = itertools.count(1)

    def push(self, at: float, event: Any) -> None:
        heapq.heappush(self._heap, (float(at), next(self._seq), event))

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def pop_due(self, now: float) -> List[Tuple[float, Any]]:
        """All events with time <= now, in (time, insertion) order."""
        out: List[Tuple[float, Any]] = []
        while self._heap and self._heap[0][0] <= now:
            at, _, ev = heapq.heappop(self._heap)
            out.append((at, ev))
        return out

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
