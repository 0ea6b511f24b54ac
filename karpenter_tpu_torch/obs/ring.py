"""Bounded in-process metrics time-series ring.

A copy of the JAX package's `obs/ring.py`.  It reads the host metric
registry only (utils/metrics.py): nothing here touches the card.

Samples every registered metric family (via `Registry.sample_all`) on a
cadence measured against the *injectable* clock — the sim hands it the
virtual clock, so a 24h replay records 24h of virtual history
deterministically and DT001 never sees a wall read.  The ring is a
fixed-size deque: steady-state memory is `slots × series_count` floats,
and sampling never blocks a reconcile (it runs inline in the manager
tick, bounded by one pass over the registry).

The payload of one sample is `{series_key: value}` where `series_key`
is the Prometheus-style `name{label="v",...}` string — stable, sorted,
and directly diffable for the bundle's metric-delta view.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Tuple


def series_key(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRing:
    def __init__(self, clock: Callable[[], float], cadence_s: float = 30.0,
                 slots: int = 512):
        self._clock = clock
        self.cadence_s = float(cadence_s)
        self.slots = int(slots)
        self._ring: deque = deque(maxlen=self.slots)  # (t, {key: value})
        self._last_t: Optional[float] = None
        self.samples_taken = 0

    def sample(self, registry) -> bool:
        """Take one sample if the cadence has elapsed.  Returns True iff
        a sample was recorded (the caller incs the sample counter on
        True, keeping the metric out of the disarmed path)."""
        now = self._clock()
        if self._last_t is not None and (now - self._last_t) < self.cadence_s:
            return False
        snap: Dict[str, float] = {}
        for name, labels, value in registry.sample_all():
            snap[series_key(name, labels)] = float(value)
        self._ring.append((now, snap))
        self._last_t = now
        self.samples_taken += 1
        return True

    def __len__(self) -> int:
        return len(self._ring)

    def tip(self) -> Tuple[float, Dict]:
        """Newest sample — the registry as of the last cadence pass (the
        SLO engine reads cumulative counter tips from here instead of
        re-walking the registry)."""
        if not self._ring:
            return (0.0, {})
        return self._ring[-1]

    def window(self, start: float, end: float) -> List[Tuple[float, Dict]]:
        return [(t, snap) for t, snap in self._ring if start <= t <= end]

    def deltas(self, window_s: float, now: float) -> Dict:
        """Per-series change over the trailing window: newest sample vs
        the baseline at the window start — the newest sample at-or-before
        `now - window_s` (so counter deltas cover the whole window), or
        the oldest sample inside it when history is shorter.  Only
        changed series are reported — a forensic bundle wants what moved,
        not the whole registry."""
        if not self._ring:
            return {"from_t": None, "to_t": None, "changed": {}}
        lo = now - float(window_s)
        base_t, base = None, None
        for t, snap in self._ring:
            if t <= lo:
                base_t, base = t, snap      # newest before the window
            else:
                if base is None:
                    base_t, base = t, snap  # oldest inside the window
                break
        tip_t, tip = self._ring[-1]
        if base is None:
            base_t, base = tip_t, tip
        changed: Dict[str, float] = {}
        for key in sorted(tip):
            d = tip[key] - base.get(key, 0.0)
            if d != 0.0:
                changed[key] = round(d, 9)
        return {"from_t": base_t, "to_t": tip_t, "changed": changed}

    # ---- warm-restart support: the cursor, not the payload ----
    def snapshot_state(self) -> Dict:
        return {"last_t": self._last_t, "samples_taken": self.samples_taken}

    def restore_state(self, state: Dict) -> None:
        last_t = state.get("last_t")
        self._last_t = float(last_t) if last_t is not None else None
        self.samples_taken = int(state.get("samples_taken", 0))
