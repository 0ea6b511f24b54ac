"""The incident trigger bus.

A copy of the JAX package's `obs/incidents.py`, its kinds and counters
byte for byte.

Every trip site in the fault-handling stack publishes here — circuit
open/quarantine, watchdog trip, solver/decode ladder demotion, fencing
refusal, cold-restore fallback, parity-probe mismatch, leader loss — and
graftlint OB006 keeps the set closed the same way RS004 keeps the
snapshot/cloud mutation funnels closed: a trip counter incremented
without a `publish_incident` in the same function is a lint finding.

The bus is process-global and DISARMED by default: `publish_incident`
is a single boolean check until a `FlightRecorder` arms it, so the hot
reconcile path pays nothing when the gate is off (the same zero-cost
pattern as `CHAOS.enabled`).  When armed, publishes are deduplicated
per kind inside a rate-limit window — a chaos storm that trips the same
circuit every tick produces one bundle per window, not a bundle flood —
and delivery happens inline on the tripping thread but is hard-bounded:
a sink failure is counted, never raised back into a reconcile.

stdlib-only on purpose: watchdog/fencing/health sit below utils.metrics
in the import order and must be able to publish without cycles.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

# Closed registry of incident kinds (the `kind` label of
# karpenter_incident_bundles_total stays enumerable, like chaos POINTS
# and watchdog PHASES).  One kind per trip-site family:
INCIDENT_KINDS = frozenset({
    "circuit_open",        # supervisor circuit opened / controller quarantined
    "watchdog_trip",       # hard deadline abandoned a phase
    "solver_demotion",     # SolverHealth ladder demoted a rung
    "decode_demotion",     # DecodeHealth breaker demoted to host decode
    "fence_refusal",       # stale fencing epoch refused a guarded mutation
    "snapshot_fallback",   # warm restore fell back to a cold rebuild
    "parity_mismatch",     # arena parity probe found divergence
    "leader_loss",         # leadership lost mid-term (deposed, not released)
    "slo_burn",            # error budget burning in both windows of a pair
    "cost_drift",          # ledger expected-vs-realized $·h drift per pool
    "gang_rejected",       # all-or-nothing gang admission rejected a gang
})


class IncidentBus:
    """Per-kind deduplicating publish/subscribe seam for trip sites.

    `armed` is the fast path: False (the default) makes `publish` a
    near-free early return.  Arming installs a sink callback, the
    injectable clock the dedup window is measured on, and the window
    itself.  All bookkeeping is behind a lock because watchdog trips
    arrive from worker threads while the manager thread reconciles.
    """

    def __init__(self) -> None:
        self.armed = False
        self._lock = threading.Lock()
        self._clock: Callable[[], float] = time.time  # reference, never read while disarmed
        self._sink: Optional[Callable[[str, Dict, float], None]] = None
        self._on_suppressed: Optional[Callable[[str, float], None]] = None
        self._dedup_s = 300.0
        self._last: Dict[str, float] = {}
        self.published: Dict[str, int] = {}
        self.suppressed: Dict[str, int] = {}
        self.sink_errors = 0

    def arm(self, sink: Callable[[str, Dict, float], None],
            clock: Callable[[], float],
            dedup_s: float = 300.0,
            on_suppressed: Optional[Callable[[str, float], None]] = None
            ) -> None:
        with self._lock:
            self._sink = sink
            self._clock = clock
            self._dedup_s = float(dedup_s)
            self._on_suppressed = on_suppressed
            self.armed = True

    def disarm(self) -> None:
        with self._lock:
            self.armed = False
            self._sink = None
            self._on_suppressed = None
            self._last.clear()
            self.published.clear()
            self.suppressed.clear()
            self.sink_errors = 0

    def publish(self, kind: str, detail: Optional[Dict] = None) -> bool:
        """Publish one trip.  Returns True iff the sink saw it (False =
        disarmed or deduplicated).  Never raises into the caller."""
        if not self.armed:
            return False
        if kind not in INCIDENT_KINDS:
            raise ValueError(f"unregistered incident kind: {kind!r} "
                             f"(add it to obs.incidents.INCIDENT_KINDS)")
        with self._lock:
            if not self.armed or self._sink is None:
                return False
            now = self._clock()
            last = self._last.get(kind)
            if last is not None and (now - last) < self._dedup_s:
                self.suppressed[kind] = self.suppressed.get(kind, 0) + 1
                cb = self._on_suppressed
                if cb is not None:
                    # the recorder uses (kind, now) to extend the open
                    # episode's window — a deduped storm is one growing
                    # incident, not a blind spot
                    try:
                        cb(kind, now)
                    except Exception:
                        pass
                return False
            self._last[kind] = now
            self.published[kind] = self.published.get(kind, 0) + 1
            sink = self._sink
        try:
            sink(kind, dict(detail or {}), now)
        except Exception:
            with self._lock:
                self.sink_errors += 1
            return False
        return True

    # ---- warm-restart support (the `incidents` snapshot section) ----
    def snapshot_state(self) -> Dict:
        """Dedup bookkeeping only — enough that a warm restart neither
        replays a just-captured incident nor forgets the counts."""
        with self._lock:
            return {"last": dict(self._last),
                    "published": dict(self.published),
                    "suppressed": dict(self.suppressed)}

    def restore_state(self, state: Dict) -> None:
        with self._lock:
            self._last = {str(k): float(v)
                          for k, v in dict(state.get("last", {})).items()}
            self.published = {str(k): int(v) for k, v
                              in dict(state.get("published", {})).items()}
            self.suppressed = {str(k): int(v) for k, v
                               in dict(state.get("suppressed", {})).items()}


BUS = IncidentBus()


def publish_incident(kind: str, detail: Optional[Dict] = None) -> bool:
    """The one seam trip sites call (graftlint OB006 pattern-matches this
    name).  Free when the bus is disarmed."""
    return BUS.publish(kind, detail)
