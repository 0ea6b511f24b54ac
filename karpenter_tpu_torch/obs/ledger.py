"""Per-decision cost ledger: $·h attribution for every capacity decision.

A copy of the JAX package's `obs/ledger.py`.

The sim report's `cost.dollar_hours` integral and the live fleet's
nodepool spend are single opaque scalars: nothing says *which* decision
— a provisioning launch, a consolidation replacement, a spot reclaim —
spent the money.  This module is the attribution seam.  Every launch
opens a ledger entry `{decision_source, nodepool, pod_class, expected
$/h, fence epoch, trace id}` at the provider's `_launch` funnel; every
termination/reclaim closes it with the realized lifetime, so
`realized $·h = instance price × lifetime` while `expected $·h` uses the
price of the cheapest offering the launch *intended* (`overrides[0]`) —
the two diverge exactly when ICE landed the claim on a pricier
offering, which is the drift the detector watches per nodepool and
publishes as `cost_drift` incidents.

Like the `IncidentBus` and `CHAOS`, the ledger is process-global and
DISARMED by default: `LEDGER.enabled` is a single boolean check at each
hook, so gate-off runs pay nothing and stay byte-identical.  Decision
attribution rides a thread-local context (`LEDGER.decision(...)`) set by
the disruption/interruption controllers around their actuation funnels;
anything not inside an explicit context is a provisioning launch.

Clock discipline matches `obs/incidents.py`: the wall default is a
stored reference that is never read while disarmed — arming injects the
operator's (virtual or wall) clock, so DT001 stays clean on the sim
path.  Headroom placeholders never launch instances themselves (their
pods flow through normal provisioning), so their entries are
*reservation annotations* kept out of the per-source capacity sums —
without that exclusion the ledger's expected $·h could double-count a
pre-provisioned node.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .incidents import publish_incident

# decision sources form a closed, bounded label set (OB003): controllers
# tag their actuation funnels; untagged launches are provisioning.
DECISION_SOURCES = frozenset({
    "provisioning",      # pending-pod launch (default attribution)
    "consolidation",     # disruption replacement / delete
    "emptiness",         # empty-node disruption
    "expiration",        # expired-node disruption
    "drift",             # drifted-node disruption
    "interruption",      # spot interruption recycle
    "spot_reclaim",      # forced reclaim (warning not honored)
    "liveness",          # failed-launch / liveness termination
    "headroom",          # forecast placeholder reservation (annotation)
    "termination",       # untagged delete (GC, manual)
})


@dataclass
class LedgerEntry:
    """One capacity decision.  `expected_rate` is the $/h the decision
    planned to pay (cheapest intended offering); `realized_rate` the $/h
    the instance actually bills.  `closed_at is None` = still running."""
    id: str
    decision_source: str
    nodepool: str
    pod_class: str
    expected_rate: float
    realized_rate: float
    opened_at: float
    fence_epoch: int = 0
    trace_id: str = ""
    closed_at: Optional[float] = None
    close_reason: str = ""

    def expected_dh(self, now: float) -> float:
        end = self.closed_at if self.closed_at is not None else now
        return self.expected_rate * max(0.0, end - self.opened_at) / 3600.0

    def realized_dh(self, now: float) -> float:
        end = self.closed_at if self.closed_at is not None else now
        return self.realized_rate * max(0.0, end - self.opened_at) / 3600.0

    def to_dict(self) -> Dict:
        return {
            "id": self.id, "decision_source": self.decision_source,
            "nodepool": self.nodepool, "pod_class": self.pod_class,
            "expected_rate": self.expected_rate,
            "realized_rate": self.realized_rate,
            "opened_at": self.opened_at, "fence_epoch": self.fence_epoch,
            "trace_id": self.trace_id, "closed_at": self.closed_at,
            "close_reason": self.close_reason,
        }


@dataclass
class Reservation:
    """A headroom placeholder's planned spend — an annotation, not
    capacity (the node it pre-warms is ledgered by its own launch)."""
    nodepool: str
    expected_dh: float
    opened_at: float
    ttl_s: float


class CostLedger:
    """Bounded per-decision $·h ledger with expected-vs-realized drift
    detection.  All bookkeeping is behind a lock: launches arrive from
    the manager tick while reclaims land from the cloud-delivery path.
    """

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._clock: Callable[[], float] = time.time  # reference, never read while disarmed
        self._retention = 256
        self._drift_threshold = 0.15
        self._drift_min_entries = 3
        self._open: Dict[str, LedgerEntry] = {}        # guarded-by: _lock
        self._closed: deque = deque(maxlen=256)        # guarded-by: _lock
        self._reservations: deque = deque(maxlen=256)  # guarded-by: _lock
        # ids ever ledgered (bounded LRU): the restart-dedup set — a
        # rehydrated launch hook must not re-open an entry the snapshot
        # already carries
        self._seen: "OrderedDict[str, None]" = OrderedDict()
        self._seen_cap = 4096
        # closed-entry aggregates survive deque eviction: totals are
        # exact even after old entries age out of the bounded window
        self._agg_source: Dict[str, Dict[str, float]] = {}
        self._agg_pool: Dict[str, Dict[str, float]] = {}
        self._drift_active: Dict[str, bool] = {}
        self.drift_alerts = 0
        self.entries_opened = 0
        self.entries_closed = 0
        self._ctx = threading.local()

    # ---- lifecycle -------------------------------------------------------
    def arm(self, clock: Callable[[], float], *, retention: int = 256,
            drift_threshold: float = 0.15,
            drift_min_entries: int = 3) -> None:
        with self._lock:
            self._clock = clock
            self._retention = int(retention)
            self._drift_threshold = float(drift_threshold)
            self._drift_min_entries = int(drift_min_entries)
            self._closed = deque(self._closed, maxlen=self._retention)
            self._reservations = deque(self._reservations,
                                       maxlen=self._retention)
            self.enabled = True

    def disarm(self) -> None:
        with self._lock:
            self.enabled = False
            self._open.clear()
            self._closed.clear()
            self._reservations.clear()
            self._seen.clear()
            self._agg_source.clear()
            self._agg_pool.clear()
            self._drift_active.clear()
            self.drift_alerts = 0
            self.entries_opened = 0
            self.entries_closed = 0

    # ---- decision-context attribution ------------------------------------
    def decision(self, source: str):
        """Context manager tagging launches/terminations inside it with
        `source` (a DECISION_SOURCES member)."""
        if source not in DECISION_SOURCES:
            raise ValueError(f"unregistered decision source: {source!r} "
                             "(add it to obs.ledger.DECISION_SOURCES)")
        ledger = self

        class _Ctx:
            def __enter__(self):
                ledger._ctx.source = source
                return ledger

            def __exit__(self, *exc):
                ledger._ctx.source = None
                return False

        return _Ctx()

    def current_source(self, default: str = "provisioning") -> str:
        src = getattr(self._ctx, "source", None)
        return src if src else default

    # ---- record hooks (free when disarmed) --------------------------------
    def record_launch(self, entry_id: str, *, nodepool: str,
                      pod_class: str = "", expected_rate: float = 0.0,
                      realized_rate: float = 0.0, at: float,
                      fence_epoch: int = 0, trace_id: str = "",
                      source: Optional[str] = None) -> bool:
        """Open an entry for one launched instance.  Returns False when
        the id was already ledgered (warm-restart replay) — the dedup
        the chaos × restart test proves."""
        if not self.enabled:
            return False
        src = source or self.current_source()
        with self._lock:
            if not self.enabled:
                return False
            if entry_id in self._seen or entry_id in self._open:
                return False
            self._seen[entry_id] = None
            while len(self._seen) > self._seen_cap:
                self._seen.popitem(last=False)
            self._open[entry_id] = LedgerEntry(
                id=entry_id, decision_source=src, nodepool=nodepool or "",
                pod_class=pod_class, expected_rate=float(expected_rate),
                realized_rate=float(realized_rate), opened_at=float(at),
                fence_epoch=int(fence_epoch), trace_id=trace_id)
            self.entries_opened += 1
        from ..utils import metrics
        metrics.ledger_entries().inc({"decision_source": src})
        metrics.ledger_open_entries().set(len(self._open))
        return True

    def record_close(self, entry_id: str, *, at: float,
                     reason: Optional[str] = None) -> bool:
        """Close the open entry for `entry_id` at its termination or
        reclaim instant.  Idempotent: a second close is a no-op, so a
        drain→delete that already closed the entry is never
        double-counted by the forced-reclaim path."""
        if not self.enabled:
            return False
        src = reason or self.current_source(default="termination")
        with self._lock:
            if not self.enabled:
                return False
            entry = self._open.pop(entry_id, None)
            if entry is None:
                return False
            entry.closed_at = float(at)
            entry.close_reason = src
            self._closed.append(entry)
            self.entries_closed += 1
            self._accumulate(entry)
        from ..utils import metrics
        metrics.ledger_open_entries().set(len(self._open))
        self._check_drift(float(at))
        return True

    def record_reservation(self, *, nodepool: str, expected_dh: float,
                           at: float, ttl_s: float) -> bool:
        """Annotate a headroom placeholder's planned spend.  Kept out of
        the per-source capacity sums (see module docstring)."""
        if not self.enabled:
            return False
        with self._lock:
            if not self.enabled:
                return False
            self._reservations.append(Reservation(
                nodepool=nodepool or "", expected_dh=float(expected_dh),
                opened_at=float(at), ttl_s=float(ttl_s)))
        from ..utils import metrics
        metrics.ledger_entries().inc({"decision_source": "headroom"})
        return True

    # ---- aggregation ------------------------------------------------------
    def _accumulate(self, entry: LedgerEntry) -> None:  # graftlint: holds(_lock)
        end = entry.closed_at
        for agg, key in ((self._agg_source, entry.decision_source),
                         (self._agg_pool, entry.nodepool)):
            slot = agg.setdefault(key, {"expected_dh": 0.0,
                                        "realized_dh": 0.0, "entries": 0})
            slot["expected_dh"] += entry.expected_dh(end)
            slot["realized_dh"] += entry.realized_dh(end)
            slot["entries"] += 1

    def summary(self, now: float) -> Dict:
        """Deterministic rollup: closed aggregates + open entries accrued
        to `now`, so the per-source expected $·h sums match a cost
        integral taken at the same instant."""
        with self._lock:
            by_source = {k: dict(v) for k, v in self._agg_source.items()}
            by_pool = {k: dict(v) for k, v in self._agg_pool.items()}
            for entry in self._open.values():
                for agg, key in ((by_source, entry.decision_source),
                                 (by_pool, entry.nodepool)):
                    slot = agg.setdefault(key, {"expected_dh": 0.0,
                                                "realized_dh": 0.0,
                                                "entries": 0})
                    slot["expected_dh"] += entry.expected_dh(now)
                    slot["realized_dh"] += entry.realized_dh(now)
                    slot["entries"] += 1
            reservations_dh = sum(
                (r.expected_dh for r in self._reservations), 0.0)
            out = {
                "entries_opened": self.entries_opened,
                "entries_closed": self.entries_closed,
                "open": len(self._open),
                "by_decision_source": {
                    k: {"expected_dh": round(v["expected_dh"], 6),
                        "realized_dh": round(v["realized_dh"], 6),
                        "entries": v["entries"]}
                    for k, v in sorted(by_source.items())},
                "by_nodepool": {
                    k: {"expected_dh": round(v["expected_dh"], 6),
                        "realized_dh": round(v["realized_dh"], 6),
                        "entries": v["entries"],
                        "drift": round(self._drift_of(v), 6)}
                    for k, v in sorted(by_pool.items())},
                "headroom_reservations": {
                    "count": len(self._reservations),
                    "expected_dh": round(reservations_dh, 6)},
                "drift_alerts": self.drift_alerts,
            }
        return out

    def recent(self, limit: int = 50) -> List[Dict]:
        with self._lock:
            closed = [e.to_dict() for e in list(self._closed)[-limit:]]
            open_ = [e.to_dict() for _, e in sorted(self._open.items())]
        return closed + open_[:max(0, limit - len(closed))]

    # ---- drift detection --------------------------------------------------
    @staticmethod
    def _drift_of(slot: Dict[str, float]) -> float:
        exp = slot["expected_dh"]
        if exp <= 0.0:
            return 0.0
        return abs(slot["realized_dh"] - exp) / exp

    def _check_drift(self, now: float) -> None:
        """Per-nodepool expected-vs-realized drift over CLOSED entries
        (realized is only measurable at close).  Activation-edge
        publishing + the bus's own per-kind dedup keep a drifting storm
        at one incident per window."""
        fired: List[Dict] = []
        with self._lock:
            if not self.enabled:
                return
            for pool in sorted(self._agg_pool):
                slot = self._agg_pool[pool]
                if slot["entries"] < self._drift_min_entries:
                    continue
                drift = self._drift_of(slot)
                active = drift > self._drift_threshold
                was = self._drift_active.get(pool, False)
                if active and not was:
                    self.drift_alerts += 1
                    fired.append({"nodepool": pool,
                                  "drift": round(drift, 6),
                                  "expected_dh": round(slot["expected_dh"], 6),
                                  "realized_dh": round(slot["realized_dh"], 6),
                                  "at": now})
                self._drift_active[pool] = active
        from ..utils import metrics
        for detail in fired:
            metrics.ledger_drift_alerts().inc(
                {"nodepool": detail["nodepool"]})
            publish_incident("cost_drift", detail)

    # ---- warm-restart support (the `ledger` snapshot section) -------------
    def snapshot_state(self) -> Dict:
        with self._lock:
            return {
                "open": [e.to_dict() for _, e in sorted(self._open.items())],
                "closed": [e.to_dict() for e in self._closed],
                "reservations": [
                    {"nodepool": r.nodepool, "expected_dh": r.expected_dh,
                     "opened_at": r.opened_at, "ttl_s": r.ttl_s}
                    for r in self._reservations],
                "seen": list(self._seen),
                "agg_source": {k: dict(v)
                               for k, v in self._agg_source.items()},
                "agg_pool": {k: dict(v) for k, v in self._agg_pool.items()},
                "drift_active": dict(self._drift_active),
                "drift_alerts": self.drift_alerts,
                "entries_opened": self.entries_opened,
                "entries_closed": self.entries_closed,
            }

    def restore_state(self, state: Dict) -> None:
        def _entry(d: Dict) -> LedgerEntry:
            return LedgerEntry(
                id=str(d["id"]), decision_source=str(d["decision_source"]),
                nodepool=str(d["nodepool"]), pod_class=str(d["pod_class"]),
                expected_rate=float(d["expected_rate"]),
                realized_rate=float(d["realized_rate"]),
                opened_at=float(d["opened_at"]),
                fence_epoch=int(d["fence_epoch"]),
                trace_id=str(d["trace_id"]),
                closed_at=None if d["closed_at"] is None
                else float(d["closed_at"]),
                close_reason=str(d["close_reason"]))
        with self._lock:
            self._open = {str(d["id"]): _entry(d)
                          for d in state.get("open", [])}
            self._closed = deque((_entry(d) for d in state.get("closed", [])),
                                 maxlen=self._retention)
            self._reservations = deque(
                (Reservation(nodepool=str(r["nodepool"]),
                             expected_dh=float(r["expected_dh"]),
                             opened_at=float(r["opened_at"]),
                             ttl_s=float(r["ttl_s"]))
                 for r in state.get("reservations", [])),
                maxlen=self._retention)
            self._seen = OrderedDict(
                (str(k), None) for k in state.get("seen", []))
            self._agg_source = {str(k): dict(v) for k, v
                                in state.get("agg_source", {}).items()}
            self._agg_pool = {str(k): dict(v) for k, v
                              in state.get("agg_pool", {}).items()}
            self._drift_active = {str(k): bool(v) for k, v
                                  in state.get("drift_active", {}).items()}
            self.drift_alerts = int(state.get("drift_alerts", 0))
            self.entries_opened = int(state.get("entries_opened", 0))
            self.entries_closed = int(state.get("entries_closed", 0))


LEDGER = CostLedger()


def current_trace_id() -> str:
    """Trace id of the span currently open on this thread, "" when no
    trace is active (the sim's untraced paths)."""
    try:
        from ..utils.tracing import TRACER
        cur = TRACER.current()
        return cur.trace_id if cur is not None else ""
    except Exception:
        return ""
