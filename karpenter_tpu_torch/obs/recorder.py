"""The FlightRecorder: ring + bus + bundles behind one gate.

A copy of the JAX package's `obs/recorder.py`.  Sampling and capture are
host work over the metric registry and the manager's context callbacks;
neither synchronizes the card nor copies a tensor from it.

Lifecycle: the manager builds one when the `FlightRecorder` gate is on,
hands it the same injectable clock every other subsystem runs on, wires
context callbacks (health snapshot, fencing/leader state, provenance,
trace export), then `arm()`s the global incident bus.  From that moment:

  * every manager tick calls `sample()` — a cadence-bounded pass over
    the metric registry into the history ring;
  * every trip-site `publish_incident` that clears the per-kind dedup
    window lands in `_capture`, which assembles one forensic bundle:
    the metric deltas over the preceding window, the trace ring, the
    full health snapshot, chaos/fencing state, and provenance for any
    pods the detail names — then stores it in memory (bounded) and,
    when a directory is configured, atomically on disk (bounded
    retention).

Capture runs inline on the tripping thread and is exception-proof: the
bus counts a sink error rather than re-raising into a reconcile, and a
failed disk write degrades to memory-only (counted) — the recorder must
never convert an incident into a second incident.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional

from ..utils import metrics
from .bundle import bundle_id, prune, write_bundle
from .incidents import BUS
from .ring import MetricsRing


class FlightRecorder:
    def __init__(self, clock: Callable[[], float], *,
                 cadence_s: float = 30.0,
                 window_s: float = 600.0,
                 dedup_s: float = 300.0,
                 retention: int = 32,
                 ring_slots: int = 512,
                 trace_cap: int = 64,
                 dirpath: Optional[str] = None,
                 registry=None):
        self._clock = clock
        self.window_s = float(window_s)
        self.dedup_s = float(dedup_s)
        self.retention = int(retention)
        self.trace_cap = int(trace_cap)
        self.dirpath = dirpath
        self._registry = registry if registry is not None else metrics.REGISTRY
        self.ring = MetricsRing(clock, cadence_s=cadence_s, slots=ring_slots)
        self.bundles: deque = deque(maxlen=self.retention)
        self._restored: List[Dict] = []   # summaries carried over a warm restart
        self._seq = 0
        self.write_errors = 0
        # context callbacks the manager wires after construction; each is
        # optional so the recorder also works bare in tests/tools
        self.health_cb: Optional[Callable[[], Dict]] = None
        self.fence_cb: Optional[Callable[[], Dict]] = None
        self.chaos_cb: Optional[Callable[[], Dict]] = None
        self.provenance_cb: Optional[Callable[[List[str]], List[Dict]]] = None
        self.traces_cb: Optional[Callable[[], List[Dict]]] = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def arm(self) -> None:
        BUS.arm(self._capture, self._clock, dedup_s=self.dedup_s,
                on_suppressed=self._suppressed)

    def disarm(self) -> None:
        BUS.disarm()

    # ------------------------------------------------------------------
    # sampling (called from the manager tick; cadence-bounded)
    # ------------------------------------------------------------------
    def sample(self) -> bool:
        took = self.ring.sample(self._registry)
        if took:
            metrics.obs_ring_samples().inc()
            metrics.obs_ring_entries().set(float(len(self.ring)))
        return took

    # ------------------------------------------------------------------
    # capture (the bus sink)
    # ------------------------------------------------------------------
    def _suppressed(self, kind: str, now: float) -> None:
        """A deduped repeat extends the open episode rather than opening
        a new bundle: the newest bundle of this kind grows its window
        end (and a repeat counter), so a storm that trips every tick for
        ten minutes is recorded as one incident COVERING ten minutes.
        Memory-only — the on-disk copy keeps the window at capture."""
        metrics.incident_suppressed().inc({"kind": kind})
        for b in reversed(self.bundles):
            if b["kind"] == kind:
                b["window"][1] = max(float(b["window"][1]), now)
                b["repeats"] = b.get("repeats", 0) + 1
                break

    def _context(self, cb: Optional[Callable], *args):
        if cb is None:
            return None
        try:
            return cb(*args)
        except Exception as e:
            return {"error": f"{type(e).__name__}: {e}"}

    def _capture(self, kind: str, detail: Dict, now: float) -> None:
        self._seq += 1
        bid = bundle_id(now, kind, self._seq)
        traces = self._context(self.traces_cb) or []
        bundle = {
            "id": bid,
            "kind": kind,
            "t": now,
            "seq": self._seq,
            "window": [now - self.window_s, now],
            "detail": detail,
            "metrics": self.ring.deltas(self.window_s, now),
            "ring_entries": len(self.ring),
            "traces": traces[:self.trace_cap],   # tracer export is newest-first
            "health": self._context(self.health_cb),
            "chaos": self._context(self.chaos_cb),
            "fencing": self._context(self.fence_cb),
            "provenance": self._context(
                self.provenance_cb, list(detail.get("pods", []))),
            "suppressed": dict(BUS.suppressed),
        }
        self.bundles.append(bundle)
        metrics.incident_bundles().inc({"kind": kind})
        if self.dirpath:
            try:
                write_bundle(self.dirpath, bundle)
                prune(self.dirpath, self.retention)
            except OSError:
                self.write_errors += 1
                metrics.incident_write_errors().inc()

    # ------------------------------------------------------------------
    # export (report section, /debug/incidents, snapshot section)
    # ------------------------------------------------------------------
    @staticmethod
    def _summary_entry(b: Dict) -> Dict:
        return {"id": b["id"], "kind": b["kind"], "t": b["t"],
                "window": list(b["window"]),
                "repeats": int(b.get("repeats", 0))}

    def summary(self) -> Dict:
        """Deterministic view for the sim report and `/debug/incidents`:
        ids/kinds/windows plus bus counters — no wall-clock payloads."""
        entries = list(self._restored) + \
            [self._summary_entry(b) for b in self.bundles]
        by_kind: Dict[str, int] = {}
        for e in entries:
            by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
        return {
            "bundles": entries,
            "by_kind": by_kind,
            "published": dict(BUS.published),
            "suppressed": dict(BUS.suppressed),
            "sink_errors": BUS.sink_errors,
            "write_errors": self.write_errors,
            "ring": {"entries": len(self.ring),
                     "samples_taken": self.ring.samples_taken},
        }

    def get_bundle(self, bid: str) -> Optional[Dict]:
        for b in self.bundles:
            if b["id"] == bid:
                return b
        if self.dirpath:
            from .bundle import read_bundle
            return read_bundle(self.dirpath, bid)
        return None

    def snapshot_state(self) -> Dict:
        return {
            "ring": self.ring.snapshot_state(),
            "bus": BUS.snapshot_state(),
            "seq": self._seq,
            "bundles": [self._summary_entry(b) for b in self.bundles],
            "restored": list(self._restored),
        }

    def restore_state(self, state: Dict) -> None:
        """Warm-restart: restore the ring cursor and the bus dedup state
        (so a trip captured just before the restart is not re-captured
        right after it), and carry the bundle summaries forward (so the
        incident record is not lost).  Full payloads live on disk when a
        directory is configured; memory-only runs keep the summary."""
        self.ring.restore_state(dict(state.get("ring", {})))
        BUS.restore_state(dict(state.get("bus", {})))
        self._seq = int(state.get("seq", 0))
        self._restored = list(state.get("restored", [])) + \
            [dict(e) for e in state.get("bundles", [])]
