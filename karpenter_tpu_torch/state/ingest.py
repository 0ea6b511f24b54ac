"""Ingestion batcher: coalesce cluster events between ticks (IngestBatch).

A copy of the JAX package's `state/ingest.py`.  At production event rates
the eager delta stream is the steady-state cost: a firehose of binds,
reclaims and price updates pays one `ClusterArena` row recompute per event,
although the solver reads the slab once per reconcile tick.
`IngestBatcher` wraps the arena behind the same delta-API surface
(`Cluster`'s mutators call ``cluster.arena.apply_*`` blindly) and absorbs
events into per-node pending state instead:

* a node needing a **full row** (add / label-taint touch) shadows any
  number of used-only refreshes for the same node;
* a **removal** cancels pending work for the node outright (and an add
  after a removal revives it — the eager remove + add pair collapses to
  one row write);
* pod binds/unbinds collapse to one **used-vector** refresh per node per
  window, however many pods churned;
* pod add/remove events carry no row work at all — they fold into the
  single epoch bump the flush applies.

`flush()` — called at the top of every tick, and as a safety net by
`gather()` — applies the whole window through
`ClusterArena.apply_ingest_flush` as one delta.  Every row re-derives from
current cluster state through the same exact math as the eager path, so a
batched window and its eager equivalent differ only in slot layout, never
in gather output.

Backpressure: when the pending set grows past ``max_events`` the batcher
degrades to `arena.invalidate()` — the next gather is a full rebuild that
re-derives every event's effect from cluster state.  Degraded, not
dropped: the rebuild is the always-correct path.

`snapshot_state` flushes the window and hands on the arena's export;
`restore_state` drops the window and restores the arena (the warm-restart
snapshot, state/snapshot.py).  The reference's ingest families count the
events, flushes and overflows, beside `events_total`, `flushes_total` and
`overflows_total` on the object.
"""

from __future__ import annotations

from typing import Dict, List

from ..utils import metrics


class IngestBatcher:
    """Arena-shaped event coalescer (see module docstring).  Like the arena
    it wraps, it takes no lock: its caller is one thread."""

    def __init__(self, arena, max_events: int = 100_000):
        self._arena = arena
        self.max_events = int(max_events)
        self._touched: Dict[str, object] = {}  # name → Node (full-row work)
        self._removed: Dict[str, None] = {}    # name → (removal pending)
        self._used: Dict[str, None] = {}       # name → (used-only refresh)
        self._bump_only = False   # pod add/remove events in the window
        self.events_total = 0
        self.flushes_total = 0
        self.overflows_total = 0

    # ---- bookkeeping ------------------------------------------------------
    @property
    def pending(self) -> int:
        return len(self._touched) + len(self._removed) + len(self._used)

    def _event(self, kind: str) -> None:
        self.events_total += 1
        metrics.ingest_events().inc({"kind": kind})
        pending = self.pending
        metrics.ingest_pending().set(pending)
        if pending > self.max_events:
            self._overflow()

    def _overflow(self) -> None:
        self.overflows_total += 1
        metrics.ingest_overflows().inc()
        self._clear()
        self._arena.invalidate("ingest_overflow")

    def _clear(self) -> None:
        self._touched.clear()
        self._removed.clear()
        self._used.clear()
        self._bump_only = False
        metrics.ingest_pending().set(0)

    # ---- the delta-API surface Cluster's mutators call --------------------
    def apply_node_add(self, node) -> None:
        self._removed.pop(node.name, None)
        self._used.pop(node.name, None)
        self._touched[node.name] = node
        self._event("node_add")

    def apply_node_remove(self, name: str) -> None:
        was_pending_add = self._touched.pop(name, None) is not None \
            and name not in self._arena._slot_of
        self._used.pop(name, None)
        if not was_pending_add:
            # tracked (or unknown) node: the arena must tombstone it; a
            # node that only ever existed inside this window cancels out
            self._removed[name] = None
        self._event("node_remove")

    def touch_node(self, node) -> None:
        if node.name in self._touched:
            self._touched[node.name] = node
        elif node.name not in self._removed and \
                node.name in self._arena._slot_of:
            self._used.pop(node.name, None)
            self._touched[node.name] = node
        # untracked or removal-pending: the eager path would no-op too
        self._event("touch")

    def apply_pod_bind(self, pod, node_name: str,
                       old_node_name: str = "") -> None:
        if old_node_name and old_node_name != node_name:
            self._mark_used(old_node_name)
        self._mark_used(node_name)
        self._event("pod_bind")

    def apply_pod_unbind(self, node_name: str) -> None:
        self._mark_used(node_name)
        self._event("pod_unbind")

    def apply_pod_add(self, pod) -> None:
        self._bump_only = True
        self._event("pod_add")

    def apply_pod_remove(self, pod, node_name: str = "") -> None:
        if node_name:
            self._mark_used(node_name)
        self._bump_only = True
        self._event("pod_remove")

    def _mark_used(self, name: str) -> None:
        if name in self._touched or name in self._removed:
            return  # full-row work (or removal) already shadows it
        self._used[name] = None

    # ---- flush + pass-throughs --------------------------------------------
    def flush(self) -> bool:
        """Apply the whole pending window as one arena delta.  Returns
        True when anything was applied."""
        if not (self._touched or self._removed or self._used
                or self._bump_only):
            return False
        touched: List[object] = list(self._touched.values())
        removed = list(self._removed)
        used = list(self._used)
        self._clear()
        self._arena.apply_ingest_flush(touched, removed, used)
        self.flushes_total += 1
        metrics.ingest_flushes().inc()
        return True

    def gather(self, *args, **kwargs):
        # safety net: a consumer that gathers before the top-of-tick flush
        # must still see every absorbed event
        self.flush()
        return self._arena.gather(*args, **kwargs)

    def invalidate(self, reason: str = "") -> None:
        # pending work is subsumed by the rebuild the flag forces
        self._clear()
        self._arena.invalidate(reason)

    def snapshot_state(self):
        self.flush()
        return self._arena.snapshot_state()

    def restore_state(self, data) -> bool:
        self._clear()
        return self._arena.restore_state(data)

    def __getattr__(self, name):
        # everything else (epoch, live_count, gathers, slab reads in tests,
        # compact, rebuild, ...) forwards to the wrapped arena untouched
        return getattr(self._arena, name)
