"""Persistent incrementally-updated cluster tensorization (the delta arena).

A copy of the JAX package's `ops/arena.py`.  `Cluster.tensorize_nodes`
lowers the live node set to dense packing arrays from scratch on every call
— O(nodes × classes) label/taint evaluations and O(pods) request summing —
even though a steady-state reconcile changes one row (a bind, a reclaim, a
taint edit).  `ClusterArena` keeps those arrays alive between ticks as a
slotted slab and applies typed deltas in place:

* **Row slots + free-list.**  Every tracked node owns a slab row
  (`slab_alloc`/`slab_used` E×R float32, `slab_compat` E×C bool slot-major).
  Removal tombstones the row (``slab_live`` mask) and recycles the slot
  through a LIFO free-list, so identical event sequences assign identical
  slots.
* **Class registry.**  Pod equivalence classes (`_class_key`) are interned
  to stable column ids; a `gather()` for reps the arena has never seen
  computes just those columns over live rows.  The table resets wholesale
  past ``class_table_max`` (per-pod-unique labels make distinct keys
  unbounded in a long-lived controller).
* **Exact row math.**  A touched row is always recomputed through the same
  arithmetic `tensorize_nodes` uses (`requested()` → `to_vector(round_up)`,
  tolerate-then-compatible), never adjusted incrementally: float add/sub
  does not invert across round_up ordering, and bit-identity with the
  from-scratch path is what lets the warm arena feed the kernels unaudited.
* **Compaction + full rebuild.**  When tombstones outnumber
  ``max(compact_floor, live)`` the slab compacts (row moves, no
  recompute).  `rebuild()` — re-derivation from cluster state — stays the
  always-correct fallback: `invalidate()` flags it, and `gather()` returns
  None (the caller falls back to `tensorize_nodes`) for anything the slab
  cannot express (extra axes, non-default scales, untracked nodes).

The slab is host numpy, as in the reference, so `gather()` is bit-identical
to `tensorize_nodes`; its arrays reach the card where the solve already
uploads `tensorize_nodes`' output.  The arena is fed by `state.Cluster`'s
mutators plus explicit `touch_node` calls at the label/taint edit sites in
the lifecycle, termination and disruption controllers.  Like every other
Cluster write it takes no lock of its own: the controller manager's ticks
and the `/v1` surface hold the operator's `state_lock` around it.

Every delta feeds the reference's arena families (`_note_delta`), the
flush, compaction and rebuild run under its `arena.*` spans, and `gathers`
counts the gather outcomes ("warm" / "fallback") beside the `arena_gather`
counter.  The reference's gang-resident index
(`gang_residents`, `gangs_on`) stays out: nothing reads it, in the JAX
package or its tests (gang scheduling, ops/gang.py, walks the nodes' pods
itself).  `snapshot_state` / `restore_state` are the arena's section of
the warm-restart snapshot (state/snapshot.py): host numpy and plain Python,
so a snapshot written beside the card loads where there is none, and a
restored arena serves its first `gather()` warm, with no `tensorize_nodes`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api import labels as wk
from ..api.objects import Node, Pod
from ..api.requirements import Requirements
from ..api.resources import DEFAULT_AXES, DEFAULT_SCALES, PODS
from ..api.taints import tolerates_all
from ..utils import metrics, tracing
from .tensorize import _class_key

_INITIAL_SLOTS = 64
_INITIAL_CLASSES = 64


class ClusterArena:
    """Slotted, incrementally-maintained mirror of `tensorize_nodes`' output
    for the default resource axes.  See module docstring."""

    def __init__(self, cluster, compact_floor: int = 32,
                 class_table_max: int = 4096):
        self._cluster = cluster
        self._axes: Tuple[str, ...] = DEFAULT_AXES
        self._scales: Dict[str, float] = dict(DEFAULT_SCALES)
        self.compact_floor = compact_floor
        self.class_table_max = class_table_max
        R = len(self._axes)
        # the tensor slab — mutate only through the apply_*/touch_node/
        # rebuild delta API below (graftlint AR001)
        self.slab_alloc = np.zeros((_INITIAL_SLOTS, R), np.float32)  # guarded-by: caller(state_lock)
        self.slab_used = np.zeros((_INITIAL_SLOTS, R), np.float32)  # guarded-by: caller(state_lock)
        self.slab_compat = np.zeros((_INITIAL_SLOTS, _INITIAL_CLASSES), bool)  # guarded-by: caller(state_lock)
        self.slab_live = np.zeros(_INITIAL_SLOTS, bool)  # guarded-by: caller(state_lock)
        self._slot_of: Dict[str, int] = {}  # guarded-by: caller(state_lock)
        self._node_at: List[Optional[Node]] = [None] * _INITIAL_SLOTS  # guarded-by: caller(state_lock)
        self._free: List[int] = []  # guarded-by: caller(state_lock)
        self._top = 0  # guarded-by: caller(state_lock)
        self._rid_of: Dict[tuple, int] = {}  # guarded-by: caller(state_lock)
        self._reps: List[Pod] = []  # guarded-by: caller(state_lock)
        # monotone per-delta counter: consumers compare it to decide
        # staleness without walking the object graph
        self.epoch = 0  # guarded-by: caller(state_lock)
        self.compactions = 0  # guarded-by: caller(state_lock)
        # gather outcomes: "warm" served from the slab, "fallback" refused
        # (the caller runs tensorize_nodes)
        self.gathers: Dict[str, int] = {"warm": 0, "fallback": 0}
        self._needs_rebuild = True  # guarded-by: caller(state_lock)

    # ---- bookkeeping ------------------------------------------------------
    @property
    def live_count(self) -> int:
        return len(self._slot_of)

    @property
    def tombstone_count(self) -> int:
        return len(self._free)

    def _note_delta(self, kind: str):  # guarded-by: caller(state_lock)
        self.epoch += 1
        metrics.arena_deltas().inc({"kind": kind})
        metrics.arena_epoch().set(self.epoch)
        metrics.arena_slots().set(self.live_count, {"state": "live"})
        metrics.arena_slots().set(self.tombstone_count,
                                  {"state": "tombstone"})

    def _grow_slots(self, need: int):  # guarded-by: caller(state_lock)
        cap = self.slab_alloc.shape[0]
        new = cap
        while new < need:
            new *= 2
        if new == cap:
            return
        R, C = self.slab_alloc.shape[1], self.slab_compat.shape[1]
        for name, width, dtype in (("slab_alloc", R, np.float32),
                                   ("slab_used", R, np.float32)):
            old = getattr(self, name)
            arr = np.zeros((new, width), dtype)
            arr[:cap] = old
            setattr(self, name, arr)
        compat = np.zeros((new, C), bool)
        compat[:cap] = self.slab_compat
        self.slab_compat = compat
        live = np.zeros(new, bool)
        live[:cap] = self.slab_live
        self.slab_live = live
        self._node_at.extend([None] * (new - cap))

    def _grow_classes(self, need: int):  # guarded-by: caller(state_lock)
        cap = self.slab_compat.shape[1]
        new = cap
        while new < need:
            new *= 2
        if new == cap:
            return
        compat = np.zeros((self.slab_compat.shape[0], new), bool)
        compat[:, :cap] = self.slab_compat
        self.slab_compat = compat

    # ---- row math (bit-identical to Cluster.tensorize_nodes) --------------
    @staticmethod
    def _provided(node: Node) -> Requirements:
        node_labels = dict(node.labels)
        # hostname defaults to the node name — same rule as tensorize_nodes
        node_labels.setdefault(wk.HOSTNAME, node.name)
        return Requirements.from_labels(node_labels)

    @staticmethod
    def _compat_entry(rep: Pod, node: Node, provided: Requirements) -> bool:
        if not tolerates_all(rep.tolerations, node.taints):
            return False
        return any(b.compatible(provided)
                   for b in rep.scheduling_requirements())

    def _fill_row(self, slot: int, node: Node):  # guarded-by: caller(state_lock)
        self.slab_alloc[slot] = node.allocatable.to_vector(self._axes,
                                                           self._scales)
        self._fill_used(slot, node)
        provided = self._provided(node)
        row = self.slab_compat[slot]
        row[:] = False
        for rid, rep in enumerate(self._reps):
            row[rid] = self._compat_entry(rep, node, provided)

    def _fill_used(self, slot: int, node: Node):  # guarded-by: caller(state_lock)
        req = node.requested()
        req[PODS] = len(node.pods)
        self.slab_used[slot] = req.to_vector(self._axes, self._scales,
                                             round_up=True)

    # ---- class registry ---------------------------------------------------
    def _ensure_classes(self, reps: Sequence[Pod],  # guarded-by: caller(state_lock)
                        _post_reset: bool = False) -> List[int]:
        fresh: List[Tuple[int, Pod]] = []
        rids: List[int] = []
        for rep in reps:
            k = _class_key(rep)
            rid = self._rid_of.get(k)
            if rid is None:
                if len(self._reps) >= self.class_table_max and not _post_reset:
                    # wholesale reset; restart registration so every
                    # requested rep gets a fresh column.  A single gather
                    # with more distinct classes than the cap still
                    # registers them all (the cap bounds the table across
                    # calls, not per call) — _post_reset stops a second
                    # reset from recursing forever.
                    self._rid_of.clear()
                    self._reps = []
                    self.slab_compat[:] = False
                    return self._ensure_classes(reps, _post_reset=True)
                rid = len(self._reps)
                self._grow_classes(rid + 1)
                self._rid_of[k] = rid
                self._reps.append(rep)
                fresh.append((rid, rep))
            rids.append(rid)
        if fresh:
            # one provided-Requirements per live node, shared by all new
            # columns (the expensive part of a cold gather)
            for name, slot in self._slot_of.items():
                node = self._node_at[slot]
                provided = self._provided(node)
                for rid, rep in fresh:
                    self.slab_compat[slot, rid] = self._compat_entry(
                        rep, node, provided)
        return rids

    # ---- delta API --------------------------------------------------------
    def _take_slot(self, name: str) -> int:  # guarded-by: caller(state_lock)
        slot = self._slot_of.get(name)
        if slot is None:
            if self._free:
                slot = self._free.pop()     # LIFO: deterministic reuse order
            else:
                slot = self._top
                self._top += 1
                self._grow_slots(self._top)
            self._slot_of[name] = slot
        return slot

    def _drop_slot(self, name: str) -> bool:  # guarded-by: caller(state_lock)
        slot = self._slot_of.pop(name, None)
        if slot is None:
            return False
        self.slab_live[slot] = False
        self._node_at[slot] = None
        self._free.append(slot)
        return True

    def _maybe_compact(self):  # guarded-by: caller(state_lock)
        if len(self._free) > max(self.compact_floor, self.live_count):
            self.compact()

    def apply_node_add(self, node: Node):  # guarded-by: caller(state_lock)
        slot = self._take_slot(node.name)
        self._node_at[slot] = node
        self.slab_live[slot] = True
        self._fill_row(slot, node)
        self._note_delta("node_add")

    def apply_node_remove(self, name: str):  # guarded-by: caller(state_lock)
        if not self._drop_slot(name):
            return
        self._note_delta("node_remove")
        self._maybe_compact()

    def touch_node(self, node: Node):  # guarded-by: caller(state_lock)
        """Re-derive a tracked node's whole row after an in-place label /
        taint / allocatable edit (lifecycle initialization, termination
        taint, disruption taint + rollback)."""
        slot = self._slot_of.get(node.name)
        if slot is None:
            return
        self._node_at[slot] = node
        self._fill_row(slot, node)
        self._note_delta("touch")

    def apply_pod_bind(self, pod: Pod, node_name: str,
                       old_node_name: str = ""):  # guarded-by: caller(state_lock)
        if old_node_name and old_node_name != node_name:
            self._refresh_used(old_node_name)
        self._refresh_used(node_name)
        self._note_delta("pod_bind")

    def apply_pod_unbind(self, node_name: str):  # guarded-by: caller(state_lock)
        self._refresh_used(node_name)
        self._note_delta("pod_unbind")

    def apply_pod_add(self, pod: Pod):  # guarded-by: caller(state_lock)
        # a pending pod touches no node row; the epoch bump is what
        # invalidates cached faces built over the old pod set
        self._note_delta("pod_add")

    def apply_pod_remove(self, pod: Pod, node_name: str = ""):  # guarded-by: caller(state_lock)
        if node_name:
            self._refresh_used(node_name)
        self._note_delta("pod_remove")

    def _refresh_used(self, node_name: str):  # guarded-by: caller(state_lock)
        slot = self._slot_of.get(node_name)
        if slot is not None:
            self._fill_used(slot, self._node_at[slot])

    def invalidate(self, reason: str = ""):  # guarded-by: caller(state_lock)
        """Flag the slab for full re-derivation on next gather — the
        always-correct escape hatch for events the delta API can't
        express."""
        self._needs_rebuild = True
        self._note_delta("invalidate")

    def apply_ingest_flush(self, touched: Sequence[Node] = (),  # guarded-by: caller(state_lock)
                           removed: Sequence[str] = (),
                           used_names: Sequence[str] = ()):
        """Apply one tick's worth of coalesced ingestion events in a single
        delta (the IngestBatch gate's flush path).  Rows re-derive through
        the same exact math as the eager API — a batched flush and the
        equivalent eager event stream differ only in slot layout, never in
        gather() output (which orders by cluster dict, not slot).  Removals
        run first so their slots recycle for same-tick adds."""
        with tracing.span("arena.ingest_flush"):
            for name in removed:
                self._drop_slot(name)
            for node in touched:
                slot = self._take_slot(node.name)
                self._node_at[slot] = node
                self.slab_live[slot] = True
                self._fill_row(slot, node)
            for name in used_names:
                self._refresh_used(name)
            self._note_delta("ingest_flush")
            self._maybe_compact()

    # ---- snapshot / warm restart ------------------------------------------
    def snapshot_state(self) -> Dict:  # guarded-by: caller(state_lock)
        """Plain-data export of the whole slab + registries for the
        WarmRestart snapshot (state/snapshot.py).  Arrays are copied; the
        caller holds the state lock for the duration either way.  Node
        objects are not exported (slots rewire by name on restore); rep
        Pods are, because their class keys are content tuples that survive
        pickling."""
        return {
            "axes": tuple(self._axes),
            "scales": dict(self._scales),
            "slab_alloc": self.slab_alloc.copy(),
            "slab_used": self.slab_used.copy(),
            "slab_compat": self.slab_compat.copy(),
            "slab_live": self.slab_live.copy(),
            "slot_of": dict(self._slot_of),
            "free": list(self._free),
            "top": self._top,
            "rid_of": dict(self._rid_of),
            "reps": list(self._reps),
            "epoch": self.epoch,
            "compactions": self.compactions,
            "needs_rebuild": self._needs_rebuild,
        }

    def restore_state(self, data: Dict) -> bool:  # guarded-by: caller(state_lock)
        """Adopt a `snapshot_state` export, rewiring every slot to the
        restored Cluster's node objects by name.  Returns False (leaving the
        arena as it was) when the snapshot can't be trusted: axis/scale
        mismatch, a tracked name the cluster no longer has, or slab shapes
        that disagree — the caller then falls back to `rebuild()`, the
        always-correct path."""
        if tuple(data["axes"]) != self._axes or \
                dict(data["scales"]) != self._scales:
            return False
        nodes = self._cluster.nodes
        slot_of: Dict[str, int] = dict(data["slot_of"])
        if any(name not in nodes for name in slot_of):
            return False
        alloc = np.asarray(data["slab_alloc"], np.float32)
        used = np.asarray(data["slab_used"], np.float32)
        compat = np.asarray(data["slab_compat"], bool)
        live = np.asarray(data["slab_live"], bool)
        cap = alloc.shape[0]
        if used.shape != alloc.shape or compat.shape[0] != cap or \
                live.shape[0] != cap or alloc.shape[1] != len(self._axes):
            return False
        node_at: List[Optional[Node]] = [None] * cap
        for name, slot in slot_of.items():
            if not (0 <= slot < cap):
                return False
            node_at[slot] = nodes[name]
        self.slab_alloc = alloc
        self.slab_used = used
        self.slab_compat = compat
        self.slab_live = live
        self._slot_of = slot_of
        self._node_at = node_at
        self._free = list(data["free"])
        self._top = int(data["top"])
        self._rid_of = dict(data["rid_of"])
        self._reps = list(data["reps"])
        self.epoch = int(data["epoch"])
        self.compactions = int(data["compactions"])
        self._needs_rebuild = bool(data["needs_rebuild"])
        self._note_delta("restore")
        return True

    # ---- compaction / rebuild ---------------------------------------------
    def compact(self):  # guarded-by: caller(state_lock)
        """Densify the slab: move live rows to the front in cluster dict
        order (deterministic), drop tombstones, reset the free-list.  Pure
        row moves — values are already exact, so nothing recomputes."""
        with tracing.span("arena.compact"):
            nodes = [n for n in self._cluster.nodes.values()
                     if n.name in self._slot_of]
            idx = np.asarray([self._slot_of[n.name] for n in nodes], np.int64)
            E = len(nodes)
            cap = max(_INITIAL_SLOTS, self.slab_alloc.shape[0])
            while cap // 2 >= max(E, _INITIAL_SLOTS):
                cap //= 2
            R, C = self.slab_alloc.shape[1], self.slab_compat.shape[1]
            alloc = np.zeros((cap, R), np.float32)
            used = np.zeros((cap, R), np.float32)
            compat = np.zeros((cap, C), bool)
            live = np.zeros(cap, bool)
            if E:
                alloc[:E] = self.slab_alloc[idx]
                used[:E] = self.slab_used[idx]
                compat[:E] = self.slab_compat[idx]
                live[:E] = True
            self.slab_alloc, self.slab_used = alloc, used
            self.slab_compat, self.slab_live = compat, live
            self._node_at = list(nodes) + [None] * (cap - E)
            self._slot_of = {n.name: i for i, n in enumerate(nodes)}
            self._free = []
            self._top = E
            self.compactions += 1
            metrics.arena_compactions().inc()
            self._note_delta("compact")

    def rebuild(self):  # guarded-by: caller(state_lock)
        """Full re-derivation from cluster state — the fallback that makes
        every other path merely an optimization.  Keeps the class registry
        (columns recompute with the rows)."""
        with tracing.span("arena.rebuild") as sp:
            nodes = list(self._cluster.nodes.values())
            E = len(nodes)
            self._grow_slots(max(E, 1))
            self.slab_live[:] = False
            self.slab_alloc[:] = 0.0
            self.slab_used[:] = 0.0
            self.slab_compat[:] = False
            self._node_at = [None] * self.slab_alloc.shape[0]
            self._slot_of = {}
            self._free = []
            self._top = E
            for slot, node in enumerate(nodes):
                self._slot_of[node.name] = slot
                self._node_at[slot] = node
                self.slab_live[slot] = True
                self._fill_row(slot, node)
            self._needs_rebuild = False
            sp.annotate(nodes=E, classes=len(self._reps))
            self._note_delta("rebuild")

    # ---- the consumer surface ---------------------------------------------
    def gather(self, pod_classes: Sequence[Pod],
               axes: Tuple[str, ...] = DEFAULT_AXES,
               exclude: Sequence[str] = (),
               scales=None):
        """Warm replacement for `Cluster.tensorize_nodes` with the same
        signature and bit-identical output, or None when the slab can't
        serve the request (extra axes, non-default scales, a node the
        deltas never covered) — the caller falls back to the from-scratch
        path.  Read-only on the slab: fancy indexing copies, so consumers
        can never corrupt it."""
        if tuple(axes) != self._axes or (
                scales is not None and dict(scales) != self._scales):
            self.gathers["fallback"] += 1
            metrics.arena_gather().inc({"outcome": "fallback"})
            return None
        if self._needs_rebuild:
            self.rebuild()
        excl = set(exclude)
        node_list = [n for n in self._cluster.nodes.values()
                     if n.name not in excl and not n.marked_for_deletion]
        slots = []
        for n in node_list:
            slot = self._slot_of.get(n.name)
            if slot is None or self._node_at[slot] is not n:
                # untracked or swapped-out node object: the delta stream
                # missed something — refuse rather than risk a stale row
                self.gathers["fallback"] += 1
                metrics.arena_gather().inc({"outcome": "fallback"})
                return None
            slots.append(slot)
        rids = self._ensure_classes(pod_classes)
        idx = np.asarray(slots, np.int64)
        cols = np.asarray(rids, np.int64)
        alloc = self.slab_alloc[idx]
        used = self.slab_used[idx]
        compat = np.ascontiguousarray(self.slab_compat[idx][:, cols].T) \
            if len(node_list) else np.zeros((len(rids), 0), bool)
        self.gathers["warm"] += 1
        metrics.arena_gather().inc({"outcome": "warm"})
        return node_list, alloc, used, compat
