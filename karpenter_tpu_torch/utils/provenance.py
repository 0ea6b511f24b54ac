"""Per-pod scheduling decision provenance.

A copy of the JAX package's `utils/provenance.py` (without its metric
counter).  Upstream Karpenter answers "why is this pod still pending" with per-pod
`FailedScheduling` events naming the violated predicate; the dense solver
erases that information when it lowers pods to
equivalence classes and boolean compat masks.  This module reconstructs
it: given a solved `Problem` and a pod the packing left unschedulable,
`explain_unschedulable` re-walks the catalog filter in the same order the
tensorizer applied it (instance-type / nodepool requirements → zone →
capacity-type → remaining label requirements → resource fit) and reports
the *first* filter that emptied the offering set.

Records land in a bounded, thread-safe `ProvenanceStore` and are mirrored
as Warning `Event`s through the in-memory recorder.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from ..api import labels as wk

# Named constraints, in the order the catalog filter applies them.
INSTANCE_TYPE = "instance-type"
NODEPOOL = "nodepool"
ZONE = "zone"
CAPACITY_TYPE = "capacity-type"
REQUIREMENT = "requirement"     # a user-defined / unmodeled label key or taint
RESOURCE = "resource"           # a resource dimension exceeds every offering
CAPACITY = "capacity"           # offerings fit, but launch/limits ran dry
NO_OFFERINGS = "no-offerings"   # empty catalog / all pools exhausted
GANG = "gang"                   # all-or-nothing gang admission rejected the pod

_NAMED_KEYS = (
    (wk.INSTANCE_TYPE, INSTANCE_TYPE, "instance_type"),
    (wk.NODEPOOL, NODEPOOL, "pool"),
    (wk.ZONE, ZONE, "zone"),
    (wk.CAPACITY_TYPE, CAPACITY_TYPE, "capacity_type"),
)


@dataclass
class ProvenanceRecord:
    """Why one pod could not be scheduled, at the moment we last tried."""
    pod: str
    constraint: str                 # one of the constants above
    dimension: str = ""             # label key or resource axis that failed
    message: str = ""
    detail: Dict[str, Any] = field(default_factory=dict)
    ts: float = field(default_factory=time.time)

    def to_dict(self) -> Dict[str, Any]:
        return {"pod": self.pod, "constraint": self.constraint,
                "dimension": self.dimension, "message": self.message,
                "detail": dict(self.detail), "ts": self.ts}


class ProvenanceStore:
    """pod name → latest ProvenanceRecord, FIFO-capped, thread-safe."""

    def __init__(self, max_records: int = 4096):
        self.max_records = max_records
        self._records: "OrderedDict[str, ProvenanceRecord]" = OrderedDict()
        self._lock = threading.Lock()

    def record(self, rec: ProvenanceRecord) -> None:
        with self._lock:
            self._records.pop(rec.pod, None)
            self._records[rec.pod] = rec
            while len(self._records) > self.max_records:
                self._records.popitem(last=False)

    def clear(self, pod: str) -> None:
        """Drop a pod's record once it schedules."""
        with self._lock:
            self._records.pop(pod, None)

    def get(self, pod: str) -> Optional[ProvenanceRecord]:
        with self._lock:
            return self._records.get(pod)

    def all(self) -> List[ProvenanceRecord]:
        with self._lock:
            return list(self._records.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


def _class_of(problem, pod_idx: int) -> Optional[int]:
    for ci, members in enumerate(problem.class_members):
        if pod_idx in np.asarray(members, np.int64):
            return ci
    return None


def explain_unschedulable(problem, pod_idx: int) -> ProvenanceRecord:
    """First failing requirement/constraint for one unschedulable pod.

    Gang rejections (GangScheduling, ops/gang.py) take precedence: a pod
    stripped because its gang failed all-or-nothing admission was often
    individually placeable, so the catalog walk would mislead.  The gang
    record names the verdict ("gang partially placeable: 7/8"), which
    members fit, and — for partial gangs — replays the catalog walk on the
    WORST member (the first unplaced one) to name the constraint that sank
    the gang."""
    rej = getattr(problem, "gang_rejections", None)
    info = rej.get(pod_idx) if rej else None
    if info is not None:
        pod = problem.pods[pod_idx]
        detail = {k: info[k] for k in ("gang", "size", "tier", "topology",
                                       "arrived", "placed", "placed_members",
                                       "reason") if k in info}
        message = info.get("message", "gang rejected")
        worst = int(info.get("worst", -1))
        if worst >= 0:
            wrec = _explain_catalog(problem, worst)
            detail["worst_member"] = wrec.pod
            detail["worst_constraint"] = wrec.constraint
            detail["worst_dimension"] = wrec.dimension
            message += (f"; worst member {wrec.pod}: {wrec.constraint}"
                        + (f"/{wrec.dimension}" if wrec.dimension else "")
                        + f" — {wrec.message}")
        return ProvenanceRecord(pod=pod.name, constraint=GANG,
                                dimension=info.get("reason", ""),
                                message=message, detail=detail)
    return _explain_catalog(problem, pod_idx)


def _explain_catalog(problem, pod_idx: int) -> ProvenanceRecord:
    """The pre-gang walk: first failing catalog filter for one pod.

    Mirrors the tensorizer's filter order (`_CatalogSide.compat_row`): if
    the pod's equivalence class kept a non-empty compat row, the label
    filters all passed and the failure is resource fit (per-axis request
    vs `option_alloc`) or plain capacity; otherwise some label filter
    emptied the offering set, and the branch walk below replays the keys
    in filter order (instance-type, nodepool, zone, capacity-type, then
    user-defined keys / taints) to name the first one that did.
    """
    pod = problem.pods[pod_idx]
    opts = problem.options
    if not opts:
        return ProvenanceRecord(
            pod=pod.name, constraint=NO_OFFERINGS,
            message="no launch offerings: catalog empty or every nodepool excluded")

    ci = _class_of(problem, pod_idx)
    compat = (np.asarray(problem.class_compat[ci], bool)
              if ci is not None and problem.class_compat.shape[0] > ci
              else np.zeros(len(opts), bool))

    if compat.any():
        alloc = np.asarray(problem.option_alloc)[compat]   # O'×R
        req = np.asarray(problem.class_requests)[ci]       # R
        for r, axis in enumerate(problem.axes):
            cap = float(alloc[:, r].max())
            if req[r] > cap:
                scale = float(dict(problem.scales).get(axis, 1.0))
                return ProvenanceRecord(
                    pod=pod.name, constraint=RESOURCE, dimension=axis,
                    message=(f"requests {req[r] * scale:g} {axis} but the largest "
                             f"compatible offering allocates {cap * scale:g}"),
                    detail={"requested": req[r] * scale,
                            "max_allocatable": cap * scale})
        return ProvenanceRecord(
            pod=pod.name, constraint=CAPACITY,
            message="compatible offerings exist but launch capacity or nodepool "
                    "limits were exhausted this round")

    # Compat row empty: replay every OR branch; report the branch that got
    # furthest through the filter chain (k8s semantics: the pod schedules
    # if ANY branch does, so the deepest failure is the binding one).
    best: Optional[ProvenanceRecord] = None
    best_depth = -1
    for reqs in pod.scheduling_requirements():
        rec, depth = _walk_branch(problem, pod, reqs)
        if depth > best_depth:
            best, best_depth = rec, depth
    if best is not None:
        return best
    # Branches pass every checkable key yet compat is empty: the group
    # mask rejected on something the dense columns can't name — taints
    # are the only remaining filter in compat_row.
    return ProvenanceRecord(
        pod=pod.name, constraint=REQUIREMENT, dimension="taints",
        message="pod does not tolerate the taints of any offering nodepool")


def _walk_branch(problem, pod, reqs):
    """Apply one requirement branch key-by-key over the offering columns.
    Returns (record | None, depth): the first key that empties the
    offering set, with depth = how many keys passed before it."""
    opts = problem.options
    mask = np.ones(len(opts), bool)
    depth = 0
    for key, constraint, attr in _NAMED_KEYS:
        req = reqs.get(key)
        if req is None:
            continue
        step = np.fromiter((req.has(getattr(o, attr)) for o in opts),
                           bool, count=len(opts))
        if not (mask & step).any():
            offered = sorted({str(getattr(o, attr)) for o, m in zip(opts, mask) if m})
            return ProvenanceRecord(
                pod=pod.name, constraint=constraint, dimension=key,
                message=f"no offering satisfies [{req!r}]; offered: {offered[:8]}",
                detail={"requirement": repr(req), "offered": offered[:16]}), depth
        mask &= step
        depth += 1
    named = {k for k, _, _ in _NAMED_KEYS}
    for key, req in reqs.items():
        if key in named:
            continue
        # The group mask fails closed on keys the catalog doesn't provide;
        # the first user-defined key is what excluded every offering.
        return ProvenanceRecord(
            pod=pod.name, constraint=REQUIREMENT, dimension=key,
            message=f"requirement [{req!r}] not satisfied by any nodepool/instance-type",
            detail={"requirement": repr(req)}), depth
    return None, depth
