"""Operator state snapshots + warm restart (the WarmRestart gate).

A copy of the JAX package's `state/snapshot.py`.  A plain process death
costs a full world re-tensorization: restart recovery
(`Operator.hydrate_cluster`) rebuilds NodeClaims from cloud tags, loses
every pod binding, and the arena, guide and PDHG warm-start caches start
cold.  This module serializes the whole control-plane working set —

* `Cluster` dicts (nodes, claims, pods, PDBs) + mutation epoch,
* the `ClusterArena` slab and registries (`ops/arena.py snapshot_state`),
* solver-adjacent caches: the LP mix/stale/support caches
  (`ops/lpguide.py`), the PDHG warm-start cache (`ops/lpsolve.py`), the
  unavailable-offerings ICE cache, the forecast demand series, the
  solver-health ladders (packing and DeviceLP), the decode breaker, and
  every controller supervisor's circuit state,
* the fake-cloud substrate and interruption queue (so a resumed run
  replays the exact launch/reclaim stream),
* the leader/readiness counters and the gang registry, and
* the module-level name/id counters (probe-and-reset, net-zero draws) so
  post-restore node names continue the uninterrupted sequence —

into one versioned, checksummed file (MAGIC ⊕ sha256 ⊕ one pickle),
written atomically (tmp + ``os.replace``) on a cadence and on SIGTERM.

Every section is host data — numpy arrays and plain Python, never a torch
tensor — so a snapshot written beside the card loads on a machine without
one.  The payload is ONE ``pickle.dumps`` over a sections dict: shared
references (a node's ``pods`` entries are the same objects as
``cluster.pods`` values) survive as shared references, which the arena's
identity-checked ``gather()`` depends on after restore.  Restore validates
magic, version, checksum, and meta↔section epoch consistency; any mismatch
is a cold fallback whose reason `restore_snapshot` returns — the operator
simply keeps what hydration built from cloud state, so a corrupt snapshot
is never worse than no snapshot.  On the happy path the restored arena
serves its first `gather()` warm: no `tensorize_nodes`.

Cross-process cache hygiene: `_class_key` caches (plain content tuples
stored on pods) pickle and stay valid; the interned `_cid` tokens of
`ops/tensorize.py` are process-local.  Their generation counter starts at
0 in every process, so a token minted by the dead process can look current
to the new one and collide with an id the new process minted for another
class.  Restore therefore drops `_cid` from every restored pod: each
re-interns lazily by its content key, and class order stays first
appearance.

Writes and restores feed the reference's snapshot families;
`restore_snapshot` also returns its outcome, and `SnapshotWriter` keeps its
write outcomes (`writes`), the last file's size and the last write's host
time.  A cold fallback publishes a `snapshot_fallback` incident
(obs/incidents.py).  The flight recorder's, the SLO engine's and the cost
ledger's sections (`incidents`, `slo`, `ledger`) are written only with
their gates on, so a gate-off snapshot is byte-identical to one written
before they existed.
"""

from __future__ import annotations

import hashlib
import itertools
import logging
import os
import pickle
import time
from typing import Dict, Iterable, Optional, Tuple

from ..obs.incidents import publish_incident
from ..utils import metrics

log = logging.getLogger("karpenter_tpu_torch.snapshot")

MAGIC = b"KTSNAP01"
VERSION = 1
_HEADER_LEN = len(MAGIC) + 32  # magic + sha256(payload)


# ---------------------------------------------------------------------------
# module-level counters: probe-and-reset (read the next value, recreate the
# counter at it — net zero draws, so snapshotting never perturbs the run)
# ---------------------------------------------------------------------------

def _counter_sites():
    # the reference also carries `cloud.fake._fleet_ids`, a counter its fake
    # cloud never draws and the port does not have
    from ..api import objects as objects_mod
    from ..cloud import queue as queue_mod
    from . import cluster as cluster_mod
    return (("node_names", cluster_mod, "_names"),
            ("object_ids", objects_mod, "_ids"),
            ("msg_ids", queue_mod, "_msg_ids"))


def _snapshot_counters() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for key, mod, attr in _counter_sites():
        v = next(getattr(mod, attr))
        setattr(mod, attr, itertools.count(v))
        out[key] = v
    return out


def _restore_counters(data: Dict[str, int]) -> None:
    for key, mod, attr in _counter_sites():
        if key in data:
            setattr(mod, attr, itertools.count(int(data[key])))


def _drop_class_tokens(pods: Iterable) -> None:
    """Forget the dead process's interned class ids (`_cid`, ops/tensorize.py)
    on restored pods: each re-interns by its content key on its next
    tensorize instead of reusing an id this process may have given another
    class."""
    for pod in pods:
        pod.__dict__.pop("_cid", None)


# ---------------------------------------------------------------------------
# collection
# ---------------------------------------------------------------------------

def _prov_attr(manager, name: str):
    prov = manager.controllers.get("provisioning") \
        if manager is not None else None
    return getattr(prov, name, None) if prov is not None else None


def collect_sections(op, manager=None) -> Dict:
    """Assemble the sections dict from a live operator (+ optional
    manager).  Caller holds the state lock; nothing here blocks."""
    from ..ops import lpguide, lpsolve
    cluster = op.cluster
    arena = cluster.arena
    sections: Dict[str, object] = {
        "counters": _snapshot_counters(),
        "cluster": cluster.snapshot_state(),
        "arena": arena.snapshot_state() if arena is not None else None,
        "unavailable": op.unavailable.snapshot_state(),
        "lpguide": lpguide.snapshot_caches(),
        "lpsolve": lpsolve.snapshot_caches(),
        "cloud": op.raw_cloud.snapshot_state(),
        "queue": op.queue.snapshot_state() if op.queue is not None else None,
    }
    observer = cluster.observer
    if observer is not None and hasattr(observer, "snapshot_state"):
        sections["series"] = observer.snapshot_state()
    if manager is not None:
        sections["supervisors"] = {
            name: sup.snapshot_state()
            for name, sup in manager.supervisors.items()}
        bw = manager.batch_window
        sections["manager"] = {
            "entries": {e.name: e.last_run for e in manager._entries},
            "batch_window": {"opened": bw._opened, "last_add": bw._last_add,
                             "last_count": bw._last_count},
        }
        for key, attr in (("health", "health"), ("decode", "decode_health"),
                          ("lp_health", "lp_health")):
            obj = _prov_attr(manager, attr)
            if obj is not None:
                sections[key] = obj.snapshot_state()
        # HA leader/readiness state (operator/manager.py)
        ha = getattr(manager, "ha_snapshot_state", None)
        if ha is not None:
            sections["leader"] = ha()
        # flight-recorder cursor + bus dedup state (FlightRecorder gate),
        # SLO error budgets and cost-ledger entries (SLOEngine gate): each
        # hook returns None when its gate is off, keeping gate-off
        # snapshots byte-identical
        for key in ("incidents", "slo", "ledger"):
            hook = getattr(manager, f"{key}_snapshot_state", None)
            state = hook() if hook is not None else None
            if state is not None:
                sections[key] = state
        # gang admission registry (GangScheduling gate): None when the gate
        # is off, keeping gate-off snapshots as they were — a restart can
        # never observe a half-admitted gang because admission is atomic
        # before binding
        gang = getattr(manager, "gang_snapshot_state", None)
        if gang is not None:
            gang_state = gang()
            if gang_state is not None:
                sections["gang"] = gang_state
    sections["meta"] = {
        "version": VERSION,
        "written_at": op.clock(),
        "cluster_epoch": cluster.mutation_epoch,
        "arena_epoch": arena.epoch if arena is not None else None,
    }
    return sections


# ---------------------------------------------------------------------------
# file format: MAGIC ⊕ sha256(payload) ⊕ payload (one pickle)
# ---------------------------------------------------------------------------

def _write(path: str, op, manager=None, fence=None) -> Tuple[str, int]:
    """Serialize + atomically replace `path`.  Returns (outcome, bytes
    written): "ok", "stale_fence" (a fence whose epoch is stale refused
    the write; nothing was written) or "error" (the previous file is
    intact: tmp + rename).  Each outcome is counted in
    karpenter_snapshot_writes_total."""
    t0 = time.perf_counter()
    if fence is not None and not fence.check("snapshot"):
        metrics.snapshot_writes().inc({"outcome": "stale_fence"})
        return "stale_fence", 0
    try:
        sections = collect_sections(op, manager)
        if fence is not None:
            sections["meta"]["fence_epoch"] = fence.epoch()
        payload = pickle.dumps(sections, protocol=pickle.HIGHEST_PROTOCOL)
        blob = MAGIC + hashlib.sha256(payload).digest() + payload
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except Exception:
        log.exception("snapshot write to %s failed", path)
        metrics.snapshot_writes().inc({"outcome": "error"})
        return "error", 0
    metrics.snapshot_writes().inc({"outcome": "ok"})
    metrics.snapshot_write_duration().observe(time.perf_counter() - t0)
    metrics.snapshot_size().set(len(blob))
    return "ok", len(blob)


def write_snapshot(path: str, op, manager=None, fence=None) -> bool:
    """Serialize + atomically replace `path`.  Returns success; a failed
    write leaves the previous snapshot intact (tmp + rename).  With a
    `fence` (utils/fencing.LeaseFence), the write is refused when the
    fencing epoch is stale — the "two operators, one snapshot file"
    invariant: a deposed leader's late write must lose to the successor,
    and the refusal is counted in `fence.refusals`, never silent."""
    return _write(path, op, manager, fence)[0] == "ok"


def load_sections(path: str) -> Tuple[Optional[Dict], str]:
    """Read + validate a snapshot file.  Returns (sections, "ok") or
    (None, reason) — the reasons are the restore outcomes."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return None, "missing"
    if len(blob) < _HEADER_LEN or not blob.startswith(MAGIC):
        return None, "bad_magic"
    digest = blob[len(MAGIC):_HEADER_LEN]
    payload = blob[_HEADER_LEN:]
    if hashlib.sha256(payload).digest() != digest:
        return None, "bad_checksum"
    try:
        sections = pickle.loads(payload)
        if int(sections["meta"]["version"]) != VERSION:
            return None, "bad_version"
    except Exception:
        return None, "bad_checksum"
    meta = sections["meta"]
    cluster_sec = sections.get("cluster") or {}
    if meta.get("cluster_epoch") != cluster_sec.get("mutation_epoch"):
        return None, "epoch_mismatch"
    arena_sec = sections.get("arena")
    arena_epoch = arena_sec["epoch"] if arena_sec is not None else None
    if meta.get("arena_epoch") != arena_epoch:
        return None, "epoch_mismatch"
    return sections, "ok"


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------

def restore_snapshot(path: str, op, manager=None) -> str:
    """Warm-restore the operator from `path`.  Returns the outcome
    ("restored", or the cold-fallback reason).  Caller holds the state
    lock.  On any failure the operator is left on the cold path — arena
    flagged for rebuild, cluster state whatever hydration built — which
    is always correct, just slower."""
    sections, reason = load_sections(path)
    if sections is None:
        log.warning("snapshot restore from %s: cold fallback (%s)",
                    path, reason)
        metrics.snapshot_restores().inc({"outcome": reason})
        publish_incident("snapshot_fallback", {"outcome": reason,
                                               "path": path})
        return reason
    # pre-state for rollback: a half-applied restore must never leave a
    # structurally invalid cluster, so on any apply exception the hydrated
    # cold state (live dict refs, untouched by the failed apply) goes back
    # before degrading
    pre_cluster = op.cluster.snapshot_state()
    pre_counters = _snapshot_counters()
    try:
        _apply_sections(sections, op, manager)
    except Exception:
        log.exception("snapshot restore from %s failed mid-apply; "
                      "rolling back to cold state", path)
        try:
            _restore_counters(pre_counters)
            op.cluster.restore_state(pre_cluster)
        except Exception:
            log.exception("rollback after failed restore also failed")
        if op.cluster.arena is not None:
            op.cluster.arena.invalidate("restore_failed")
        metrics.snapshot_restores().inc({"outcome": "apply_error"})
        publish_incident("snapshot_fallback", {"outcome": "apply_error",
                                               "path": path})
        return "apply_error"
    age = max(0.0, op.clock() - float(sections["meta"]["written_at"]))
    metrics.snapshot_restores().inc({"outcome": "restored"})
    metrics.snapshot_age().set(age)
    log.info("warm restore from %s: %d nodes, %d pods, snapshot age %.3fs",
             path, len(op.cluster.nodes), len(op.cluster.pods), age)
    return "restored"


def _apply_sections(sections: Dict, op, manager=None) -> None:
    from ..ops import lpguide, lpsolve
    _restore_counters(sections.get("counters", {}))
    op.cluster.restore_state(sections["cluster"])
    arena = op.cluster.arena
    arena_sec = sections.get("arena")
    _drop_class_tokens(op.cluster.pods.values())
    if arena_sec is not None:
        _drop_class_tokens(arena_sec["reps"])
    if arena is not None:
        if arena_sec is None or not arena.restore_state(arena_sec):
            arena.invalidate("restore_mismatch")
    op.unavailable.restore_state(sections["unavailable"])
    lpguide.restore_caches(sections.get("lpguide", {}))
    lpsolve.restore_caches(sections.get("lpsolve", {}))
    op.raw_cloud.restore_state(sections["cloud"])
    if op.queue is not None and sections.get("queue") is not None:
        op.queue.restore_state(sections["queue"])
    observer = op.cluster.observer
    if observer is not None and hasattr(observer, "restore_state") \
            and "series" in sections:
        observer.restore_state(sections["series"])
    if manager is None:
        return
    for name, data in sections.get("supervisors", {}).items():
        sup = manager.supervisors.get(name)
        if sup is not None:
            sup.restore_state(data)
    mgr_sec = sections.get("manager")
    if mgr_sec is not None:
        last_runs = mgr_sec.get("entries", {})
        for e in manager._entries:
            if e.name in last_runs:
                e.last_run = float(last_runs[e.name])
        bw = mgr_sec.get("batch_window")
        if bw is not None:
            manager.batch_window._opened = bw["opened"]
            manager.batch_window._last_add = bw["last_add"]
            manager.batch_window._last_count = int(bw["last_count"])
    for key, attr in (("health", "health"), ("decode", "decode_health"),
                      ("lp_health", "lp_health")):
        obj = _prov_attr(manager, attr)
        if obj is not None and key in sections:
            obj.restore_state(sections[key])
    ha = getattr(manager, "ha_restore_state", None)
    if ha is not None and sections.get("leader") is not None:
        ha(sections["leader"])
    for key in ("incidents", "slo", "ledger"):
        hook = getattr(manager, f"{key}_restore_state", None)
        if hook is not None and sections.get(key) is not None:
            hook(sections[key])
    gang = getattr(manager, "gang_restore_state", None)
    if gang is not None and sections.get("gang") is not None:
        gang(sections["gang"])


# ---------------------------------------------------------------------------
# cadence driver (held by the ControllerManager under the WarmRestart gate)
# ---------------------------------------------------------------------------

class SnapshotWriter:
    """Periodic snapshot driver: `maybe_write(now)` from the tick loop,
    `write_final()` from `stop()` (the SIGTERM hook).  `writes` counts the
    outcomes of its writes; `last_bytes` / `last_write_ms` are the last
    successful file's size and its write's host time (collection, pickle
    and the atomic replace)."""

    def __init__(self, path: str, op, manager=None,
                 interval_s: float = 30.0, fence=None):
        self.path = path
        self.op = op
        self.manager = manager
        self.interval_s = float(interval_s)
        self._last_written = float("-inf")
        # HAFailover: the manager attaches its LeaseFence here, so every
        # cadence and final write validates the fencing epoch first — a
        # deposed replica's cadence can never clobber the successor's
        # snapshot
        self.fence = fence
        self.writes: Dict[str, int] = {}
        self.last_bytes = 0
        self.last_write_ms = 0.0

    def _write(self) -> bool:
        t0 = time.perf_counter()
        outcome, nbytes = _write(self.path, self.op, self.manager,
                                 fence=self.fence)
        self.writes[outcome] = self.writes.get(outcome, 0) + 1
        if outcome == "ok":
            self.last_bytes = nbytes
            self.last_write_ms = (time.perf_counter() - t0) * 1e3
        return outcome == "ok"

    def maybe_write(self, now: float) -> bool:
        if not self.path or now - self._last_written < self.interval_s:
            return False
        ok = self._write()
        if ok:
            self._last_written = now
        return ok

    def write_final(self) -> bool:
        if not self.path:
            return False
        return self._write()
