"""Device decode (the DeviceDecode gate): columnar plan assembly from the
slot slab.

A copy of the JAX package's `ops/decode.py`.  The slab is what
`class_pack_assign_slab_kernel[_fresh]` emits (K1-K3, then K6
`classpack_slab` on the card), or per shard what the partitioned driver's
`_partitioned_assign_slab` emits (the same kernels shard-batched):

    order        row ids stable-sorted by slot (unscheduled rows, then
                 padding, sort to the back under key=K)
    slot_counts  pods per slot — node run lengths after the sort
    slot_option  option column per slot

From those three arrays every plan artifact is a gather, repeat or
reduceat, and `assemble_slab_single` reproduces the legacy decode exactly:
same node order, same pod order inside a node, same dict insertion order,
same float total.

`DecodeHealth` is the single-rung analog of `ops/health.SolverHealth`: a
slab-assembly failure falls back to host assembly over
`slab_to_assignment` (no second kernel launch) and demotes the device path
for a doubling backoff window.  Every transition is logged, tallied and
counted in the reference's decode families, and each demotion publishes a
`decode_demotion` incident (obs/incidents.py).
`assemble_slab_sharded` is the mesh drivers' assembler over the shard-major
stitched slabs, and `merge_residual_used` charges the mesh pass's
existing-node fills before the residual reconcile.

Every function here is decode-hot (`graftlint` JH007/JH008 hold the
whole module to the no-per-pod-Python discipline); the deliberate
per-existing-node exceptions are `range()` loops over node counts, and
the residual-reconcile merge is grandfathered in the baseline.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..obs.incidents import publish_incident
from ..utils import metrics

log = logging.getLogger("karpenter_tpu_torch.decode")

# graftlint: decode-path

# Below this many pods the slab path is not worth the extra on-device sort:
# the legacy decode's host argsort on a few hundred rows is already
# microseconds, and small batches are the steady state of a live cluster.
DEVICE_DECODE_FLOOR = 512

DEMOTE_AFTER_ERRORS = 2       # consecutive failures before demotion
DEFAULT_WINDOW_S = 60.0       # first demotion window
DEFAULT_WINDOW_MAX_S = 600.0  # doubling cap


class DecodeHealth:
    """Single-rung breaker for the DeviceDecode path: device ⇄ host.

    Repeated slab failures demote device decode for a backoff window that
    doubles per consecutive demotion; an expired window offers exactly one
    half-open probe — success promotes back, failure re-demotes for
    longer.  Host assembly is always available and never demoted.  The
    clock is injectable, and the state round-trips through
    `snapshot_state` / `restore_state`."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 demote_after: int = DEMOTE_AFTER_ERRORS,
                 window_s: float = DEFAULT_WINDOW_S,
                 window_max_s: float = DEFAULT_WINDOW_MAX_S):
        self.clock = clock
        self.demote_after = max(1, int(demote_after))
        self.window_s = float(window_s)
        self.window_max_s = float(window_max_s)
        self.failures = 0            # consecutive, since last success
        self.demotions = 0           # consecutive (window doubling)
        self.demoted_until = float("-inf")
        self.probing = False         # a half-open probe is in flight
        self.total_failures = 0
        self.total_demotions = 0
        # deterministic transition tally: "event:reason" → n
        self.transitions: Dict[str, int] = {}

    def allow(self) -> bool:
        """True when the device path may run.  An expired demotion window
        turns into a half-open probe: offered once; failure re-demotes."""
        now = self.clock()
        if self.demoted_until <= now:
            if self.demotions and not self.probing:
                self.probing = True
                log.info("device decode: half-open probe")
            return True
        return False

    def report_success(self) -> None:
        if self.probing or self.demotions:
            self._transition("recovered", "recovered")
        self.failures = 0
        self.demotions = 0
        self.probing = False
        self.demoted_until = float("-inf")
        metrics.decode_demoted().set(0)

    def report_failure(self, reason: str = "error") -> None:
        self.failures += 1
        self.total_failures += 1
        if self.probing or self.failures >= self.demote_after:
            self.probing = False
            self.failures = 0
            self.demotions += 1
            self.total_demotions += 1
            window = min(self.window_s * (2.0 ** (self.demotions - 1)),
                         self.window_max_s)
            self.demoted_until = self.clock() + window
            self._transition("demoted", reason)
            log.warning("device decode demoted to host assembly (%s), "
                        "window %.0fs", reason, window)
        metrics.decode_demoted().set(
            1 if self.demoted_until > self.clock() else 0)

    def _transition(self, event: str, reason: str) -> None:
        key = f"{event}:{reason}"
        self.transitions[key] = self.transitions.get(key, 0) + 1
        metrics.decode_transitions().inc({"event": event, "reason": reason})
        if event != "recovered":
            publish_incident("decode_demotion", {
                "reason": reason, "demotions": self.demotions,
                "transitions": dict(self.transitions)})
        if event == "recovered":
            log.info("device decode recovered")

    # ---- warm restart ----------------------------------------------------
    def snapshot_state(self) -> Dict:
        """Round-trippable breaker state; `demoted_until` is an absolute
        clock reading, valid only within one clock domain."""
        return {
            "failures": self.failures,
            "demotions": self.demotions,
            "demoted_until": self.demoted_until,
            "probing": self.probing,
            "total_failures": self.total_failures,
            "total_demotions": self.total_demotions,
            "transitions": dict(self.transitions),
        }

    def restore_state(self, data: Dict) -> None:
        self.failures = int(data["failures"])
        self.demotions = int(data["demotions"])
        self.demoted_until = float(data["demoted_until"])
        self.probing = bool(data["probing"])
        self.total_failures = int(data["total_failures"])
        self.total_demotions = int(data["total_demotions"])
        self.transitions = dict(data["transitions"])


def slab_to_assignment(order_idx: np.ndarray, slot_counts: np.ndarray,
                       n_rows: int, K: int) -> np.ndarray:
    """Reconstruct the legacy per-row assignment vector from the slab —
    the host-fallback bridge when slab assembly fails after the kernel
    already ran (launching it again would double the device cost).  Exact
    inverse of the slab sort: rows order[:S] carry slots
    repeat(arange(K), slot_counts); everything else is unscheduled."""
    order_idx = np.asarray(order_idx, np.int64)
    slot_counts = np.asarray(slot_counts, np.int64)
    S = int(slot_counts.sum())
    out = np.full(n_rows, -1, np.int32)
    out[order_idx[:S]] = np.repeat(
        np.arange(K, dtype=np.int32), slot_counts)
    return out


def assemble_slab_single(problem, order_idx, slot_counts, slot_option,
                         pod_idx, class_of_row, E: int, K: int,
                         max_alternatives: int, n_rows: int):
    """Single-device slab → PackingResult, bit-identical to the legacy
    `solve_classpack` decode over the same kernel output.

    Parity notes (each pins a byte of the legacy output):
    - unschedulable: the key-K segment of `order` keeps original row
      order under the stable sort — same list as `pod_idx[~sched]`.
    - existing fills: the slab is slot-sorted but the legacy dict is
      ROW-ordered, so the existing segment is argsorted back to row
      order before the dict(zip(...)).
    - per-node usage: the same `np.add.reduceat` over the request rows the
      legacy decode runs (exact: integer-valued)."""
    from .classpack import resolve_alternatives
    from .ffd import NodeDecision, PackingResult

    O = problem.num_options
    order_idx = np.asarray(order_idx, np.int64)
    slot_counts = np.asarray(slot_counts, np.int64)
    S = int(slot_counts.sum())
    take = order_idx[:S]
    unschedulable = pod_idx[order_idx[S:S + (n_rows - S)]].tolist()

    nE = int(slot_counts[:E].sum()) if E else 0
    if nE:
        ex_rows = take[:nE]
        eids = np.repeat(np.arange(E, dtype=np.int64), slot_counts[:E])
        ro = np.argsort(ex_rows, kind="stable")
        existing_assignments = dict(zip(pod_idx[ex_rows[ro]].tolist(),
                                        eids[ro].tolist()))
    else:
        existing_assignments = {}

    new_sorted = take[nE:]
    cnts = slot_counts[E:]
    occ = np.nonzero(cnts)[0]
    run = cnts[occ]
    node_slots = (occ + E).astype(np.int64)
    ends = np.cumsum(run)
    starts = ends - run
    ks = np.repeat(node_slots, run)
    cls_sorted = class_of_row[new_sorted]

    if len(starts):
        row_reqs = problem.class_requests[cls_sorted]
        node_used = np.add.reduceat(row_reqs, starts, axis=0).astype(np.int64)
    else:
        node_used = np.zeros((0, problem.class_requests.shape[1]), np.int64)

    Cn = problem.num_classes
    upq = np.unique(ks * (Cn + 1) + cls_sorted) if len(ks) else \
        np.zeros(0, np.int64)
    uslot, ucls = upq // (Cn + 1), upq % (Cn + 1)
    cls_starts = np.searchsorted(uslot, node_slots, side="left")
    cls_ends = np.searchsorted(uslot, node_slots, side="right")

    pod_sorted = pod_idx[new_sorted].tolist()
    node_oi = slot_option[node_slots].astype(np.int64)
    launch_mask = (node_oi >= 0) & (node_oi < O)
    total = float(problem.option_price[node_oi[launch_mask]].sum())
    oi_l = node_oi.tolist()
    starts_l, ends_l = starts.tolist(), ends.tolist()
    options_l = problem.options

    compat_bits = np.packbits(problem.class_compat, axis=1)
    ucls_l = ucls.tolist()
    cs_l, ce_l = cls_starts.tolist(), cls_ends.tolist()
    N = len(oi_l)
    jcb_list: List = [None] * N
    for i in range(N):
        if not (0 <= oi_l[i] < O):
            continue
        cls = ucls_l[cs_l[i]:ce_l[i]]
        jcb_list[i] = (compat_bits[cls[0]] if len(cls) == 1 else
                       np.bitwise_and.reduce(compat_bits[cls], axis=0))
    resolved = resolve_alternatives(problem, oi_l, jcb_list, node_used,
                                    max_alternatives)

    nodes = []
    for i in range(N):
        hit = resolved[i]
        if hit is None:
            continue
        nodes.append(NodeDecision(
            option=options_l[oi_l[i]],
            pod_indices=pod_sorted[starts_l[i]:ends_l[i]],
            used=hit[1],
            alternatives=hit[0],
        ))
    return PackingResult(nodes=nodes, unschedulable=unschedulable,
                         existing_assignments=existing_assignments,
                         total_price=total)


def assemble_slab_sharded(problem, pods_sorted, cls_sorted, node_slots,
                          run, unsched_pods, slot_option, O: int, K: int):
    """Sharded slab → (PackingResult, existing_used_add), bit-identical
    to `parallel/sharded._assemble_plan` over the concatenated shard
    rows.  The inputs are already globally slot-sorted: per-shard stable
    sorts concatenated shard-major equal one global stable sort because
    shard s's slot ids live in [s*K, (s+1)*K).

    Parity notes:
    - existing dict: node-major insertion in global slot order — one
      `np.repeat` of the node mask over run lengths reproduces it.
    - per-existing-node usage adds keep the legacy float32 `.sum(axis=0)`
      expression verbatim (a per-EXISTING-node loop, bounded by the
      cluster's node count, never pods).
    - total price: legacy accumulates `total += float(price[oi])`
      sequentially in float64; `np.cumsum` over float64 is the same left
      fold, so the last element is bit-equal.
    """
    from .classpack import resolve_alternatives
    from .ffd import NodeDecision, PackingResult

    unschedulable = unsched_pods.tolist()
    run = np.asarray(run, np.int64)
    node_slots = np.asarray(node_slots, np.int64)
    ends = np.cumsum(run)
    starts = ends - run
    node_shard = node_slots // K
    node_local = node_slots % K
    node_col = slot_option[node_shard, node_local].astype(np.int64)

    existing_assignments: Dict[int, int] = {}
    existing_used_add: Dict[int, np.ndarray] = {}
    reqs_f = problem.class_requests
    ex_mask = node_col >= O
    if ex_mask.any():
        row_ex = np.repeat(ex_mask, run)
        eid_rows = np.repeat(node_col - O, run)
        existing_assignments = dict(zip(pods_sorted[row_ex].tolist(),
                                        eid_rows[row_ex].tolist()))
        ex_idx = np.nonzero(ex_mask)[0]
        s_l, e_l = starts[ex_idx].tolist(), ends[ex_idx].tolist()
        eid_l = (node_col[ex_idx] - O).tolist()
        for j in range(len(eid_l)):
            add = reqs_f[cls_sorted[s_l[j]:e_l[j]]].sum(axis=0)
            existing_used_add[eid_l[j]] = \
                existing_used_add.get(eid_l[j], 0.0) + add

    new_idx = np.nonzero(~ex_mask)[0]
    oi_arr = node_col[new_idx]
    reqs = problem.class_requests.astype(np.int64)
    if len(starts):
        used_all = np.add.reduceat(reqs[cls_sorted], starts, axis=0)
        used_mat = used_all[new_idx]
    else:
        used_mat = np.zeros((0, reqs.shape[1]), np.int64)

    # per-node class sets from one global unique over (node, class) pairs
    # — feeds resolve_alternatives' content-digest memo (cls_keys), so the
    # joint-compat AND only runs for memo misses
    Cn = problem.num_classes
    node_of_row = np.repeat(np.arange(len(node_slots), dtype=np.int64), run)
    upq = (np.unique(node_of_row * (Cn + 1) + cls_sorted)
           if len(cls_sorted) else np.zeros(0, np.int64))
    unode, ucls = upq // (Cn + 1), upq % (Cn + 1)
    cs = np.searchsorted(unode, new_idx, side="left").tolist()
    ce = np.searchsorted(unode, new_idx, side="right").tolist()
    ucls_l = ucls.tolist()
    M = len(new_idx)
    cls_keys = [tuple(ucls_l[cs[j]:ce[j]]) for j in range(M)]

    oi_l = oi_arr.tolist()
    resolved = resolve_alternatives(problem, oi_l, None, used_mat,
                                    cls_keys=cls_keys)

    price_new = problem.option_price[oi_arr]
    total = (float(np.cumsum(price_new.astype(np.float64))[-1])
             if len(oi_arr) else 0.0)
    pods_l = pods_sorted.tolist()
    s_l, e_l = starts[new_idx].tolist(), ends[new_idx].tolist()
    nodes = []
    for j in range(M):
        alts, used_rl = resolved[j]
        nodes.append(NodeDecision(
            option=problem.options[oi_l[j]],
            pod_indices=pods_l[s_l[j]:e_l[j]],
            used=used_rl, alternatives=alts))
    return PackingResult(nodes=nodes, unschedulable=unschedulable,
                         existing_assignments=existing_assignments,
                         total_price=total), existing_used_add


def merge_residual_used(existing_used: Optional[np.ndarray],
                        used_add: Dict[int, np.ndarray],
                        E: int, R: int) -> np.ndarray:
    """True leftovers for the residual reconcile: charge the mesh pass's
    existing-node fills against each node's free space.  The per-eid loop
    is the deliberate residual-reconcile exception (bounded by cluster
    node count, grandfathered in
    karpenter_tpu_torch/tools/graftlint-baseline.json)."""
    used2 = (existing_used.astype(np.float64).copy()
             if existing_used is not None
             else np.zeros((E, R), np.float64))
    for eid in sorted(used_add):
        used2[eid] += used_add[eid]
    return used2
