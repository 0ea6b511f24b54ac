"""First-fit-decreasing packing, pod by pod, and the result types every
solver returns.

The port of the JAX package's `ops/ffd.py`.  `solve_ffd` expands classes to
FFD-sorted pod rows, pads them as the reference does and runs one scan step
per row: the first open slot that fits, else the best new node (highest
pool rank, then the least tail-aware score price × ceil(tail / m)).  Its
backends:

  * "jax" (the reference's label, kept): the scan on the card, the
    hand-written CUDA kernel K7 `ffd_scan` (ops/ffd_kernels.py,
    csrc/ffd.cu); on the CPU, only when asked for, its plain version;
  * "numpy": `ffd_pack_numpy`, the degradation ladder's host greedy rung —
    no device, always terminates;
  * "native": the C++ packer of `karpenter_tpu_torch/native` on the host
    (the ladder's "native" rung), bit-identical to the scan; it raises
    RuntimeError where the library is unavailable, as the reference does;
  * "auto": "jax".  The reference's "auto" sends batches of at most
    NATIVE_CUTOVER_ROWS rows to its native packer; the two give the same
    slots bit for bit, and the port keeps those batches on K7.

`decode_assignment` turns the slot arrays into NodeDecisions.  The
constants and dataclasses below are shared with the class-granular solve
and the consolidation sweep.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..api.resources import ResourceList
from ..utils import tracing
from .tensorize import LaunchOption, Problem, pad_to

NO_ASSIGNMENT = -1

# Cap on new-node scores (price × ceil(tail/m)): large-but-finite prices
# times a big tail overflow float32 to +inf, which an argmin over all-inf
# scores resolves to index 0 — possibly an incompatible option.  Clamping
# keeps overflowed candidates comparable (ties break to the lower,
# cheaper-sorted index) and matches the reference's clamp bit for bit
# (the CUDA scan uses the same float32 constant).
SCORE_CAP = 3.38e38  # just under float32 max (3.4028e38)


@dataclass
class NodeDecision:
    """One node to launch: the chosen option plus the pods packed onto it.
    The flexible `alternatives` list (instance types the packed pods are
    jointly compatible with, price-ordered) is what feeds CreateFleet-style
    flexible launches (karpenter:pkg/providers/instance/instance.go:88-105)."""
    option: LaunchOption
    pod_indices: List[int]
    used: "ResourceList" = None   # canonical units (bytes/millicores)
    alternatives: List[LaunchOption] = field(default_factory=list)


@dataclass
class PackingResult:
    nodes: List[NodeDecision]
    unschedulable: List[int]            # original pod indices
    existing_assignments: Dict[int, int]  # pod index -> pre-opened slot id
    total_price: float

    @property
    def scheduled_count(self) -> int:
        return (sum(len(n.pod_indices) for n in self.nodes)
                + len(self.existing_assignments))

    def strip_pods(self, pod_indices, pods=None) -> None:
        """Remove pods from the plan in place: they leave their node
        decisions / existing slots and land in `unschedulable`.  Decisions
        left empty are dropped (their node is never launched) and
        `total_price` re-sums over the survivors.  This is how gang
        enforcement (ops/gang.py) takes a rejected gang out of the plan
        wholesale — no partial bind ever reaches claim_requests.  `pods`
        (the Problem's pod list) lets per-decision `used` shrink with the
        departures so downstream claim sizing stays honest."""
        drop = {int(i) for i in pod_indices}
        if not drop:
            return
        kept = []
        for dec in self.nodes:
            removed = [i for i in dec.pod_indices if int(i) in drop]
            if removed:
                dec.pod_indices = [i for i in dec.pod_indices
                                   if int(i) not in drop]
                if dec.used is not None and pods is not None:
                    for i in removed:
                        dec.used = dec.used - pods[i].requests
                    dec.used = dec.used.clamp_nonnegative()
            if dec.pod_indices:
                kept.append(dec)
        self.nodes = kept
        for i in [i for i in self.existing_assignments if int(i) in drop]:
            del self.existing_assignments[i]
        self.unschedulable = sorted(
            {int(i) for i in self.unschedulable} | drop)
        self.total_price = float(sum(d.option.price for d in self.nodes))


@dataclass
class SweepResult:
    """Aggregate verdicts for B masked sub-problems solved in one (or a few
    bucket-padded) device calls — the batched consolidation sweep's output.
    Row b answers the b-th probe exactly as a decode=False PackingResult
    would: could the probe's pods land on the unmasked columns, how many
    NEW nodes would launch, and at what launch cost."""
    total_price: np.ndarray     # B float32 — price of newly-launched nodes
    new_nodes: np.ndarray       # B int32  — nodes launched (existing excluded)
    unschedulable: np.ndarray   # B int32  — pods left unplaced
    device_calls: int = 1       # padded kernel invocations this sweep took

    def feasible_delete(self, b: int) -> bool:
        """The delete-probe contract: every pod lands on survivors alone."""
        return (int(self.unschedulable[b]) == 0
                and int(self.new_nodes[b]) == 0)


# below this many rows the reference's native C++ packer beats a device
# launch; `Provisioner._pick_solver` sends such batches to `solve_ffd`
NATIVE_CUTOVER_ROWS = 256


def ffd_pack_numpy(requests: np.ndarray,     # P×R float32, FFD-sorted
                   compat: np.ndarray,       # P×(O+E) bool
                   class_ids: np.ndarray,    # P int32
                   row_caps: np.ndarray,     # P int32
                   rem: np.ndarray,          # P int32
                   alloc: np.ndarray,        # (O+E)×R float32
                   price: np.ndarray,        # O+E float32, existing = inf
                   rank: np.ndarray,         # O+E int32
                   init_option: np.ndarray,  # K int32
                   init_used: np.ndarray,    # K×R float32
                   K: int):
    """Pure-NumPy mirror of the scan (K7 `ffd_scan`) on UNPADDED arrays — the
    degradation ladder's guaranteed-terminating greedy bottom rung
    (ops/health.py): no device, no compile, no C extension, one bounded
    Python loop.  Semantics (first-fit slot choice, tail-aware new-node
    score, float32 arithmetic and the SCORE_CAP clamp) track the scan
    step exactly so plans stay backend-comparable."""
    P, _ = requests.shape
    IBIG = np.int32(2**30)
    f32 = np.float32
    slot_option = init_option.astype(np.int32).copy()
    slot_used = init_used.astype(f32).copy()
    slot_cls = np.zeros(K, np.int32)
    prev_cid = None
    n_open = int((slot_option >= 0).sum())
    assignment = np.full(P, NO_ASSIGNMENT, np.int32)
    for i in range(P):
        req = requests[i]
        comp = compat[i]
        cid = int(class_ids[i])
        cap = int(row_caps[i])
        if cid != prev_cid:
            slot_cls[:] = 0
        prev_cid = cid
        opt = np.maximum(slot_option, 0)
        fits = ((slot_option >= 0) & comp[opt] & (slot_cls < cap)
                & np.all(slot_used + req <= alloc[opt], axis=-1))
        if fits.any():
            k = int(np.argmax(fits))
        else:
            new_ok = comp & np.all(req <= alloc, axis=-1) & np.isfinite(price)
            if not new_ok.any() or n_open >= K:
                continue  # row stays NO_ASSIGNMENT
            best_rank = np.min(np.where(new_ok, rank, IBIG))
            new_ok_r = new_ok & (rank == best_rank)
            reqpos = req > 0
            safe_req = np.where(reqpos, req, f32(1.0))
            m = np.min(np.where(reqpos[None, :],
                                np.floor(alloc / safe_req[None, :]),
                                f32(2**30)), axis=-1)
            m = np.clip(m, f32(1.0), f32(max(cap, 1)))
            score = np.minimum(
                price * np.ceil(f32(max(int(rem[i]), 1)) / m), f32(SCORE_CAP))
            k = n_open
            slot_option[k] = int(np.argmin(np.where(new_ok_r, score, np.inf)))
            n_open += 1
        slot_used[k] += req
        slot_cls[k] += 1
        assignment[i] = k
    return assignment, slot_option, slot_used, n_open


def rem_in_class(class_ids: np.ndarray) -> np.ndarray:
    """Per row: rows of the row's class still unplaced (itself included) —
    rows are class-contiguous, so this is count-from-the-back.  Feeds the
    tail-aware new-node score of every backend."""
    P = len(class_ids)
    if P == 0:
        return np.zeros(0, np.int32)
    ends = np.nonzero(np.diff(class_ids, append=class_ids[-1] + 1))[0]
    out = np.empty(P, np.int64)
    start = 0
    for e in ends:
        out[start:e + 1] = np.arange(e + 1 - start, 0, -1)
        start = e + 1
    return out.astype(np.int32)


@dataclass
class FFDLowered:
    """A problem expanded to FFD-sorted pod rows and padded for the scan
    (numpy, host): the reference's exact lowering, with the compat matrix
    kept per class (`ccomp`, C × Opad, plus each row's class in `crow_p`)
    for the kernel and per row (`compat`, P × (O+E)) for the decode."""
    req_p: np.ndarray        # Ppad×R f32
    ccomp: np.ndarray        # max(C, 1)×Opad bool (existing columns appended)
    crow_p: np.ndarray       # Ppad int32: each row's compat row
    cid_p: np.ndarray        # Ppad int32 (−2 on padding)
    valid: np.ndarray        # Ppad bool
    cap_p: np.ndarray        # Ppad int32
    rem_p: np.ndarray        # Ppad int32
    alloc_p: np.ndarray      # Opad×R f32
    price_p: np.ndarray      # Opad f32, +inf == not launchable
    rank_p: np.ndarray       # Opad int32
    init_option: np.ndarray  # K int32
    init_used: np.ndarray    # K×R f32
    compat: np.ndarray       # P×(O+E) bool, the decode's
    pod_idx: np.ndarray      # P
    class_ids: np.ndarray    # P
    row_caps: np.ndarray     # P
    alloc: np.ndarray        # (O+E)×R, unpadded
    new_price: np.ndarray    # O+E, unpadded
    rank: np.ndarray         # O+E, unpadded
    K: int
    P: int
    E: int
    O: int


def lower_ffd(problem: Problem,
              max_nodes: Optional[int] = None,
              existing_alloc: Optional[np.ndarray] = None,
              existing_used: Optional[np.ndarray] = None,
              existing_compat: Optional[np.ndarray] = None
              ) -> Optional[FFDLowered]:
    """Expand, sort and pad a problem for the pod-granular scan, step for
    step as the reference's `solve_ffd`; None when there is no column at
    all (no option and no existing node)."""
    E = 0 if existing_alloc is None else len(existing_alloc)
    ec = None
    if E:
        ec = existing_compat if existing_compat is not None else \
            np.ones((problem.num_classes, E), bool)
    requests, compat, pod_idx, class_ids = problem.expand(extra_compat=ec)
    caps = (problem.class_node_cap if problem.class_node_cap is not None
            else np.full(problem.num_classes, 2**30, np.int32))
    row_caps = caps[class_ids] if len(class_ids) else np.zeros(0, np.int32)
    P = len(requests)
    alloc = problem.option_alloc
    price = problem.option_price
    O = alloc.shape[0]
    R = alloc.shape[1]
    if E:
        # one virtual option per existing node, price 0 (sunk cost)
        alloc = np.concatenate([alloc, existing_alloc.astype(np.float32)], axis=0)
        price = np.concatenate([price, np.zeros(E, np.float32)])
    if alloc.shape[0] == 0:
        return None
    K = max_nodes if max_nodes is not None else 4096
    K = min(K, pad_to(P + E, (256, 1024, 4096)))
    K = max(K, E + 1)

    rank = np.zeros(alloc.shape[0], np.int32)
    rank[:O] = problem.option_rank
    new_price = price.copy()
    if E:
        new_price[O:] = np.inf  # existing nodes can't be "launched" again

    init_option = np.full(K, -1, np.int32)
    init_used = np.zeros((K, R), np.float32)
    if E:
        init_option[:E] = np.arange(O, O + E, dtype=np.int32)
        init_used[:E] = existing_used.astype(np.float32) \
            if existing_used is not None else 0.0

    # the reference's padding of both the pod axis and the option axis
    Ppad = pad_to(P)
    Opad = pad_to(alloc.shape[0], (512, 2048, 4096, 8192, 32768))
    req_p = np.zeros((Ppad, R), np.float32)
    req_p[:P] = requests
    valid = np.zeros(Ppad, bool)
    valid[:P] = True
    cid_p = np.full(Ppad, -2, np.int32)   # padded rows: no real class
    cid_p[:P] = class_ids
    cap_p = np.full(Ppad, 2**30, np.int32)
    cap_p[:P] = row_caps
    rem_p = np.zeros(Ppad, np.int32)
    rem_p[:P] = rem_in_class(class_ids)
    alloc_p = np.zeros((Opad, R), np.float32)
    alloc_p[:alloc.shape[0]] = alloc
    price_p = np.full(Opad, np.inf, np.float32)
    price_p[:alloc.shape[0]] = new_price
    rank_p = np.full(Opad, 2**30, np.int32)
    rank_p[:alloc.shape[0]] = rank
    # compat per CLASS (the rows of a class share it), with the E existing
    # columns appended: the kernel indexes it by each row's class, so the
    # P × Opad matrix never reaches the card; padded rows point at class 0
    # and place nothing
    ccomp = np.zeros((max(problem.num_classes, 1), Opad), bool)
    ccomp[:problem.num_classes, :O] = problem.class_compat
    if E:
        ccomp[:problem.num_classes, O:O + E] = ec
    crow_p = np.zeros(Ppad, np.int32)
    crow_p[:P] = class_ids
    return FFDLowered(req_p, ccomp, crow_p, cid_p, valid, cap_p, rem_p,
                      alloc_p, price_p, rank_p, init_option, init_used,
                      compat, pod_idx, class_ids, row_caps, alloc, new_price,
                      rank, K, P, E, O)


def ffd_device_args(low: FFDLowered, dev) -> tuple:
    """The lowered arrays on `dev`, in `ffd_scan`'s argument order (without
    max_nodes)."""
    import torch

    def up(a):
        return torch.tensor(np.ascontiguousarray(a), device=dev)

    return (up(low.req_p), up(np.packbits(low.ccomp, axis=1)),
            up(low.crow_p), up(low.cid_p), up(low.valid), up(low.cap_p),
            up(low.rem_p), up(low.alloc_p), up(low.price_p), up(low.rank_p),
            up(low.init_option), up(low.init_used))


def solve_ffd(problem: Problem,
              max_nodes: Optional[int] = None,
              existing_alloc: Optional[np.ndarray] = None,   # E×R
              existing_used: Optional[np.ndarray] = None,    # E×R
              existing_compat: Optional[np.ndarray] = None,  # C×E bool
              max_alternatives: int = 60,
              backend: str = "auto",
              device="cuda") -> PackingResult:
    """Host wrapper: expand classes → pad → scan → decode decisions.

    Existing cluster nodes enter as pre-opened slots with price already
    paid: their allocatable/used vectors are appended as virtual options
    that can never be launched again.  The signature is the reference's
    plus `device` ("cuda" by default; "cpu" runs the kernel's plain
    version).  `backend` "jax" (the scan), "native" (the C++ packer on
    the host), "numpy" (the host greedy rung) or "auto" (the scan)."""
    if backend not in ("auto", "jax", "native", "numpy"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "native":
        from .. import native
        tracing.annotate(backend="native", device_calls=0)
        return native.solve_ffd_native(
            problem, max_nodes=max_nodes, existing_alloc=existing_alloc,
            existing_used=existing_used, existing_compat=existing_compat,
            max_alternatives=max_alternatives)
    # the reference's label and count for its scan (K7 here); the host
    # greedy rung re-annotates below
    tracing.annotate(backend="jax", device_calls=1)
    low = lower_ffd(problem, max_nodes, existing_alloc, existing_used,
                    existing_compat)
    if low is None:  # no options and no existing nodes
        pod_idx = problem.expand()[2]
        return PackingResult(nodes=[], unschedulable=[int(i) for i in pod_idx],
                             existing_assignments={}, total_price=0.0)
    if backend == "numpy":
        tracing.annotate(backend="numpy", device_calls=0)
        assignment, slot_option, slot_used, _ = ffd_pack_numpy(
            low.req_p[:low.P], low.compat, low.class_ids.astype(np.int32),
            low.row_caps, low.rem_p[:low.P], low.alloc.astype(np.float32),
            low.new_price.astype(np.float32), low.rank, low.init_option,
            low.init_used, low.K)
    else:
        from .classpack import resolve_device
        from .ffd_kernels import ffd_scan
        dev = resolve_device(device)
        assignment, slot_option, slot_used, _ = ffd_scan(
            *ffd_device_args(low, dev), low.K)
        assignment = assignment.cpu().numpy()[:low.P]
        slot_option = slot_option.cpu().numpy()
        slot_used = slot_used.cpu().numpy()
    return decode_assignment(problem, assignment, slot_option, slot_used,
                             low.pod_idx, low.compat, low.E, low.O,
                             max_alternatives)


def decode_assignment(problem: Problem, assignment: np.ndarray,
                      slot_option: np.ndarray, slot_used: np.ndarray,
                      pod_idx: np.ndarray, compat: np.ndarray,
                      E: int, O: int, max_alternatives: int = 60
                      ) -> PackingResult:
    """Slot arrays → NodeDecisions (shared by every backend, which produce
    identical slot layouts)."""
    slot_pods: Dict[int, List[int]] = {}
    slot_rows: Dict[int, List[int]] = {}
    unschedulable: List[int] = []
    existing_assignments: Dict[int, int] = {}
    for row, k in enumerate(assignment):
        orig = int(pod_idx[row])
        if k == NO_ASSIGNMENT:
            unschedulable.append(orig)
        elif k < E:
            existing_assignments[orig] = int(k)
        else:
            slot_pods.setdefault(int(k), []).append(orig)
            slot_rows.setdefault(int(k), []).append(row)

    nodes: List[NodeDecision] = []
    total = 0.0
    for k, pods_on_node in sorted(slot_pods.items()):
        oi = int(slot_option[k])
        if oi < 0 or oi >= O:
            continue
        option = problem.options[oi]
        total += option.price
        # joint-compat alternatives for flexible launch — same pool only
        # (a NodeClaim belongs to exactly one NodePool)
        rows = slot_rows.get(k, [])
        joint = compat[rows][:, :O].all(axis=0) if rows else np.zeros(O, bool)
        used_vec = slot_used[k]
        cap_ok = (problem.option_alloc >= used_vec).all(axis=1)
        same_pool = np.asarray([o.pool == option.pool for o in problem.options])
        alt_ids = np.nonzero(joint & cap_ok & same_pool)[0][:max_alternatives]
        nodes.append(NodeDecision(
            option=option,
            pod_indices=pods_on_node,
            used=ResourceList.from_vector(used_vec, problem.axes, problem.scales),
            alternatives=[problem.options[a] for a in alt_ids],
        ))
    return PackingResult(nodes=nodes, unschedulable=unschedulable,
                         existing_assignments=existing_assignments,
                         total_price=total)
