"""Class-granular packing on the card: one scan step per pod *equivalence
class*.

The port of the JAX package's `ops/classpack.py` for `guide=None`: identical
pods are interchangeable, so a batch of 50k pods collapses to a few hundred
classes and each scan step places an entire class —

  * existing/open slots absorb `min(count, floor(free/req))` pods each, an
    exclusive-prefix greedy fill that is exactly first-fit for identical
    pods;
  * overflow opens `ceil(rem/m)` new nodes of the option minimizing
    price × nodes needed.

The device programs are five hand-written CUDA kernels
(ops/classpack_kernels.py, csrc/classpack.cu); the functions named like the
JAX package's jit'd programs below compose them the same way, so each can be
held against its counterpart.  `solve_classpack_sweep` is the consolidation
sweep's host wrapper: B masked aggregate solves in one K1 + K5 call.  Host lowering (sort, pad, bucket) and host
decode (rows → NodeDecisions with flexible alternatives) are copies of the
reference's.  All arithmetic is int32 in scaled units (millicores / MiB /
counts), so feasibility math is exact.

`solve_classpack`'s default `guide="lp"` routes a fresh decoded solve to the
LP-guided path (ops/lpguide.py, with its off-tick `refinery` and the
`device_lp` PDHG master of ops/lpsolve.py), as the reference does.  With
`device_decode` (the DeviceDecode gate) a batch of at least
ops/decode.DEVICE_DECODE_FLOOR pods takes the slab programs
(`class_pack_assign_slab_kernel[_fresh]`: K1-K3, then K6 sorts the pod rows
by slot on the card) and the host assembles the plan with column
operations (ops/decode.py).
"""

from __future__ import annotations

import hashlib
import logging
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .._build import KernelError
from ..api.resources import ResourceList
from .classpack_kernels import (classpack_aggregate, classpack_assign_decode,
                                classpack_precompute, classpack_scan,
                                classpack_slab, classpack_sweep, pack_bits)
from .ffd import NodeDecision, PackingResult, SweepResult
from .tensorize import Problem, pad_to
from ..utils import metrics, tracing

log = logging.getLogger("karpenter_tpu_torch.classpack")

# one lock for all module caches: check-then-insert must be atomic or
# concurrent misses overshoot the size caps
_CACHE_LOCK = threading.Lock()

# faults of the card or of a kernel: raised past every fallback (the
# provisioning ladder, the partitioned driver's single-device escape),
# since each would answer them with work elsewhere
DEVICE_FAULTS = tuple(t for t in (KernelError,
                                  getattr(torch, "AcceleratorError", None),
                                  torch.cuda.OutOfMemoryError)
                      if t is not None)


# ---------------------------------------------------------------------------
# The JAX package's device programs, composed from the kernels
# ---------------------------------------------------------------------------

def class_pack_kernel_packed(requests, counts, compat_packed, node_cap,
                             alloc, price, rank, init_option, init_used,
                             max_nodes: int, emit_takes: bool = False):
    """class_pack_kernel on a bit-packed compat matrix (uint8, np.packbits
    along options): K1 precompute, then the K2 scan.  init_option /
    init_used None == all slots closed (the `_fresh` programs)."""
    m_all, ok_all = classpack_precompute(requests, node_cap, compat_packed,
                                         alloc, price, rank)
    return classpack_scan(requests, counts, compat_packed, node_cap, alloc,
                          price, m_all, ok_all, init_option, init_used,
                          max_nodes, emit_takes)


def class_pack_kernel(requests, counts, compat, node_cap, alloc, price, rank,
                      init_option, init_used, max_nodes: int,
                      emit_takes: bool = False):
    """Returns (slot_option K, slot_used K×R, n_open, n_unsched, takes)."""
    return class_pack_kernel_packed(requests, counts, pack_bits(compat),
                                    node_cap, alloc, price, rank, init_option,
                                    init_used, max_nodes, emit_takes)


def class_pack_aggregate_kernel_packed(requests, counts, compat_packed,
                                       node_cap, alloc, price, rank,
                                       init_option, init_used,
                                       max_nodes: int):
    """Pack and reduce to one float32 vector [total_cost, n_open, n_unsched,
    nodes_per_option…] on the card (K1, K2, K4)."""
    slot_option, _, n_open, n_unsched, _ = class_pack_kernel_packed(
        requests, counts, compat_packed, node_cap, alloc, price, rank,
        init_option, init_used, max_nodes, False)
    return classpack_aggregate(slot_option, price, n_open, n_unsched)


def class_pack_aggregate_kernel(requests, counts, compat, node_cap, alloc,
                                price, rank, init_option, init_used,
                                max_nodes: int):
    return class_pack_aggregate_kernel_packed(
        requests, counts, pack_bits(compat), node_cap, alloc, price, rank,
        init_option, init_used, max_nodes)


def class_pack_aggregate_kernel_fresh(requests, counts, compat_packed,
                                      node_cap, alloc, price, rank,
                                      max_nodes: int):
    """Aggregate solve with no pre-opened slots (state built in-kernel)."""
    return class_pack_aggregate_kernel_packed(
        requests, counts, compat_packed, node_cap, alloc, price, rank,
        None, None, max_nodes)


def class_pack_assign_kernel(requests, counts, compat_packed, node_cap,
                             alloc, price, rank, init_option, init_used,
                             max_nodes: int, n_pods: int):
    """Pack and decode POD→SLOT on the card (K1, K2 emitting takes, K3).
    Returns (assignment n_pods int16/int32, slot_option K, n_unsched)."""
    slot_option, _, _, n_unsched, takes = class_pack_kernel_packed(
        requests, counts, compat_packed, node_cap, alloc, price, rank,
        init_option, init_used, max_nodes, True)
    return (classpack_assign_decode(takes, counts, n_pods), slot_option,
            n_unsched)


def class_pack_assign_kernel_fresh(requests, counts, compat_packed, node_cap,
                                   alloc, price, rank, max_nodes: int,
                                   n_pods: int):
    return class_pack_assign_kernel(requests, counts, compat_packed,
                                    node_cap, alloc, price, rank, None, None,
                                    max_nodes, n_pods)


def class_pack_assign_slab_kernel(requests, counts, compat_packed, node_cap,
                                  alloc, price, rank, init_option, init_used,
                                  max_nodes: int, n_pods: int):
    """The assign program plus the on-card SLAB the columnar decode
    consumes (K1, K2, K3, then K6): row ids stable-sorted by slot
    (`order`, unplaced and padded rows last under key K, the real
    unplaced rows ahead of the padding), rows per slot (`slot_counts`) and
    the slot→option column.  Returns (order n_pods int32, slot_counts K
    int32, slot_option K, n_unsched)."""
    assignment, slot_option, n_unsched = class_pack_assign_kernel(
        requests, counts, compat_packed, node_cap, alloc, price, rank,
        init_option, init_used, max_nodes, n_pods)
    order, slot_counts = classpack_slab(assignment, max_nodes)
    return order, slot_counts, slot_option, n_unsched


def class_pack_assign_slab_kernel_fresh(requests, counts, compat_packed,
                                        node_cap, alloc, price, rank,
                                        max_nodes: int, n_pods: int):
    return class_pack_assign_slab_kernel(requests, counts, compat_packed,
                                         node_cap, alloc, price, rank, None,
                                         None, max_nodes, n_pods)


def class_pack_sweep_kernel_packed(requests, counts_b, compat_packed,
                                   node_cap, alloc, price, rank,
                                   col_mask_packed, price_cap_b, init_option,
                                   init_used, max_nodes: int):
    """class_pack_sweep_kernel on bit-packed column masks (uint8 B×Opad/8):
    ONE unbatched K1 for the shared m_all (m only: each row's launchable
    options are K5's own, masked by the row's columns and price cap), then
    K5 over the B rows."""
    m_all, _ = classpack_precompute(requests, node_cap, compat_packed, alloc,
                                    price, rank, with_ok=False)
    return classpack_sweep(requests, counts_b, compat_packed, node_cap, alloc,
                           price, rank, col_mask_packed, price_cap_b,
                           init_option, init_used, m_all, max_nodes)


def class_pack_sweep_kernel(requests, counts_b, compat_packed, node_cap,
                            alloc, price, rank, col_mask_b, price_cap_b,
                            init_option, init_used, max_nodes: int):
    """B masked aggregate solves in one device call — the consolidation
    sweep's program.  Shared: the padded class arrays, the column catalog
    (options + existing-node columns) and the pre-opened slot state.  Per
    row: `counts_b` (which classes the probe reschedules), `col_mask_b`
    (bool, False == the column is gone) and `price_cap_b` (options priced
    >= cap are unlaunchable).  Returns float32 B×3 [total_cost, n_new,
    n_unsched], n_new counting launched slots, never pre-opened ones."""
    return class_pack_sweep_kernel_packed(
        requests, counts_b, compat_packed, node_cap, alloc, price, rank,
        pack_bits(col_mask_b), price_cap_b, init_option, init_used,
        max_nodes)


# batch-axis padding buckets for the sweep, and the reference's memory
# guard on its vmapped B×Cpad×Opad ok mask (~256M elements per call).  The
# kernels never build that mask, but the chunking is kept exactly: the
# number of device calls is observable (SweepResult.device_calls)
_SWEEP_B_BUCKETS = (8, 32, 128, 512)
_SWEEP_MASK_BUDGET = 1 << 28


# ---------------------------------------------------------------------------
# Device placement and content-keyed device caches
# ---------------------------------------------------------------------------

def resolve_device(device) -> torch.device:
    """The solve's device.  CUDA is the default; without a card that is an
    error — the solve never moves itself to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise KernelError(
            "karpenter_tpu_torch solves on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a), device=dev)


# device-resident catalog cache: (content fingerprint, device) → tensors.
# The catalog side (alloc/price/rank) changes only on ICE/pricing seq bumps,
# so consecutive solves reuse the same device buffers instead of re-uploading.
_CATALOG_CACHE: dict = {}
_CATALOG_CACHE_MAX = 8

# device-resident pod-side cache: content hash of the padded class arrays →
# uploaded tensors.  Re-solves over an unchanged pending set skip the
# host→device transfer entirely.
_PODSIDE_CACHE: dict = {}
_PODSIDE_CACHE_MAX = 8


def _cached(cache: dict, cap: int, key, arrays, dev: torch.device,
            name: str):
    """The cached upload of `arrays`; the hit or miss is annotated on the
    active span as `<name>_cache`, as the reference does."""
    hit = cache.get(key)
    if hit is not None:
        tracing.annotate(**{f"{name}_cache": "hit"})
        return hit
    tracing.annotate(**{f"{name}_cache": "miss"})
    val = tuple(_upload(a, dev) for a in arrays)
    with _CACHE_LOCK:
        while len(cache) >= cap:
            cache.pop(next(iter(cache)), None)
        cache[key] = val
    return val


def _device_podside(req_p: np.ndarray, cnt_p: np.ndarray,
                    packed: np.ndarray, cap_p: np.ndarray,
                    dev: torch.device):
    key = (str(dev), req_p.shape, packed.shape,
           hashlib.blake2b(req_p.tobytes() + cnt_p.tobytes()
                           + packed.tobytes() + cap_p.tobytes(),
                           digest_size=16).digest())
    return _cached(_PODSIDE_CACHE, _PODSIDE_CACHE_MAX, key,
                   (req_p, cnt_p, packed, cap_p), dev, "podside")


def _device_catalog(alloc: np.ndarray, price: np.ndarray, rank: np.ndarray,
                    dev: torch.device):
    key = (str(dev), alloc.shape, price.shape, rank.shape,
           hashlib.blake2b(
               alloc.tobytes() + price.tobytes() + rank.tobytes(),
               digest_size=16).digest())
    return _cached(_CATALOG_CACHE, _CATALOG_CACHE_MAX, key,
                   (alloc, price, rank), dev, "catalog")


# cross-solve alternatives memo.  A node's flexible-alternative list depends
# only on (catalog columns, joint class compat, pool, usage vector) — all
# content below is keyed by content, never by class *indices* (which are
# batch-specific), so hits are exact across different pod batches.  The
# outer key pins the catalog identity via the option_alloc/options object
# pair (kept as a strong ref so ids can't be recycled while the entry
# lives); the catalog-side cache in ops/tensorize.py already dedups equal
# catalogs to one object, so object identity == content identity here.
_ALT_MEMO: dict = {}
_ALT_MEMO_MAX_CATALOGS = 4
_ALT_MEMO_MAX_ENTRIES = 65536


def _alt_memo_for(problem: Problem) -> dict:
    key = id(problem.options)
    hit = _ALT_MEMO.get(key)
    if hit is not None and hit[0] is problem.options:
        if len(hit[1]) > _ALT_MEMO_MAX_ENTRIES:
            hit[1].clear()
        return hit[1]
    with _CACHE_LOCK:
        hit = _ALT_MEMO.get(key)
        if hit is not None and hit[0] is problem.options:
            return hit[1]
        while len(_ALT_MEMO) >= _ALT_MEMO_MAX_CATALOGS:
            _ALT_MEMO.pop(next(iter(_ALT_MEMO)), None)
        entries: dict = {}
        _ALT_MEMO[key] = (problem.options, entries)
        return entries


def _sorted_classes(problem: Problem, extra_compat: Optional[np.ndarray]):
    """FFD order over classes via Problem.class_order() — the shared key, so
    class-granular and pod-granular solves agree on ordering."""
    order = problem.class_order()
    compat = problem.class_compat[order]
    if extra_compat is not None:
        compat = np.concatenate([compat, extra_compat[order]], axis=1)
    caps = (problem.class_node_cap if problem.class_node_cap is not None
            else np.full(problem.num_classes, 2**30, np.int32))
    return (problem.class_requests[order], problem.class_counts[order],
            compat, caps[order], order)


@dataclass
class Lowered:
    """A problem sorted, padded and bucketed for the kernels (numpy, host):
    the reference's exact lowering."""
    req_p: np.ndarray        # Cpad×R int32
    cnt_p: np.ndarray        # Cpad int32
    packed: np.ndarray       # Cpad×Opad/8 uint8 (np.packbits of compat)
    cap_p: np.ndarray        # Cpad int32
    alloc_i: np.ndarray      # Opad×R int32 (truncated)
    price_p: np.ndarray      # Opad f32, +inf == not launchable
    rank_p: np.ndarray       # Opad int32
    init_option: Optional[np.ndarray]   # K int32, None when E == 0
    init_used: Optional[np.ndarray]     # K×R int32, None when E == 0
    order: np.ndarray        # sorted class order
    C: int
    O: int
    E: int
    P: int
    K: int
    Ppad: int


def lower_problem(problem: Problem, max_nodes: int = 8192,
                  existing_alloc: Optional[np.ndarray] = None,
                  existing_used: Optional[np.ndarray] = None,
                  existing_compat: Optional[np.ndarray] = None
                  ) -> Optional[Lowered]:
    """Sort classes, append the E existing-node columns, pad and bucket —
    the reference solve's host lowering, step for step.  None when there
    is no column at all (no option and no existing node)."""
    E = 0 if existing_alloc is None else len(existing_alloc)
    ec = None
    if E:
        ec = existing_compat if existing_compat is not None else \
            np.ones((problem.num_classes, E), bool)
    requests, counts, compat, caps, order = _sorted_classes(problem, ec)
    C, R = requests.shape
    alloc = problem.option_alloc
    price = problem.option_price.astype(np.float32)
    O = alloc.shape[0]
    if E:
        alloc = np.concatenate([alloc, existing_alloc.astype(np.float32)], axis=0)
        price = np.concatenate([price, np.full(E, np.inf, np.float32)])
    if alloc.shape[0] == 0:
        return None
    rank = np.zeros(alloc.shape[0], np.int32)
    rank[:O] = problem.option_rank

    # the reference's buckets: parity needs the same padded shapes
    Cpad = pad_to(C, (64, 256, 1024, 4096))
    Opad = pad_to(alloc.shape[0], (512, 2048, 4096, 8192, 32768))
    req_p = np.zeros((Cpad, R), np.int32)
    req_p[:C] = requests.astype(np.int32)
    cnt_p = np.zeros(Cpad, np.int32)
    cnt_p[:C] = counts
    cap_p = np.full(Cpad, 2**30, np.int32)
    cap_p[:C] = caps
    comp_p = np.zeros((Cpad, Opad), bool)
    comp_p[:C, :alloc.shape[0]] = compat
    alloc_p = np.zeros((Opad, R), np.float32)
    alloc_p[:alloc.shape[0]] = alloc
    price_p = np.full(Opad, np.inf, np.float32)
    price_p[:alloc.shape[0]] = price
    rank_p = np.full(Opad, 2**30 - 1, np.int32)
    rank_p[:alloc.shape[0]] = rank

    # slot count: never more nodes than pods; bucketed like the reference
    P = int(problem.class_counts.sum())
    K = max(min(max_nodes, pad_to(P + E, (256, 1024, 8192))), E + 1)
    init_option = init_used = None
    if E:
        init_option = np.full(K, -1, np.int32)
        init_used = np.zeros((K, R), np.int32)
        init_option[:E] = np.arange(O, O + E, dtype=np.int32)
        if existing_used is not None:
            init_used[:E] = np.ceil(existing_used).astype(np.int32)
    # int32 lowering TRUNCATES fractional allocatable, as the reference does
    return Lowered(req_p, cnt_p, np.packbits(comp_p, axis=1), cap_p,
                   alloc_p.astype(np.int32), price_p, rank_p, init_option,
                   init_used, order, C, O, E, P, K, pad_to(P))


def device_args(low: Lowered, dev: torch.device):
    """((requests, counts, compat_packed, node_cap), (alloc, price, rank),
    (init_option, init_used)) on `dev`.  With no existing nodes the catalog
    and pod sides come from the content-keyed device caches and the init
    state is (None, None): the kernels build the all-closed state
    themselves.  Existing-node columns embed per-solve cluster state, so
    those solves upload directly and leave the caches alone."""
    if low.E == 0:
        # the catalog side first, as the reference looks its caches up
        cat = _device_catalog(low.alloc_i, low.price_p, low.rank_p, dev)
        return (_device_podside(low.req_p, low.cnt_p, low.packed, low.cap_p,
                                dev), cat, (None, None))
    return (tuple(_upload(a, dev) for a in (low.req_p, low.cnt_p, low.packed,
                                            low.cap_p)),
            tuple(_upload(a, dev) for a in (low.alloc_i, low.price_p,
                                            low.rank_p)),
            (_upload(low.init_option, dev), _upload(low.init_used, dev)))


def solve_classpack(problem: Problem,
                    max_nodes: int = 8192,
                    existing_alloc: Optional[np.ndarray] = None,
                    existing_used: Optional[np.ndarray] = None,
                    existing_compat: Optional[np.ndarray] = None,
                    decode: bool = True,
                    max_alternatives: int = 60,
                    guide: Optional[str] = "lp",
                    refinery=None,
                    device_decode: bool = False,
                    decode_health=None,
                    device_lp: bool = False,
                    lp_health=None,
                    device="cuda") -> PackingResult:
    """Host wrapper: sort classes → pad → kernels → decode.

    The signature is the reference's, plus `device` ("cuda" by default; the
    CPU runs the kernels' plain versions and only when asked for).  With
    decode=False only aggregate state leaves the device (node count per
    option + total price, no per-pod binding).  Existing nodes enter as E
    pre-opened columns with +inf price (never launched).

    guide="lp" (the default) on a fresh decoded solve runs the LP-guided
    path (ops/lpguide.solve_guided, with `refinery`, `device_lp` and
    `lp_health` passed on); when the guide does not apply it returns None
    and the greedy kernels below solve.  With E > 0 or decode=False the
    guide is skipped, as in the reference.

    device_decode=True (the `DeviceDecode` gate) routes decoded batches of
    at least ops/decode.DEVICE_DECODE_FLOOR pods through the slab programs:
    the pod→slot sort runs on the card (K6) and the host assembles the
    plan with column operations (ops/decode.assemble_slab_single) —
    identical output.  A slab-assembly failure rebuilds the legacy
    assignment vector from the slab (no second kernel launch), decodes it
    the legacy way and reports to `decode_health` (ops/decode.DecodeHealth),
    whose demotion keeps the next solves on the legacy decode."""
    dev = resolve_device(device)
    E = 0 if existing_alloc is None else len(existing_alloc)
    if guide == "lp" and E == 0 and decode:
        from .lpguide import solve_guided
        res = solve_guided(problem, max_alternatives=max_alternatives,
                           max_nodes=max_nodes, refinery=refinery,
                           device_lp=device_lp, lp_health=lp_health,
                           device=dev)
        if res is not None:
            return res
    low = lower_problem(problem, max_nodes, existing_alloc, existing_used,
                        existing_compat)
    if low is None:  # no options and no existing nodes
        return PackingResult(
            nodes=[], unschedulable=[int(p) for m in problem.class_members
                                     for p in m],
            existing_assignments={}, total_price=0.0)
    O, K = low.O, low.K
    # the pad buckets, and the device programs this solve dispatches (the
    # reference's one scan program; K1 + K2 + K3 or K4 here)
    tracing.annotate(device_calls=1, pad_classes=low.req_p.shape[0],
                     pad_options=low.price_p.shape[0], slots=K)
    pod_args, cat_args, init = device_args(low, dev)

    if not decode:
        # aggregate path: ONE device→host transfer of the launch plan
        flat = class_pack_aggregate_kernel_packed(
            *pod_args, *cat_args, *init, K).cpu().numpy()
        total, n_unsched = float(flat[0]), int(flat[2])
        nodes_per_option = flat[3:3 + O].astype(np.int64)
        nodes = [NodeDecision(option=problem.options[oi], pod_indices=[])
                 for oi in np.repeat(np.arange(O), nodes_per_option)]
        return PackingResult(nodes=nodes, unschedulable=[None] * n_unsched,
                             existing_assignments={}, total_price=total)

    from . import decode as decode_mod
    use_slab = bool(device_decode) and low.P >= decode_mod.DEVICE_DECODE_FLOOR
    if use_slab and decode_health is not None and not decode_health.allow():
        use_slab = False
        metrics.decode_solves().inc({"path": "classpack",
                                     "outcome": "suppressed"})
    elif device_decode and not use_slab:
        metrics.decode_solves().inc({"path": "classpack", "outcome": "floor"})

    # the launches and the blocking device→host copies: the span closes only
    # once the card's work has landed on the host
    with tracing.span("solve.kernel"):
        if use_slab:
            order_idx, slot_counts, slot_option, _ = \
                class_pack_assign_slab_kernel(*pod_args, *cat_args, *init, K,
                                              low.Ppad)
            order_idx = order_idx.cpu().numpy()
            slot_counts = slot_counts.cpu().numpy()
        else:
            assignment, slot_option, _ = class_pack_assign_kernel(
                *pod_args, *cat_args, *init, K, low.Ppad)
            assignment = assignment.cpu().numpy()
        slot_option = slot_option.cpu().numpy()
    # everything below is host-side decode: rows -> NodeDecisions
    with tracing.span("solve.decode"):
        if not use_slab:
            return decode_plan(problem, low, assignment, slot_option,
                               max_alternatives)
        pod_idx, class_of_row = _rows(problem, low)
        try:
            res = decode_mod.assemble_slab_single(
                problem, order_idx, slot_counts, slot_option, pod_idx,
                class_of_row, E, K, max_alternatives, low.P)
        except Exception:
            log.exception("slab decode failed; host assembly fallback")
            metrics.decode_solves().inc({"path": "classpack",
                                         "outcome": "fallback"})
            if decode_health is not None:
                decode_health.report_failure("error")
            # the kernel output is still good: rebuild the legacy assignment
            # vector from the slab, no second launch
            assignment = decode_mod.slab_to_assignment(order_idx, slot_counts,
                                                       low.Ppad, K)
            return decode_plan(problem, low, assignment, slot_option,
                               max_alternatives)
        metrics.decode_solves().inc({"path": "classpack", "outcome": "device"})
        if decode_health is not None:
            decode_health.report_success()
        return res


@dataclass
class SweepLowered:
    """A sweep's sub-problems sorted, padded and bucketed for K1 + K5
    (numpy, host): the reference's exact sweep lowering."""
    req_p: np.ndarray        # Cpad×R int32
    packed: np.ndarray       # Cpad×Opad/8 uint8
    cap_p: np.ndarray        # Cpad int32
    alloc_p: np.ndarray      # Opad×R int32 (truncated)
    price_p: np.ndarray      # Opad f32, +inf == not launchable
    rank_p: np.ndarray       # Opad int32
    init_option: np.ndarray  # K int32 (the E existing columns pre-opened)
    init_used: np.ndarray    # K×R int32
    cnt_p: np.ndarray        # B×Cpad int32
    mask_p: np.ndarray       # B×Opad bool
    caps_b: np.ndarray       # B f32
    K: int
    chunk: int               # rows per device call

    def chunks(self):
        """(start, end, counts, packed column masks, caps) of each device
        call, every one padded to a row bucket."""
        B = self.cnt_p.shape[0]
        for s in range(0, B, self.chunk):
            e = min(s + self.chunk, B)
            Bp = next(b for b in _SWEEP_B_BUCKETS if b >= e - s) \
                if e - s <= _SWEEP_B_BUCKETS[-1] else e - s
            cb = np.zeros((Bp, self.cnt_p.shape[1]), np.int32)
            cb[:e - s] = self.cnt_p[s:e]
            mb = np.zeros((Bp, self.mask_p.shape[1]), bool)
            mb[:e - s] = self.mask_p[s:e]
            pb = np.full(Bp, np.inf, np.float32)
            pb[:e - s] = self.caps_b[s:e]
            yield s, e, cb, np.packbits(mb, axis=1), pb


def lower_sweep(problem: Problem,
                counts_b: np.ndarray,
                existing_alloc: Optional[np.ndarray] = None,
                existing_used: Optional[np.ndarray] = None,
                existing_compat: Optional[np.ndarray] = None,
                exist_mask_b: Optional[np.ndarray] = None,
                price_cap_b: Optional[np.ndarray] = None,
                max_nodes: int = 8192) -> Optional[SweepLowered]:
    """One padding/lowering pass shared by all B sub-problems (arguments as
    `solve_classpack_sweep`); None when there is no column at all."""
    E = 0 if existing_alloc is None else len(existing_alloc)
    ec = None
    if E:
        ec = existing_compat if existing_compat is not None else \
            np.ones((problem.num_classes, E), bool)
    requests, _, compat, caps, order = _sorted_classes(problem, ec)
    counts_b = np.asarray(counts_b, np.int32)[:, order]
    B, C = counts_b.shape
    R = requests.shape[1]

    alloc = problem.option_alloc
    price = problem.option_price.astype(np.float32)
    O = alloc.shape[0]
    if E:
        alloc = np.concatenate([alloc, existing_alloc.astype(np.float32)],
                               axis=0)
        price = np.concatenate([price, np.full(E, np.inf, np.float32)])
    if alloc.shape[0] == 0:
        return None
    rank = np.zeros(alloc.shape[0], np.int32)
    rank[:O] = problem.option_rank

    Cpad = pad_to(C, (64, 256, 1024, 4096))
    Opad = pad_to(alloc.shape[0], (512, 2048, 4096, 8192, 32768))
    req_p = np.zeros((Cpad, R), np.int32)
    req_p[:C] = requests.astype(np.int32)
    cap_p = np.full(Cpad, 2**30, np.int32)
    cap_p[:C] = caps
    comp_p = np.zeros((Cpad, Opad), bool)
    comp_p[:C, :alloc.shape[0]] = compat
    # int32 lowering TRUNCATES fractional allocatable exactly like
    # solve_classpack's astype — ceil here would let the sweep fit a pod
    # the sequential probe rejects
    alloc_p = np.zeros((Opad, R), np.int32)
    alloc_p[:alloc.shape[0]] = alloc.astype(np.int32)
    price_p = np.full(Opad, np.inf, np.float32)
    price_p[:alloc.shape[0]] = price
    rank_p = np.full(Opad, 2**30 - 1, np.int32)
    rank_p[:alloc.shape[0]] = rank

    # K = P + E always suffices: each scan step opens at most one node per
    # remaining pod, so new slots never exceed the row's pod count
    P = int(counts_b.sum(axis=1).max()) if B else 0
    K = max(min(max_nodes,
                pad_to(P + E, (256, 512, 1024, 2048, 4096, 8192))),
            E + 1)
    init_option = np.full(K, -1, np.int32)
    init_used = np.zeros((K, R), np.int32)
    if E:
        init_option[:E] = np.arange(O, O + E, dtype=np.int32)
        if existing_used is not None:
            init_used[:E] = np.ceil(existing_used).astype(np.int32)

    cnt_p = np.zeros((B, Cpad), np.int32)
    cnt_p[:, :C] = counts_b
    mask_p = np.zeros((B, Opad), bool)
    mask_p[:, :alloc.shape[0]] = True
    if E and exist_mask_b is not None:
        mask_p[:, O:O + E] = np.asarray(exist_mask_b, bool)
    caps_b = (np.full(B, np.inf, np.float32) if price_cap_b is None
              else np.asarray(price_cap_b, np.float32))

    chunk = max(_SWEEP_B_BUCKETS[0], _SWEEP_MASK_BUDGET // (Cpad * Opad))
    chunk = next((b for b in _SWEEP_B_BUCKETS if b >= min(chunk, B)),
                 _SWEEP_B_BUCKETS[-1])
    return SweepLowered(req_p, np.packbits(comp_p, axis=1), cap_p, alloc_p,
                        price_p, rank_p, init_option, init_used, cnt_p,
                        mask_p, caps_b, K, chunk)


def sweep_device_args(low: SweepLowered, dev: torch.device):
    """The shared arrays of a lowered sweep on `dev`, in the sweep
    program's order: (requests, compat_packed, node_cap, alloc, price,
    rank, init_option, init_used)."""
    return tuple(_upload(a, dev) for a in (
        low.req_p, low.packed, low.cap_p, low.alloc_p, low.price_p,
        low.rank_p, low.init_option, low.init_used))


def solve_classpack_sweep(problem: Problem,
                          counts_b: np.ndarray,
                          existing_alloc: Optional[np.ndarray] = None,
                          existing_used: Optional[np.ndarray] = None,
                          existing_compat: Optional[np.ndarray] = None,
                          exist_mask_b: Optional[np.ndarray] = None,
                          price_cap_b: Optional[np.ndarray] = None,
                          max_nodes: int = 8192,
                          device="cuda") -> SweepResult:
    """Host wrapper for the batched sweep: one padding/lowering pass shared
    by all B sub-problems, then bucket-padded K1 + K5 calls.

    `counts_b` (B×C, problem class order) gives each sub-problem's pod
    multiset; classes with count 0 are exact no-ops in the scan.
    `exist_mask_b` (B×E bool, False == excluded) masks existing-node
    columns per sub-problem; `price_cap_b` (B float) strictly bounds
    launchable option prices (None/inf == no cap).  Returns a SweepResult
    whose rows match what decode=False solve_classpack calls over the
    same masked sub-problems would report.  The signature is the
    reference's plus `device` ("cuda" by default, "cpu" runs the plain
    versions)."""
    dev = resolve_device(device)
    low = lower_sweep(problem, counts_b, existing_alloc, existing_used,
                      existing_compat, exist_mask_b, price_cap_b, max_nodes)
    B = len(counts_b)
    if low is None:
        per = np.asarray(counts_b, np.int32).sum(axis=1).astype(np.int32)
        return SweepResult(total_price=np.zeros(B, np.float32),
                           new_nodes=np.zeros(B, np.int32),
                           unschedulable=per, device_calls=0)
    req, packed, cap, alloc, price, rank, iopt, iused = \
        sweep_device_args(low, dev)
    cost = np.zeros(B, np.float32)
    n_new = np.zeros(B, np.int32)
    unsched = np.zeros(B, np.int32)
    calls = 0
    for s, e, cb, mb, pb in low.chunks():
        out = class_pack_sweep_kernel_packed(
            req, _upload(cb, dev), packed, cap, alloc, price, rank,
            _upload(mb, dev), _upload(pb, dev), iopt, iused,
            low.K).cpu().numpy()
        calls += 1
        cost[s:e] = out[:e - s, 0]
        n_new[s:e] = np.rint(out[:e - s, 1]).astype(np.int32)
        unsched[s:e] = np.rint(out[:e - s, 2]).astype(np.int32)
    tracing.annotate(device_calls=calls, sweep_rows=B, sweep_chunk=low.chunk)
    return SweepResult(total_price=cost, new_nodes=n_new,
                       unschedulable=unsched, device_calls=calls)


def _rows(problem: Problem, low: Lowered):
    """(pod index, class) of every kernel row: rows follow the sorted-class
    order, members consumed in sequence."""
    C, order = low.C, low.order
    members_arr = problem.members_arrays()
    pod_idx = (np.concatenate([members_arr[ci] for ci in order]) if C else
               np.zeros(0, np.int64))
    class_of_row = np.repeat(np.asarray(order, np.int64),
                             problem.class_counts[order]) if C else \
        np.zeros(0, np.int64)
    return pod_idx, class_of_row


def decode_plan(problem: Problem, low: Lowered, assignment: np.ndarray,
                slot_option: np.ndarray,
                max_alternatives: int = 60) -> PackingResult:
    """Host-side decode of the per-pod slots: rows → NodeDecisions with
    per-node `used` and flexible alternatives (the reference's decode)."""
    O, E, P = low.O, low.E, low.P
    pod_idx, class_of_row = _rows(problem, low)

    assignment = np.asarray(assignment, dtype=np.int32)[:P]
    sched = assignment >= 0
    unschedulable = pod_idx[~sched].tolist()
    ex = sched & (assignment < E)
    existing_assignments = dict(zip(pod_idx[ex].tolist(),
                                    assignment[ex].tolist()))
    new_rows = np.nonzero(sched & (assignment >= E))[0]
    new_rows = new_rows[np.argsort(assignment[new_rows], kind="stable")]
    ks = assignment[new_rows]
    # node boundaries by vectorized edge-detect: rows are slot-sorted, so
    # each node is one contiguous run (np.split's per-group array machinery
    # costs ~15ms at 5k nodes; slicing one pre-built list costs ~nothing)
    starts = np.nonzero(np.diff(ks, prepend=np.int32(-1)))[0]
    ends = np.append(starts[1:], len(ks))
    node_slots = ks[starts] if len(starts) else np.zeros(0, np.int32)

    # per-node resource usage, reconstructed host-side (the decode does not
    # ship the K×R slot_used — one gather + reduceat rebuilds it); values
    # are exact: same integer sums the kernel's alloc-minus-free
    # bookkeeping produces
    if len(starts):
        row_reqs = problem.class_requests[class_of_row[new_rows]]
        node_used = np.add.reduceat(row_reqs, starts, axis=0).astype(np.int64)
    else:
        node_used = np.zeros((0, problem.class_requests.shape[1]), np.int64)

    # one global unique over (slot, class) pairs replaces a per-node
    # np.unique; searchsorted then yields every node's class-set span
    Cn = problem.num_classes
    upq = np.unique(ks.astype(np.int64) * (Cn + 1) + class_of_row[new_rows]) \
        if len(ks) else np.zeros(0, np.int64)
    uslot, ucls = upq // (Cn + 1), upq % (Cn + 1)
    cls_starts = np.searchsorted(uslot, node_slots, side="left")
    cls_ends = np.searchsorted(uslot, node_slots, side="right")

    # hot loop below runs once per node (~5-6k at 50k pods): stage every
    # array it touches as plain Python lists — list indexing/slicing is an
    # order of magnitude cheaper than per-element numpy scalar access
    pod_sorted = pod_idx[new_rows].tolist()
    node_oi = slot_option[node_slots].astype(np.int64)
    # fleet cost: only pod-hosting slots launch.  Demand-driven opens
    # always host ≥1 pod so this matches the old every-open-slot sum; the
    # difference is guided solves, whose pre-opened-but-unfilled slots
    # must not be bought.
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


def resolve_alternatives(problem: Problem, oi_l: Sequence[int],
                         jcb_list: Sequence, node_used: np.ndarray,
                         max_alternatives: int = 60,
                         cls_keys: Optional[Sequence] = None) -> List:
    """Per-node flexible alternatives (and the used ResourceList).

    These dedupe hard: full nodes of the same class mix share (pool,
    joint-compat, used) exactly, so a 5k-node plan has only a few hundred
    distinct content keys.  Every node resolves through a cross-solve
    content-keyed memo; cold keys queue ONCE (dict dedup) for a single
    batched capacity/compat filter.  Inputs: per-node option index,
    per-node joint compat bits (AND over hosted classes, packbits form;
    None to skip), per-node used vectors (N×R).  Returns a list aligned
    with the inputs of (alternatives, used_ResourceList) or None.

    `cls_keys` (per-node sorted class-id tuples) replaces `jcb_list` as
    the memo key when given: the joint-compat AND then runs only for
    memo MISSES — at 50k scale that's a few hundred small reduces
    instead of a fleet-wide 20MB reduceat (~100ms, measured)."""
    options_l = problem.options
    O = problem.num_options
    option_alloc = problem.option_alloc
    # per-resource rows contiguous for the global capacity compare
    allocT = np.ascontiguousarray(option_alloc.T)
    pool_of_option = np.asarray([o.pool for o in options_l])
    pool_masks: Dict[object, np.ndarray] = {}
    memo = _alt_memo_for(problem)
    N = len(oi_l)
    used_l = node_used.tolist()
    node_ckeys: List = [None] * N
    # thread-local view of every resolved key: the shared memo can be
    # cleared/evicted by a concurrent solve between fill and assembly, so
    # assembly must never read it directly
    resolved: Dict[tuple, tuple] = {}
    miss_index: Dict[tuple, int] = {}     # ckey -> row in the miss batch
    miss_nodes: List[int] = []
    miss_jc: List[np.ndarray] = []
    compat_bits = (np.packbits(problem.class_compat, axis=1)
                   if cls_keys is not None else None)
    # class-id tuples are batch-specific; the cross-solve memo's invariant
    # is CONTENT keying (two batches assign ids in their own order), so a
    # cls tuple maps to a digest of the classes' requests+compat rows —
    # computed once per distinct tuple per call (review r5)
    cls_digest: Dict[tuple, bytes] = {}

    def _digest(cl: tuple) -> bytes:
        d = cls_digest.get(cl)
        if d is None:
            import hashlib
            idx = list(cl)
            d = hashlib.blake2b(
                problem.class_requests[idx].tobytes()
                + compat_bits[idx].tobytes(), digest_size=16).digest()
            cls_digest[cl] = d
        return d

    for i in range(N):
        oi = oi_l[i]
        if not (0 <= oi < O) or \
                (cls_keys is None and jcb_list[i] is None):
            continue
        pool = options_l[oi].pool
        if cls_keys is not None:
            ckey = (pool, _digest(cls_keys[i]), tuple(used_l[i]),
                    max_alternatives)
        else:
            ckey = (pool, jcb_list[i].tobytes(), tuple(used_l[i]),
                    max_alternatives)
        node_ckeys[i] = ckey
        if ckey not in resolved and ckey not in miss_index:
            hit = memo.get(ckey)
            if hit is not None:
                resolved[ckey] = hit
            else:
                miss_index[ckey] = i
                miss_nodes.append(i)
                if cls_keys is not None:
                    cl = list(cls_keys[i])
                    miss_jc.append(compat_bits[cl[0]] if len(cl) == 1 else
                                   np.bitwise_and.reduce(compat_bits[cl],
                                                         axis=0))
                else:
                    miss_jc.append(jcb_list[i])

    if miss_nodes:
        # ONE global capacity filter for every distinct miss: per-resource
        # outer compare with a running AND (M×O per resource) — no
        # per-group fancy-indexed copies of the catalog, no M×O×R temporary
        used_mat = np.asarray(node_used)[miss_nodes].astype(option_alloc.dtype)
        M = len(miss_nodes)
        ok = np.ones((M, option_alloc.shape[0]), bool)
        for r in range(allocT.shape[0]):
            np.logical_and(ok, allocT[r][None, :] >= used_mat[:, r][:, None],
                           out=ok)
        n_compat_cols = problem.class_compat.shape[1]
        jc_all = np.unpackbits(np.asarray(miss_jc), axis=1,
                               count=n_compat_cols).astype(bool)
        np.logical_and(ok, jc_all, out=ok)
        for m, (ckey, i) in enumerate(miss_index.items()):
            pool = ckey[0]
            same_pool = pool_masks.get(pool)
            if same_pool is None:
                same_pool = pool_masks[pool] = pool_of_option == pool
            alt_ids = np.nonzero(ok[m] & same_pool)[0][:max_alternatives]
            val = ([options_l[a] for a in alt_ids],
                   ResourceList.from_vector(np.asarray(ckey[2], np.int64),
                                            problem.axes, problem.scales))
            resolved[ckey] = val
            memo[ckey] = val

    return [resolved[k] if k is not None else None for k in node_ckeys]
