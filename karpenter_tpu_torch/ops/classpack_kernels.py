"""Wrappers of the class-granular packing kernels (csrc/classpack.cu).

Four kernels carry the class-granular solve, a fifth the batched
consolidation sweep and a sixth the slab sort of the device decode; K1-K4
and K6 also run shard-batched (one launch over the n shards of a mesh, the
shard a grid axis: the `*_sharded` wrappers), and a seventh, K8
`shard_psum`, sums the shards' flat aggregates in the mesh's reduction
order.  Each wrapper here has

  * a plain PyTorch version of the same function (`*_plain`), which it
    runs ONLY when its tensors lie on the CPU — the CPU tests use it, and
    `chip_smoke.py` holds each kernel against it on the card;
  * a launch counter (`LAUNCHES[name]`), raised by one exactly where the
    wrapper launches its kernel;
  * on CUDA tensors, the kernel itself: the wrapper checks device, dtype,
    shape and contiguity, allocates outputs and scratch with torch, launches
    on the current stream through the ctypes library and raises on any
    `cudaError_t`.  There is no fallback to the plain version on the card.

| kernel                  | replaces (JAX package)                                 |
|-------------------------|--------------------------------------------------------|
| classpack_precompute    | ops/classpack.py class_pack_kernel :75-85              |
| classpack_scan          | ops/classpack.py class_pack_kernel :87-152             |
| classpack_assign_decode | ops/classpack.py class_pack_assign_kernel :228-245     |
| classpack_aggregate     | ops/classpack.py class_pack_aggregate_kernel :169-178  |
| classpack_sweep         | ops/classpack.py class_pack_sweep_kernel :332-363      |
| classpack_slab          | ops/classpack.py class_pack_assign_slab_kernel :280-297 |
| classpack_*_sharded     | the same, under parallel/sharded.py and parallel/driver.py's shard_map (:117-191, :68-172) |
| shard_psum              | the hierarchical psum of parallel/sharded.py :142-146 and parallel/driver.py :90-91 |

A shard-batched wrapper takes its per-shard operands with a leading shard
axis n: each a stack of contiguous shards, or one copy shared by every
shard (an `expand`ed view, shard stride 0 — the replicated operands of
rows 13-14); the catalog (alloc, price, rank) is always shared.  Its plain
version is a loop over the shards of the single-device plain version.  The
single-device wrappers launch the same kernels with n = 1, and each kind
of launch has its own counter.  Only the port's own programs call the
wrappers, so operands that break a wrapper's contract raise
`KernelContractError`, a KernelError that no ladder answers on the host;
the shard-batched wrappers raise it as `ShardLayoutError`, which the
partitioned driver raises instead of answering the batch on the
single-device path.

All integer math is int32 with the reference's semantics (floor division,
two's complement wrap); the new-node score is float32.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .._build import KernelContractError, KernelError, KernelLimitError
from .ffd import SCORE_CAP

BIG = 2**30

KERNELS = ("classpack_precompute", "classpack_scan",
           "classpack_assign_decode", "classpack_aggregate",
           "classpack_sweep", "classpack_slab",
           "classpack_precompute_sharded", "classpack_scan_sharded",
           "classpack_assign_decode_sharded", "classpack_aggregate_sharded",
           "classpack_slab_sharded", "shard_psum")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# the library
# ---------------------------------------------------------------------------

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from .._build import load
        lib = load("classpack")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        llp = ctypes.POINTER(ll)
        lib.kp_error_string.argtypes = [i]
        lib.kp_error_string.restype = ctypes.c_char_p
        lib.kp_max_r.restype = i
        lib.kp_max_slots.restype = i
        lib.kp_precompute.argtypes = [p] * 6 + [i] * 4 + [llp] + [i] * 7 \
            + [p, p, p]
        lib.kp_precompute.restype = i
        lib.kp_precompute_clusters.argtypes = [i] * 4 + [ctypes.POINTER(i)]
        lib.kp_precompute_clusters.restype = i
        lib.kp_scan.argtypes = ([p] * 10 + [i] * 6 + [llp] + [i] * 7
                                + [p] * 5 + [p])
        lib.kp_scan.restype = i
        lib.kp_scan_clusters.argtypes = [i] * 4 + [ctypes.POINTER(i)]
        lib.kp_scan_clusters.restype = i
        lib.kp_step_cycles.argtypes = [i] * 4 + [p, p]
        lib.kp_step_cycles.restype = i
        lib.kp_assign_decode.argtypes = [p, p, ll] + [i] * 5 + [p, p]
        lib.kp_assign_decode.restype = i
        lib.kp_aggregate.argtypes = [p] * 4 + [ll] + [i] * 6 + [p, p]
        lib.kp_aggregate.restype = i
        lib.kp_aggregate_clusters.argtypes = [i] * 3 + [ctypes.POINTER(i)]
        lib.kp_aggregate_clusters.restype = i
        lib.kp_shard_psum.argtypes = [p, i, i, i, p, p]
        lib.kp_shard_psum.restype = i
        lib.kp_sweep_max_slots.restype = i
        lib.kp_sweep.argtypes = [p] * 12 + [i] * 11 + [p] * 3 + [p]
        lib.kp_sweep.restype = i
        lib.kp_sweep_blocks.argtypes = [i] * 3 + [ctypes.POINTER(i)]
        lib.kp_sweep_blocks.restype = i
        lib.kp_slab_budget.argtypes = [ctypes.POINTER(i)] * 2
        lib.kp_slab_budget.restype = i
        lib.kp_slab.argtypes = [p, i, i, i, i, i, i, i] + [p] * 5 + [p]
        lib.kp_slab.restype = i
        # the wrappers check R against MAX_R: read the kernels' limit once
        if lib.kp_max_r() != MAX_R:
            raise KernelError(f"the library takes {lib.kp_max_r()} resource "
                              f"axes, the wrappers {MAX_R}")
        _LIB = lib
    return _LIB


def _raise_on(err: int, name: str) -> None:
    if err:
        msg = _lib().kp_error_string(err).decode()
        raise KernelError(f"{name}: CUDA error {err} ({msg})")


def _on_cuda(*tensors) -> bool:
    """True for all-CUDA inputs, False for all-CPU; mixed devices raise."""
    devs = {t.device for t in tensors if t is not None}
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len(devs) == 1:
        return True
    raise KernelContractError(f"inputs on mixed or unsupported devices: "
                              f"{sorted(map(str, devs))}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise KernelContractError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise KernelContractError(f"{name}: shape {tuple(t.shape)}, "
                                  f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise KernelContractError(f"{name}: not contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    # the raw handle where the CUDA build has it: no Stream object a launch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None and dev.index is not None:
        return raw(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


_NO_SWITCH = contextlib.nullcontext()


def _at(dev: torch.device):
    """torch.cuda.device(dev) for a launch, or nothing when `dev` is
    already the current card (the context costs the host more than a short
    kernel runs)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return _NO_SWITCH
    return torch.cuda.device(dev)


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


# ---------------------------------------------------------------------------
# bit packing (np.packbits / np.unpackbits along axis 1, big-endian bits)
# ---------------------------------------------------------------------------

def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    C, O = mask.shape
    m = torch.nn.functional.pad(mask.to(torch.uint8), (0, (-O) % 8))
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                     device=mask.device)
    return (m.reshape(C, -1, 8).to(torch.int32) * w).sum(-1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor, count: int) -> torch.Tensor:
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :count].bool()


# ---------------------------------------------------------------------------
# K1 classpack_precompute
# ---------------------------------------------------------------------------

def classpack_precompute_plain(requests, node_cap, compat_packed, alloc,
                               price, rank, with_ok: bool = True):
    C, R = requests.shape
    O = alloc.shape[0]
    reqpos = requests > 0
    safe = torch.where(reqpos, requests, torch.ones_like(requests))
    m = torch.full((C, O), BIG, dtype=torch.int32, device=requests.device)
    for r in range(R):
        q = torch.div(alloc[None, :, r], safe[:, r, None], rounding_mode="floor")
        m = torch.where(reqpos[:, r, None], torch.minimum(m, q), m)
    m = torch.minimum(m, node_cap[:, None])
    if not with_ok:
        return m, None
    compat = unpack_bits(compat_packed, O)
    ok = compat & (m > 0) & torch.isfinite(price)[None, :]
    best = torch.where(ok, rank[None, :], BIG).amin(dim=1)
    ok = ok & (rank[None, :] == best[:, None])
    return m, ok.to(torch.uint8)


def classpack_precompute(requests: torch.Tensor, node_cap: torch.Tensor,
                         compat_packed: torch.Tensor, alloc: torch.Tensor,
                         price: torch.Tensor, rank: torch.Tensor,
                         with_ok: bool = True
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-(class × option) pods-per-node `m` (int32 C×O) and the
    launchable, best-rank mask `ok` (uint8 C×O; None when not `with_ok`:
    the sweep reads only m, and no ok is computed)."""
    if not _on_cuda(requests, node_cap, compat_packed, alloc, price, rank):
        return classpack_precompute_plain(requests, node_cap, compat_packed,
                                          alloc, price, rank, with_ok)
    C, R = requests.shape
    O = alloc.shape[0]
    if R > MAX_R:
        raise KernelLimitError(
            f"R={R} resource axes exceed the kernel's {MAX_R}")
    _check(requests, "requests", torch.int32, (C, R))
    _check(node_cap, "node_cap", torch.int32, (C,))
    _check(compat_packed, "compat_packed", torch.uint8, (C, (O + 7) // 8))
    _check(alloc, "alloc", torch.int32, (O, R))
    _check(price, "price", torch.float32, (O,))
    _check(rank, "rank", torch.int32, (O,))
    return _launch_precompute("classpack_precompute", 1, requests, node_cap,
                              compat_packed, alloc, price, rank, None,
                              with_ok, (C, O))


# --- the plan of a K1 launch (a host function, tested on the CPU) ---

PRE_MAX_CLASSES = 8           # classes a tile (kPreMaxClasses)
PRE_GROUPS = (1, 2, 4, 8)     # groups of 4 options a thread
PRE_THREADS = (128, 256, 512, 1024)
PRE_MAX_CLUSTER = 16
PRE_MIN_WARPS = 12            # warps an SM the classes a tile leave, at least
PRE_STATIC_SMEM = 8192        # the kernel's own shared memory, rounded up


@dataclasses.dataclass(frozen=True)
class PrecomputePlan:
    """How K1 tiles the C × O work: tiles of `classes` classes; each
    class's options over a cluster of `cluster` CTAs of `threads` threads,
    each thread `groups` groups of 4 consecutive options (`options` =
    4 · groups · threads a CTA, the cluster's CTAs covering O); the CTA's
    alloc rows staged in shared memory (`stage`) or read in place; `smem`
    dynamic bytes a CTA (the kernel checks it against its own carve)."""
    classes: int
    options: int
    cluster: int
    threads: int
    groups: int
    stage: bool
    smem: int

    def tiles(self, C: int) -> int:
        return -(-C // self.classes)


def precompute_smem_bytes(R: int, options: int, stage: bool, classes: int,
                          threads: int) -> int:
    """A K1 CTA's dynamic shared memory, as the kernel carves it: a word of
    ok bits a class and thread, then (staged) its options' alloc rows
    axis-major, each axis row padded by 4 ints."""
    return (classes * threads + (R * (options + 4) if stage else 0)) * 4


def precompute_plan(C: int, O: int, R: int, n: int, sms: int,
                    smem_optin: int,
                    clusters: Callable[[int, int, int, int], int]
                    ) -> Optional[PrecomputePlan]:
    """The tiles of a K1 launch over `n` shards of C classes, O options and
    R axes on a card of `sms` SMs whose blocks may opt into `smem_optin`
    bytes of shared memory; `clusters(cs, threads, groups, smem)` is the
    card's count of such clusters it holds at once
    (cudaOccupancyMaxActiveClusters; 0: it cannot run one).  The options:
    the smallest cluster that covers O (a cluster's barriers and exchange
    cost about a microsecond on an H100), then the fewest groups a thread,
    then the fewest threads, among the layouts the card runs; the alloc
    rows staged where they fit.  The classes: the most a tile (up to
    PRE_MAX_CLASSES, halving) that still leave a CTA on nearly every SM
    (7/8 of them) and PRE_MIN_WARPS warps an SM, else one.  None past the
    kernel's limits (R > 32, n > 65535) or when no cluster covers O (past
    16 × 1024 × 32 = 524 288 options)."""
    if not (C > 0 and O > 0 and 0 <= R <= MAX_R and 0 < n <= 65535
            and sms > 0):
        return None
    layouts = sorted((-(-O // (4 * G * T)), G, T) for G in PRE_GROUPS
                     for T in PRE_THREADS)
    for cs, G, T in layouts:
        if cs > PRE_MAX_CLUSTER:
            break
        ot = 4 * G * T
        ct = PRE_MAX_CLASSES
        while ct > 1 and (8 * n * -(-C // ct) * cs < 7 * sms
                          or n * -(-C // ct) * cs * T < 32 * PRE_MIN_WARPS
                          * sms):
            ct //= 2
        for stage in ((True, False) if R else (False,)):
            smem = precompute_smem_bytes(R, ot, stage, ct, T)
            if smem + PRE_STATIC_SMEM > smem_optin:
                continue
            if clusters(cs, T, G, smem) < 1:
                continue
            return PrecomputePlan(classes=ct, options=ot, cluster=cs,
                                  threads=T, groups=G, stage=stage, smem=smem)
    return None


@functools.lru_cache(maxsize=None)
def _precompute_clusters(index: int, cs: int, T: int, G: int,
                         smem: int) -> int:
    """The card's count of K1 clusters of this layout at once; 0 where it
    refuses the layout (a cluster shape it does not schedule), so the plan
    takes another."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _lib().kp_precompute_clusters(cs, T, G, smem, ctypes.byref(out))
    return 0 if err else out.value


@functools.lru_cache(maxsize=1024)
def _precompute_plan_at(index: int, C: int, O: int, R: int,
                        n: int) -> Optional[PrecomputePlan]:
    sms, smem = _slab_budget(index)
    return precompute_plan(
        C, O, R, n, sms, smem,
        lambda cs, T, G, b: _precompute_clusters(index, cs, T, G, b))


def precompute_plan_for(dev: torch.device, C: int, O: int, R: int,
                        n: int) -> PrecomputePlan:
    """`precompute_plan` on card `dev` (its SMs, opt-in shared memory and
    cluster occupancy), kept per shape; raises KernelLimitError when
    nothing fits."""
    plan = _precompute_plan_at(_device_index(dev), C, O, R, n)
    if plan is None:
        raise KernelLimitError(
            f"classpack_precompute: no tiles for C={C}, O={O}, R={R}, n={n}")
    return plan


def _launch_precompute(name, n, requests, node_cap, compat_packed, alloc,
                       price, rank, strides, with_ok, shape):
    """One K1 launch over n shards (operands checked by the caller).
    Returns (m, ok or None), each of `shape` (n × C × O in memory)."""
    C, R = requests.shape[-2:]
    O = alloc.shape[0]
    dev = requests.device
    plan = precompute_plan_for(dev, C, O, R, n)
    m = torch.empty(shape, dtype=torch.int32, device=dev)
    ok = torch.empty(shape, dtype=torch.uint8, device=dev) if with_ok else None
    with _at(dev):
        err = _lib().kp_precompute(
            _ptr(requests), _ptr(node_cap), _ptr(compat_packed), _ptr(alloc),
            _ptr(price), _ptr(rank), n, C, O, R, strides, plan.classes,
            plan.cluster, plan.threads, plan.groups, int(plan.stage),
            int(with_ok), plan.smem, _ptr(m), _ptr(ok), _stream(dev))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return m, ok


# --- numpy models of K1's arithmetic (the CPU tests hold them against the
# plain version) ---

def floordiv_magic_np(a, q: int) -> np.ndarray:
    """K1's floor division of int32 numerators by one divisor q > 0
    (csrc/classpack.cu `floordiv_magic32`), step for step: the multiplier
    of K2's `magic_model` (m, shift = 32 + s), or m = 0, s = 0 and x added
    for q = 1; x = a or -1 - a; d = (umulhi(x, m) + x·[q = 1]) >> s, with
    no correction step; then the sign."""
    mult, shift = magic_model(int(q))
    m32, add, s = (0, True, 0) if shift == 31 else (mult, False, shift - 32)
    a = np.asarray(a, np.int64)
    x = np.where(a >= 0, a, -1 - a)
    hi = (x.astype(np.uint64) * np.uint64(m32)) >> np.uint64(32)
    d = ((hi.astype(np.int64) + (x if add else 0)) >> s).astype(np.int64)
    return np.where(a >= 0, d, -1 - d)


def precompute_tile_model(requests, node_cap, compat_packed, alloc, price,
                          rank, plan: PrecomputePlan, with_ok: bool = True):
    """K1 on one shard as its tiles compute it under `plan` (numpy): m by
    the multipliers of each class's positive axes; then for each tile's
    classes, each CTA of the cluster over its options [r · options, ...),
    thread t holding groups g of options 4 (t + g · threads) + v; each
    thread's minimum of where(ok, rank, BIG) over its options (INT_MAX
    when it holds none), each warp's minimum of its lanes', the CTA's of
    its warps', the class's of the cluster's CTAs'; ok kept where the
    option's rank equals it.  Returns (m int32 C×O, ok uint8 C×O or
    None)."""
    req = np.asarray(requests, np.int64)
    cap = np.asarray(node_cap, np.int64)
    alloc = np.asarray(alloc, np.int64)
    price = np.asarray(price, np.float32)
    rank = np.asarray(rank, np.int64)
    C, R = req.shape
    O = alloc.shape[0]
    m = np.full((C, O), BIG, np.int64)
    for c in range(C):
        for r in range(R):
            q = int(req[c, r])
            if q > 0:
                m[c] = np.minimum(m[c], floordiv_magic_np(alloc[:, r], q))
    m = np.minimum(m, cap[:, None]).astype(np.int32)
    if not with_ok:
        return m, None
    compat = np.unpackbits(np.asarray(compat_packed, np.uint8), axis=1,
                           count=O).astype(bool)
    ok = compat & (m > 0) & np.isfinite(price)[None, :]
    T, ot, cs = plan.threads, plan.options, plan.cluster
    assert cs * ot >= O > (cs - 1) * ot and ot == 4 * plan.groups * T
    # each option's CTA and thread
    o = np.arange(O)
    cta, oi = o // ot, o % ot
    thread = (oi // 4) % T
    slot = cta * T + thread               # (CTA, thread) of each option
    INT_MAX = np.int64(2**31 - 1)
    best = np.empty(C, np.int64)
    for c in range(C):
        tmin = np.full(cs * T, INT_MAX)
        np.minimum.at(tmin, slot, np.where(ok[c], rank, BIG))
        warp = tmin.reshape(cs, T // 32, 32).min(axis=2)   # redux.sync
        best[c] = warp.min(axis=1).min()    # the CTAs', then the cluster's
    ok &= rank[None, :] == best[:, None]
    return m, ok.astype(np.uint8)


# ---------------------------------------------------------------------------
# K2 classpack_scan
# ---------------------------------------------------------------------------

def classpack_scan_plain(requests, counts, compat_packed, node_cap, alloc,
                         price, m_all, ok_all, init_option, init_used,
                         max_nodes: int, emit_takes: bool):
    C, R = requests.shape
    O = alloc.shape[0]
    K = max_nodes
    dev = requests.device
    i32 = torch.int32
    compat = unpack_bits(compat_packed, O)
    ok_all = ok_all.bool()
    idx = torch.arange(K, dtype=i32, device=dev)
    if init_option is None:
        slot_option = torch.full((K,), -1, dtype=i32, device=dev)
        init_used = torch.zeros((K, R), dtype=i32, device=dev)
    else:
        slot_option = init_option.clone()
    slot_free = torch.where((slot_option >= 0)[:, None],
                            alloc[slot_option.clamp(min=0).long()] - init_used,
                            0)
    n_open = (slot_option >= 0).sum().to(i32)
    n_unsched = torch.zeros((), dtype=i32, device=dev)
    cap_score = torch.tensor(SCORE_CAP, dtype=torch.float32, device=dev)
    outs = []
    for c in range(C):
        req, cnt, cap = requests[c], counts[c], node_cap[c]
        opt = slot_option.clamp(min=0).long()
        reqpos = req > 0
        safe = torch.where(reqpos, req, torch.ones_like(req))
        fit = torch.where(reqpos[None, :],
                          torch.div(slot_free, safe[None, :],
                                    rounding_mode="floor"),
                          BIG).amin(dim=-1)
        fit = torch.minimum(fit, cap)
        fit = torch.where((slot_option >= 0) & compat[c][opt],
                          fit.clamp(min=0), 0)
        prefix = torch.cumsum(fit, 0, dtype=i32) - fit
        take = torch.minimum((cnt - prefix).clamp(min=0), fit)
        remaining = cnt - take.sum(dtype=i32)
        m = m_all[c]
        m_safe = m.clamp(min=1)
        nodes_needed = torch.div(remaining.clamp(min=1) + m_safe - 1, m_safe,
                                 rounding_mode="floor")
        score = torch.where(
            ok_all[c],
            torch.minimum(price * nodes_needed.to(torch.float32), cap_score),
            float("inf"))
        j = torch.argmin(score)
        can = torch.isfinite(score[j])
        m_sel = m[j].clamp(min=1)
        needed = torch.where(can & (remaining > 0),
                             torch.div(remaining + m_sel - 1, m_sel,
                                       rounding_mode="floor"), 0)
        n_new = torch.minimum(needed, K - n_open)
        sched_new = torch.minimum(remaining, n_new * m_sel)
        is_new = (idx >= n_open) & (idx < n_open + n_new)
        pods_on = torch.where(is_new, m_sel, 0)
        rem_last = sched_new - (n_new - 1) * m_sel
        pods_on = torch.where(is_new & (idx == n_open + n_new - 1), rem_last,
                              pods_on)
        slot_option = torch.where(is_new, j.to(i32), slot_option)
        slot_free = slot_free - take[:, None] * req[None, :]
        slot_free = torch.where(is_new[:, None],
                                alloc[j][None, :] - pods_on[:, None] * req[None, :],
                                slot_free)
        n_open = n_open + n_new
        n_unsched = n_unsched + (remaining - sched_new)
        outs.append(take + pods_on if emit_takes else take.sum(dtype=i32))
    slot_used = torch.where((slot_option >= 0)[:, None],
                            alloc[slot_option.clamp(min=0).long()] - slot_free, 0)
    takes = (torch.stack(outs) if outs else
             torch.zeros((0, K) if emit_takes else (0,), dtype=i32, device=dev))
    return slot_option, slot_used, n_open, n_unsched, takes


# --- the plan of a K2 launch (a host function, tested on the CPU) ---

SCAN_THREADS = 1024       # threads of a K2 block at 32 slots a thread
SCAN_CTA_THREADS = 512    # ... the most below that
SCAN_MIN_THREADS = 128    # ... and the least (the option pass shares them)
SCAN_CLUSTERS = (1, 2, 4, 8, 16)
SCAN_MIN_CTA_SLOTS = 128  # the fewest slots a CTA of a preferred cluster holds
SCAN_STATIC_SMEM = 4096   # the kernel's own shared memory, rounded up
SCAN_MAX_SLOTS = 32768    # kp_max_slots()
MAX_R = 32                # kp_max_r()


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """How K2 lays out one shard's scan: a cluster of `cluster` CTAs of
    `threads` threads, each CTA holding `per_cta` contiguous slots,
    `slots_per_thread` a thread; the slot state in shared memory
    (`state_smem`) or in a global slice; the class inputs staged in shared
    memory one class ahead (`stage`) or read in place; `smem` dynamic bytes
    a CTA (the kernel checks it against its own carve)."""
    cluster: int
    threads: int
    slots_per_thread: int
    per_cta: int
    state_smem: bool
    stage: bool
    smem: int

    def state_ints(self, R: int) -> int:
        """Ints of one CTA's slot state (its global slice when spilled)."""
        return self.slots_per_thread * self.threads * (R + 1)


def scan_geometry(K: int, cluster: int) -> Tuple[int, int, int]:
    """(slots a CTA, slots a thread, threads) of K slots over `cluster`
    CTAs: the fewest slots a thread (a power of two, at most 32) that hold
    a CTA's slots in SCAN_CTA_THREADS threads (1024 at 32 slots a thread),
    as few threads as hold them, in whole warps, but at least
    SCAN_MIN_THREADS."""
    per = -(-K // cluster)
    S = 1
    while S < 32 and S * SCAN_CTA_THREADS < per:
        S *= 2
    T = max(SCAN_MIN_THREADS, 32 * -(-per // (32 * S)))
    return per, S, T


def _ring_bytes(O: int, with_ok: bool) -> int:
    return (O + 7) // 8 + O * 4 + (O if with_ok else 0)


def scan_smem_bytes(cluster: int, threads: int, S: int, R: int, O: int,
                    state_smem: bool, stage: bool) -> int:
    """A K2 CTA's dynamic shared memory, as the kernel carves it: the slot
    state, the price vector and three staged classes' rows (compat, m,
    ok)."""
    n = 0
    if state_smem:
        n += S * threads * (R + 1) * 4
    if stage:
        n += O * 4 + 3 * _ring_bytes(O, True)
    return n


def scan_plan(K: int, R: int, O: int, n_shards: int, sms: int,
              smem_optin: int, max_clusters: Callable[[int, int, int, int], int],
              aligned: bool = True) -> Optional[ScanPlan]:
    """The layout of a K2 launch of `n_shards` shards of K slots, R axes
    and O options on a card of `sms` SMs whose blocks may opt into
    `smem_optin` bytes of shared memory; `max_clusters(cs, threads, S,
    smem)` is the card's count of such clusters it can hold at once
    (cudaOccupancyMaxActiveClusters).  In order of preference: the slot
    state and the staged class inputs both in shared memory, then the
    state alone, then the state in a global slice (with, then without,
    the staging).  Staging needs O % 128 == 0 and 16-byte aligned rows
    (`aligned`).  Among cluster sizes the largest whose CTAs each hold at
    least SCAN_MIN_CTA_SLOTS slots comes first (more SMs share a step's
    fits and options), then the smaller ones, then the rest, smallest
    first.  A size the card can hold `n_shards` clusters of (every
    shard's cluster resident at once) comes before one it cannot.  None
    past the kernel's limits (K, R) or when nothing fits, which no
    (K <= 32768, R <= 32) does on a card that runs one cluster of any
    size."""
    if not (0 < K <= SCAN_MAX_SLOTS and 0 < R <= MAX_R and O > 0
            and n_shards > 0 and sms > 0):
        return None
    stage_ok = aligned and O % 128 == 0

    def rank(cs):
        full = -(-K // cs) >= SCAN_MIN_CTA_SLOTS
        return (not full, -cs if full else cs)
    order = sorted(SCAN_CLUSTERS, key=rank)
    for state_smem, stage in ((True, True), (True, False), (False, True),
                              (False, False)):
        if stage and not stage_ok:
            continue
        for need in sorted({n_shards, 1}, reverse=True):
            for cs in order:
                per, S, T = scan_geometry(K, cs)
                smem = scan_smem_bytes(cs, T, S, R, O, state_smem, stage)
                if smem + SCAN_STATIC_SMEM > smem_optin:
                    continue
                if max_clusters(cs, T, S, smem) < need:
                    continue
                return ScanPlan(cluster=cs, threads=T, slots_per_thread=S,
                                per_cta=per, state_smem=state_smem,
                                stage=stage, smem=smem)
    return None


# --- numpy models of the kernels' arithmetic (the CPU tests hold them
# against the reference's) ---

def magic_model(q: int) -> Tuple[int, int]:
    """(m, shift) of K2 / K5's division by a class's request q > 0
    (csrc/classpack.cu `magic_of`), step for step: l = ceil(log2 q),
    M = 2^(31+l) + q - 1, a float32 estimate of M / q, one float32
    correction of the remainder, one exact integer step; m must come out
    as ceil(2^(31+l) / q)."""
    f32 = np.float32
    l = (q - 1).bit_length()
    M = (1 << (31 + l)) + q - 1
    rq = f32(1) / f32(q)
    m = int(f32(M) * rq)
    r = M - m * q
    m += int(np.floor(f32(r) * rq))
    r = M - m * q
    m += (r >= q) - (r < 0)
    return m, 31 + l


def floordiv_magic_model(a, q) -> int:
    """K2 / K5's floor division of an int32 `a` by a class's invariant
    request q > 0 through its multiplier (`magic_model`; csrc
    `floordiv_magic`), step for step in integers: x = a or -1 - a,
    d = (x * m) >> shift, one correction step, then the sign."""
    a, q = int(a), int(q)
    m, shift = magic_model(q)
    assert m == -(-(1 << shift) // q) and m < 1 << 32
    x = a if a >= 0 else -1 - a
    d = (x * m) >> shift
    r = x - d * q
    d += (r >= q) - (r < 0)
    return d if a >= 0 else -1 - d


def scan_fill_model(fit, cnt: int, cluster: int, threads: int, S: int):
    """K2's greedy first-fit fill of one class over a cluster, as the
    kernel computes it: each thread's S contiguous slots, the cluster scan
    of the threads' sums (each warp's total to every CTA's table, each
    warp's prefix from the table), the takes from the uint32 prefix, and
    the class's sum of takes — min(cnt, total) when the exact total is
    below 2^31 (no prefix wrapped), else the uint32 sum of the takes.
    `fit`: the K slots' fits (>= 0).  Returns (take int32 K, taken int)."""
    fit = np.asarray(fit, np.int64)
    K = fit.shape[0]
    per = -(-K // cluster)
    sums = np.zeros((cluster, threads), np.int64)
    for k in range(K):
        r, l = divmod(k, per)
        sums[r, l // S] += fit[k]
    warps = threads // 32
    warp_tot = sums.reshape(cluster, warps, 32).sum(2)
    table = warp_tot.reshape(-1)              # (rank, warp) order
    take = np.zeros(K, np.int64)
    for k in range(K):
        r, l = divmod(k, per)
        t = l // S
        e = r * warps + t // 32
        pre = table[:e].sum() + sums[r, (t // 32) * 32:t].sum() \
            + fit[r * per + t * S:k].sum()
        run = pre & 0xFFFFFFFF                # the uint32 prefix
        d = (cnt - run) & 0xFFFFFFFF
        d = d - (1 << 32) if d >= 1 << 31 else d
        take[k] = min(max(d, 0), fit[k])
    total = int(table.sum())
    if total < 2**31:
        taken = min(cnt, total)
    else:
        taken = int(take.sum()) & 0xFFFFFFFF
        taken = taken - (1 << 32) if taken >= 1 << 31 else taken
    return take.astype(np.int32), taken


def sweep_choice_model(rank, launchable, score):
    """K5's option choice as ONE lexicographic minimum over (rank, score,
    index) (csrc `block_keymin`): a launchable option o is the key
    (rank[o], score[o], o); a non-launchable one is the key (2^30, +inf,
    last) — the reference's `where(ok, rank, BIG)` gives it rank BIG and
    its score is +inf.  Returns (index, can): the minimum's index when its
    score is finite, else (0, False).  The reference's rule it replaces:
    best = min(where(ok, rank, BIG)), keep rank == best, argmin of the
    kept scores (+inf elsewhere), ties to the lowest index, can =
    finite(score[j])."""
    rank = np.asarray(rank, np.int64)
    score = np.asarray(score, np.float32)
    ok = np.asarray(launchable, bool)
    keys = [(int(rank[o]), float(score[o]), o) for o in np.nonzero(ok)[0]]
    if not ok.all():
        keys.append((BIG, float("inf"), 2**31 - 1))
    r, sc, o = min(keys)
    return (o, True) if np.isfinite(sc) else (0, False)


def classpack_scan(requests: torch.Tensor, counts: torch.Tensor,
                   compat_packed: torch.Tensor, node_cap: torch.Tensor,
                   alloc: torch.Tensor, price: torch.Tensor,
                   m_all: torch.Tensor, ok_all: torch.Tensor,
                   init_option: Optional[torch.Tensor],
                   init_used: Optional[torch.Tensor],
                   max_nodes: int, emit_takes: bool = False):
    """The sequential class scan.  Returns (slot_option K, slot_used K×R,
    n_open, n_unsched, takes): takes is the C×K placement matrix when
    `emit_takes`, else the per-class sum of fills into open slots (C).
    `init_option`/`init_used` None == all slots closed (the `_fresh`
    variants: the state is built in-kernel)."""
    if (init_option is None) != (init_used is None):
        raise KernelContractError("init_option and init_used come together")
    if not _on_cuda(requests, counts, compat_packed, node_cap, alloc, price,
                    m_all, ok_all, init_option, init_used):
        return classpack_scan_plain(requests, counts, compat_packed, node_cap,
                                    alloc, price, m_all, ok_all, init_option,
                                    init_used, max_nodes, emit_takes)
    C, R = requests.shape
    O = alloc.shape[0]
    K = int(max_nodes)
    _check_scan_limits(K, R)
    _check(requests, "requests", torch.int32, (C, R))
    _check(counts, "counts", torch.int32, (C,))
    _check(compat_packed, "compat_packed", torch.uint8, (C, (O + 7) // 8))
    _check(node_cap, "node_cap", torch.int32, (C,))
    _check(alloc, "alloc", torch.int32, (O, R))
    _check(price, "price", torch.float32, (O,))
    _check(m_all, "m_all", torch.int32, (C, O))
    _check(ok_all, "ok_all", torch.uint8, (C, O))
    if init_option is not None:
        _check(init_option, "init_option", torch.int32, (K,))
        _check(init_used, "init_used", torch.int32, (K, R))
    slot_option, slot_used, scalars, takes = _launch_scan(
        "classpack_scan", 1, requests, counts, compat_packed, node_cap, alloc,
        price, m_all, ok_all, init_option, init_used, K, emit_takes, None)
    return slot_option[0], slot_used[0], scalars[0, 0], scalars[0, 1], \
        takes[0]


def _check_scan_limits(K: int, R: int) -> None:
    if not (0 < R <= MAX_R and 0 < K <= SCAN_MAX_SLOTS):
        raise KernelLimitError(
            f"R={R} / K={K} outside the scan kernel's limits "
            f"({MAX_R} axes, {SCAN_MAX_SLOTS} slots)")


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


@functools.lru_cache(maxsize=None)
def _scan_clusters(index: int, cs: int, T: int, S: int, smem: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        _raise_on(_lib().kp_scan_clusters(cs, T, S, smem, ctypes.byref(out)),
                  "classpack_scan")
    return out.value


def scan_plan_for(dev: torch.device, K: int, R: int, O: int, n: int,
                  aligned: bool = True) -> ScanPlan:
    """`scan_plan` on card `dev` (its SMs, opt-in shared memory and
    cluster occupancy); raises KernelLimitError when nothing fits."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    sms, smem = _slab_budget(index)
    plan = scan_plan(K, R, O, n, sms, smem,
                     lambda cs, T, S, b: _scan_clusters(index, cs, T, S, b),
                     aligned=aligned)
    if plan is None:
        raise KernelLimitError(
            f"classpack_scan: no layout for K={K}, R={R}, O={O}")
    return plan


def _launch_scan(name, n, requests, counts, compat_packed, node_cap, alloc,
                 price, m_all, ok_all, init_option, init_used, K, emit_takes,
                 strides):
    """One K2 launch over n shards (operands checked by the caller; n = 1
    with `strides` None is the single-device program).  Returns
    (slot_option n×K, slot_used n×K×R, scalars n×2, takes)."""
    C, R = requests.shape[-2:]
    O = alloc.shape[0]
    dev = requests.device
    plan = scan_plan_for(dev, K, R, O, n,
                         _aligned(compat_packed, m_all, ok_all, price))
    slot_option = torch.empty((n, K), dtype=torch.int32, device=dev)
    slot_used = torch.empty((n, K, R), dtype=torch.int32, device=dev)
    scalars = torch.empty((n, 2), dtype=torch.int32, device=dev)
    takes = torch.empty((n, C, K) if emit_takes else (n, C),
                        dtype=torch.int32, device=dev)
    g_state = None if plan.state_smem else torch.empty(
        (n, plan.cluster, plan.state_ints(R)), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().kp_scan(
            _ptr(requests), _ptr(counts), _ptr(compat_packed), _ptr(node_cap),
            _ptr(alloc), _ptr(price), _ptr(m_all), _ptr(ok_all),
            _ptr(init_option), _ptr(init_used), n, C, O, R, K,
            int(emit_takes), strides, plan.cluster, plan.threads,
            plan.slots_per_thread, plan.per_cta, int(plan.state_smem),
            int(plan.stage), plan.smem, _ptr(slot_option), _ptr(g_state),
            _ptr(slot_used), _ptr(scalars), _ptr(takes), _stream(dev))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return slot_option, slot_used, scalars, takes


STEP_CHAIN = 4096   # steps in the chain `step_cycles` times


def step_cycles(cluster: int, threads: int, with_min: bool) -> float:
    """SM cycles of the least class step on the current card: a chain of
    STEP_CHAIN dependent exchanges (the cluster scan at cluster size
    `cluster`, `threads` a CTA), each followed by a block reduction when
    `with_min`, timed by clock64 (csrc/classpack.cu `kp_step_cycles`).  A
    measurement for the bounds of K2 and K5, not a kernel of the port: it
    counts no launch."""
    dev = torch.device("cuda", torch.cuda.current_device())
    cycles = torch.zeros(2, dtype=torch.int64, device=dev)
    _raise_on(_lib().kp_step_cycles(cluster, threads, STEP_CHAIN,
                                    int(with_min), _ptr(cycles),
                                    _stream(dev)), "step_cycles")
    # a measurement's one read-back, never on a solve's path
    # graftlint: disable=JH001
    return cycles[0].item() / STEP_CHAIN


# ---------------------------------------------------------------------------
# K3 classpack_assign_decode
# ---------------------------------------------------------------------------

def repeat_classes(counts: torch.Tensor, n_pods: int) -> torch.Tensor:
    """jnp.repeat(arange(C), counts, total_repeat_length=n_pods): rows past
    the last pod take the last class id."""
    C = counts.shape[0]
    ids = torch.repeat_interleave(
        torch.arange(C, dtype=torch.int64, device=counts.device),
        counts.long())
    if ids.shape[0] >= n_pods:
        return ids[:n_pods]
    pad = torch.full((n_pods - ids.shape[0],), C - 1, dtype=torch.int64,
                     device=counts.device)
    return torch.cat([ids, pad])


def classpack_assign_decode_plain(takes, counts, n_pods: int):
    C, K = takes.shape
    i32 = torch.int32
    dev = takes.device
    flat = torch.cumsum(takes.reshape(-1), 0, dtype=i32)
    ends = flat[K - 1::K]
    base = torch.cat([torch.zeros(1, dtype=i32, device=dev), ends[:C - 1]])
    totals = ends - base
    class_ids = repeat_classes(counts, n_pods)
    cnt_csum = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                          torch.cumsum(counts, 0, dtype=i32)])[:-1]
    rank_in_class = (torch.arange(n_pods, dtype=i32, device=dev)
                     - cnt_csum[class_ids])
    q = base[class_ids] + rank_in_class
    f = torch.searchsorted(flat, q, right=True).to(i32)
    slot = f - class_ids.to(i32) * K
    sched = rank_in_class < totals[class_ids]
    assignment = torch.where(sched, slot, -1)
    return assignment.to(torch.int16) if K < 2**15 else assignment


def _check_decode_slots(lib, K: int) -> None:
    # one block holds a class's K-wide row in shared memory
    if K > lib.kp_max_slots():
        raise KernelLimitError(f"K={K} slots: the decode takes at most "
                               f"{lib.kp_max_slots()}")


def classpack_assign_decode(takes: torch.Tensor, counts: torch.Tensor,
                            n_pods: int) -> torch.Tensor:
    """Per-pod slot (−1 unscheduled) for `n_pods` padded pod rows, from the
    C×K takes: int16 when K < 2^15, else int32."""
    if not _on_cuda(takes, counts):
        return classpack_assign_decode_plain(takes, counts, n_pods)
    C, K = takes.shape
    _check(takes, "takes", torch.int32, (C, K))
    _check(counts, "counts", torch.int32, (C,))
    lib = _lib()
    _check_decode_slots(lib, K)
    dev = takes.device
    out16 = K < 2**15
    out = torch.empty(n_pods, dtype=torch.int16 if out16 else torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        err = lib.kp_assign_decode(
            _ptr(takes), _ptr(counts), 0, 1, C, K, int(n_pods), int(out16),
            _ptr(out), _stream(dev))
    _raise_on(err, "classpack_assign_decode")
    LAUNCHES["classpack_assign_decode"] += 1
    return out


# ---------------------------------------------------------------------------
# K4 classpack_aggregate
# ---------------------------------------------------------------------------

def classpack_aggregate_plain(slot_option, price, n_open, n_unsched):
    O = price.shape[0]
    opt = slot_option.clamp(min=0).long()
    launched = (slot_option >= 0) & torch.isfinite(price[opt])
    nodes_per_option = torch.zeros(O, dtype=torch.float32,
                                   device=price.device).index_add_(
        0, opt, launched.to(torch.float32))
    total_cost = torch.where(launched, price[opt], 0.0).sum()
    head = torch.stack([total_cost, n_open.to(torch.float32),
                        n_unsched.to(torch.float32)])
    return torch.cat([head, nodes_per_option])


def classpack_aggregate(slot_option: torch.Tensor, price: torch.Tensor,
                        n_open: torch.Tensor, n_unsched: torch.Tensor
                        ) -> torch.Tensor:
    """float32 [total_cost, n_open, n_unsched, nodes_per_option…] over the
    launchable (finite-price) open slots."""
    if not _on_cuda(slot_option, price, n_open, n_unsched):
        return classpack_aggregate_plain(slot_option, price, n_open, n_unsched)
    K = slot_option.shape[0]
    O = price.shape[0]
    _check(slot_option, "slot_option", torch.int32, (K,))
    _check(price, "price", torch.float32, (O,))
    _check(n_open, "n_open", torch.int32, ())
    _check(n_unsched, "n_unsched", torch.int32, ())
    return _launch_aggregate("classpack_aggregate", 1, slot_option, price,
                             n_open, n_unsched, 0, (3 + O,))


# --- the plan of a K4 launch (a host function, tested on the CPU) ---

AGG_THREADS = 1024          # threads of a K4 CTA
AGG_CTA_SPAN = 8192         # slots or bins a CTA of a larger cluster takes
AGG_MAX_CLUSTER = 16
AGG_STATIC_SMEM = 1024      # the kernel's own shared memory, rounded up


@dataclasses.dataclass(frozen=True)
class AggregatePlan:
    """How K4 splits each shard's K slots: a cluster of `cluster` CTAs of
    `threads` threads, each CTA a run of `per_cta` slots; `smem` dynamic
    bytes a CTA (its O-bin histogram)."""
    cluster: int
    threads: int
    per_cta: int
    smem: int


def aggregate_plan(K: int, O: int, n: int, smem_optin: int,
                   clusters: Callable[[int, int, int], int]
                   ) -> Optional[AggregatePlan]:
    """The cluster of a K4 launch over `n` shards of K slots and O options
    on a card whose blocks may opt into `smem_optin` bytes; `clusters(cs,
    threads, smem)` is the card's count of such clusters it holds at once
    (0: it cannot run one).  A shard's cluster depends on K and O alone,
    never on n, so a shard-batched launch sums each shard's cost in the
    order of that shard's single-device launch: the fewest CTAs (a power
    of two, up to AGG_MAX_CLUSTER and no more than K, so no CTA is without
    a slot) whose slots and bins each take at most AGG_CTA_SPAN — on an
    H100 one CTA is as fast as any cluster up to the headline's 8192 slots
    and faster on the megafleet's 4096 a shard (a cluster's two barriers),
    and a cluster of 4-8 beats one CTA at 32 768 — or fewer where the card
    refuses.  None past the kernel's limits or when the histogram does not
    fit a CTA."""
    smem = O * 4
    if not (K >= 0 and O > 0 and 0 < n <= 65535
            and smem + AGG_STATIC_SMEM <= smem_optin):
        return None
    cs = 1
    while (cs < AGG_MAX_CLUSTER and 2 * cs <= K
           and cs * AGG_CTA_SPAN < max(K, O)):
        cs *= 2
    while cs > 1 and clusters(cs, AGG_THREADS, smem) < 1:
        cs //= 2
    if clusters(cs, AGG_THREADS, smem) < 1:
        return None
    return AggregatePlan(cluster=cs, threads=AGG_THREADS,
                         per_cta=max(1, -(-K // cs)), smem=smem)


@functools.lru_cache(maxsize=None)
def _aggregate_clusters(index: int, cs: int, T: int, smem: int) -> int:
    """The card's count of K4 clusters of this layout at once; 0 where it
    refuses the layout."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _lib().kp_aggregate_clusters(cs, T, smem, ctypes.byref(out))
    return 0 if err else out.value


@functools.lru_cache(maxsize=1024)
def _aggregate_plan_at(index: int, K: int, O: int,
                       n: int) -> Optional[AggregatePlan]:
    return aggregate_plan(K, O, n, _slab_budget(index)[1],
                          lambda cs, T, b: _aggregate_clusters(index, cs, T, b))


def aggregate_plan_for(dev: torch.device, K: int, O: int,
                       n: int) -> AggregatePlan:
    """`aggregate_plan` on card `dev`, kept per shape; raises
    KernelLimitError when nothing fits."""
    plan = _aggregate_plan_at(_device_index(dev), K, O, n)
    if plan is None:
        raise KernelLimitError(
            f"classpack_aggregate: no cluster for K={K}, O={O}, n={n}")
    return plan


def _launch_aggregate(name, n, slot_option, price, n_open, n_unsched,
                      sc_ss, shape) -> torch.Tensor:
    """One K4 launch over n shards (operands checked by the caller).
    Returns floats of `shape` (n × (3 + O) in memory)."""
    K = slot_option.shape[-1]
    O = price.shape[0]
    dev = price.device
    plan = aggregate_plan_for(dev, K, O, n)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    with _at(dev):
        err = _lib().kp_aggregate(
            _ptr(slot_option), _ptr(price), _ptr(n_open), _ptr(n_unsched),
            sc_ss, n, K, O, plan.cluster, plan.threads, plan.per_cta,
            _ptr(out), _stream(dev))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def aggregate_sum_model(slot_option, price, plan: AggregatePlan):
    """K4's result on one shard's slots under `plan` (numpy): the float32
    cost in the kernel's order — CTA r's run [r · per, ...), thread t
    adding its slots t, t + threads, ... in order, a butterfly of each
    warp's lanes (lane i adds lane i ^ d, d = 16 .. 1), the same butterfly
    over the warps' partials on warp 0 (zeros past the last warp), then
    the CTAs' partials in rank order — and the launched slots per option
    (exact).  Returns (cost np.float32, counts int64 O)."""
    f32 = np.float32
    so = np.asarray(slot_option, np.int64)
    price = np.asarray(price, f32)
    K, O = so.shape[0], price.shape[0]
    T, cs, per = plan.threads, plan.cluster, plan.per_cta
    p = np.where(so >= 0, price[np.maximum(so, 0)], f32(np.inf))
    launched = (so >= 0) & np.isfinite(p)
    lanes = np.arange(32)

    def butterfly(v):   # v: (..., 32) float32
        for d in (16, 8, 4, 2, 1):
            v = v + v[..., lanes ^ d]
        return v[..., 0]
    parts = []
    for r in range(cs):
        lo, hi = min(K, r * per), min(K, r * per + per)
        acc = np.zeros(T, f32)
        for j in range(lo, hi, T):
            n = min(T, hi - j)
            acc[:n] = np.where(launched[j:j + n], acc[:n] + p[j:j + n],
                               acc[:n])
        warps = butterfly(acc.reshape(T // 32, 32))
        w = np.zeros(32, f32)
        w[:T // 32] = warps
        parts.append(butterfly(w))
    cost = parts[0]
    for x in parts[1:]:
        cost = f32(cost + x)
    counts = np.bincount(so[launched], minlength=O)
    return f32(cost), counts


# ---------------------------------------------------------------------------
# K5 classpack_sweep
# ---------------------------------------------------------------------------

def classpack_sweep_plain(requests, counts_b, compat_packed, node_cap, alloc,
                          price, rank, col_mask_packed, price_cap_b,
                          init_option, init_used, m_all, max_nodes: int):
    """B masked aggregate solves, all rows stepped together: the scan of
    `classpack_scan_plain` with a batch axis, where each class step touches
    only the rows whose count for it is non-zero (a zero-count class is an
    exact no-op, as in the kernel)."""
    B, C = counts_b.shape
    O, R = alloc.shape
    K = max_nodes
    dev = requests.device
    i32, f32 = torch.int32, torch.float32
    compat = unpack_bits(compat_packed, O)
    mask = unpack_bits(col_mask_packed, O)
    pr = torch.where(mask & (price[None, :] < price_cap_b[:, None]),
                     price[None, :], float("inf"))
    pr_ok = torch.isfinite(pr)
    idx = torch.arange(K, dtype=i32, device=dev)
    opt0 = init_option.clamp(min=0).long()
    slot_option = init_option[None, :].repeat(B, 1)
    slot_free = torch.where((init_option >= 0)[:, None], alloc[opt0] - init_used,
                            0)[None].repeat(B, 1, 1)
    n_open = (slot_option >= 0).sum(1, dtype=i32)
    n_unsched = torch.zeros(B, dtype=i32, device=dev)
    cap_score = torch.tensor(SCORE_CAP, dtype=f32, device=dev)
    active = counts_b > 0
    for c in torch.nonzero(active.any(0)).flatten().tolist():
        rows = torch.nonzero(active[:, c]).flatten()
        cnt = counts_b[rows, c]
        req, cap = requests[c], node_cap[c]
        so, sf, no = slot_option[rows], slot_free[rows], n_open[rows]
        mrows = mask[rows]
        opt = so.clamp(min=0).long()
        reqpos = req > 0
        safe = torch.where(reqpos, req, torch.ones_like(req))
        fit = torch.where(reqpos, torch.div(sf, safe, rounding_mode="floor"),
                          BIG).amin(dim=-1)
        fit = torch.minimum(fit, cap)
        fit = torch.where((so >= 0) & compat[c][opt] & mrows.gather(1, opt),
                          fit.clamp(min=0), 0)
        prefix = torch.cumsum(fit, 1, dtype=i32) - fit
        take = torch.minimum((cnt[:, None] - prefix).clamp(min=0), fit)
        remaining = cnt - take.sum(1, dtype=i32)
        # this row's launchable options at its own best pool rank
        m = m_all[c]
        ok = compat[c][None, :] & mrows & (m > 0)[None, :] & pr_ok[rows]
        best = torch.where(ok, rank[None, :], BIG).amin(dim=1)
        ok = ok & (rank[None, :] == best[:, None])
        m_safe = m.clamp(min=1)
        nodes_needed = torch.div(remaining.clamp(min=1)[:, None] + m_safe - 1,
                                 m_safe, rounding_mode="floor")
        score = torch.where(
            ok, torch.minimum(pr[rows] * nodes_needed.to(f32), cap_score),
            float("inf"))
        j = torch.argmin(score, dim=1)
        can = torch.isfinite(score.gather(1, j[:, None])[:, 0])
        m_sel = m[j].clamp(min=1)
        needed = torch.where(can & (remaining > 0),
                             torch.div(remaining + m_sel - 1, m_sel,
                                       rounding_mode="floor"), 0)
        n_new = torch.minimum(needed, K - no)
        sched_new = torch.minimum(remaining, n_new * m_sel)
        is_new = (idx[None, :] >= no[:, None]) & \
            (idx[None, :] < (no + n_new)[:, None])
        pods_on = torch.where(is_new, m_sel[:, None], 0)
        rem_last = sched_new - (n_new - 1) * m_sel
        pods_on = torch.where(is_new & (idx[None, :] == (no + n_new - 1)[:, None]),
                              rem_last[:, None], pods_on)
        slot_option[rows] = torch.where(is_new, j.to(i32)[:, None], so)
        sf = sf - take[:, :, None] * req
        slot_free[rows] = torch.where(
            is_new[:, :, None],
            alloc[j][:, None, :] - pods_on[:, :, None] * req, sf)
        n_open[rows] = no + n_new
        n_unsched[rows] = n_unsched[rows] + (remaining - sched_new)
    p = pr.gather(1, slot_option.clamp(min=0).long())
    launched = (slot_option >= 0) & torch.isfinite(p)
    cost = torch.where(launched, p, 0.0).sum(1)
    return torch.stack([cost, launched.sum(1).to(f32), n_unsched.to(f32)], 1)


# --- the plan of a K5 launch (a host function, tested on the CPU) ---

SWEEP_MAX_SLOTS = 8192    # kp_sweep_max_slots()
SWEEP_THREADS = 512       # a row's block (on an H100 a row's step is shorter
#                           than at 256 threads, at 32, 128 and 512 rows)
SWEEP_STATIC_SMEM = 6144  # the kernel's own shared memory, rounded up


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """How K5 runs each row: one block of SWEEP_THREADS threads, each
    holding `slots_per_thread` contiguous slots; the row's slot state
    (`state_smem`) and invariants (`inv_smem`: the masked price and the
    rank of every option) in shared memory or in global slices; the class inputs
    staged one class ahead (`stage`) or read in place; `smem` dynamic bytes
    a block."""
    threads: int
    slots_per_thread: int
    state_smem: bool
    inv_smem: bool
    stage: bool
    smem: int

    def state_ints(self, R: int) -> int:
        return self.slots_per_thread * self.threads * (R + 1)


def sweep_smem_bytes(threads: int, S: int, R: int, O: int, state_smem: bool,
                     inv_smem: bool, stage: bool) -> int:
    """A K5 block's dynamic shared memory, as the kernel carves it."""
    n = 0
    if state_smem:
        n += S * threads * (R + 1) * 4
    if inv_smem:
        n += O * 8
    if stage:
        n += (O + 7) // 8 + 3 * _ring_bytes(O, False)
    return n


def sweep_plan(K: int, R: int, O: int, B: int, sms: int, smem_optin: int,
               max_blocks: Callable[[int, int, int], int],
               aligned: bool = True) -> Optional[SweepPlan]:
    """The layout of a K5 launch of B rows of K slots, R axes and O options
    on a card of `sms` SMs whose blocks may opt into `smem_optin` bytes;
    `max_blocks(threads, S, smem)` is how many such blocks one SM holds.
    In order of
    preference: everything in shared memory, then without the staging,
    then without the invariants, then the slot state in a global slice.
    None past the kernel's limits (K, R) or when nothing fits."""
    if not (0 < K <= SWEEP_MAX_SLOTS and 0 < R <= MAX_R and O > 0 and B > 0
            and sms > 0):
        return None
    T = SWEEP_THREADS
    S = 1
    while S * T < K:
        S *= 2
    stage_ok = aligned and O % 128 == 0
    for state_smem, inv_smem, stage in (
            (True, True, True), (True, True, False), (True, False, False),
            (False, True, True), (False, True, False), (False, False, False)):
        if stage and not stage_ok:
            continue
        smem = sweep_smem_bytes(T, S, R, O, state_smem, inv_smem, stage)
        if smem + SWEEP_STATIC_SMEM > smem_optin:
            continue
        if max_blocks(T, S, smem) < 1:
            continue
        return SweepPlan(threads=T, slots_per_thread=S, state_smem=state_smem,
                         inv_smem=inv_smem, stage=stage, smem=smem)
    return None


@functools.lru_cache(maxsize=None)
def _sweep_blocks(index: int, T: int, S: int, smem: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        _raise_on(_lib().kp_sweep_blocks(T, S, smem, ctypes.byref(out)),
                  "classpack_sweep")
    return out.value


def classpack_sweep(requests: torch.Tensor, counts_b: torch.Tensor,
                    compat_packed: torch.Tensor, node_cap: torch.Tensor,
                    alloc: torch.Tensor, price: torch.Tensor,
                    rank: torch.Tensor, col_mask_packed: torch.Tensor,
                    price_cap_b: torch.Tensor, init_option: torch.Tensor,
                    init_used: torch.Tensor, m_all: torch.Tensor,
                    max_nodes: int) -> torch.Tensor:
    """float32 B×3 [cost, n_new, n_unsched]: row b solves the shared class
    arrays with its own counts (`counts_b` B×C), column mask (`col_mask_packed`
    B×ceil(O/8), np.packbits order) and strict price cap (`price_cap_b` B),
    from the shared pre-opened slots (`init_option` K, `init_used` K×R).
    `m_all` (C×O pods per fresh node) is K1's."""
    if not _on_cuda(requests, counts_b, compat_packed, node_cap, alloc, price,
                    rank, col_mask_packed, price_cap_b, init_option,
                    init_used, m_all):
        return classpack_sweep_plain(requests, counts_b, compat_packed,
                                     node_cap, alloc, price, rank,
                                     col_mask_packed, price_cap_b,
                                     init_option, init_used, m_all, max_nodes)
    B, C = counts_b.shape
    R = requests.shape[1]
    O = alloc.shape[0]
    K = int(max_nodes)
    if not (0 < R <= MAX_R and 0 < K <= SWEEP_MAX_SLOTS):
        raise KernelLimitError(
            f"R={R} / K={K} outside the sweep kernel's limits "
            f"({MAX_R} axes, {SWEEP_MAX_SLOTS} slots)")
    if B == 0 or C == 0 or O == 0:
        raise KernelContractError(f"empty sweep: B={B}, C={C}, O={O}")
    _check(requests, "requests", torch.int32, (C, R))
    _check(counts_b, "counts_b", torch.int32, (B, C))
    _check(compat_packed, "compat_packed", torch.uint8, (C, (O + 7) // 8))
    _check(node_cap, "node_cap", torch.int32, (C,))
    _check(alloc, "alloc", torch.int32, (O, R))
    _check(price, "price", torch.float32, (O,))
    _check(rank, "rank", torch.int32, (O,))
    _check(col_mask_packed, "col_mask_packed", torch.uint8, (B, (O + 7) // 8))
    _check(price_cap_b, "price_cap_b", torch.float32, (B,))
    _check(init_option, "init_option", torch.int32, (K,))
    _check(init_used, "init_used", torch.int32, (K, R))
    _check(m_all, "m_all", torch.int32, (C, O))
    dev = requests.device
    plan = sweep_plan_for(dev, K, R, O, B,
                          _aligned(compat_packed, m_all, col_mask_packed))
    # per-row slot state and invariants spill to global slices only past
    # the plan's shared memory
    g_state = None if plan.state_smem else torch.empty(
        (B, plan.state_ints(R)), dtype=torch.int32, device=dev)
    g_inv = None if plan.inv_smem else torch.empty(
        (B, 2 * O), dtype=torch.int32, device=dev)
    out = torch.empty((B, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().kp_sweep(
            _ptr(requests), _ptr(counts_b), _ptr(compat_packed),
            _ptr(node_cap), _ptr(alloc), _ptr(price), _ptr(rank),
            _ptr(col_mask_packed), _ptr(price_cap_b), _ptr(init_option),
            _ptr(init_used), _ptr(m_all), B, C, O, R, K, plan.threads,
            plan.slots_per_thread, int(plan.state_smem), int(plan.inv_smem),
            int(plan.stage), plan.smem, _ptr(g_state), _ptr(g_inv), _ptr(out),
            _stream(dev))
    _raise_on(err, "classpack_sweep")
    LAUNCHES["classpack_sweep"] += 1
    return out


def sweep_plan_for(dev: torch.device, K: int, R: int, O: int, B: int,
                   aligned: bool = True) -> SweepPlan:
    """`sweep_plan` on card `dev`; raises KernelLimitError when nothing
    fits."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    sms, smem = _slab_budget(index)
    plan = sweep_plan(K, R, O, B, sms, smem,
                      lambda T, S, b: _sweep_blocks(index, T, S, b),
                      aligned=aligned)
    if plan is None:
        raise KernelLimitError(f"classpack_sweep: no layout for K={K}, "
                               f"R={R}, O={O}, B={B}")
    return plan


# ---------------------------------------------------------------------------
# K6 classpack_slab
# ---------------------------------------------------------------------------

def classpack_slab_plain(assignment, max_nodes: int):
    """The reference's slab sort: key = slot, or K for an unplaced row; the
    composite key·n + row sorted when (K+1)·n < 2^31, else a stable argsort
    of the key (both give the same order); slot_counts from a K+1-bin
    scatter-add with the overflow bin sliced off."""
    K = int(max_nodes)
    n = assignment.shape[0]
    dev = assignment.device
    a = assignment.to(torch.int32)
    key = torch.where(a >= 0, a, K)
    if (K + 1) * n < 2**31:
        comp = key * n + torch.arange(n, dtype=torch.int32, device=dev)
        order = (torch.sort(comp).values % n).to(torch.int32)
    else:
        order = torch.argsort(key, stable=True).to(torch.int32)
    counts = torch.zeros(K + 1, dtype=torch.int32, device=dev).index_add_(
        0, key.long(), torch.ones(n, dtype=torch.int32, device=dev))
    return order, counts[:K]


SLAB_WARPS = 8          # warps of a scatter block, at most
SLAB_TILE = 256         # keys per scan block


@dataclasses.dataclass(frozen=True)
class SlabPlan:
    """How K6 cuts each shard's rows: `blocks` row blocks of `seg` rows
    (the last may hold fewer, none is empty), scatter blocks of `warps`
    warps."""
    blocks: int
    seg: int
    warps: int


def slab_plan(n: int, K: int, n_shards: int, sms: int,
              smem: int) -> Optional[SlabPlan]:
    """The row blocks of a K6 launch over `n_shards` shards of `n` rows and
    K + 1 keys, on a card of `sms` SMs whose blocks may opt into `smem`
    bytes of shared memory; None past the kernel's limits.  About one
    block per SM over all shards, each of about K + 1 rows or more, so the
    work per key (a histogram row per block, W warp tables) stays small
    beside the rows; the scatter block takes as many warps (at most
    SLAB_WARPS) as W tables of K + 1 counts fit its shared memory."""
    keys = K + 1
    tiles = -(-keys // SLAB_TILE)
    if min(n, K, n_shards, sms) <= 0 or keys * 4 > smem:
        return None
    warps = min(SLAB_WARPS, (smem // 4 - tiles) // keys)
    if warps < 1:
        return None
    per_shard = max(1, sms // n_shards)
    seg = max(-(-n // per_shard), keys, 32 * warps)
    blocks = -(-n // seg)
    seg = -(-n // blocks)
    return SlabPlan(blocks=-(-n // seg), seg=seg, warps=warps)


@functools.lru_cache(maxsize=None)
def _slab_budget(index: int) -> Tuple[int, int]:
    """(SMs, opt-in shared memory per block) of card `index`."""
    sms, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        _raise_on(_lib().kp_slab_budget(ctypes.byref(sms),
                                        ctypes.byref(smem)), "classpack_slab")
    return sms.value, smem.value


def _launch_slab(assignment: torch.Tensor, n_sh: int, n: int, K: int,
                 name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = assignment.device
    plan = slab_plan(n, K, n_sh, *_slab_budget(dev.index))
    if plan is None:
        raise KernelLimitError(f"{name}: K={K} outside the slab kernel's "
                               f"shared memory")
    keys = K + 1
    chunk_counts = torch.empty((n_sh, plan.blocks, keys), dtype=torch.int32,
                               device=dev)
    key_first = torch.empty((n_sh, keys), dtype=torch.int32, device=dev)
    tile_sum = torch.empty((n_sh, -(-keys // SLAB_TILE)), dtype=torch.int32,
                           device=dev)
    order = torch.empty((n_sh, n), dtype=torch.int32, device=dev)
    slot_counts = torch.empty((n_sh, K), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().kp_slab(_ptr(assignment),
                             int(assignment.dtype == torch.int16), n_sh, n, K,
                             plan.blocks, plan.seg, plan.warps,
                             _ptr(chunk_counts), _ptr(key_first),
                             _ptr(tile_sum), _ptr(order), _ptr(slot_counts),
                             _stream(dev))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return order, slot_counts


def classpack_slab(assignment: torch.Tensor, max_nodes: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order n int32, slot_counts K int32) of K3's per-row slots
    (`assignment`, n int16 or int32, −1 unplaced, each < K): the rows
    stable-sorted by key = slot, or K for unplaced and padded rows, and the
    rows per slot."""
    if not _on_cuda(assignment):
        return classpack_slab_plain(assignment, max_nodes)
    K = int(max_nodes)
    n = assignment.shape[0]
    if assignment.dtype not in (torch.int16, torch.int32):
        raise KernelContractError(f"assignment: dtype {assignment.dtype}, "
                                  f"expected int16 or int32")
    if assignment.dim() != 1 or not assignment.is_contiguous():
        raise KernelContractError("assignment: not a contiguous vector")
    if n == 0 or K <= 0:
        raise KernelContractError(f"empty slab: n={n}, K={K}")
    order, slot_counts = _launch_slab(assignment, 1, n, K, "classpack_slab")
    return order[0], slot_counts[0]


# ---------------------------------------------------------------------------
# the shard-batched launches (rows 13-17) and K8 shard_psum
# ---------------------------------------------------------------------------

def _shard_stride(t: torch.Tensor, name: str, dtype: torch.dtype,
                  shape) -> int:
    """Element stride between the shards of `t` (n × …): a stack of
    contiguous shards (stride = one shard's size) or one copy shared by
    every shard (stride 0, an `expand`ed view)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    size = 1
    for d in shape[1:]:
        size *= int(d)
    if not t[0].is_contiguous() or (shape[0] > 1
                                    and t.stride(0) not in (0, size)):
        raise ValueError(f"{name}: shards neither contiguous nor shared "
                         f"(strides {t.stride()})")
    return t.stride(0) if shape[0] > 1 else 0


class ShardLayoutError(KernelContractError):
    """A shard-batched wrapper was given operands that break its contract
    (dtype, shape, shard layout, device): the KernelContractError of the
    shard-batched wrappers, which the partitioned driver raises instead of
    answering the batch on the single-device path."""


def _shard_contract(fn):
    """Raise every contract fault, TypeError or ValueError of a
    shard-batched wrapper as a ShardLayoutError (see there); kernel faults
    pass unchanged."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except KernelContractError as e:
            raise ShardLayoutError(f"{fn.__name__}: {e}") from e
        except KernelError:
            raise
        except (TypeError, ValueError) as e:
            raise ShardLayoutError(f"{fn.__name__}: {e}") from e
    return run


def _strides(*vals) -> ctypes.Array:
    return (ctypes.c_longlong * 8)(*vals)


def _check_shards(n: int) -> None:
    if not 0 < n <= 65535:
        raise KernelLimitError(f"{n} shards: a launch takes 1-65535")


def classpack_precompute_sharded_plain(requests, node_cap, compat_packed,
                                       alloc, price, rank):
    outs = [classpack_precompute_plain(requests[s], node_cap[s],
                                       compat_packed[s], alloc, price, rank)
            for s in range(requests.shape[0])]
    return (torch.stack([m for m, _ in outs]),
            torch.stack([ok for _, ok in outs]))


@_shard_contract
def classpack_precompute_sharded(requests: torch.Tensor,
                                 node_cap: torch.Tensor,
                                 compat_packed: torch.Tensor,
                                 alloc: torch.Tensor, price: torch.Tensor,
                                 rank: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 over n shards in one launch: requests n×C×R, node_cap n×C,
    compat_packed n×C×ceil(O/8) → (m n×C×O, ok n×C×O).  When every
    per-shard operand is shared, so are the outputs: one shard is computed
    and returned expanded over n (stride 0)."""
    if not _on_cuda(requests, node_cap, compat_packed, alloc, price, rank):
        return classpack_precompute_sharded_plain(
            requests, node_cap, compat_packed, alloc, price, rank)
    n, C, R = requests.shape
    O = alloc.shape[0]
    _check_shards(n)
    if R > MAX_R:
        raise KernelLimitError(
            f"R={R} resource axes exceed the kernel's {MAX_R}")
    ss_req = _shard_stride(requests, "requests", torch.int32, (n, C, R))
    ss_cap = _shard_stride(node_cap, "node_cap", torch.int32, (n, C))
    ss_cmp = _shard_stride(compat_packed, "compat_packed", torch.uint8,
                           (n, C, (O + 7) // 8))
    _check(alloc, "alloc", torch.int32, (O, R))
    _check(price, "price", torch.float32, (O,))
    _check(rank, "rank", torch.int32, (O,))
    shared = ss_req == ss_cap == ss_cmp == 0
    n_run = 1 if shared else n
    m, ok = _launch_precompute(
        "classpack_precompute_sharded", n_run, requests, node_cap,
        compat_packed, alloc, price, rank,
        _strides(ss_req, 0, ss_cmp, ss_cap, 0, 0, 0, 0), True, (n_run, C, O))
    return m.expand(n, C, O), ok.expand(n, C, O)


def classpack_scan_sharded_plain(requests, counts, compat_packed, node_cap,
                                 alloc, price, m_all, ok_all, init_option,
                                 init_used, max_nodes: int, emit_takes: bool):
    outs = [classpack_scan_plain(
        requests[s], counts[s], compat_packed[s], node_cap[s], alloc, price,
        m_all[s], ok_all[s], None if init_option is None else init_option[s],
        None if init_used is None else init_used[s], max_nodes, emit_takes)
        for s in range(counts.shape[0])]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(5))


@_shard_contract
def classpack_scan_sharded(requests: torch.Tensor, counts: torch.Tensor,
                           compat_packed: torch.Tensor,
                           node_cap: torch.Tensor, alloc: torch.Tensor,
                           price: torch.Tensor, m_all: torch.Tensor,
                           ok_all: torch.Tensor,
                           init_option: Optional[torch.Tensor],
                           init_used: Optional[torch.Tensor],
                           max_nodes: int, emit_takes: bool = False):
    """K2 over n shards in one launch, one cluster per shard: requests n×C×R,
    counts n×C, compat_packed n×C×ceil(O/8), node_cap n×C, m_all / ok_all
    n×C×O (K1's), init_option n×K / init_used n×K×R or None (all slots
    closed).  Returns (slot_option n×K, slot_used n×K×R, n_open n,
    n_unsched n, takes n×C×K when `emit_takes`, else n×C)."""
    if (init_option is None) != (init_used is None):
        raise ValueError("init_option and init_used come together")
    if not _on_cuda(requests, counts, compat_packed, node_cap, alloc, price,
                    m_all, ok_all, init_option, init_used):
        return classpack_scan_sharded_plain(
            requests, counts, compat_packed, node_cap, alloc, price, m_all,
            ok_all, init_option, init_used, max_nodes, emit_takes)
    n, C, R = requests.shape
    O = alloc.shape[0]
    K = int(max_nodes)
    _check_shards(n)
    _check_scan_limits(K, R)
    st = [_shard_stride(requests, "requests", torch.int32, (n, C, R)),
          _shard_stride(counts, "counts", torch.int32, (n, C)),
          _shard_stride(compat_packed, "compat_packed", torch.uint8,
                        (n, C, (O + 7) // 8)),
          _shard_stride(node_cap, "node_cap", torch.int32, (n, C)),
          _shard_stride(m_all, "m_all", torch.int32, (n, C, O)),
          _shard_stride(ok_all, "ok_all", torch.uint8, (n, C, O)), 0, 0]
    _check(alloc, "alloc", torch.int32, (O, R))
    _check(price, "price", torch.float32, (O,))
    if init_option is not None:
        st[6] = _shard_stride(init_option, "init_option", torch.int32, (n, K))
        st[7] = _shard_stride(init_used, "init_used", torch.int32, (n, K, R))
    slot_option, slot_used, scalars, takes = _launch_scan(
        "classpack_scan_sharded", n, requests, counts, compat_packed,
        node_cap, alloc, price, m_all, ok_all, init_option, init_used, K,
        emit_takes, _strides(*st))
    return slot_option, slot_used, scalars[:, 0], scalars[:, 1], takes


def classpack_assign_decode_sharded_plain(takes, counts, n_pods: int):
    return torch.stack([classpack_assign_decode_plain(takes[s], counts[s],
                                                      n_pods)
                        for s in range(takes.shape[0])])


@_shard_contract
def classpack_assign_decode_sharded(takes: torch.Tensor, counts: torch.Tensor,
                                    n_pods: int) -> torch.Tensor:
    """K3 over n shards in one launch: per-pod slots n×n_pods (int16 when
    K < 2^15, else int32) from the takes n×C×K and counts n×C."""
    if not _on_cuda(takes, counts):
        return classpack_assign_decode_sharded_plain(takes, counts, n_pods)
    n, C, K = takes.shape
    _check_shards(n)
    _check(takes, "takes", torch.int32, (n, C, K))
    cnt_ss = _shard_stride(counts, "counts", torch.int32, (n, C))
    lib = _lib()
    _check_decode_slots(lib, K)
    dev = takes.device
    out16 = K < 2**15
    out = torch.empty((n, n_pods),
                      dtype=torch.int16 if out16 else torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.kp_assign_decode(
            _ptr(takes), _ptr(counts), cnt_ss, n, C, K, int(n_pods),
            int(out16), _ptr(out), _stream(dev))
    _raise_on(err, "classpack_assign_decode_sharded")
    LAUNCHES["classpack_assign_decode_sharded"] += 1
    return out


def classpack_aggregate_sharded_plain(slot_option, price, n_open, n_unsched):
    return torch.stack([classpack_aggregate_plain(slot_option[s], price,
                                                  n_open[s], n_unsched[s])
                        for s in range(slot_option.shape[0])])


@_shard_contract
def classpack_aggregate_sharded(slot_option: torch.Tensor,
                                price: torch.Tensor, n_open: torch.Tensor,
                                n_unsched: torch.Tensor) -> torch.Tensor:
    """K4 over n shards in one launch, one cluster per shard: float32
    n×(3+O), each row [total_cost, n_open, n_unsched, nodes_per_option…]
    of its shard (slot_option n×K; n_open, n_unsched: K2's n-vectors)."""
    if not _on_cuda(slot_option, price, n_open, n_unsched):
        return classpack_aggregate_sharded_plain(slot_option, price, n_open,
                                                 n_unsched)
    n, K = slot_option.shape
    O = price.shape[0]
    _check_shards(n)
    _check(slot_option, "slot_option", torch.int32, (n, K))
    _check(price, "price", torch.float32, (O,))
    for t, name in ((n_open, "n_open"), (n_unsched, "n_unsched")):
        if t.dtype != torch.int32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name}: expected int32 ({n},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    if n > 1 and n_open.stride(0) != n_unsched.stride(0):
        raise ValueError("n_open and n_unsched: strides differ")
    sc_ss = n_open.stride(0) if n > 1 else 0
    return _launch_aggregate("classpack_aggregate_sharded", n, slot_option,
                             price, n_open, n_unsched, sc_ss, (n, 3 + O))


def classpack_slab_sharded_plain(assignment, max_nodes: int):
    outs = [classpack_slab_plain(assignment[s], max_nodes)
            for s in range(assignment.shape[0])]
    return (torch.stack([o for o, _ in outs]),
            torch.stack([c for _, c in outs]))


@_shard_contract
def classpack_slab_sharded(assignment: torch.Tensor, max_nodes: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 over n shards in one launch: (order n×rows int32, slot_counts n×K
    int32) of K3's per-shard slots (`assignment` n×rows, int16 or int32)."""
    if not _on_cuda(assignment):
        return classpack_slab_sharded_plain(assignment, max_nodes)
    K = int(max_nodes)
    if assignment.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"assignment: dtype {assignment.dtype}, expected "
                        f"int16 or int32")
    if assignment.dim() != 2 or not assignment.is_contiguous():
        raise ValueError("assignment: not a contiguous n × rows matrix")
    n_sh, n = assignment.shape
    _check_shards(n_sh)
    if n == 0 or K <= 0:
        raise ValueError(f"empty slab: n={n}, K={K}")
    return _launch_slab(assignment, n_sh, n, K, "classpack_slab_sharded")


def shard_psum_plain(flat, hosts: int):
    """The kernel's order: per host the left fold over its chips, then the
    left fold of the host partials."""
    n = flat.shape[0]
    chips = n // hosts
    total = None
    for h in range(hosts):
        part = flat[h * chips]
        for c in range(1, chips):
            part = part + flat[h * chips + c]
        total = part if total is None else total + part
    return total


@_shard_contract
def shard_psum(flat: torch.Tensor, hosts: int = 1) -> torch.Tensor:
    """K8: the sum over the n shards of their flat float32 vectors
    (`flat` n×L, shard-major, host-major over a (hosts × n/hosts) mesh),
    reduced over the mesh's innermost axis (chips) first, then over hosts
    — `for ax in reversed(axes): psum` on one card.  Returns L floats."""
    n, L = flat.shape
    if hosts <= 0 or n % hosts:
        raise ValueError(f"{n} shards do not lay out over {hosts} hosts")
    if not _on_cuda(flat):
        return shard_psum_plain(flat, hosts)
    _check(flat, "flat", torch.float32, (n, L))
    if L == 0:
        raise ValueError("empty flat vectors")
    lib = _lib()
    dev = flat.device
    out = torch.empty(L, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.kp_shard_psum(_ptr(flat), hosts, n // hosts, L, _ptr(out),
                                _stream(dev))
    _raise_on(err, "shard_psum")
    LAUNCHES["shard_psum"] += 1
    return out
