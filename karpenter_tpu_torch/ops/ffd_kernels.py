"""Wrapper of the pod-granular FFD scan kernel (csrc/ffd.cu).

K7 `ffd_scan` replaces the JAX package's `ops/ffd.py:ffd_pack_kernel`
(:43-118), the `lax.scan` over FFD-sorted pod rows.  As the class-granular
wrappers do (ops/classpack_kernels.py), it has

  * a plain PyTorch version of the same function (`ffd_scan_plain`), which
    it runs ONLY when its tensors lie on the CPU — the CPU tests use it, and
    `chip_smoke.py` holds the kernel against it on the card;
  * a launch counter (`LAUNCHES["ffd_scan"]`), raised by one exactly where
    the wrapper launches its kernel;
  * on CUDA tensors, the kernel itself, or an exception: there is no
    fallback to the plain version on the card.

The compat matrix is given per compat ROW, not per pod: `compat_packed` is
T × ceil(O/8) bits (np.packbits order) and `compat_row[i]` names pod row
i's entry.  `solve_ffd` passes the class-level table (C rows), so the
P × O boolean matrix of the reference (180 MB at 50k pods × 3600 columns)
is never built.

The slot state is float32 and matches the reference bit for bit: IEEE
adds, divides and products in the reference's order (round-to-nearest
intrinsics, which the compiler never contracts into an FMA), `argmax` /
`argmin` ties to the lowest index, and +inf / NaN prices excluded from new
nodes by `isfinite`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .._build import KernelError, KernelLimitError
from .classpack_kernels import _check, _on_cuda, _ptr, _stream, unpack_bits
from .ffd import NO_ASSIGNMENT, SCORE_CAP

IBIG = 2**30

KERNELS = ("ffd_scan",)
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from .._build import load
        lib = load("ffd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ffd_error_string.argtypes = [i]
        lib.ffd_error_string.restype = ctypes.c_char_p
        lib.ffd_max_r.restype = i
        lib.ffd_scratch_bytes.argtypes = [i] * 4
        lib.ffd_scratch_bytes.restype = ctypes.c_longlong
        lib.ffd_scan.argtypes = [p] * 12 + [i] * 5 + [p] * 5 + [p]
        lib.ffd_scan.restype = i
        lib.ffd_step_cycles.argtypes = [i, p, p]
        lib.ffd_step_cycles.restype = i
        _LIB = lib
    return _LIB


def ffd_scan_plain(requests, compat_packed, compat_row, class_id, valid,
                   node_cap, rem, alloc, price, rank, init_option, init_used,
                   max_nodes: int):
    """The reference scan step by step (`ffd_pack_kernel`), one pod row at
    a time.  A row that places nothing leaves the state as it was (the
    reference adds 0.0 to a slot and re-sets its option)."""
    P, R = requests.shape
    O = alloc.shape[0]
    K = int(max_nodes)
    dev = requests.device
    i32, f32 = torch.int32, torch.float32
    compat = unpack_bits(compat_packed, O)
    if init_option is None:
        slot_option = torch.full((K,), -1, dtype=i32, device=dev)
        slot_used = torch.zeros((K, R), dtype=f32, device=dev)
    else:
        slot_option = init_option.clone()
        slot_used = init_used.clone()
    slot_cls = torch.zeros(K, dtype=i32, device=dev)
    n_open = int((slot_option >= 0).sum())
    assignment = torch.full((P,), NO_ASSIGNMENT, dtype=i32, device=dev)
    finite = torch.isfinite(price)
    big = torch.tensor(float(IBIG), dtype=f32, device=dev)
    one = torch.tensor(1.0, dtype=f32, device=dev)
    cap_score = torch.tensor(SCORE_CAP, dtype=f32, device=dev)
    rows = list(zip(class_id.tolist(), valid.tolist(), node_cap.tolist(),
                    compat_row.tolist(), rem.tolist()))
    prev = -1
    for i, (cid, ok_row, cap, crow, tail) in enumerate(rows):
        if cid != prev:
            slot_cls.zero_()
        prev = cid
        if not ok_row:
            continue
        req = requests[i]
        comp = compat[crow]
        opt = slot_option.clamp(min=0).long()
        fits = ((slot_option >= 0) & comp[opt] & (slot_cls < cap)
                & ((slot_used + req) <= alloc[opt]).all(-1))
        hit = torch.nonzero(fits)
        if len(hit):
            k = int(hit[0, 0])
        else:
            new_ok = comp & (req[None, :] <= alloc).all(-1) & finite
            if n_open >= K or not bool(new_ok.any()):
                continue
            best = torch.where(new_ok, rank, IBIG).amin()
            ok_r = new_ok & (rank == best)
            reqpos = req > 0
            safe = torch.where(reqpos, req, one)
            m = torch.where(reqpos[None, :], torch.floor(alloc / safe[None, :]),
                            big).amin(-1)
            hi = torch.maximum(torch.tensor(float(cap), dtype=f32, device=dev),
                               one)
            m = torch.minimum(torch.maximum(m, one), hi)
            t = torch.tensor(float(max(tail, 1)), dtype=f32, device=dev)
            score = torch.minimum(price * torch.ceil(t / m), cap_score)
            k = n_open
            slot_option[k] = torch.argmin(
                torch.where(ok_r, score, float("inf"))).to(i32)
            n_open += 1
        slot_used[k] += req
        slot_cls[k] += 1
        assignment[i] = k
    return (assignment, slot_option, slot_used,
            torch.tensor(n_open, dtype=i32, device=dev))


def ffd_scan(requests: torch.Tensor, compat_packed: torch.Tensor,
             compat_row: torch.Tensor, class_id: torch.Tensor,
             valid: torch.Tensor, node_cap: torch.Tensor, rem: torch.Tensor,
             alloc: torch.Tensor, price: torch.Tensor, rank: torch.Tensor,
             init_option: Optional[torch.Tensor],
             init_used: Optional[torch.Tensor], max_nodes: int):
    """The pod-granular FFD scan over P FFD-sorted rows (requests P×R f32,
    valid P bool, class_id / node_cap / rem / compat_row P int32) against O
    columns (alloc O×R f32, price O f32, rank O int32; compat_packed T ×
    ceil(O/8) uint8).  `init_option` (K int32, −1 == closed) / `init_used`
    (K×R f32) None == all slots closed.  Returns (assignment P int32 slot
    or −1, slot_option K int32, slot_used K×R f32, n_open int32)."""
    if (init_option is None) != (init_used is None):
        raise ValueError("init_option and init_used come together")
    if not _on_cuda(requests, compat_packed, compat_row, class_id, valid,
                    node_cap, rem, alloc, price, rank, init_option,
                    init_used):
        return ffd_scan_plain(requests, compat_packed, compat_row, class_id,
                              valid, node_cap, rem, alloc, price, rank,
                              init_option, init_used, max_nodes)
    P, R = requests.shape
    O = alloc.shape[0]
    T = compat_packed.shape[0]
    K = int(max_nodes)
    lib = _lib()
    scratch_bytes = lib.ffd_scratch_bytes(O, R, K, T)
    if scratch_bytes < 0:
        raise KernelLimitError(
            f"R={R} / K={K} / O={O} / T={T} outside the scan kernel's "
            f"limits ({lib.ffd_max_r()} axes)")
    _check(requests, "requests", torch.float32, (P, R))
    _check(compat_packed, "compat_packed", torch.uint8, (T, (O + 7) // 8))
    _check(compat_row, "compat_row", torch.int32, (P,))
    _check(class_id, "class_id", torch.int32, (P,))
    _check(valid, "valid", torch.bool, (P,))
    _check(node_cap, "node_cap", torch.int32, (P,))
    _check(rem, "rem", torch.int32, (P,))
    _check(alloc, "alloc", torch.float32, (O, R))
    _check(price, "price", torch.float32, (O,))
    _check(rank, "rank", torch.int32, (O,))
    if init_option is not None:
        _check(init_option, "init_option", torch.int32, (K,))
        _check(init_used, "init_used", torch.float32, (K, R))
    dev = requests.device
    assignment = torch.empty(P, dtype=torch.int32, device=dev)
    slot_option = torch.empty(K, dtype=torch.int32, device=dev)
    slot_used = torch.empty((K, R), dtype=torch.float32, device=dev)
    n_open = torch.empty((), dtype=torch.int32, device=dev)
    # the slot state and the new-node candidates go to global scratch only
    # past the kernel's shared-memory budget (slot_option / slot_used are
    # the outputs, so they double as the state there)
    scratch = None
    if scratch_bytes:
        scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.ffd_scan(
            _ptr(requests), _ptr(compat_packed), _ptr(compat_row),
            _ptr(class_id), _ptr(valid), _ptr(node_cap), _ptr(rem),
            _ptr(alloc), _ptr(price), _ptr(rank), _ptr(init_option),
            _ptr(init_used), P, O, R, K, T, _ptr(scratch), _ptr(assignment),
            _ptr(slot_option), _ptr(slot_used), _ptr(n_open), _stream(dev))
    if err:
        msg = lib.ffd_error_string(err).decode()
        raise KernelError(f"ffd_scan: CUDA error {err} ({msg})")
    LAUNCHES["ffd_scan"] += 1
    return assignment, slot_option, slot_used, n_open


STEP_CHAIN = 4096       # steps in each chain `step_cycles` times


def step_cycles():
    """(SM cycles of one least row step of the scan, SM cycles of one
    dependent float32 add) on the current card: one warp's chain of
    STEP_CHAIN steps, each a shared-memory load at the index the step
    before chose, a float32 add and compare and a warp vote, then a chain
    of STEP_CHAIN dependent adds, each timed by clock64 (csrc/ffd.cu
    `ffd_step_cycles`).  A measurement for K7's bound, not a kernel of the
    port: it counts no launch."""
    dev = torch.device("cuda", torch.cuda.current_device())
    cycles = torch.zeros(3, dtype=torch.int64, device=dev)
    err = _lib().ffd_step_cycles(STEP_CHAIN, _ptr(cycles), _stream(dev))
    if err:
        msg = _lib().ffd_error_string(err).decode()
        raise KernelError(f"ffd_step_cycles: CUDA error {err} ({msg})")
    c = cycles.cpu().tolist()
    return c[0] / STEP_CHAIN, c[1] / STEP_CHAIN
