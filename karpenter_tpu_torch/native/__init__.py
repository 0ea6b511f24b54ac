"""The native C++ FFD packer (host code, loaded with ctypes).

A copy of the JAX package's `native/`: `csrc/ffd.cc` is its source
unchanged, a first-fit-decreasing packer with slot semantics identical to
the scan kernel K7 (`ops/ffd_kernels.py`, `csrc/ffd.cu`) and its plain
version, so all of them share `ops/ffd.decode_assignment`.  It is the
degradation ladder's "native" rung (ops/health.py): the Provisioner and the
DisruptionController demote to it when the "jax" rung fails.  It runs on
the host and is not a port of a device program.

The loader differs from the reference's, which builds `_libffd.so` in place
beside the source: here `build()` compiles to a temporary name under
`build/native/` at the repository root and renames it into place as
`ffd-<hash>.so`, where the hash covers the source and the flags, so
concurrent builders (test workers, processes) agree and an unchanged source
is reused.  The flags are the reference's (`g++ -O3 -shared -fPIC
-std=c++17`, no `-ffast-math`), so the float results stay bit-identical.

`available()` is False where no compiler exists or the build fails, as in
the reference; `build()` raises `NativeBuildError` instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger("karpenter_tpu_torch.native")

SRC = Path(__file__).resolve().parent / "csrc" / "ffd.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.RLock()        # the compile and the load
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


class NativeBuildError(RuntimeError):
    """The native library did not compile or load on this host."""


def target() -> Path:
    """The library's path for the current source and flags."""
    h = hashlib.sha256(SRC.read_bytes() + " ".join([CXX, *CXX_FLAGS])
                       .encode())
    return BUILD_DIR / f"ffd-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile `csrc/ffd.cc` unless its library exists; returns the
    library's path.  The compiler writes a temporary file that
    `os.replace` moves into place, so a concurrent build by another
    process leaves one complete library either way."""
    with _lock:
        out = target()
        if out.exists():
            return out
        cxx = shutil.which(CXX)
        if cxx is None:
            raise NativeBuildError(f"{CXX} not found on PATH: the native "
                                   f"packer is built from source at first "
                                   f"use")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        try:
            subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                           check=True, capture_output=True, text=True,
                           timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            tmp.unlink(missing_ok=True)
            detail = getattr(e, "stderr", None) or e
            raise NativeBuildError(f"{CXX} failed on {SRC}: {detail}") from e
        os.replace(tmp, out)   # atomic: concurrent builders agree
        return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (NativeBuildError, OSError) as e:
            log.warning("native packer unavailable: %s", e)
            _build_failed = True
            return None
        lib.ffd_pack.restype = ctypes.c_int32
        lib.ffd_pack.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def ffd_pack_native(requests: np.ndarray, compat: np.ndarray,
                    class_ids: np.ndarray, caps: np.ndarray,
                    alloc: np.ndarray, price: np.ndarray,
                    rank: np.ndarray,
                    existing_used: Optional[np.ndarray],
                    O: int, E: int, K: int):
    """Raw slot-level pack (the contract of K7's `ffd_scan`, unpadded).
    Returns (assignment P, slot_option K, slot_used K×R, n_open)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    P, R = requests.shape
    requests = np.ascontiguousarray(requests, np.float32)
    compat = np.ascontiguousarray(compat, np.uint8)
    class_ids = np.ascontiguousarray(class_ids, np.int32)
    caps = np.ascontiguousarray(caps, np.int32)
    from ..ops.ffd import rem_in_class
    rem = rem_in_class(class_ids)
    alloc = np.ascontiguousarray(alloc, np.float32)
    # the scan never opens a node on a non-finite-priced option (its new-
    # node test gates on isfinite); the float32 clamp below only demotes
    # such options to "most expensive", which still opens them when nothing
    # else fits — mask their compat columns instead.  Only the first O
    # columns are options; pre-opened slots (>= O) keep their compatibility
    # regardless of price.
    nonfinite = ~np.isfinite(np.asarray(price[:O], np.float64))
    if nonfinite.any():
        compat = compat.copy()
        compat[:, :O][:, nonfinite] = 0
    price_a = np.zeros(alloc.shape[0], np.float32)
    price_a[:min(len(price), len(price_a))] = np.nan_to_num(
        np.asarray(price[:len(price_a)], np.float32), posinf=3.4e38)
    rank_a = np.zeros(alloc.shape[0], np.int32)
    rank_a[:min(len(rank), len(rank_a))] = np.asarray(
        rank[:len(rank_a)], np.int32)
    if E:
        # None == existing nodes start empty (zero-fill like the scan)
        eu = (np.ascontiguousarray(existing_used, np.float32)
              if existing_used is not None else np.zeros((E, R), np.float32))
    else:
        eu = None
    assignment = np.empty(P, np.int32)
    slot_option = np.empty(K, np.int32)
    slot_used = np.zeros((K, R), np.float32)
    n_open = lib.ffd_pack(
        P, R, O, E, K,
        _ptr(requests, ctypes.c_float), _ptr(compat, ctypes.c_uint8),
        _ptr(class_ids, ctypes.c_int32), _ptr(caps, ctypes.c_int32),
        _ptr(rem, ctypes.c_int32),
        _ptr(alloc, ctypes.c_float), _ptr(price_a, ctypes.c_float),
        _ptr(rank_a, ctypes.c_int32),
        _ptr(eu, ctypes.c_float) if eu is not None
        else ctypes.cast(None, ctypes.POINTER(ctypes.c_float)),
        _ptr(assignment, ctypes.c_int32), _ptr(slot_option, ctypes.c_int32),
        _ptr(slot_used, ctypes.c_float))
    if n_open < 0:
        raise RuntimeError(f"ffd_pack returned {n_open}")
    return assignment, slot_option, slot_used, int(n_open)


def solve_ffd_native(problem, max_nodes: Optional[int] = None,
                     existing_alloc: Optional[np.ndarray] = None,
                     existing_used: Optional[np.ndarray] = None,
                     existing_compat: Optional[np.ndarray] = None,
                     max_alternatives: int = 60):
    """`ops/ffd.solve_ffd` on the native packer instead of the scan (the
    same PackingResult through the shared decoder)."""
    from ..ops.ffd import PackingResult, decode_assignment

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
    O = alloc.shape[0]
    if E:
        alloc = np.concatenate([alloc, existing_alloc.astype(np.float32)],
                               axis=0)
    if alloc.shape[0] == 0:
        return PackingResult(nodes=[], unschedulable=[int(i) for i in pod_idx],
                             existing_assignments={}, total_price=0.0)
    K = max(max_nodes if max_nodes is not None else P + E, E + 1)
    price = problem.option_price
    rank = (problem.option_rank if problem.option_rank is not None
            else np.zeros(O, np.int32))
    assignment, slot_option, slot_used, _ = ffd_pack_native(
        requests, compat, class_ids, row_caps, alloc, price, rank,
        existing_used, O, E, K)
    return decode_assignment(problem, assignment, slot_option, slot_used,
                             pod_idx, compat, E, O, max_alternatives)
