"""Batched LP solver on the card: restarted PDHG (PDLP-style).

The port of the JAX package's `ops/lpsolve.py`.  Problem form:

    min  c·x    s.t.  A x = b,   G x ≤ h,   0 ≤ x ≤ u       (u may be +inf)

with the saddle-point iteration over L(x, y, λ) = c·x + y·(Ax−b) + λ·(Gx−h):

    x⁺ = clip(x − τ(c + Aᵀy + Gᵀλ), 0, u)        τ = η/ω
    y⁺ = y + σ(A(2x⁺−x) − b)                      σ = η·ω
    λ⁺ = max(0, λ + σ(G(2x⁺−x) − h))

after Ruiz equilibration, with η from a power-iteration bound on ‖[A;G]‖₂
and the PDLP primal-weight rebalance on restarts.  Every `check_every`
iterations the loop scores both the current iterate and the epoch average
against the unscaled KKT residuals, adopts the better, restarts on
sufficient decay, and freezes converged members so a batch reproduces each
member's solo trajectory.

`_pdhg_kernel` is the JAX program's name; here it is ONE launch of the
hand-written CUDA kernel (ops/lpsolve_kernels.py, csrc/lpsolve.cu) on CUDA
tensors, and the plain PyTorch version on CPU tensors.

Sign convention vs scipy: `scipy_duals()` returns (−y, −λ), scipy's eqlin /
ineqlin marginals, so lpguide's dual-sign certificate validates PDHG duals
verbatim.  Padding is exact: a padded variable has a zero column, zero cost
and u = 0; a padded row has zero coefficients and zero rhs.

Row equilibration happens host-side in float64 before the float32 cast:
each row and its rhs are divided by the row's ∞-norm, and the returned
multipliers are divided by the same factor, so callers see duals in their
original row units (the refinery masters mix millicore- and byte-scale
rows, whose float32 round-off would otherwise swamp the relative KKT
measurement).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .classpack import resolve_device
from .lpsolve_kernels import pdhg
from .tensorize import pad_to

# Dim buckets for LP operands (the reference's); past the last bucket
# pad_to falls back to the next power of two.
LP_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)

DEFAULT_EPS = 1e-4        # relative KKT tolerance (float32 solver)
DEFAULT_ITERS_CAP = 20000
DEFAULT_CHECK_EVERY = 32

STATUS_CONVERGED = "converged"
STATUS_CAP = "cap"

_WARM_MAX = 64
_WARM_LOCK = threading.Lock()
_WARM_CACHE: "OrderedDict[str, Dict]" = OrderedDict()


@dataclass
class LPSolution:
    """One instance's unpadded solve result (numpy, natural dims)."""
    x: np.ndarray           # primal (n,)
    y: np.ndarray           # eq multipliers, L-convention (me,)
    lam: np.ndarray         # ineq multipliers ≥ 0, L-convention (mi,)
    obj: float              # c·x
    status: str             # STATUS_CONVERGED | STATUS_CAP
    iterations: int
    restarts: int
    primal_res: float       # relative residuals at exit
    dual_res: float
    gap: float

    @property
    def converged(self) -> bool:
        return self.status == STATUS_CONVERGED

    def scipy_duals(self) -> Tuple[np.ndarray, np.ndarray]:
        """(eqlin.marginals, ineqlin.marginals) in scipy's sign
        convention: ∂z/∂b = −y, ∂z/∂h = −λ ≤ 0."""
        return -self.y, -self.lam


def _pdhg_kernel(A, b, G, h, c, u, init_x, init_y, init_lam, eps,
                 iters_cap: int, check_every: int):
    """Batched restarted PDHG on tensors (see ops/lpsolve_kernels.pdhg):
    returns (x, y, λ, done, iters, restarts, pres, dres, gap)."""
    return pdhg(A, b, G, h, c, u, init_x, init_y, init_lam, float(eps),
                int(iters_cap), int(check_every))


@dataclass(frozen=True)
class LPInstance:
    """One LP in natural dims; eq/ineq blocks optional, u entries may be
    +inf (the default when `upper` is None)."""
    c: np.ndarray
    A_eq: Optional[np.ndarray] = None
    b_eq: Optional[np.ndarray] = None
    A_ub: Optional[np.ndarray] = None
    b_ub: Optional[np.ndarray] = None
    upper: Optional[np.ndarray] = None
    warm_key: Optional[str] = None

    def dims(self) -> Tuple[int, int, int]:
        n = int(np.asarray(self.c).shape[0])
        me = 0 if self.A_eq is None else int(np.asarray(self.A_eq).shape[0])
        mi = 0 if self.A_ub is None else int(np.asarray(self.A_ub).shape[0])
        return n, me, mi


def _warm_get(key: Optional[str], dims: Tuple[int, int, int]):
    if key is None:
        return None
    with _WARM_LOCK:
        ent = _WARM_CACHE.get(key)
        if ent is None or ent["dims"] != tuple(dims):
            return None
        _WARM_CACHE.move_to_end(key)
        return ent


def _warm_put(key: Optional[str], dims: Tuple[int, int, int],
              x: np.ndarray, y: np.ndarray, lam: np.ndarray) -> None:
    if key is None:
        return
    with _WARM_LOCK:
        _WARM_CACHE[key] = {"dims": tuple(dims),
                            "x": np.asarray(x, np.float32).copy(),
                            "y": np.asarray(y, np.float32).copy(),
                            "lam": np.asarray(lam, np.float32).copy()}
        _WARM_CACHE.move_to_end(key)
        while len(_WARM_CACHE) > _WARM_MAX:
            _WARM_CACHE.popitem(last=False)


def warm_cache_len() -> int:
    with _WARM_LOCK:
        return len(_WARM_CACHE)


def snapshot_caches() -> dict:
    """Plain-data export of the warm-start cache (the reference's WarmRestart
    "lpsolve" section): caller digests → natural-dim float32 arrays."""
    with _WARM_LOCK:
        return {"warm": {k: dict(v) for k, v in _WARM_CACHE.items()}}


def restore_caches(data: dict) -> None:
    with _WARM_LOCK:
        _WARM_CACHE.clear()
        for k, v in data.get("warm", {}).items():
            _WARM_CACHE[k] = {"dims": tuple(v["dims"]),
                              "x": np.asarray(v["x"], np.float32),
                              "y": np.asarray(v["y"], np.float32),
                              "lam": np.asarray(v["lam"], np.float32)}
        while len(_WARM_CACHE) > _WARM_MAX:
            _WARM_CACHE.popitem(last=False)


def reset_caches() -> None:
    with _WARM_LOCK:
        _WARM_CACHE.clear()


@dataclass
class LPBatch:
    """A batch padded to one bucketed envelope (numpy, float32), with the
    float64 row factors that unscale the duals."""
    A: np.ndarray
    b: np.ndarray
    G: np.ndarray
    h: np.ndarray
    c: np.ndarray
    u: np.ndarray
    ix: np.ndarray
    iy: np.ndarray
    il: np.ndarray
    se: np.ndarray
    si: np.ndarray
    dims: List[Tuple[int, int, int]]

    def operands(self):
        """The kernel's nine operands, in its order."""
        return (self.A, self.b, self.G, self.h, self.c, self.u, self.ix,
                self.iy, self.il)


def pad_batch(instances: Sequence[LPInstance],
              buckets: Sequence[int] = LP_BUCKETS) -> LPBatch:
    """Pad → row-equilibrate (float64) → cast, and seed warm starts: the
    reference's host lowering, step for step."""
    B = len(instances)
    dims = [inst.dims() for inst in instances]
    nb = pad_to(max(d[0] for d in dims), buckets)
    meb = pad_to(max(max(d[1] for d in dims), 1), buckets)
    mib = pad_to(max(max(d[2] for d in dims), 1), buckets)

    A = np.zeros((B, meb, nb), np.float32)
    G = np.zeros((B, mib, nb), np.float32)
    b = np.zeros((B, meb), np.float32)
    h = np.zeros((B, mib), np.float32)
    c = np.zeros((B, nb), np.float32)
    u = np.zeros((B, nb), np.float32)          # padded vars pinned to 0
    ix = np.zeros((B, nb), np.float32)
    iy = np.zeros((B, meb), np.float32)
    il = np.zeros((B, mib), np.float32)

    # per-row ∞-norm scales (f64), kept to unscale duals on the way out
    se = np.ones((B, meb), np.float64)
    si = np.ones((B, mib), np.float64)

    for i, inst in enumerate(instances):
        n, me, mi = dims[i]
        c[i, :n] = np.asarray(inst.c, np.float32)
        u[i, :n] = np.inf if inst.upper is None else \
            np.asarray(inst.upper, np.float32)
        if me:
            Ae = np.asarray(inst.A_eq, np.float64)
            s = np.abs(Ae).max(axis=1)
            s = np.where(s > 0.0, s, 1.0)
            se[i, :me] = s
            A[i, :me, :n] = (Ae / s[:, None]).astype(np.float32)
            b[i, :me] = (np.asarray(inst.b_eq, np.float64) /
                         s).astype(np.float32)
        if mi:
            Gi = np.asarray(inst.A_ub, np.float64)
            s = np.abs(Gi).max(axis=1)
            s = np.where(s > 0.0, s, 1.0)
            si[i, :mi] = s
            G[i, :mi, :n] = (Gi / s[:, None]).astype(np.float32)
            h[i, :mi] = (np.asarray(inst.b_ub, np.float64) /
                         s).astype(np.float32)
        warm = _warm_get(inst.warm_key, dims[i])
        if warm is not None:
            # cached duals are in original row units; the kernel works in
            # row-normalized units (y' = s·y)
            ix[i, :n] = warm["x"]
            iy[i, :me] = warm["y"] * se[i, :me]
            il[i, :mi] = warm["lam"] * si[i, :mi]
    return LPBatch(A, b, G, h, c, u, ix, iy, il, se, si, dims)


def solve_lp_batch(instances: Sequence[LPInstance],
                   eps: float = DEFAULT_EPS,
                   iters_cap: int = DEFAULT_ITERS_CAP,
                   check_every: int = DEFAULT_CHECK_EVERY,
                   buckets: Sequence[int] = LP_BUCKETS,
                   device="cuda") -> List[LPSolution]:
    """Solve a batch of LPs in one padded device call (one kernel launch on
    the card).  All instances pad to one bucketed (n, me, mi) envelope —
    padding is exact, so heterogeneous natural dims batch fine.  Returns
    one LPSolution per instance, natural dims.  `device` is "cuda" by
    default; "cpu" runs the plain version."""
    if not instances:
        return []
    dev = resolve_device(device)
    bt = pad_batch(instances, buckets)
    ops = [torch.from_numpy(a).to(dev) for a in bt.operands()]
    out = _pdhg_kernel(*ops, eps, iters_cap=int(iters_cap),
                       check_every=int(check_every))
    xs, ys, ls, done, iters, restarts, pres, dres, gap = \
        [o.cpu().numpy() for o in out]

    sols: List[LPSolution] = []
    for i, inst in enumerate(instances):
        n, me, mi = bt.dims[i]
        x = xs[i, :n].astype(np.float64)
        y = ys[i, :me].astype(np.float64) / bt.se[i, :me]
        lam = ls[i, :mi].astype(np.float64) / bt.si[i, :mi]
        ok = bool(done[i])
        sol = LPSolution(
            x=x, y=y, lam=lam,
            obj=float(np.asarray(inst.c, np.float64) @ x),
            status=STATUS_CONVERGED if ok else STATUS_CAP,
            iterations=int(iters[i]), restarts=int(restarts[i]),
            primal_res=float(pres[i]), dual_res=float(dres[i]),
            gap=float(gap[i]))
        if ok:
            _warm_put(inst.warm_key, bt.dims[i], x, y, lam)
        sols.append(sol)
    return sols


def solve_lp(c, A_eq=None, b_eq=None, A_ub=None, b_ub=None, upper=None,
             warm_key: Optional[str] = None, eps: float = DEFAULT_EPS,
             iters_cap: int = DEFAULT_ITERS_CAP,
             check_every: int = DEFAULT_CHECK_EVERY,
             buckets: Sequence[int] = LP_BUCKETS,
             device="cuda") -> LPSolution:
    """Single-LP convenience wrapper over `solve_lp_batch` (a B=1 batch, so
    single and batched solves share one kernel and one trajectory)."""
    return solve_lp_batch(
        [LPInstance(c=np.asarray(c, np.float32), A_eq=A_eq, b_eq=b_eq,
                    A_ub=A_ub, b_ub=b_ub, upper=upper, warm_key=warm_key)],
        eps=eps, iters_cap=iters_cap, check_every=check_every,
        buckets=buckets, device=device)[0]


def certified_upper_bound(d: np.ndarray, R: np.ndarray, a: np.ndarray,
                          ub: np.ndarray, lam: np.ndarray) -> float:
    """Certified upper bound on  max d·z  s.t.  R z ≤ a, 0 ≤ z ≤ ub,
    from ANY λ ≥ 0 (weak duality):  a·λ + Σ_j max(0, d_j − (Rᵀλ)_j)·ub_j."""
    lam = np.maximum(np.asarray(lam, np.float64), 0.0)
    slack = np.maximum(np.asarray(d, np.float64) -
                       np.asarray(R, np.float64).T @ lam, 0.0)
    return float(np.asarray(a, np.float64) @ lam +
                 slack @ np.asarray(ub, np.float64))
