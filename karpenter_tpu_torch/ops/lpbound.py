"""Certified lower bounds on packing cost.

The port of the JAX package's `ops/lpbound.py`: the same bounds from the
same operands.  Only `device_dual_bound` touches the card, through the
PDHG kernel (ops/lpsolve.py, csrc/lpsolve.cu) on `lp_device`.

The bench harness measures the solver's plan cost against a bound on the
achievable optimum (BASELINE.md: "packing cost overhead vs optimal").
This module provides two certified bounds:

  * `class_lp_bound` — the EXACT optimum of the class-granular LP
    relaxation, solved off the clock with scipy/HiGHS:

        min  Σ_j price_j · n_j
        s.t. Σ_c req[c,r] · x[c,j] ≤ alloc[j,r] · n_j   ∀ j, r
             Σ_{j ∈ compat(c)} x[c,j] = count_c          ∀ c
             x, n ≥ 0

    (x[c,j] = pods of class c placed on option-j nodes; n_j = fractional
    node count.)  This is the relaxation the tensorized solver itself is
    built on (SURVEY.md §7): it drops node integrality AND per-node
    resource coupling (pods of one option pool their resource use across
    that option's nodes), so its optimum is a true — if sometimes loose —
    lower bound on any integral packing.

  * `dual_feasible_bound` — a certificate-carrying fallback needing only
    numpy: any λ[j,r] ≥ 0 with Σ_r alloc[j,r]·λ[j,r] ≤ price_j is
    feasible for the LP dual, giving the valid bound
    Σ_c count_c · min_{j ∈ compat(c)} Σ_r req[c,r]·λ[j,r].
    Projected supergradient ascent over λ tightens it toward the LP
    optimum; EVERY iterate is dual-feasible, so the best-so-far value is
    always a certified bound (no convergence needed for validity).

Note the subtlety the previous bench bound got wrong: the per-pod
"max-share" heuristic (pod costs ≥ price_j · max_r req_r/alloc_jr) is NOT
a valid bound — two complementary pods (cpu-heavy + mem-heavy) can share
one node while their max-shares sum past 1, so summed imputed costs can
EXCEED the true optimum.  The dual certificate replaces it: a λ
concentrated on one resource recovers exactly the safe single-resource
bound, and mixing resources stays valid because dual feasibility is
enforced by construction.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _fit_compat(problem) -> np.ndarray:
    """class_compat ∧ (at least one pod of the class fits one node of the
    option) — the same m ≥ 1 feasibility the packing kernel enforces, so
    unfittable pods are excluded from demand exactly as they are excluded
    from the solver's total_price (they come back unschedulable)."""
    req = problem.class_requests.astype(np.float64)
    alloc = problem.option_alloc.astype(np.float64)
    reqpos = req > 0
    safe_req = np.where(reqpos, req, 1.0)
    m = np.where(reqpos[:, None, :], alloc[None, :, :] // safe_req[:, None, :],
                 np.inf).min(axis=2)
    return problem.class_compat & (m >= 1.0)


def _dedup_options(alloc: np.ndarray, price: np.ndarray,
                   compat: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Collapse options identical in (alloc row, price, compat column) —
    zone-expanded offerings of one type are LP-indistinguishable, which
    shrinks the 3600-column catalogs to ~their type count."""
    O = alloc.shape[0]
    keys = {}
    keep = []
    for j in range(O):
        k = (alloc[j].tobytes(), float(price[j]), compat[:, j].tobytes())
        if k not in keys:
            keys[k] = True
            keep.append(j)
    keep = np.asarray(keep, dtype=np.int64)
    return alloc[keep], price[keep], compat[:, keep]


def class_lp_bound(problem, time_limit_s: float = 900.0) -> Optional[float]:
    """Exact class-granular LP optimum via scipy/HiGHS; None if scipy is
    unavailable or the LP fails to solve (incl. hitting the time limit —
    a partially-solved primal is NOT a valid bound).  Off-the-clock use
    only: the 50k-pod × 600-type instance takes minutes."""
    try:
        from scipy import sparse
        from scipy.optimize import linprog
    except ImportError:  # pragma: no cover — scipy is baked into the image
        return None
    if problem.num_options == 0 or problem.num_classes == 0:
        return 0.0
    fit = _fit_compat(problem)
    feas = fit.any(axis=1)
    req = problem.class_requests[feas].astype(np.float64)
    cnt = problem.class_counts[feas].astype(np.float64)
    compat = fit[feas]
    alloc, price, compat = _dedup_options(
        problem.option_alloc.astype(np.float64),
        problem.option_price.astype(np.float64), compat)
    C, R = req.shape
    O = alloc.shape[0]
    if C == 0 or O == 0:
        return 0.0

    # variables: x over compat pairs (sparse), then n (O)
    pair_c, pair_j = np.nonzero(compat)
    P = len(pair_c)
    n_base = P
    nvars = P + O

    rows, cols, vals = [], [], []
    # capacity rows, one per (j, r): Σ_c req[c,r]·x[c,j] - alloc[j,r]·n_j ≤ 0
    for r in range(R):
        nz = req[pair_c, r] != 0
        rows.append(pair_j[nz] * R + r)
        cols.append(np.nonzero(nz)[0])
        vals.append(req[pair_c[nz], r])
    rows.append(np.repeat(np.arange(O), R) * R + np.tile(np.arange(R), O))
    cols.append(np.repeat(np.arange(O) + n_base, R))
    vals.append(-alloc.reshape(-1))
    A_ub = sparse.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(O * R, nvars))
    b_ub = np.zeros(O * R)
    # demand rows, one per class: Σ_j x[c,j] = count_c
    A_eq = sparse.csr_matrix(
        (np.ones(P), (pair_c, np.arange(P))), shape=(C, nvars))
    b_eq = cnt
    c_obj = np.concatenate([np.zeros(P), price])
    res = linprog(c_obj, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
                  bounds=(0, None), method="highs",
                  options={"time_limit": float(time_limit_s)})
    if not res.success:
        return None
    return float(res.fun)


def dual_feasible_bound(problem, iters: int = 300,
                        step0: float = 0.5) -> float:
    """Certified bound from projected supergradient ascent on the LP dual.

    λ is parameterized as λ[j,r] = price_j · μ[j,r] / alloc[j,r] with
    μ[j] ≥ 0, Σ_r μ[j,r] ≤ 1 — dual feasibility holds by construction, so
    the best iterate's value is a valid bound regardless of convergence.
    Initialized from the best single-resource concentration (recovering
    the classic per-resource bound) and improved from there."""
    if problem.num_options == 0 or problem.num_classes == 0:
        return 0.0
    fit = _fit_compat(problem)
    feas = fit.any(axis=1)
    req = problem.class_requests[feas].astype(np.float64)
    cnt = problem.class_counts[feas].astype(np.float64)
    compat = fit[feas]
    alloc, price, compat = _dedup_options(
        problem.option_alloc.astype(np.float64),
        problem.option_price.astype(np.float64), compat)
    C, R = req.shape
    O = alloc.shape[0]
    if C == 0 or O == 0:
        return 0.0
    safe_alloc = np.where(alloc > 0, alloc, np.inf)
    # unit[c,j,r]: cost contribution of one unit of μ[j,r] to class c's
    # per-pod price on option j
    unit = price[None, :, None] * req[:, None, :] / safe_alloc[None, :, :]

    def value_and_argmin(mu):
        percls = np.einsum("cjr,jr->cj", unit, mu)
        percls = np.where(compat, percls, np.inf)
        jstar = np.argmin(percls, axis=1)
        y = percls[np.arange(C), jstar]
        return float(np.dot(cnt, y)), jstar

    best = 0.0
    # single-resource concentrations (always valid starting certificates)
    start = None
    for r in range(R):
        mu = np.zeros((O, R))
        mu[:, r] = 1.0
        v, _ = value_and_argmin(mu)
        if v > best:
            best, start = v, mu
    if start is None:
        start = np.zeros((O, R))
        start[:, 0] = 1.0
    mu = start.copy()
    scale = max(best, 1.0)
    for t in range(iters):
        v, jstar = value_and_argmin(mu)
        if v > best:
            best = v
        # supergradient of Σ_c cnt_c · min_j ⟨unit[c,j], μ_j⟩ at the argmin
        g = np.zeros((O, R))
        np.add.at(g, jstar, cnt[:, None] * unit[np.arange(C), jstar])
        step = step0 * scale / (np.linalg.norm(g) + 1e-12) / np.sqrt(t + 1.0)
        mu += step * g
        # project each row onto {μ ≥ 0, Σ μ ≤ 1}
        np.clip(mu, 0.0, None, out=mu)
        s = mu.sum(axis=1)
        over = s > 1.0
        if over.any():
            mu[over] /= s[over, None]
    return best


def device_dual_bound(problem, eps: float = 1e-5,
                      iters_cap: int = 20000, lp_device="cuda") -> float:
    """Certified bound from PDHG-harvested capacity duals.

    Solves the class LP (same formulation as `class_lp_bound`, dense) on
    the device solver (ops/lpsolve.py) and harvests the capacity-row
    multipliers λ[j,r] ≥ 0.  The harvested λ is then REPAIRED to exact
    dual feasibility — each option row is scaled so
    Σ_r alloc[j,r]·λ[j,r] ≤ price_j (the n_j column's dual constraint) —
    after which the `dual_feasible_bound` certificate

        Σ_c count_c · min_{j ∈ compat(c)} Σ_r req[c,r]·λ[j,r]

    is a valid lower bound by weak duality REGARDLESS of whether PDHG
    converged: non-convergence only makes λ loose, never invalid.  This
    turns the device solve into a certificate producer, so the bench can
    quote a certified gap without a HiGHS solve on the clock.

    The PDHG solve runs on `lp_device`: "cuda" by default, "cpu" for the
    kernel's plain version."""
    from . import lpsolve
    if problem.num_options == 0 or problem.num_classes == 0:
        return 0.0
    fit = _fit_compat(problem)
    feas = fit.any(axis=1)
    req = problem.class_requests[feas].astype(np.float64)
    cnt = problem.class_counts[feas].astype(np.float64)
    compat = fit[feas]
    alloc, price, compat = _dedup_options(
        problem.option_alloc.astype(np.float64),
        problem.option_price.astype(np.float64), compat)
    C, R = req.shape
    O = alloc.shape[0]
    if C == 0 or O == 0:
        return 0.0

    pair_c, pair_j = np.nonzero(compat)
    P = len(pair_c)
    nvars = P + O
    A_ub = np.zeros((O * R, nvars))
    A_ub[pair_j[None, :] * R + np.arange(R)[:, None],
         np.arange(P)[None, :]] = req[pair_c].T
    A_ub[np.arange(O * R), np.arange(O).repeat(R) + P] = -alloc.reshape(-1)
    A_eq = np.zeros((C, nvars))
    A_eq[pair_c, np.arange(P)] = 1.0
    c_obj = np.concatenate([np.zeros(P), price])
    sol = lpsolve.solve_lp(c_obj, A_eq=A_eq, b_eq=cnt,
                           A_ub=A_ub, b_ub=np.zeros(O * R),
                           warm_key="lpbound:class",
                           eps=eps, iters_cap=iters_cap, device=lp_device)
    lam = np.maximum(sol.lam.reshape(O, R), 0.0)
    # repair: scale each option's row into the n_j dual constraint
    s = np.einsum("jr,jr->j", alloc, lam)
    lam *= np.where(s > price, price / np.maximum(s, 1e-300), 1.0)[:, None]
    percls = np.where(compat, req @ lam.T, np.inf)
    return float(np.dot(cnt, percls.min(axis=1)))


def cost_lower_bound(problem) -> float:
    """Best certified bound available: exact LP when scipy is present,
    else the dual-certificate ascent."""
    lp = class_lp_bound(problem)
    if lp is not None:
        return lp
    return dual_feasible_bound(problem)
