"""Gilmore-Gomory configuration-LP lower bound (offline certification).

The port of the JAX package's `ops/ggbound.py`: the same column generation
on the host (scipy/HiGHS), whose optional pricing screen is one batched
PDHG launch on the card (ops/lpsolve.py, csrc/lpsolve.cu) on `lp_device`.

The strongest tractable bound family for the packing problem: a
set-covering LP over *node configurations* (integral fills of one node)
with exact MILP pricing per launch option, warm-started from an actual
packing plan.  Farley's bound makes every iteration's value a certified
lower bound — convergence is not required for validity:

    LB = z_master / max_j (pricing_value_j / price_j)

Compute cost is minutes on bench-scale instances (hundreds of pricing
MILPs), so this runs OFFLINE — `class_lp_bound` (ops/lpbound.py) remains
the bench's in-line certificate.

Measured on the bench's 10k-mixed instance (docs/design-relaxation.md):
the configuration LP converges to ~645.6 vs the plain class-LP's 642.91
(+0.4%), while the greedy plan costs 704.12 — establishing that the
residual certified gap is λ-integrality (how many nodes of each
configuration), which no LP in this family can close, not a weakness
specific to the class-granular relaxation.
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np

from . import lpbound


def gg_bound(problem, iters: int = 20, time_limit_s: float = 600.0,
             pricing_time_limit_s: float = 2.0,
             warm_plan=None, log=None,
             device: bool = False, lp_device="cuda") -> Tuple[float, dict]:
    """Certified lower bound via column generation with Farley's rule.

    Returns (bound, info).  The bound is always valid: it starts at the
    exact class-LP optimum and only improves when an iteration's Farley
    value (or the converged master) exceeds it.  `warm_plan` may be a
    PackingResult whose node fills seed the column pool.

    With `device=True` the per-option fractional pricing screens — the
    bulk of the serial HiGHS calls — run as ONE vmapped PDHG batch
    (ops/lpsolve.py), and the screen threshold uses the dual-certified
    upper bound, which is valid for Farley regardless of PDHG
    convergence (see `lpsolve.certified_upper_bound`).  The batch runs on
    `lp_device`: "cuda" by default, "cpu" for the kernel's plain version.
    """
    best, _state, info = _colgen(problem, iters, time_limit_s,
                                 pricing_time_limit_s, warm_plan, log,
                                 device=device, lp_device=lp_device)
    return best, info


def integral_bracket(problem, iters: int = 20, time_limit_s: float = 600.0,
                     pricing_time_limit_s: float = 2.0,
                     master_time_limit_s: float = 120.0,
                     warm_plan=None, log=None,
                     device: bool = False, lp_device="cuda"
                     ) -> Tuple[float, float, dict]:
    """Bracket the EXACT integral packing optimum: (lb, ub, info).

    lb is the certified configuration-LP/Farley bound from column
    generation; ub is the cost of a genuine integral packing — the
    restricted master re-solved as a MILP (integer node counts per
    generated configuration, coverage ≥ demand).  The true integral
    optimum lies in [lb, ub], so ub/lb bounds how loose the LP
    certificate can possibly be, and plan_cost/ub lower-bounds how much
    of a plan's measured overhead is real packer waste rather than bound
    slack.  This settles the question the bench's x-ratios alone cannot
    (docs/performance.md): which side of the gap owns the residual.

    Runs OFFLINE (minutes): column generation plus one MILP over the
    generated column pool.  Singleton columns keep the MILP feasible
    regardless of convergence, so (lb, ub) is always a valid bracket.
    `device` and `lp_device` are `gg_bound`'s.
    """
    best, state, info = _colgen(problem, iters, time_limit_s,
                                pricing_time_limit_s, warm_plan, log,
                                device=device, lp_device=lp_device)
    if state is None:
        return best, float("inf"), info
    ub, lam = _integral_master(state, master_time_limit_s)
    info["integral_ub"] = ub
    if lam is not None:
        info["integral_columns_used"] = int((lam > 0.5).sum())
    return best, ub, info


def _integral_master(state, time_limit_s: float):
    """Solve the restricted master with integer multiplicities.  Every
    column is an integral single-node fill, so any feasible λ IS a
    concrete fleet whose cost upper-bounds the integral optimum."""
    from scipy import sparse
    from scipy.optimize import Bounds, LinearConstraint, milp
    import numpy as np
    cols, cnt = state["cols"], state["cnt"]
    cost = np.array([c for c, _ in cols])
    A = sparse.csr_matrix(np.stack([a for _, a in cols], axis=1))
    res = milp(cost,
               constraints=[LinearConstraint(A, cnt, np.inf)],
               integrality=np.ones(len(cols)),
               bounds=Bounds(0, np.inf),
               options={"time_limit": float(time_limit_s)})
    if res.x is None:  # pragma: no cover — singletons keep this feasible
        return float("inf"), None
    return float(res.fun), np.round(res.x)


def _device_screen(jobs, duals, req, alloc, lp_device="cuda"):
    """Batched PDHG pre-screen: one vmapped solve over every option's
    fractional pricing LP, then a dual-certified upper bound per option.

    The certified bound (weak duality from the harvested λ ≥ 0) OVER-
    estimates the pricing optimum even when PDHG did not converge, which
    is exactly the direction both the screen and Farley's `worst`
    quotient need — a loose bound only makes the screen conservative,
    never invalid.  Returns {option j: certified ub}.  A kernel that
    fails raises (`KernelError`): nothing answers for it."""
    from . import lpsolve
    insts = [lpsolve.LPInstance(c=-duals[idx], A_ub=req[idx].T,
                                b_ub=alloc[j], upper=ub,
                                warm_key=f"gg:pricing:{j}")
             for j, idx, ub in jobs]
    sols = lpsolve.solve_lp_batch(insts, device=lp_device)
    return {j: lpsolve.certified_upper_bound(duals[idx], req[idx].T,
                                             alloc[j], ub, sol.lam)
            for (j, idx, ub), sol in zip(jobs, sols)}


def _colgen(problem, iters, time_limit_s, pricing_time_limit_s,
            warm_plan, log, device=False, lp_device="cuda"):
    """Shared column-generation core.  Returns (best_lb, state, info)
    where state carries the generated column pool for the integral
    master (None when scipy is absent or the instance is empty)."""
    try:
        from scipy import sparse
        from scipy.optimize import Bounds, LinearConstraint, linprog, milp
    except ImportError:  # pragma: no cover
        return lpbound.dual_feasible_bound(problem), None, {"method": "dual"}

    base = lpbound.class_lp_bound(problem)
    if base is None:
        base = lpbound.dual_feasible_bound(problem)
    info = {"method": "gg", "base_lp": base, "iters": 0, "converged": False,
            "pricing_screen": "device" if device else "highs"}
    if problem.num_options == 0 or problem.num_classes == 0:
        return 0.0, None, info

    fit = lpbound._fit_compat(problem)
    feas = fit.any(axis=1)
    req = problem.class_requests[feas].astype(np.float64)
    cnt = problem.class_counts[feas].astype(np.float64)
    compat = fit[feas]
    alloc, price, compat = lpbound._dedup_options(
        problem.option_alloc.astype(np.float64),
        problem.option_price.astype(np.float64), compat)
    C, R = req.shape
    O = alloc.shape[0]
    if C == 0 or O == 0:
        return 0.0, None, info

    reqpos = req > 0
    safe_req = np.where(reqpos, req, 1.0)
    m = np.where(reqpos[:, None, :],
                 alloc[None, :, :] // safe_req[:, None, :], np.inf).min(axis=2)
    m = np.where(compat, m, 0)

    cols: list = []
    colset: set = set()

    def add_col(j: int, a: np.ndarray) -> bool:
        key = (j, a.tobytes())
        if key in colset:
            return False
        colset.add(key)
        cols.append((float(price[j]), a.astype(np.float64)))
        return True

    # singleton columns guarantee master feasibility
    for c in range(C):
        j = int(np.argmin(np.where(m[c] > 0, price, np.inf)))
        if m[c, j] > 0:
            a = np.zeros(C)
            a[c] = min(m[c, j], cnt[c])
            add_col(j, a)

    if warm_plan is not None:
        _seed_from_plan(problem, warm_plan, feas, fit, add_col)

    def solve_master():
        cost = np.array([c for c, _ in cols])
        A = sparse.csr_matrix(np.stack([a for _, a in cols], axis=1))
        res = linprog(cost, A_ub=-A, b_ub=-cnt, bounds=(0, None),
                      method="highs")
        if not res.success:  # pragma: no cover
            return None, None
        return res.fun, -res.ineqlin.marginals

    best = float(base)
    t0 = time.perf_counter()
    # dual-threshold slack: the pricing step ignores classes whose dual is
    # ≤ 1e-9 (and options with no such class at all), so each pricing value
    # can under-estimate the true pricing optimum by at most
    # 1e-9 · Σ_c min(m, cnt) pods' worth of omitted dual mass.  Farley
    # divides by the WORST pricing ratio, so every ratio must be an
    # over-estimate: add this worst-case omitted contribution to every
    # pricing value (the correction is ~1e-5 on bench scales,
    # documented tolerance rather than a silent epsilon).
    eps_omit = 1e-9 * float(np.minimum(np.where(m > 0, m, 0),
                                       cnt[:, None]).sum(axis=0).max())
    for it in range(iters):
        z, duals = solve_master()
        if z is None:
            break
        worst = eps_omit / float(price.min())   # covers fully-skipped options
        added = 0
        farley_valid = True   # every option's pricing ratio accounted for
        proven = True         # every option priced out or MILP-optimal
        jobs = []
        for j in range(O):
            mask = compat[:, j] & (m[:, j] > 0) & (duals > 1e-9)
            if mask.any():
                idx = np.nonzero(mask)[0]
                jobs.append((j, idx, np.minimum(m[idx, j], cnt[idx])))
        # one vmapped PDHG dispatch replaces the serial HiGHS screens
        dev_ub = _device_screen(jobs, duals, req, alloc, lp_device) \
            if device else None
        for j, idx, ub in jobs:
            A_p = sparse.csr_matrix(req[idx].T)
            # fractional pricing bound filters options that cannot violate
            if dev_ub is not None:
                lp_ub = dev_ub[j]   # certified even if PDHG hit its cap
            else:
                lp = linprog(-duals[idx], A_ub=A_p, b_ub=alloc[j],
                             bounds=np.stack([np.zeros(len(idx)), ub],
                                             axis=1),
                             method="highs")
                if not lp.success:
                    # Farley needs EVERY option's ratio; an unpriced option
                    # invalidates this iteration's bound (not the run)
                    farley_valid = False
                    proven = False
                    continue
                lp_ub = -lp.fun
            if lp_ub <= price[j] * (1 + 1e-9):
                continue     # proven non-violating by the relaxation
            res = milp(-duals[idx],
                       constraints=[LinearConstraint(A_p, -np.inf, alloc[j])],
                       integrality=np.ones(len(idx)), bounds=Bounds(0, ub),
                       options={"time_limit": float(pricing_time_limit_s)})
            if res.status != 0 or res.x is None:
                # the screen bound safely over-estimates the pricing
                # optimum — Farley stays valid, but the master is NOT
                # proven optimal
                worst = max(worst, (lp_ub + eps_omit) / price[j])
                proven = False
                continue
            val = -res.fun
            worst = max(worst, (val + eps_omit) / price[j])
            if val > price[j] * (1 + 1e-7):
                a = np.zeros(C)
                a[idx] = np.round(res.x)
                added += add_col(j, a)
        # denominator floor covers options skipped by the screens: the
        # fractional screen admits true ratios up to 1+1e-9+eps/price, and
        # the MILP path only adds columns above the 1e-7 add-threshold, so
        # tolerance-scale improving columns can survive even at
        # "convergence" — both the Farley quotient AND the converged master
        # value must be discounted by this floor
        floor = 1.0 + 1e-7 + eps_omit / float(price.min())
        if farley_valid:
            best = max(best, z / max(worst, floor))   # Farley
        info["iters"] = it + 1
        if log:
            log(f"gg iter {it}: master={z:.2f} worst={worst:.4f} "
                f"best_lb={best:.2f} cols={len(cols)}")
        if added == 0:
            if proven:
                # converged restricted master ≈ GG LP up to screen
                # tolerances; z/floor is the certified value
                best = max(best, z / floor)
                info["converged"] = True
            break
        if time.perf_counter() - t0 > time_limit_s:
            break
    info["columns"] = len(cols)
    state = {"cols": cols, "cnt": cnt, "price": price, "req": req,
             "compat": compat, "alloc": alloc}
    return float(best), state, info


def _seed_from_plan(problem, plan, feas, fit, add_col) -> None:
    """Seed columns from a PackingResult's actual node fills."""
    cid_map = -np.ones(problem.num_classes, np.int64)
    cid_map[np.nonzero(feas)[0]] = np.arange(int(feas.sum()))
    keys: dict = {}
    dedup_of = {}
    comp = fit[feas]
    for j in range(problem.num_options):
        k = (problem.option_alloc[j].astype(np.float64).tobytes(),
             float(problem.option_price[j]), comp[:, j].tobytes())
        if k not in keys:
            keys[k] = len(keys)
        dedup_of[j] = keys[k]
    class_of_pod = {}
    for ci, mem in enumerate(problem.class_members):
        for p in np.asarray(mem):
            class_of_pod[int(p)] = ci
    opt_index = {id(o): j for j, o in enumerate(problem.options)}
    C = int(feas.sum())
    for nd in plan.nodes:
        a = np.zeros(C)
        ok = True
        for p in nd.pod_indices:
            ci = class_of_pod.get(p)
            cc = cid_map[ci] if ci is not None else -1
            if cc < 0:
                ok = False
                break
            a[cc] += 1
        j = opt_index.get(id(nd.option))
        if ok and j is not None:
            add_col(dedup_of[j], a)
