"""LP-guided option mix: close the packer's option-choice gap.

The port of the JAX package's `ops/lpguide.py` — the product's default
`solve_classpack(guide="lp")`.  Each class independently buying the type
cheapest for itself strands the non-bottleneck resource a complementary
class could have used; the fix solves the class-granular LP

    min  Σ_j price_j · n_j
    s.t. Σ_c req[c,r]·x[c,j] ≤ alloc[j,r]·n_j   ∀ j,r
         Σ_j x[c,j] = cnt_c                      ∀ c,  x, n ≥ 0

exactly by option-granular column generation (restricted masters through
HiGHS, or with the DeviceLP gate through the PDHG kernel of
ops/lpsolve.py), stripes the LP mix into integral node fills, tucks the
striping's demotions into any bulk node with room, and packs what is left
with the ordinary scan kernels (K1-K3).  The mix is content-cached; with a
`refinery` a miss never blocks the caller on column generation.

Device placement: `solve_guided(device=...)` runs the remainder and greedy-
compare solves on that device and hands it to the PDHG master as
`lp_device`; `exact_lp_mix(device=True)` keeps the reference's meaning
("use the device master") and takes the torch device as `lp_device`.  The
guide path (warm / device / stale / cold) is counted and annotated on the
active span, and the refinery's job runs its `refinery.lp` and
`refinery.price` spans, as in the reference.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Optional, Tuple

import numpy as np

from ..utils import metrics, tracing
from .tensorize import Problem

_BIG = np.int32(2**30)

# content-keyed mix cache: (classes ⊕ catalog fingerprint) → guided rows.
# Same discipline as classpack's catalog/pod-side caches: check-then-insert
# under one lock, bounded size.
_MIX_CACHE: dict = {}
_MIX_CACHE_MAX = 16
_MIX_LOCK = threading.Lock()

# stale-guide cache: keyed WITHOUT pod counts (class shapes ⊕ catalog), so
# a tick whose counts changed but whose catalog fingerprint still matches
# can rescale the freshest old mix instead of blocking on column
# generation.  Entries carry a monotonic stamp; the refinery's staleness
# window bounds how old a mix may serve.
_STALE_CACHE: dict = {}
_STALE_CACHE_MAX = 16

# LP warm-start cache: class-shape digest → the terminal colgen support as
# CONTENT keys (alloc-row bytes, price), so a changed catalog maps old
# support columns back by content and counts-only deltas reuse them
# directly.  Seeds only — a wrong seed just adds columns to the restricted
# LP, never changes the optimum.
_SUPPORT_CACHE: dict = {}
_SUPPORT_CACHE_MAX = 32


def _feasible_mask(problem: Problem) -> np.ndarray:
    """class_compat ∧ fits-one-node ∧ launchable ∧ best-pool-rank — the
    same preselection the pack kernel applies, so the LP optimizes over
    exactly the kernel's action space."""
    req = problem.class_requests.astype(np.float64)
    alloc = problem.option_alloc.astype(np.float64)
    reqpos = req > 0
    safe = np.where(reqpos, req, 1.0)
    m = np.where(reqpos[:, None, :], alloc[None, :, :] // safe[:, None, :],
                 np.inf).min(axis=2)
    ok = problem.class_compat & (m >= 1.0) & \
        np.isfinite(problem.option_price)
    rank = (problem.option_rank if problem.option_rank is not None
            else np.zeros(problem.num_options, np.int32))
    best = np.min(np.where(ok, rank[None, :], _BIG), axis=1)
    return ok & (rank[None, :] == best[:, None])


def _dedup_with_inverse(alloc: np.ndarray, price: np.ndarray,
                        compat: np.ndarray):
    """Collapse options identical in (alloc, price, compat column); returns
    (alloc', price', compat', group_of: O→O' inverse map).  Zone/subnet
    copies of one offering are LP-indistinguishable, and their identical
    compat columns mean a group mask is exactly the member mask."""
    O = alloc.shape[0]
    keys: dict = {}
    group_of = np.empty(O, np.int64)
    keep = []
    for j in range(O):
        k = (alloc[j].tobytes(), float(price[j]), compat[:, j].tobytes())
        g = keys.get(k)
        if g is None:
            g = keys[k] = len(keep)
            keep.append(j)
        group_of[j] = g
    keep = np.asarray(keep, np.int64)
    return alloc[keep], price[keep], compat[:, keep], group_of


def _dual_certificate_ok(y: np.ndarray, mu: np.ndarray, reqf: np.ndarray,
                         cnt: np.ndarray, z: float, pc: np.ndarray,
                         pj: np.ndarray, xvals: np.ndarray,
                         tol: float = 1e-5) -> bool:
    """Cheap invariant pinning scipy's dual-sign convention (the pricing
    step at the rc computation below silently inverts if a scipy release
    flips marginal signs).  Two checks, both consequences of LP optimality
    under the convention the pricing assumes:

      * strong duality: the dual objective is b_eq·y + b_ub·μ, and b_ub is
        all zeros here, so y·cnt must reconstruct the primal objective;
      * complementary slackness: rc(c,j) = −y_c − Σ_r μ_jr·req[c,r] must
        vanish on in-support basic pairs (x[c,j] > 0).

    A flipped y fails the first; a flipped μ fails the second."""
    scale = max(1.0, abs(z))
    if abs(float(y @ cnt.astype(np.float64)) - z) > tol * scale:
        return False
    basic = xvals > 1e-9 * max(1.0, float(cnt.max()) if len(cnt) else 1.0)
    if not basic.any():
        return True
    rc = -y[pc[basic]] - np.einsum("pr,pr->p", reqf[pc[basic]], mu[pj[basic]])
    # rc is price-scaled (objective units); normalize like the duality gap
    return float(np.abs(rc).max()) <= tol * scale


# Device-path certificate tolerance: PDHG solves to a relative KKT
# tolerance of ~1e-4 (f32), so strong duality / complementary slackness
# hold to that order — the certificate still pins the SIGN convention
# (a flipped dual is off by O(1), not O(eps)), it just stops pretending
# the duals are vertex-exact the way HiGHS marginals are.
_DEVICE_CERT_TOL = 1e-3


def _report_device_failure(lp_health, reason: str) -> None:
    """One device-master failure: count the fallback and feed the
    DeviceLP ladder."""
    metrics.lp_solves().inc({"outcome": "demoted"})
    if lp_health is not None:
        lp_health.report_failure("device_lp", reason)


def _device_master(ub_rows, ub_cols, ub_vals, m_ub: int, pc, pj, P: int,
                   nvars: int, c_obj, cnt, reqf, O: int, R: int,
                   warm_key, lp_health, lp_device="cuda"):
    """Solve one restricted master on the device (ops/lpsolve.py PDHG)
    and validate its duals with the same sign certificate the scipy path
    uses.  Returns (x_vars, z, y, mu) in scipy's dual convention, or
    None after reporting the failure to the DeviceLP ladder (iteration
    cap / certificate failure — the caller re-solves through HiGHS).

    The dense operands are COMPRESSED to the active options (those with
    at least one support pair) before padding: an inactive option
    contributes only the degenerate row 0 − alloc_j·n_j ≤ 0 with n_j = 0
    at the optimum and a zero marginal — HiGHS absorbs those rows
    through sparsity, but on the dense device path a 3600-option catalog
    would pad the envelope ~50x past the ~dozens of seeded options the
    restricted master actually prices.  Their μ rows scatter back as 0,
    which is exactly the marginal HiGHS reports for them."""
    from . import lpsolve
    act = np.unique(pj)
    Oa = len(act)
    newj = np.full(O, -1, np.int64)
    newj[act] = np.arange(Oa)
    j_of_row = ub_rows // R
    keep = newj[j_of_row] >= 0
    rr = newj[j_of_row[keep]] * R + ub_rows[keep] % R
    cc = ub_cols[keep].copy()
    isn = cc >= P
    cc[isn] = P + newj[cc[isn] - P]
    A_ub = np.zeros((Oa * R, P + Oa), np.float64)
    A_ub[rr, cc] = ub_vals[keep]
    A_eq = np.zeros((len(cnt), P + Oa), np.float64)
    A_eq[pc, np.arange(P)] = 1.0
    c_act = np.concatenate([c_obj[:P], c_obj[P + act]])
    sol = lpsolve.solve_lp(c_act, A_eq=A_eq, b_eq=cnt.astype(np.float64),
                           A_ub=A_ub, b_ub=np.zeros(Oa * R),
                           warm_key=warm_key, device=lp_device)
    if not sol.converged:
        _report_device_failure(lp_health, "cap")
        return None
    # HiGHS returns a vertex with clean zeros; PDHG leaves 1e-4-scale
    # dust on non-basic entries.  Sweep it so the certificate's basic-
    # pair selection and the striper's floors see the same support a
    # vertex solution would.
    dust = 1e-4 * max(1.0, float(cnt.max()) if len(cnt) else 1.0)
    x_act = np.where(sol.x >= dust, sol.x, 0.0)
    x_vars = np.zeros(nvars)
    x_vars[:P] = x_act[:P]
    x_vars[P + act] = x_act[P:]
    z = float(c_obj @ x_vars)
    y, mu_flat = sol.scipy_duals()
    mu = np.zeros((O, R))
    mu[act] = mu_flat.reshape(Oa, R)
    if not _dual_certificate_ok(y, mu, reqf, cnt, z, pc, pj, x_vars[:P],
                                tol=_DEVICE_CERT_TOL):
        _report_device_failure(lp_health, "certificate")
        return None
    if lp_health is not None:
        lp_health.report_success("device_lp")
    return x_vars, z, y, mu


def exact_lp_mix(req: np.ndarray, cnt: np.ndarray, compat: np.ndarray,
                 alloc: np.ndarray, price: np.ndarray,
                 pricing_rounds: int = 3, add_per_round: int = 16,
                 tol: float = 1e-6, seed_support: Optional[np.ndarray] = None,
                 device: bool = False, lp_health=None,
                 warm_key: Optional[str] = None, lp_device="cuda"):
    """Class-LP optimum by option-granular column generation.  Returns
    (x C×O, objective, info) or (None, None, info) when scipy is
    unavailable or the LP fails.

    Seeding is the part that makes this fast: for a small family of
    resource weightings w (each axis alone, the uniform mix, pairwise
    mixes, and the bottleneck max), every class contributes its cheapest
    option under cost_w = price_j·Σ_r w_r·req_cr/alloc_jr.  That yields
    a few dozen ratio-diverse options whose restricted LP — ALL
    compatible (class, option) pairs for seeded options — lands on the
    full-LP optimum immediately on every bench shape measured (the
    ratio-matched option family the LP blends is exactly what the
    weighting sweep enumerates).  Safety net for adversarial shapes:
    price the excluded options with the master's duals, admit the worst
    `add_per_round`, and stop as soon as the objective stops improving —
    duals of these degenerate masters routinely flag options that cannot
    actually improve the optimum, so improvement (not rc-cleanliness) is
    the stopping criterion.  Certified bounds stay lpbound's job.

    `seed_support` (option indices) unions extra columns into the initial
    support — the refinery's warm start: the terminal support of the
    previous solve of the same class shapes, mapped by content, usually
    IS the new optimum's support, so the first restricted LP lands on it
    and pricing terminates in one round.

    `device=True` solves the restricted masters with the PDHG kernel on
    `lp_device` ("cuda" by default, "cpu" for the plain version)."""
    try:
        from scipy import sparse
        from scipy.optimize import linprog
    except ImportError:  # pragma: no cover — scipy is baked into the image
        return None, None, {"method": "none"}

    C, R = req.shape
    O = alloc.shape[0]
    reqf = req.astype(np.float64)
    allocf = alloc.astype(np.float64)
    pricef = price.astype(np.float64)
    inv_alloc = np.where(allocf > 0, 1.0 / np.maximum(allocf, 1e-12), 0.0)

    # ---- multi-weight seeding ----
    weights = [np.eye(R)[r] for r in range(R)]
    weights.append(np.ones(R) / R)
    for a in range(R):
        for b in range(a + 1, R):
            w = np.zeros(R)
            w[a] = w[b] = 0.5
            weights.append(w)
    S = np.zeros(O, bool)
    for w in weights:
        cost_w = pricef[None, :] * (reqf @ (inv_alloc * w[None, :]).T)
        cost_w = np.where(compat, cost_w, np.inf)
        S[np.unique(np.argmin(cost_w, axis=1))] = True
    ppm = np.where(compat, pricef[None, :] *
                   np.max(reqf[:, None, :] * inv_alloc[None, :, :], axis=2),
                   np.inf)
    S[np.unique(np.argmin(ppm, axis=1))] = True
    if seed_support is not None and len(seed_support):
        S[np.asarray(seed_support, np.int64)] = True

    info = {"method": "colgen-lp", "rounds": 0, "proven": False,
            "dual_check": True}
    # device masters are only attempted while the DeviceLP ladder says
    # the rung is healthy; a single in-call failure also stops retrying
    # (the scipy master this round already has the operands built)
    use_device = device and (lp_health is None or
                             lp_health.active_rung("device_lp") ==
                             "device_lp")
    x_full = None
    z = None
    for rnd in range(pricing_rounds):
        supp = compat & S[None, :]
        pc, pj = np.nonzero(supp)
        P = len(pc)
        nvars = P + O
        rows, cols, vals = [], [], []
        for r in range(R):
            nz = reqf[pc, r] != 0
            rows.append(pj[nz] * R + r)
            cols.append(np.nonzero(nz)[0])
            vals.append(reqf[pc[nz], r])
        rows.append(np.repeat(np.arange(O), R) * R + np.tile(np.arange(R), O))
        cols.append(np.repeat(np.arange(O) + P, R))
        vals.append(-allocf.reshape(-1))
        ub_rows = np.concatenate(rows)
        ub_cols = np.concatenate(cols)
        ub_vals = np.concatenate(vals)
        c_obj = np.concatenate([np.zeros(P), pricef])
        x_vars = None
        if use_device:
            dev = _device_master(ub_rows, ub_cols, ub_vals, O * R, pc, pj,
                                 P, nvars, c_obj, cnt, reqf, O, R,
                                 warm_key, lp_health, lp_device)
            if dev is None:
                use_device = False   # demoted: HiGHS for the rest of call
            else:
                x_vars, z_new, y, mu = dev
                info["method"] = "colgen-lp-device"
                cert_tol = _DEVICE_CERT_TOL
        if x_vars is None:
            A_ub = sparse.csr_matrix(
                (ub_vals, (ub_rows, ub_cols)), shape=(O * R, nvars))
            A_eq = sparse.csr_matrix((np.ones(P), (pc, np.arange(P))),
                                     shape=(C, nvars))
            res = linprog(c_obj, A_ub=A_ub, b_ub=np.zeros(O * R),
                          A_eq=A_eq, b_eq=cnt.astype(np.float64),
                          bounds=(0, None), method="highs")
            if not res.success:
                return None, None, info
            x_vars = res.x
            z_new = float(res.fun)
            # capacity rows (≤, duals μ ≤ 0 in scipy's sign), demand
            # rows (=, dual y)
            y = res.eqlin.marginals
            mu = res.ineqlin.marginals.reshape(O, R)
            cert_tol = 1e-5
        info["rounds"] = rnd + 1
        if z is not None and z_new > z - max(tol, tol * abs(z)):
            # pricing admitted options but the optimum didn't move —
            # dual-degeneracy noise, not real columns; keep the last x
            info["proven"] = True
            break
        z = z_new
        x_full = np.zeros((C, O))
        x_full[pc, pj] = x_vars[:P]
        # option pricing under the master's duals:
        # rc(c,j) = −y_c − Σ_r μ_jr·req[c,r]
        if not _dual_certificate_ok(y, mu, reqf, cnt, z_new, pc, pj,
                                    x_vars[:P], tol=cert_tol):
            # the duals don't certify this master (sign-convention drift
            # or a degenerate basis): pricing with them could admit
            # garbage columns or terminate early with a false "proven".
            # Keep the primal solution — it is still restricted-LP
            # optimal — but stop pricing and report it unproven.
            info["dual_check"] = False
            info["proven"] = False
            break
        rc = -y[:, None] - np.einsum("cr,jr->cj", reqf, mu)
        optmin = np.where(compat & ~S[None, :], rc, np.inf).min(axis=0)
        worst = np.argsort(optmin)[:add_per_round]
        worst = worst[optmin[worst] < -max(tol, tol * abs(z))]
        if len(worst) == 0:
            info["proven"] = True
            break
        S[worst] = True
    info["objective"] = z
    info["options_used"] = int(S.sum())
    info["support"] = np.nonzero(S)[0]
    return x_full, z, info


def _stripe_group(amounts: np.ndarray, ng: int, req: np.ndarray,
                  alloc: np.ndarray):
    """Distribute amounts[c] pods of each class across ng identical nodes
    WITHOUT exceeding any node's alloc.

    Least-loaded placement: classes go biggest-pod-first; each round a
    class puts one pod on each of the `remaining` least-loaded nodes
    that still fit it (load = bottleneck utilization).  Unlike
    ring-rotation striping — whose window-overlap variance demoted ~12%
    of pods on the bench's big blended group — this keeps fills balanced
    by construction, so only true integrality friction (a class whose
    pods no node can take anymore) demotes to the remainder.
    Returns (fills ng×C int64, demoted C int64)."""
    Cg = len(amounts)
    R = len(alloc)
    fills = np.zeros((ng, Cg), np.int64)
    used = np.zeros((ng, R), np.int64)
    inv_alloc = 1.0 / np.maximum(alloc.astype(np.float64), 1)
    demoted = np.zeros(Cg, np.int64)
    order = np.argsort(-np.max(req * inv_alloc[None, :], axis=1))
    for c in order:
        rem = int(amounts[c])
        rc = req[c]
        while rem > 0:
            fits = (used + rc[None, :] <= alloc[None, :]).all(axis=1)
            n_fit = int(fits.sum())
            if n_fit == 0:
                demoted[c] += rem
                break
            take = min(rem, n_fit)
            if take < n_fit:
                load = np.max(used * inv_alloc[None, :], axis=1)
                load[~fits] = np.inf
                target = np.argpartition(load, take - 1)[:take]
            else:
                target = np.nonzero(fits)[0]
            fills[target, c] += 1
            used[target] += rc
            rem -= take
    return fills, demoted


def _cache_put(cache: dict, cache_max: int, key, value) -> None:
    """Bounded check-then-insert under the shared lock (oldest-first
    eviction, same discipline as classpack's content caches)."""
    with _MIX_LOCK:
        while len(cache) >= cache_max:
            cache.pop(next(iter(cache)), None)
        cache[key] = value


def snapshot_caches() -> dict:
    """Plain-data export of the mix/stale/support caches for the
    WarmRestart snapshot (state/snapshot.py) — keys are content digests,
    values numpy arrays and scalars, all picklable.  Stale-entry stamps
    transfer as-is: they only matter inside one clock domain (the sim's
    virtual clock, or a same-boot restart); a cross-domain stamp just
    fails the staleness window and the entry recomputes."""
    with _MIX_LOCK:
        return {"mix": dict(_MIX_CACHE), "stale": dict(_STALE_CACHE),
                "support": dict(_SUPPORT_CACHE)}


def restore_caches(data: dict) -> None:
    with _MIX_LOCK:
        _MIX_CACHE.clear()
        _MIX_CACHE.update(data.get("mix", {}))
        _STALE_CACHE.clear()
        _STALE_CACHE.update(data.get("stale", {}))
        _SUPPORT_CACHE.clear()
        _SUPPORT_CACHE.update(data.get("support", {}))


def _mix_keys(problem: Problem, caps: np.ndarray, max_nodes: int):
    """Content digests at three granularities over the RAW inputs (the
    feasibility mask is a deterministic — and, at 50k scale, ~150ms —
    function of them, so cache hits skip recomputing it):

      * exact:  classes ⊕ counts ⊕ catalog ⊕ max_nodes — the mix cache key.
        max_nodes is part of it: a gate rejection under a tight launch cap
        must not disable the guide for the same pending set solved with a
        roomier budget.
      * stale:  the exact key MINUS counts/max_nodes — a tick whose pod
        counts changed but whose catalog fingerprint still matches can
        rescale an old mix (group space identical: the mask and dedup
        don't read counts).
      * shape:  class requests ⊕ caps only — the warm-start key; support
        columns survive catalog edits because they're stored by content.
    """
    rank = (problem.option_rank if problem.option_rank is not None
            else np.zeros(problem.num_options, np.int32))
    req_b = problem.class_requests.tobytes()
    cnt_b = problem.class_counts.tobytes()
    compat_b = np.packbits(problem.class_compat).tobytes()
    caps_b = caps.tobytes()
    cat_b = (problem.option_alloc.tobytes() + problem.option_price.tobytes()
             + np.ascontiguousarray(rank).tobytes())
    key = hashlib.blake2b(
        req_b + cnt_b + compat_b + caps_b + cat_b
        + str(max_nodes).encode(), digest_size=16).digest()
    stale_key = hashlib.blake2b(req_b + compat_b + caps_b + cat_b,
                                digest_size=16).digest()
    shape_key = hashlib.blake2b(req_b + caps_b, digest_size=16).digest()
    return key, stale_key, shape_key


def _round_mix(x: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Largest-remainder rounding per class: integer y with
    Σ_g y[c] == targets[c] exactly — no fractional leftovers ever reach
    the (greedy-priced) remainder solve."""
    y = np.floor(x)
    frac = x - y
    short = np.round(targets - y.sum(axis=1)).astype(np.int64)
    for c in np.nonzero(short > 0)[0]:
        top = np.argsort(-frac[c])[:short[c]]
        y[c, top] += 1
    return y


def _compute_mix(problem: Problem, caps: np.ndarray, stale_key=None,
                 shape_key=None, clock=time.monotonic, device: bool = False,
                 lp_health=None, lp_device="cuda"):
    """The expensive half of the guide: feasibility mask → dedup →
    (warm-started) colgen LP → largest-remainder rounding.  Returns the
    mix entry [y, n_g, group_of, z, ok, rejected] or None, refreshing the
    stale-guide and warm-start caches when keys are given.  With
    `device=True` (the DeviceLP gate) the restricted masters solve on
    the PDHG kernel — fast enough to run ON the provisioning tick, which
    is what closes the stale-guide window; otherwise this runs in-tick
    only when no refinery is wired, else in the refinery worker."""
    ok = _feasible_mask(problem)
    if ok.any(axis=1).sum() < 2:
        return None
    d_alloc, d_price, d_compat, group_of = _dedup_with_inverse(
        problem.option_alloc.astype(np.float64),
        problem.option_price.astype(np.float64), ok)
    # hostname-capped classes are excluded from the mix: the pooled LP
    # cannot honor per-node caps, so those classes go to the kernel
    uncapped = caps >= _BIG
    cnt_lp = np.where(uncapped, problem.class_counts, 0)
    seed = None
    if shape_key is not None:
        support = _SUPPORT_CACHE.get(shape_key)
        if support:
            by_content = {(d_alloc[j].tobytes(), float(d_price[j])): j
                          for j in range(len(d_price))}
            seed = [by_content[k] for k in support if k in by_content]
    x, z, info = exact_lp_mix(problem.class_requests, cnt_lp,
                              d_compat, d_alloc, d_price,
                              seed_support=seed, device=device,
                              lp_health=lp_health, lp_device=lp_device,
                              warm_key=(shape_key.hex() + ":master")
                              if shape_key is not None else None)
    if x is None:
        return None
    if shape_key is not None and info.get("support") is not None:
        _cache_put(_SUPPORT_CACHE, _SUPPORT_CACHE_MAX, shape_key,
                   [(d_alloc[j].tobytes(), float(d_price[j]))
                    for j in info["support"]])
    # the striper recomputes node counts from the rounded loads so the
    # slight overfill vs the fractional optimum stays inside each group's
    # ceil slack
    y = _round_mix(x, cnt_lp)
    loadg = np.einsum("cj,cr->jr", y,
                      problem.class_requests.astype(np.float64))
    n_g = np.max(loadg / np.maximum(d_alloc, 1e-12), axis=1)
    if stale_key is not None:
        _cache_put(_STALE_CACHE, _STALE_CACHE_MAX, stale_key, {
            "x": x, "cnt": cnt_lp.astype(np.float64), "group_of": group_of,
            "ok": ok, "alloc": d_alloc, "price": d_price, "stamp": clock()})
    return [y, n_g, group_of, float(z), ok, False]


def _stale_mix(problem: Problem, stale_key, caps: np.ndarray, now: float,
               ttl: float):
    """Rescale the freshest old mix whose catalog fingerprint still
    matches (same classes/compat/caps/options — only pod counts differ)
    to the current counts: per-class group distribution × new counts,
    largest-remainder rounded.  Bounded by the staleness window `ttl`.
    The gate's z is the rescaled mix's own fractional cost — achievable
    by construction, with the greedy-compare backstop unchanged."""
    ent = _STALE_CACHE.get(stale_key)
    if ent is None or not (now - ent["stamp"] <= ttl):
        return None
    covered = ent["cnt"] > 0
    uncapped = caps >= _BIG
    cnt_lp = np.where(uncapped & covered, problem.class_counts, 0)
    if not cnt_lp.any():
        return None
    frac = np.where(covered[:, None],
                    ent["x"] / np.maximum(ent["cnt"], 1e-12)[:, None], 0.0)
    x = frac * cnt_lp[:, None].astype(np.float64)
    y = _round_mix(x, cnt_lp)
    reqf = problem.class_requests.astype(np.float64)
    inv_alloc = 1.0 / np.maximum(ent["alloc"], 1e-12)
    n_g = np.max(np.einsum("cj,cr->jr", y, reqf) * inv_alloc, axis=1)
    z_est = float((np.max(np.einsum("cj,cr->jr", x, reqf) * inv_alloc,
                          axis=1) * ent["price"]).sum())
    return [y, n_g, ent["group_of"], z_est, ent["ok"], False]


def _refine_job(problem: Problem, caps: np.ndarray, max_nodes: int, key,
                stale_key, shape_key, clock, device: bool = False,
                lp_health=None, lp_device="cuda"):
    """Refinery worker body: compute the exact mix off the tick, land it
    in the content-keyed cache (upgrading the next tick), then price the
    greedy alternative so the refinery can raise the one-shot re-solve
    hint when the refined mix is a real saving.  Background refines use
    the device solver too when the DeviceLP rung is healthy — the same
    ladder the in-tick path consults."""
    with tracing.span("refinery.lp"):
        hit = _compute_mix(problem, caps, stale_key, shape_key, clock=clock,
                           device=device, lp_health=lp_health,
                           lp_device=lp_device)
    if hit is None:
        return None
    with tracing.span("refinery.price") as sp:
        _cache_put(_MIX_CACHE, _MIX_CACHE_MAX, key, hit)
        from .classpack import solve_classpack
        greedy = solve_classpack(problem, max_nodes=max_nodes, decode=False,
                                 guide=None, device=lp_device)
        sp.annotate(z_lp=hit[3], greedy_total=float(greedy.total_price))
    return {"z_lp": hit[3], "greedy_total": float(greedy.total_price)}


def solve_guided(problem: Problem, max_alternatives: int = 60,
                 max_nodes: int = 8192, ng_slack: float = 1.0,
                 refinery=None, device_lp: bool = False, lp_health=None,
                 device="cuda"):
    """LP-guided solve: stripe the LP mix into concrete node fills, then
    run the pack kernel on what the LP cannot see.

    1. `exact_lp_mix` gives x[c,g] (pods of class c on option group g)
       and the implied node counts n_g.
    2. The floor of each x[c,g] is STRIPED across ceil(n_g) nodes —
       integral per-node fills that reproduce the LP's blend (sequential
       first-fit cannot: its prefix rule concentrates every class on the
       earliest nodes and measured +19-30% cost).
    3. Everything integrality leaves over — fractional parts, striping
       repairs, hostname-capped classes the pooled LP cannot reason
       about — is a small remainder solved by the ordinary scan kernel
       against the striped nodes' leftover free space (existing columns)
       plus fresh launches.

    Returns a PackingResult indistinguishable from the greedy path's, or
    None when the guide does not apply (degenerate instance, scipy
    missing).  The mix is content-cached on (classes ⊕ catalog).

    With a `refinery` (ops/refinery.GuideRefinery), a mix-cache miss
    never blocks the caller on column generation: the freshest stale mix
    whose catalog fingerprint still matches serves immediately (bounded
    by the refinery's staleness window), else the caller falls back to
    greedy for this tick — either way the exact problem signature is
    enqueued and the refined mix upgrades the next tick.

    With `device_lp` (the DeviceLP gate; inherited from the refinery's
    wiring when one is attached) a miss is answered by the PDHG solver
    IN the same tick — the refine completes synchronously, the
    stale-guide window closes, and no refine job is enqueued.  Only when
    the device path fails (non-convergence or certificate failure, which
    demote the `lp_health` ladder) does the miss fall back to the
    stale/greedy + background-refine behavior above — the HiGHS rung of
    the LP ladder.

    `device` ("cuda" by default, "cpu" for the plain versions) runs the
    remainder and greedy-compare solves and the PDHG masters.
    """
    from .classpack import resolve_alternatives, solve_classpack
    from .ffd import NodeDecision, PackingResult

    C0, R = problem.class_requests.shape
    O0 = problem.num_options
    if C0 < 2 or O0 == 0:
        return None
    caps = (problem.class_node_cap if problem.class_node_cap is not None
            else np.full(C0, _BIG, np.int32))

    if refinery is not None:
        device_lp = device_lp or getattr(refinery, "device_lp", False)
        lp_health = lp_health if lp_health is not None else \
            getattr(refinery, "lp_health", None)

    key, stale_key, shape_key = _mix_keys(problem, caps, max_nodes)
    if device_lp:
        # device mixes are valid but not byte-equal to HiGHS mixes
        # (first-order vs vertex optimum of the same LP) — namespace the
        # cache keys so gate-on and gate-off runs sharing one process
        # never serve each other's mixes (golden determinism)
        key, stale_key, shape_key = (b"d" + key, b"d" + stale_key,
                                     b"d" + shape_key)
    hit = _MIX_CACHE.get(key)
    path = "warm"
    if hit is None:
        device_ok = device_lp and (lp_health is None or
                                   lp_health.active_rung("device_lp") ==
                                   "device_lp")
        if device_ok:
            # DeviceLP rung healthy: refine synchronously ON the tick —
            # the PDHG masters are fast enough that a cold miss ships a
            # refined (non-greedy) guide with no stale window
            clock = refinery.clock if refinery is not None \
                else time.monotonic
            hit = _compute_mix(problem, caps, stale_key, shape_key,
                               clock=clock, device=True,
                               lp_health=lp_health, lp_device=device)
            if hit is not None:
                _cache_put(_MIX_CACHE, _MIX_CACHE_MAX, key, hit)
                path = "device"
    if hit is None:
        if refinery is not None:
            # never block the tick on column generation: serve the
            # freshest matching stale mix (or greedy), refine off-tick
            hit = _stale_mix(problem, stale_key, caps, refinery.clock(),
                             refinery.stale_ttl)
            refinery.submit(key, lambda: _refine_job(
                problem, caps, max_nodes, key, stale_key, shape_key,
                refinery.clock, device=device_lp, lp_health=lp_health,
                lp_device=device))
            if hit is None:
                metrics.lpguide_requests().inc({"path": "cold"})
                tracing.annotate(guide_path="cold")
                return None
            path = "stale"
        else:
            path = "cold"
            hit = _compute_mix(problem, caps, stale_key, shape_key)
            if hit is None:
                return None
            _cache_put(_MIX_CACHE, _MIX_CACHE_MAX, key, hit)
    metrics.lpguide_requests().inc({"path": path})
    tracing.annotate(guide_path=path)
    x, n_g, group_of, z_lp, ok, rejected = hit
    if rejected:
        return None
    # per-round launch-cap contract: the striper creates
    # nodes directly, so it must honor max_nodes like the kernel's K cap
    # does — when the LP fleet alone would blow the budget, the greedy
    # path owns the cap semantics (pack what fits, leave the rest
    # unschedulable for the next round)
    if int(np.ceil(n_g - 1e-9).sum()) > max_nodes:
        return None

    members_arr = problem.members_arrays()
    reqs_int = problem.class_requests.astype(np.int64)
    consumed = np.zeros(C0, np.int64)
    ptr = np.zeros(C0, np.int64)

    # ---- stripe each LP-used group into integral node fills ----
    # assembled fully vectorized: per class one np.repeat gives each pod's
    # node id; one global stable argsort + boundary split then yields the
    # per-node pod lists (the same pattern the kernel decode uses) — no
    # per-(class, node) Python loop at 50k-pod scale
    all_node_ids: list = []
    all_pod_ids: list = []
    all_cls_ids: list = []
    node_oi_parts: list = []
    node_used_parts: list = []
    node_base = 0
    for g in np.nonzero(n_g > 1e-6)[0]:
        members = np.nonzero(group_of == g)[0]
        if not len(members):
            continue
        oi = int(members[0])
        cls = np.nonzero(x[:, g] >= 1.0)[0]
        amounts = np.floor(x[cls, g]).astype(np.int64)
        amounts = np.minimum(amounts,
                             problem.class_counts[cls] - consumed[cls])
        keep = amounts > 0
        cls, amounts = cls[keep], amounts[keep]
        if not len(cls):
            continue
        ng = int(np.ceil(n_g[g] * ng_slack - 1e-9))
        fills, demoted = _stripe_group(
            amounts, ng, reqs_int[cls],
            problem.option_alloc[oi].astype(np.int64))
        placed = amounts - demoted
        consumed[cls] += placed
        nodes_of_group = np.arange(ng)
        for k, c in enumerate(cls):
            n_pl = int(placed[k])
            if n_pl == 0:
                continue
            node_ids = np.repeat(nodes_of_group, fills[:, k]) + node_base
            all_node_ids.append(node_ids)
            all_pod_ids.append(members_arr[c][ptr[c]:ptr[c] + n_pl])
            all_cls_ids.append(np.full(n_pl, c, np.int64))
            ptr[c] += n_pl
        node_oi_parts.append(np.full(ng, oi, np.int64))
        node_used_parts.append(fills @ reqs_int[cls])
        node_base += ng

    if not all_node_ids:
        return None
    node_ids = np.concatenate(all_node_ids)
    pod_ids = np.concatenate(all_pod_ids)
    cls_ids = np.concatenate(all_cls_ids)
    order = np.argsort(node_ids, kind="stable")
    node_ids, pod_ids, cls_ids = (node_ids[order], pod_ids[order],
                                  cls_ids[order])
    starts = np.nonzero(np.diff(node_ids, prepend=np.int64(-1)))[0]
    ends = np.append(starts[1:], len(node_ids))
    occupied = node_ids[starts]                 # node id per non-empty node
    all_oi = np.concatenate(node_oi_parts) if node_oi_parts else \
        np.zeros(0, np.int64)
    all_used = np.concatenate(node_used_parts) if node_used_parts else \
        np.zeros((0, R), np.int64)
    bulk_oi = all_oi[occupied].tolist()
    bulk_pods = [pod_ids[s:e].tolist() for s, e in zip(starts, ends)]
    # duplicates are fine downstream (joint compat ANDs idempotently), so
    # skip the ~per-node np.unique
    bulk_cls = [cls_ids[s:e].tolist() for s, e in zip(starts, ends)]

    if not bulk_oi:
        return None

    # ---- cross-group tuck: demoted pods into ANY bulk node with room ----
    # Striping strands slivers per node (≈1-2% of bulk capacity) while
    # demoting the pods that no longer fit their OWN group; across groups
    # those slivers add up to whole node-equivalents.  One host-side
    # least-loaded pass over the entire fleet (compat-checked against each
    # node's option) re-places most demotions for free — measured 12%→
    # remainder drop to a few % on 50k-burst — and lets the remainder
    # solve run WITHOUT existing columns, keeping the fresh kernel's
    # compiled shapes.  Hostname-capped classes stay out (their per-node
    # caps need the kernel).
    rem = problem.class_counts.astype(np.int64) - consumed
    alloc_int = problem.option_alloc.astype(np.int64)
    used_mat = all_used[occupied].astype(np.int64)
    node_oi_arr = np.asarray(bulk_oi, np.int64)
    free_mat = alloc_int[node_oi_arr] - used_mat
    inv_node_alloc = 1.0 / np.maximum(alloc_int[node_oi_arr], 1)
    tuck_order = np.argsort(
        -(reqs_int / np.maximum(alloc_int.mean(axis=0), 1)).max(axis=1))
    # tucked placements accumulate as (node, pod, class) ARRAYS — one
    # np.repeat-style slice per round, one global stable argsort +
    # boundary split at the end — instead of a per-pod Python append loop
    # (O(remainder-pods) interpreter work on the 50k decode path)
    tuck_node_idx: list = []
    tuck_pod_ids: list = []
    tuck_cls_ids: list = []
    for c in tuck_order:
        if rem[c] <= 0:
            continue
        rc = reqs_int[c]
        # RAW compat, not the rank-restricted mask: pool-weight precedence
        # governs what to LAUNCH, never what already-bought capacity may
        # host (same rule as the kernel's existing columns)
        node_ok = problem.class_compat[c][node_oi_arr]
        # hostname-capped classes tuck too: striped bulk nodes host none
        # of their pods, so a fresh per-node counter enforces the cap
        # exactly (skipping them would force fresh launches for
        # pods the fleet's slivers could legally hold)
        placed_c = np.zeros(len(node_oi_arr), np.int64)
        cap_c = int(caps[c])
        mem = members_arr[c]
        while rem[c] > 0:
            fits = node_ok & (free_mat >= rc[None, :]).all(axis=1) & \
                (placed_c < cap_c)
            n_fit = int(fits.sum())
            if n_fit == 0:
                break
            take = min(int(rem[c]), n_fit)
            if take < n_fit:
                load = np.max(used_mat * inv_node_alloc, axis=1)
                load[~fits] = np.inf
                sel = np.argpartition(load, take - 1)[:take]
            else:
                sel = np.nonzero(fits)[0]
            tuck_node_idx.append(sel.astype(np.int64))
            tuck_pod_ids.append(mem[ptr[c]:ptr[c] + take])
            tuck_cls_ids.append(np.full(take, c, np.int64))
            ptr[c] += take
            used_mat[sel] += rc
            free_mat[sel] -= rc
            placed_c[sel] += 1
            consumed[c] += take
            rem[c] -= take
    if tuck_node_idx:
        tni = np.concatenate(tuck_node_idx)
        tpi = np.concatenate(tuck_pod_ids)
        tci = np.concatenate(tuck_cls_ids)
        t_order = np.argsort(tni, kind="stable")
        tni, tpi, tci = tni[t_order], tpi[t_order], tci[t_order]
        t_starts = np.nonzero(np.diff(tni, prepend=np.int64(-1)))[0]
        t_ends = np.append(t_starts[1:], len(tni))
        for s, e in zip(t_starts, t_ends):
            i = int(tni[s])
            bulk_pods[i].extend(tpi[s:e].tolist())
            # duplicates fine: cls_keys below sets/sorts per node
            bulk_cls[i].extend(tci[s:e].tolist())

    # ---- remainder: what even the tuck couldn't place, capped classes ----
    rem_cls = np.nonzero(rem > 0)[0]
    sub_res = None
    if len(rem_cls):
        sub = _subproblem(problem, rem_cls, rem[rem_cls], ptr)
        # fresh-only solve: the tuck already consumed the fleet's usable
        # slivers, so existing columns would add kernel shape variants for
        # nothing.  A fully consumed launch budget removes the catalog
        # outright — then these pods come back unschedulable for the next
        # round (a max(1, …) floor would leak an extra node).
        budget = max_nodes - len(bulk_oi)
        if budget <= 0:
            sub.options = []
            sub.option_alloc = sub.option_alloc[:0]
            sub.option_price = sub.option_price[:0]
            if sub.option_rank is not None:
                sub.option_rank = sub.option_rank[:0]
            if sub.option_zone is not None:
                sub.option_zone = sub.option_zone[:0]
            if sub.option_captype is not None:
                sub.option_captype = sub.option_captype[:0]
            sub.class_compat = sub.class_compat[:, :0]
            budget = 0
        sub_res = solve_classpack(sub, max_nodes=max(budget, 1),
                                  decode=True, guide=None,
                                  max_alternatives=max_alternatives,
                                  device=device)

    # ---- merge ----
    unschedulable: list = []
    new_nodes: list = []
    total = 0.0
    if sub_res is not None:
        unschedulable = sub_res.unschedulable
        new_nodes = sub_res.nodes
        total += sub_res.total_price

    # acceptance gate: when integrality friction blows the result past
    # the guide's design envelope (tiny fleets, where one node of ceil
    # slack is a large relative cost), price the greedy ALTERNATIVE with
    # one cheap aggregate solve and keep whichever plan is actually
    # better.  The envelope check means the extra kernel call only
    # happens on suspicious instances, never on the bench/product hot
    # path; rejections are remembered so re-solves skip straight to
    # greedy.
    probe_total = (sub_res.total_price if sub_res is not None else 0.0) + \
        sum(float(problem.option_price[oi]) for oi in bulk_oi)
    probe_unsched = len(unschedulable)
    # z_lp excludes hostname-capped classes, so on cap-heavy workloads
    # the envelope check would mis-trigger every solve — the
    # envelope is only meaningful when the LP priced most of the demand
    capped_frac = float(problem.class_counts[caps < _BIG].sum()) / \
        max(float(problem.class_counts.sum()), 1.0)
    if z_lp > 0 and capped_frac < 0.5 and probe_total > 1.08 * z_lp:
        greedy = solve_classpack(problem, max_nodes=max_nodes, decode=False,
                                 guide=None, device=device)
        # strictly worse only: a tie keeps the guided plan (its decode is
        # already materialized) instead of permanently rejecting the key
        if (probe_unsched, probe_total) > (len(greedy.unschedulable),
                                           greedy.total_price):
            hit[5] = True
            return None

    # memo keys are the nodes' class SETS — joint-compat bits are only
    # computed for memo misses inside resolve_alternatives (a fleet-wide
    # AND costs ~100ms at 50k; the distinct keys are a few hundred)
    cls_keys = [tuple(sorted(set(cl))) for cl in bulk_cls]
    resolved = resolve_alternatives(problem, bulk_oi, None, used_mat,
                                    max_alternatives, cls_keys=cls_keys)
    nodes = []
    for i, oi in enumerate(bulk_oi):
        alts, used_rl = resolved[i]
        nodes.append(NodeDecision(option=problem.options[oi],
                                  pod_indices=bulk_pods[i],
                                  used=used_rl, alternatives=alts))
        total += float(problem.option_price[oi])
    nodes.extend(new_nodes)
    return PackingResult(nodes=nodes, unschedulable=unschedulable,
                         existing_assignments={}, total_price=total)


def _subproblem(problem: Problem, cls: np.ndarray, counts: np.ndarray,
                ptr: np.ndarray) -> Problem:
    """A Problem restricted to `cls` with `counts` pods each, whose member
    lists are the UNCONSUMED tails of the original classes — so every pod
    index in the sub-solve's result is a real original pod id."""
    import copy
    members_arr = problem.members_arrays()
    sub = copy.copy(problem)
    sub.class_requests = problem.class_requests[cls]
    sub.class_counts = counts.astype(np.int32)
    sub.class_compat = problem.class_compat[cls]
    if problem.class_node_cap is not None:
        sub.class_node_cap = problem.class_node_cap[cls]
    sub.class_members = [members_arr[c][ptr[c]:ptr[c] + n]
                         for c, n in zip(cls, counts)]
    sub.__dict__.pop("_members_arr", None)
    sub.__dict__.pop("_class_order", None)
    return sub
