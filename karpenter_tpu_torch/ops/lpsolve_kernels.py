"""Wrapper of the restarted-PDHG LP kernel (csrc/lpsolve.cu).

| kernel | replaces (JAX package)                          |
|--------|-------------------------------------------------|
| pdhg   | ops/lpsolve.py `_pdhg_kernel` :145-329 (row 12) |

The kernel comes in two forms, chosen before the launch from shapes and
device attributes only (`resident_plan`): where the scaled operator fits
the SMs' combined shared memory, the RESIDENT kernel keeps one tile of it
in each block's shared memory for the whole solve; where it does not, the
STREAMING kernel reads it from L2 / HBM at every step.  Both are
hand-written kernels of the same launch; a fault of either raises
`KernelError`, and neither retries on the other.

In the idiom of `classpack_kernels.py`:

  * `pdhg_plain` is the plain PyTorch version of the same function (the
    JAX program's einsums and `while_loop`, written out in float32).  The
    wrapper runs it ONLY when its tensors lie on the CPU; on the card it is
    the oracle `chip_smoke.py` holds the kernel against.  On CUDA tensors it
    refuses to run with TF32 matmuls enabled: the oracle must be float32.
  * `LAUNCHES["pdhg"]` is raised by one exactly where the wrapper launches
    the kernel, in either form; `LAUNCHES["pdhg_resident"]` also counts
    the launches of the resident form.
  * On CUDA tensors the wrapper checks device, dtype, shape and contiguity,
    allocates outputs and scratch with torch, launches on the current
    stream through the ctypes library and raises on any `cudaError_t`.
    There is no fallback to the plain version on the card.

Problem form, per batch member b (all float32, padded exactly):

    min c·x  s.t.  A x = b,  G x ≤ h,  0 ≤ x ≤ u        (u may be +inf)

Outputs: (dc·x, de·y, di·λ, done, iters, restarts, pres, dres, gap), the
unscaled primal and duals of the adopted iterate and each member's exit
statistics, as the JAX program returns them.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import torch

from .._build import KernelError

KERNELS = ("pdhg", "pdhg_resident")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

_RESTART_DECAY = 0.36     # sufficient-decay restart threshold (PDLP β)
_RESTART_LEN = 512        # artificial restart: epoch length cap (iters)
_TINY = 1e-12


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


def restart_len(check_every: int) -> int:
    """Epoch-length cap in checks: max(512 // check_every, 2)."""
    return max(_RESTART_LEN // int(check_every), 2)


# ---------------------------------------------------------------------------
# the library
# ---------------------------------------------------------------------------

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from .._build import load
        lib = load("lpsolve")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lp_error_string.argtypes = [i]
        lib.lp_error_string.restype = ctypes.c_char_p
        lib.lp_scalar_slots.restype = i
        lib.lp_resident_budget.argtypes = [ctypes.POINTER(i)] * 3
        lib.lp_resident_budget.restype = i
        lib.lp_resident_smem.argtypes = [i, i]
        lib.lp_resident_smem.restype = ctypes.c_longlong
        lib.lp_pdhg.argtypes = ([p] * 9 + [i] * 4 + [f] + [i] * 3
                                + [p] * 7 + [p] * 7 + [i] * 4 + [p] * 2
                                + [p])
        lib.lp_pdhg.restype = i
        _LIB = lib
    return _LIB


def _raise_on(err: int, name: str) -> None:
    if err:
        msg = _lib().lp_error_string(err).decode()
        raise KernelError(f"{name}: CUDA error {err} ({msg})")


def _on_cuda(*tensors) -> bool:
    """True for all-CUDA inputs, False for all-CPU; mixed devices raise."""
    devs = {t.device for t in tensors if t is not None}
    kinds = {d.type for d in devs}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len(devs) == 1:
        return True
    raise ValueError(f"inputs on mixed or unsupported devices: {sorted(map(str, devs))}")


def _check(t: torch.Tensor, name: str, shape) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


# ---------------------------------------------------------------------------
# the resident plan
# ---------------------------------------------------------------------------

RED_FLOATS = 1024     # csrc/lpsolve.cu kRedFloats


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def resident_smem_bytes(h: int, w: int) -> int:
    """Dynamic shared memory of one resident block (csrc/lpsolve.cu
    `resident_smem_bytes`): the tile hp × w, seven column-band and five
    row-band vectors, and the column pass's partials; hp = h rounded up
    to 4."""
    hp = 4 * _ceil(h, 4)
    return 4 * (hp * w + 7 * w + 5 * hp + RED_FLOATS)


@dataclass(frozen=True)
class ResidentPlan:
    """B members, each cut into `row_bands` bands of `band_rows` rows and
    `col_bands` bands of `band_cols` columns (a multiple of 4): one block
    per tile, `blocks` = B × row_bands × col_bands, each holding
    `smem_bytes` of dynamic shared memory."""
    B: int
    mt: int
    n: int
    row_bands: int
    col_bands: int
    band_rows: int
    band_cols: int

    @property
    def blocks(self) -> int:
        return self.B * self.row_bands * self.col_bands

    @property
    def smem_bytes(self) -> int:
        return resident_smem_bytes(self.band_rows, self.band_cols)

    def tiles(self) -> Iterator[Tuple[int, int, int, int, int]]:
        """(member, first row, end row, first column, end column) of each
        block's tile, in block order."""
        for b in range(self.B):
            for rb in range(self.row_bands):
                r0 = rb * self.band_rows
                for cb in range(self.col_bands):
                    c0 = cb * self.band_cols
                    yield (b, r0, min(r0 + self.band_rows, self.mt), c0,
                           min(c0 + self.band_cols, self.n))


def _step_cost(h: int, w: int, R: int, Q: int) -> float:
    """A model of one PDHG step of a resident block, in SM clocks: the two
    passes over the tile at 128 B per clock of shared memory, the partials
    of the other bands read from L2 (about 32 B per clock), and the two
    band arrivals when the member has more than one block."""
    smem = 2 * 4 * h * w / 128
    reduce = 4 * ((h * Q if Q > 1 else 0) + (w * R if R > 1 else 0)) / 32
    sync = 2000 + 20 * (R + Q) if R * Q > 1 else 0
    return smem + reduce + sync


def resident_plan(B: int, mt: int, n: int, sms: int,
                  smem_per_block: int) -> Optional[ResidentPlan]:
    """The tile plan of the resident PDHG kernel, or None when the scaled
    operator (B × mt × n float32) does not fit: at most `sms` blocks, one
    per SM, each tile and its band vectors within `smem_per_block` bytes.
    Every member gets the same bands; among the plans that fit, the one of
    least modelled step time (`_step_cost`), then of fewest blocks."""
    if min(B, mt, n, sms) <= 0 or B * mt * n * 4 > sms * smem_per_block:
        return None
    best, best_key = None, None
    for R in range(1, min(mt, sms // B) + 1):
        h = _ceil(mt, R)
        if _ceil(mt, h) != R:           # the same bands as a smaller R
            continue
        for Q in range(1, sms // (B * R) + 1):
            w = 4 * _ceil(_ceil(n, Q), 4)
            if _ceil(n, w) != Q:
                continue
            if resident_smem_bytes(h, w) > smem_per_block:
                continue
            key = (_step_cost(h, w, R, Q), R * Q)
            if best_key is None or key < best_key:
                best, best_key = (R, Q, h, w), key
    if best is None:
        return None
    R, Q, h, w = best
    return ResidentPlan(B=B, mt=mt, n=n, row_bands=R, col_bands=Q,
                        band_rows=h, band_cols=w)


def device_smem(dev: torch.device) -> Tuple[int, int, int]:
    """(SMs, opt-in shared memory per block, dynamic shared memory one
    resident block can hold) of `dev`, read from the device and the built
    kernel."""
    lib = _lib()
    sms, optin, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(dev):
        _raise_on(lib.lp_resident_budget(ctypes.byref(sms),
                                         ctypes.byref(optin),
                                         ctypes.byref(smem)), "pdhg")
    return sms.value, optin.value, smem.value


def device_plan(B: int, mt: int, n: int,
                dev: torch.device) -> Optional[ResidentPlan]:
    """The resident plan of a B × mt × n envelope on `dev`, or None: the
    launch takes the streaming kernel."""
    sms, _, smem = device_smem(dev)
    return resident_plan(B, mt, n, sms, smem)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _kkt(A, b, G, h, c, u_fin, u_free, rhs_nrm, c_nrm, dc, de, di, x, y,
         lam):
    """Relative KKT score of a SCALED iterate, measured against the
    unscaled operands: primal/dual infeasibility and duality gap."""
    xo = dc * x
    yo = de * y
    lo = di * lam
    r_eq = torch.einsum("bmn,bn->bm", A, xo) - b
    r_ub = torch.clamp(torch.einsum("bmn,bn->bm", G, xo) - h, min=0.0)
    pres = torch.maximum(r_eq.abs().amax(dim=1),
                         r_ub.amax(dim=1)) / (1.0 + rhs_nrm)
    rc = c + torch.einsum("bmn,bm->bn", A, yo) + \
        torch.einsum("bmn,bm->bn", G, lo)
    dres = (torch.clamp(-rc, min=0.0) * u_free).amax(dim=1) / (1.0 + c_nrm)
    pobj = (c * xo).sum(dim=1)
    dobj = -(b * yo).sum(dim=1) - (h * lo).sum(dim=1) + \
        (torch.clamp(rc, max=0.0) * u_fin).sum(dim=1)
    gap = (pobj - dobj).abs() / (1.0 + pobj.abs() + dobj.abs())
    score = torch.maximum(torch.maximum(pres, dres), gap)
    return score, pres, dres, gap


def _absmax(t: torch.Tensor, dim: int) -> torch.Tensor:
    """jnp.max(|t|, axis=dim, initial=0.0): 0 over an empty axis."""
    if t.shape[dim] == 0:
        shape = list(t.shape)
        del shape[dim]
        return torch.zeros(shape, dtype=t.dtype, device=t.device)
    return t.abs().amax(dim=dim)


def pdhg_plain(A, b, G, h, c, u, init_x, init_y, init_lam, eps: float,
               iters_cap: int, check_every: int):
    """The JAX program `_pdhg_kernel` in plain PyTorch, float32: 8 Ruiz
    sweeps, 24 power iterations for ‖[A;G]‖₂, then the restarted loop with
    a KKT check every `check_every` steps and a per-member `done` freeze.
    The loop reads `done` on the host once per check."""
    if A.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("pdhg_plain is the float32 oracle: disable "
                           "torch.backends.cuda.matmul.allow_tf32")
    f32 = torch.float32
    dev = A.device
    A, G, b, h, c, u = (t.to(f32) for t in (A, G, b, h, c, u))
    B, me, n = A.shape
    mi = G.shape[1]
    tiny = torch.tensor(_TINY, dtype=f32, device=dev)

    u_free = torch.isinf(u).to(f32)
    u_fin = torch.where(torch.isinf(u), torch.zeros_like(u), u)
    rhs_nrm = torch.maximum(_absmax(b, 1), _absmax(h, 1))
    c_nrm = _absmax(c, 1)

    As, Gs = A.clone(), G.clone()
    de = torch.ones((B, me), dtype=f32, device=dev)
    di = torch.ones((B, mi), dtype=f32, device=dev)
    dc = torch.ones((B, n), dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    for _ in range(8):
        re = _absmax(As, 2)
        ri = _absmax(Gs, 2)
        se = torch.where(re > tiny, one / torch.sqrt(torch.maximum(re, tiny)),
                         one)
        si = torch.where(ri > tiny, one / torch.sqrt(torch.maximum(ri, tiny)),
                         one)
        As = As * se[:, :, None]
        Gs = Gs * si[:, :, None]
        col = torch.maximum(_absmax(As, 1), _absmax(Gs, 1))
        sc = torch.where(col > tiny,
                         one / torch.sqrt(torch.maximum(col, tiny)), one)
        As = As * sc[:, None, :]
        Gs = Gs * sc[:, None, :]
        de, di, dc = de * se, di * si, dc * sc
    bs = b * de
    hs = h * di
    cs = c * dc
    us = u / torch.maximum(dc, tiny)

    v0 = 1.0 + 0.5 * torch.cos(torch.arange(n, dtype=f32, device=dev)
                               * torch.tensor(1.618, dtype=f32, device=dev))
    v = v0.expand(B, n)
    v = v / torch.sqrt((v * v).sum(dim=1, keepdim=True))
    sigma = torch.ones(B, dtype=f32, device=dev)
    for _ in range(24):
        we = torch.einsum("bmn,bn->bm", As, v)
        wi = torch.einsum("bmn,bn->bm", Gs, v)
        vn = torch.einsum("bmn,bm->bn", As, we) + \
            torch.einsum("bmn,bm->bn", Gs, wi)
        nrm = torch.sqrt((vn * vn).sum(dim=1))
        sigma = torch.sqrt(torch.maximum(nrm, tiny))
        v = vn / torch.maximum(nrm, tiny)[:, None]
    sigma = torch.clamp(sigma, min=1e-6)
    eta = 0.9 / sigma

    nc = torch.sqrt((cs * cs).sum(dim=1))
    nrhs = torch.sqrt((bs * bs).sum(dim=1) + (hs * hs).sum(dim=1))
    omega = torch.where((nc > tiny) & (nrhs > tiny),
                        torch.clamp(nc / torch.maximum(nrhs, tiny), 1e-2,
                                    1e2), one)

    x = torch.minimum(torch.clamp(init_x.to(f32) / torch.maximum(dc, tiny),
                                  min=0.0), us)
    y = init_y.to(f32) / torch.maximum(de, tiny)
    lam = torch.clamp(init_lam.to(f32) / torch.maximum(di, tiny), min=0.0)
    xs, ys, ls = torch.zeros_like(x), torch.zeros_like(y), \
        torch.zeros_like(lam)
    xa, ya, la = x.clone(), y.clone(), lam.clone()
    i32 = torch.int32
    elen = torch.zeros(B, dtype=i32, device=dev)
    score_anc = torch.full((B,), float("inf"), dtype=f32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=i32, device=dev)
    restarts = torch.zeros(B, dtype=i32, device=dev)
    pres = torch.zeros(B, dtype=f32, device=dev)
    dres = torch.zeros(B, dtype=f32, device=dev)
    gap = torch.zeros(B, dtype=f32, device=dev)
    eps_t = torch.tensor(eps, dtype=f32, device=dev)
    rl = restart_len(check_every)

    k = 0
    while k * check_every < iters_cap and not bool(done.all()):
        live = ~done
        lv = live[:, None]
        livec = lv.to(f32)
        tau = (eta / omega)[:, None]
        sig = (eta * omega)[:, None]
        for _ in range(check_every):
            kty = torch.einsum("bmn,bm->bn", As, y) + \
                torch.einsum("bmn,bm->bn", Gs, lam)
            xn = torch.minimum(torch.clamp(x - tau * (cs + kty), min=0.0), us)
            xb = 2.0 * xn - x
            yn = y + sig * (torch.einsum("bmn,bn->bm", As, xb) - bs)
            ln = torch.clamp(
                lam + sig * (torch.einsum("bmn,bn->bm", Gs, xb) - hs),
                min=0.0)
            x = torch.where(lv, xn, x)
            y = torch.where(lv, yn, y)
            lam = torch.where(lv, ln, lam)
            xs, ys, ls = xs + livec * x, ys + livec * y, ls + livec * lam
        elen = elen + check_every * live.to(i32)

        div = torch.clamp(elen, min=1).to(f32)[:, None]
        sc_, pc_, dc_, gc_ = _kkt(A, b, G, h, c, u_fin, u_free, rhs_nrm,
                                  c_nrm, dc, de, di, x, y, lam)
        sa_, pa_, da_, ga_ = _kkt(A, b, G, h, c, u_fin, u_free, rhs_nrm,
                                  c_nrm, dc, de, di, xs / div, ys / div,
                                  ls / div)
        use_avg = sa_ < sc_
        ua = use_avg[:, None]
        bx = torch.where(ua, xs / div, x)
        by = torch.where(ua, ys / div, y)
        bl = torch.where(ua, ls / div, lam)
        bscore = torch.minimum(sa_, sc_)
        bpres = torch.where(use_avg, pa_, pc_)
        bdres = torch.where(use_avg, da_, dc_)
        bgap = torch.where(use_avg, ga_, gc_)

        newly = live & (bscore <= eps_t)
        suff = bscore <= _RESTART_DECAY * score_anc
        long_epoch = elen >= rl * check_every
        adopt = live & (suff | long_epoch | newly)

        dxn = torch.sqrt(((bx - xa) ** 2).sum(dim=1))
        dyn = torch.sqrt(((by - ya) ** 2).sum(dim=1)
                         + ((bl - la) ** 2).sum(dim=1))
        ok = (dxn > tiny) & (dyn > tiny)
        om_new = torch.clamp(torch.exp(
            0.5 * torch.log(torch.maximum(dyn, tiny) / torch.maximum(dxn, tiny))
            + 0.5 * torch.log(omega)), 1e-3, 1e3)
        omega = torch.where(adopt & ok & ~newly, om_new, omega)

        ad = adopt[:, None]
        x, y, lam = (torch.where(ad, bx, x), torch.where(ad, by, y),
                     torch.where(ad, bl, lam))
        xs, ys, ls = (torch.where(ad, torch.zeros_like(xs), xs),
                      torch.where(ad, torch.zeros_like(ys), ys),
                      torch.where(ad, torch.zeros_like(ls), ls))
        elen = torch.where(adopt, torch.zeros_like(elen), elen)
        xa, ya, la = (torch.where(ad, bx, xa), torch.where(ad, by, ya),
                      torch.where(ad, bl, la))
        score_anc = torch.where(adopt, bscore, score_anc)
        done = done | newly
        iters = iters + check_every * live.to(i32)
        restarts = restarts + (adopt & ~newly).to(i32)
        pres = torch.where(live, bpres, pres)
        dres = torch.where(live, bdres, dres)
        gap = torch.where(live, bgap, gap)
        k += 1
    return (dc * x, de * y, di * lam, done, iters, restarts, pres, dres, gap)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def pdhg(A: torch.Tensor, b: torch.Tensor, G: torch.Tensor, h: torch.Tensor,
         c: torch.Tensor, u: torch.Tensor, init_x: torch.Tensor,
         init_y: torch.Tensor, init_lam: torch.Tensor, eps: float,
         iters_cap: int, check_every: int) -> Tuple[torch.Tensor, ...]:
    """Batched restarted PDHG.  Shapes: A (B,me,n), G (B,mi,n), b (B,me),
    h (B,mi), c/u/init_x (B,n), init_y (B,me), init_lam (B,mi), all
    float32.  One launch runs the whole solve (scaling, power iteration and
    the restarted loop) on the card."""
    if not _on_cuda(A, b, G, h, c, u, init_x, init_y, init_lam):
        return pdhg_plain(A, b, G, h, c, u, init_x, init_y, init_lam, eps,
                          iters_cap, check_every)
    B, me, n = A.shape
    mi = G.shape[1]
    if B == 0 or n == 0 or me + mi == 0:
        raise ValueError(f"empty LP envelope: B={B}, n={n}, me={me}, mi={mi}")
    if int(check_every) <= 0:
        raise ValueError(f"check_every={check_every} must be positive")
    _check(A, "A", (B, me, n))
    _check(G, "G", (B, mi, n))
    _check(b, "b", (B, me))
    _check(h, "h", (B, mi))
    for t, name in ((c, "c"), (u, "u"), (init_x, "init_x")):
        _check(t, name, (B, n))
    _check(init_y, "init_y", (B, me))
    _check(init_lam, "init_lam", (B, mi))
    lib = _lib()
    dev = A.device
    f32, i32 = torch.float32, torch.int32
    mt = me + mi
    plan = device_plan(B, mt, n, dev)
    emp = lambda *s: torch.empty(s, dtype=f32, device=dev)  # noqa: E731
    # scratch: the scaled stacked operator, row/column scalings, the scaled
    # data, the iterates with their epoch sums and anchors, per-row and
    # per-column check values, per-member scalars, the grid barrier and
    # (resident) the band partials and arrival counters
    ks = emp(B, mt, n)
    vec_n = emp(8, B, n)
    vec_m = emp(8, B, mt)
    rowv = emp(B, mt, 4)
    colv = emp(B, n, 6)
    scal = emp(B, lib.lp_scalar_slots())
    if plan is None:
        bands = (0, 0, 0, 0)
        pc = pr = None
    else:
        bands = (plan.row_bands, plan.col_bands, plan.band_rows,
                 plan.band_cols)
        pc = emp(2, B, plan.row_bands, n)
        pr = emp(2, B, plan.col_bands, mt)
    bar = torch.zeros(2 + B * (bands[0] + bands[1]), dtype=i32, device=dev)
    x_out, y_out, l_out = emp(B, n), emp(B, me), emp(B, mi)
    done = torch.empty(B, dtype=i32, device=dev)
    iters = torch.empty(B, dtype=i32, device=dev)
    restarts = torch.empty(B, dtype=i32, device=dev)
    stats = emp(3, B)
    with torch.cuda.device(dev):
        err = lib.lp_pdhg(
            A.data_ptr(), b.data_ptr(), G.data_ptr(), h.data_ptr(),
            c.data_ptr(), u.data_ptr(), init_x.data_ptr(),
            init_y.data_ptr(), init_lam.data_ptr(), B, me, mi, n,
            float(eps), int(iters_cap), int(check_every),
            restart_len(check_every), ks.data_ptr(), vec_n.data_ptr(),
            vec_m.data_ptr(), rowv.data_ptr(), colv.data_ptr(),
            scal.data_ptr(), bar.data_ptr(), x_out.data_ptr(),
            y_out.data_ptr(), l_out.data_ptr(), done.data_ptr(),
            iters.data_ptr(), restarts.data_ptr(), stats.data_ptr(),
            *bands, None if pc is None else pc.data_ptr(),
            None if pr is None else pr.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "pdhg" if plan is None else "pdhg (resident)")
    LAUNCHES["pdhg"] += 1
    if plan is not None:
        LAUNCHES["pdhg_resident"] += 1
    return (x_out, y_out, l_out, done.bool(), iters, restarts, stats[0],
            stats[1], stats[2])
