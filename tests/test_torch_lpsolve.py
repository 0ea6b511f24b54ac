"""The port's PDHG program against the JAX package's, on the CPU.

The same numpy operands, padded by the same host lowering, go through the
JAX package's jit'd `_pdhg_kernel` and the port's `_pdhg_kernel` (the plain
PyTorch version: `device="cpu"`).  Float32 sums run in another order in the
two, so iterates may differ in the last bits and a restart or convergence
decision near its threshold may land on another check.  The criteria:

  * the same status (converged / cap);
  * objectives within RTOL = 1e-3 of each other and of HiGHS's;
  * primal x within 2e-2 (absolute) of the JAX package's;
  * iteration counts within a factor 1.5 of the JAX package's;
  * a batch equals its members solved alone (the `done` freeze).
"""

import numpy as np
import pytest
from scipy.optimize import linprog

from karpenter_tpu.ops import lpsolve as ref_lp
from karpenter_tpu_torch.ops import lpsolve as port_lp
from karpenter_tpu_torch.ops import lpsolve_kernels as lk
from torch_cases import one_torch_thread  # noqa: F401
from torch_cases import random_lp as _random_lp

RTOL = 1e-3
X_ATOL = 2e-2
ITER_FACTOR = 1.5


@pytest.fixture(autouse=True)
def _fresh_warm_caches():
    ref_lp.reset_caches()
    port_lp.reset_caches()
    yield
    ref_lp.reset_caches()
    port_lp.reset_caches()


def _highs(c, A, b, G, h, u):
    res = linprog(c, A_ub=G, b_ub=h, A_eq=A, b_eq=b,
                  bounds=np.stack([np.zeros(len(c)), u], axis=1),
                  method="highs")
    assert res.success
    return res.fun


def _tiny_master():
    """tests/test_lpsolve.py's 3-class / 4-option master, as the dense
    restricted LP `_device_master` builds (every pair in the support)."""
    rng = np.random.default_rng(21)
    req = rng.uniform(1.0, 3.0, (3, 2))
    cnt = np.array([5, 3, 4])
    alloc = rng.uniform(8.0, 16.0, (4, 2))
    price = rng.uniform(1.0, 2.0, 4)
    C, R, O = 3, 2, 4
    pc, pj = np.nonzero(np.ones((C, O), bool))
    P = len(pc)
    A_ub = np.zeros((O * R, P + O))
    for r in range(R):
        A_ub[pj * R + r, np.arange(P)] = req[pc, r]
    A_ub[np.arange(O * R), P + np.repeat(np.arange(O), R)] = \
        -alloc.reshape(-1)
    A_eq = np.zeros((C, P + O))
    A_eq[pc, np.arange(P)] = 1.0
    c = np.concatenate([np.zeros(P), price])
    return c, A_eq, cnt.astype(np.float64), A_ub, np.zeros(O * R), None


def _both_kernels(insts, iters_cap=port_lp.DEFAULT_ITERS_CAP,
                  buckets=port_lp.LP_BUCKETS):
    """Both packages' `_pdhg_kernel` on one padded batch: (ref, port), each
    a tuple of numpy outputs."""
    import torch
    bt = port_lp.pad_batch(insts, buckets)
    ref = ref_lp._pdhg_kernel(*[a.copy() for a in bt.operands()],
                              np.float32(port_lp.DEFAULT_EPS),
                              iters_cap=int(iters_cap),
                              check_every=port_lp.DEFAULT_CHECK_EVERY)
    port = port_lp._pdhg_kernel(*[torch.from_numpy(a.copy())
                                  for a in bt.operands()],
                                port_lp.DEFAULT_EPS, iters_cap=int(iters_cap),
                                check_every=port_lp.DEFAULT_CHECK_EVERY)
    return ([np.asarray(o) for o in ref], [o.numpy() for o in port], bt)


def _assert_close(ref, port, c_pad, n):
    """Status, objective, x and iteration criteria on batch member 0."""
    assert bool(ref[3][0]) == bool(port[3][0])
    obj_r = float(c_pad[0].astype(np.float64) @ ref[0][0].astype(np.float64))
    obj_p = float(c_pad[0].astype(np.float64) @ port[0][0].astype(np.float64))
    assert obj_p == pytest.approx(obj_r, rel=RTOL, abs=RTOL)
    np.testing.assert_allclose(port[0][0][:n], ref[0][0][:n], atol=X_ATOL)
    it_r, it_p = int(ref[4][0]), int(port[4][0])
    assert it_p <= ITER_FACTOR * it_r and it_r <= ITER_FACTOR * it_p
    return obj_p


@pytest.mark.parametrize("n,me,mi", [(20, 5, 8), (40, 10, 16), (80, 20, 30)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pdhg_program_matches_reference(n, me, mi, seed):
    rng = np.random.default_rng(1000 * seed + n)
    c, A, b, G, h, u = _random_lp(rng, n, me, mi)
    ref, port, bt = _both_kernels([port_lp.LPInstance(
        c=np.asarray(c, np.float32), A_eq=A, b_eq=b, A_ub=G, b_ub=h,
        upper=u)])
    assert bool(port[3][0])                             # converged
    obj = _assert_close(ref, port, bt.c, n)
    assert obj == pytest.approx(_highs(c, A, b, G, h, u), rel=RTOL, abs=RTOL)


@pytest.mark.parametrize("n,me,mi", [(20, 5, 8), (80, 20, 30)])
def test_solve_lp_matches_reference_and_highs(n, me, mi):
    """The host wrappers too: row equilibration, unpadding, dual
    unscaling and scipy's sign convention."""
    c, A, b, G, h, u = _random_lp(np.random.default_rng(7 + n), n, me, mi)
    want = ref_lp.solve_lp(c, A_eq=A, b_eq=b, A_ub=G, b_ub=h, upper=u)
    got = port_lp.solve_lp(c, A_eq=A, b_eq=b, A_ub=G, b_ub=h, upper=u,
                           device="cpu")
    assert got.status == want.status == port_lp.STATUS_CONVERGED
    assert got.obj == pytest.approx(want.obj, rel=RTOL, abs=RTOL)
    assert got.obj == pytest.approx(_highs(c, A, b, G, h, u), rel=RTOL,
                                    abs=RTOL)
    np.testing.assert_allclose(got.x, want.x, atol=X_ATOL)
    for g, w in zip(got.scipy_duals(), want.scipy_duals()):
        np.testing.assert_allclose(g, w, atol=5e-3)
    assert (got.lam >= 0).all()
    assert got.iterations <= ITER_FACTOR * want.iterations
    assert want.iterations <= ITER_FACTOR * got.iterations


def test_tiny_master_matches_reference():
    c, A_eq, b_eq, A_ub, b_ub, _ = _tiny_master()
    ref, port, bt = _both_kernels([port_lp.LPInstance(
        c=np.asarray(c, np.float32), A_eq=A_eq, b_eq=b_eq, A_ub=A_ub,
        b_ub=b_ub)])
    assert bool(port[3][0])
    obj = _assert_close(ref, port, bt.c, len(c))
    res = linprog(c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
                  bounds=(0, None), method="highs")
    assert obj == pytest.approx(res.fun, rel=RTOL)


def test_batch_matches_singles_and_reference():
    """A B = 3 batch: every member equals its solo solve in the same
    envelope (same iterations, x to 1e-4), and the batch equals the JAX
    package's batch within the criteria."""
    rng = np.random.default_rng(3)
    insts = []
    for n, me, mi in [(20, 5, 8), (28, 7, 12), (16, 4, 6)]:
        c, A, b, G, h, u = _random_lp(rng, n, me, mi)
        insts.append(port_lp.LPInstance(c=np.asarray(c, np.float32), A_eq=A,
                                        b_eq=b, A_ub=G, b_ub=h, upper=u))
    batch = port_lp.solve_lp_batch(insts, buckets=(32,), device="cpu")
    ref = ref_lp.solve_lp_batch([ref_lp.LPInstance(**vars(i)) for i in insts],
                                buckets=(32,))
    for inst, b_sol, r_sol in zip(insts, batch, ref):
        solo = port_lp.solve_lp_batch([inst], buckets=(32,), device="cpu")[0]
        assert b_sol.status == solo.status == r_sol.status
        assert b_sol.iterations == solo.iterations
        np.testing.assert_allclose(b_sol.x, solo.x, atol=1e-4)
        assert b_sol.obj == pytest.approx(r_sol.obj, rel=RTOL, abs=RTOL)
        np.testing.assert_allclose(b_sol.x, r_sol.x, atol=X_ATOL)
        assert b_sol.iterations <= ITER_FACTOR * r_sol.iterations
        assert r_sol.iterations <= ITER_FACTOR * b_sol.iterations


def test_warm_start_matches_reference():
    """A warm-started re-solve (cached duals in original row units, scaled
    by the host row factor on entry) converges in fewer iterations than
    the cold solve, in both packages, to the same objective."""
    c, A, b, G, h, u = _random_lp(np.random.default_rng(5), 24, 6, 10)
    kw = dict(A_eq=A, b_eq=b, A_ub=G, b_ub=h, upper=u, warm_key="t:warm")
    out = {}
    for name, solve, extra in (("ref", ref_lp.solve_lp, {}),
                               ("port", port_lp.solve_lp,
                                dict(device="cpu"))):
        cold = solve(c, **kw, **extra)
        warm = solve(c, **kw, **extra)
        assert cold.converged and warm.converged
        assert warm.iterations < cold.iterations
        out[name] = (cold, warm)
    assert port_lp.warm_cache_len() == ref_lp.warm_cache_len() == 1
    for i in (0, 1):
        got, want = out["port"][i], out["ref"][i]
        assert got.obj == pytest.approx(want.obj, rel=RTOL, abs=RTOL)
        np.testing.assert_allclose(got.x, want.x, atol=X_ATOL)
    # the cached duals are in original row units in both packages
    ent_p = port_lp.snapshot_caches()["warm"]["t:warm"]
    ent_r = ref_lp.snapshot_caches()["warm"]["t:warm"]
    assert tuple(ent_p["dims"]) == tuple(ent_r["dims"]) == (24, 6, 10)
    np.testing.assert_allclose(ent_p["y"], ent_r["y"], atol=5e-3)


def test_iteration_cap_matches_reference():
    """An instance that cannot converge in 64 iterations exits at the cap
    in both packages, with status 'cap' and 64 iterations."""
    c, A, b, G, h, u = _random_lp(np.random.default_rng(11), 80, 20, 30)
    ref, port, bt = _both_kernels([port_lp.LPInstance(
        c=np.asarray(c, np.float32), A_eq=A, b_eq=b, A_ub=G, b_ub=h,
        upper=u)], iters_cap=64)
    assert not bool(port[3][0]) and not bool(ref[3][0])
    assert int(port[4][0]) == int(ref[4][0]) == 64
    sol = port_lp.solve_lp(c, A_eq=A, b_eq=b, A_ub=G, b_ub=h, upper=u,
                           iters_cap=64, device="cpu")
    assert sol.status == port_lp.STATUS_CAP and sol.iterations == 64


def test_infinite_and_finite_bounds_match_reference():
    """u with +inf entries (free above) beside finite ones: the dual
    residual and the dual objective split on them."""
    rng = np.random.default_rng(13)
    c, A, b, G, h, u = _random_lp(rng, 40, 10, 16)
    u[::3] = np.inf
    ref, port, bt = _both_kernels([port_lp.LPInstance(
        c=np.asarray(c, np.float32), A_eq=A, b_eq=b, A_ub=G, b_ub=h,
        upper=u)])
    _assert_close(ref, port, bt.c, 40)


def test_padded_envelope_is_exact():
    """The same LP at natural dims and inside a larger envelope lands on
    the same optimum (exact padding), in the port as in the reference."""
    c, A, b, G, h, u = _random_lp(np.random.default_rng(11), 24, 6, 10)
    exact = port_lp.solve_lp(c, A_eq=A, b_eq=b, A_ub=G, b_ub=h, upper=u,
                             buckets=(6, 10, 24), device="cpu")
    padded = port_lp.solve_lp(c, A_eq=A, b_eq=b, A_ub=G, b_ub=h, upper=u,
                              buckets=(64,), device="cpu")
    assert exact.converged and padded.converged
    assert padded.obj == pytest.approx(exact.obj, rel=RTOL, abs=RTOL)
    np.testing.assert_allclose(padded.x, exact.x, atol=X_ATOL)


def test_certified_upper_bound_matches_reference():
    rng = np.random.default_rng(9)
    d = rng.uniform(0.0, 1.0, 12)
    R = rng.uniform(0.0, 1.0, (4, 12))
    a = rng.uniform(1.0, 3.0, 4)
    ub = rng.uniform(0.5, 4.0, 12)
    lam = rng.uniform(0.0, 5.0, 4)
    assert port_lp.certified_upper_bound(d, R, a, ub, lam) == \
        ref_lp.certified_upper_bound(d, R, a, ub, lam)


def test_cpu_solve_launches_no_kernel_and_default_needs_cuda(monkeypatch):
    import torch
    c, A, b, G, h, u = _random_lp(np.random.default_rng(2), 20, 5, 8)
    lk.reset_launches()
    port_lp.solve_lp(c, A_eq=A, b_eq=b, A_ub=G, b_ub=h, upper=u,
                     device="cpu")
    assert lk.LAUNCHES == {k: 0 for k in lk.KERNELS}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_lp.solve_lp(c, A_eq=A, b_eq=b, A_ub=G, b_ub=h, upper=u)


def test_mixed_devices_raise():
    import torch
    bt = port_lp.pad_batch([port_lp.LPInstance(c=np.ones(4, np.float32),
                                               upper=np.ones(4))])
    ops = [torch.from_numpy(a) for a in bt.operands()]
    ops[0] = ops[0].to("meta")
    with pytest.raises(ValueError, match="mixed"):
        lk.pdhg(*ops, 1e-4, 64, 32)
