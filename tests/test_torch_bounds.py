"""The port's certified cost bounds (ops/lpbound.py, ops/ggbound.py) and
its certify tool against the JAX package's, on the CPU.

- tests/test_lpguide.py's `class_lp_bound` case on both packages
  (tests/torch_suites.py): the column generation's optimum is the full
  class LP's, and the compared values are equal.
- The host bounds on the LP instances (`workloads.LP_SIZES`):
  `_fit_compat`, `_dedup_options`, `class_lp_bound`, `dual_feasible_bound`
  and `cost_lower_bound` run NumPy and HiGHS on the same operands in both
  packages, so they are equal.
- `device_dual_bound` on the LP instances, the port on `pdhg`'s plain
  version and the reference on its JAX solver, from the same iteration
  cap: within RTOL (tests/test_lpsolve.py's 1e-3) of the class LP of each
  other, and a certified bound: positive and at most the class LP.
- `gg_bound(device=True)` on tests/test_optimality.py's instances: the
  port (`lp_device="cpu"`) within RTOL of the class LP of the reference,
  class LP ≤ gg ≤ plan cost, and every certified screen bound at least the
  HiGHS optimum of its pricing LP.  With the HiGHS screen, `gg_bound` and
  `integral_bracket` are equal to the reference's, lb ≤ ub.
- The certify tool with `--device cpu` prints the reference tool's keys,
  its plan and class LP equal to the reference's.
- `workloads.GOLDEN_CERTIFY` is what the JAX package computes.
- A `KernelError` raised in the PDHG screen leaves `gg_bound`: no HiGHS
  screen answers for it.
"""

import importlib.util
import json
import math
import os

import numpy as np
import pytest
from scipy.optimize import linprog

import bench
from helpers import cpu_pod, make_type, small_catalog
from karpenter_tpu.api.objects import NodePool, Pod
from karpenter_tpu.api.resources import CPU, MEMORY, ResourceList
from karpenter_tpu.catalog.generate import generate_catalog
from karpenter_tpu.ops import ggbound as ref_gg
from karpenter_tpu.ops import lpbound as ref_lb
from karpenter_tpu.ops.classpack import solve_classpack as ref_solve
from karpenter_tpu.ops.tensorize import tensorize
from karpenter_tpu_torch import convert, workloads
from karpenter_tpu_torch._build import KernelError
from karpenter_tpu_torch.ops import ggbound as port_gg
from karpenter_tpu_torch.ops import lpbound as port_lb
from karpenter_tpu_torch.ops import lpsolve as port_lp
from karpenter_tpu_torch.ops.classpack import solve_classpack as port_solve
from karpenter_tpu_torch.tools import certify as port_certify
from torch_cases import clear_lp_caches
from torch_cases import one_torch_thread  # noqa: F401
from torch_suites import Suite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-3             # tests/test_lpsolve.py's PDHG tolerance
CERT_TOL = 1e-6         # certified orderings, as the reference's tests
CERTIFY_RTOL = 1e-6     # GOLDEN_CERTIFY's plan cost and LP values, relative
# device_dual_bound's iteration cap on the LP instances: the dense class LP
# (2186 variables and 1402 rows at lp-100, 5970 and 1860 at lp-250) caps
# there, which keeps either solver to seconds on one thread; the
# certificate holds at any cap
DUAL_ITERS_CAP = 256

LPGUIDE = Suite("test_lpguide")


@pytest.fixture(autouse=True)
def _cold_caches():
    clear_lp_caches("karpenter_tpu", "karpenter_tpu_torch")
    yield
    clear_lp_caches("karpenter_tpu", "karpenter_tpu_torch")


@pytest.mark.parametrize("case", LPGUIDE.cases(
    only=("test_matches_full_lp_on_blend",)))
def test_class_lp_bound_is_the_colgen_optimum(case, request):
    LPGUIDE.both(case, request)


def _lp_problem(C):
    """(reference Problem, port Problem) of `workloads.lp_problems()[C]`:
    `bench.build_pods` from a fresh default_rng(LP_SEED), both packages'
    tensorize."""
    rng = np.random.default_rng(workloads.LP_SEED)
    pods = bench.build_pods(C, C * 20, rng, zone_frac=0.2)
    prob = tensorize(pods, generate_catalog(workloads.LP_TYPES), [NodePool()])
    return prob, workloads.lp_problems()[C]


@pytest.mark.parametrize("C", workloads.LP_SIZES)
def test_host_bounds_equal_the_reference(C):
    prob, tprob = _lp_problem(C)
    fit = port_lb._fit_compat(tprob)
    np.testing.assert_array_equal(fit, ref_lb._fit_compat(prob))
    args = (tprob.option_alloc.astype(np.float64),
            tprob.option_price.astype(np.float64), fit)
    for got, want in zip(port_lb._dedup_options(*args),
                         ref_lb._dedup_options(*args)):
        np.testing.assert_array_equal(got, want)
    lp = port_lb.class_lp_bound(tprob)
    assert lp == ref_lb.class_lp_bound(prob)
    assert lp == pytest.approx(workloads.GOLDEN_LP[C]["z"], rel=1e-9)
    df = port_lb.dual_feasible_bound(tprob)
    assert df == ref_lb.dual_feasible_bound(prob)
    assert 0.0 < df <= lp + CERT_TOL
    assert port_lb.cost_lower_bound(tprob) == lp


@pytest.mark.parametrize("C", workloads.LP_SIZES)
def test_device_dual_bound_within_the_lp_tolerance(C):
    prob, tprob = _lp_problem(C)
    lp = ref_lb.class_lp_bound(prob)
    got = port_lb.device_dual_bound(tprob, iters_cap=DUAL_ITERS_CAP,
                                    lp_device="cpu")
    want = ref_lb.device_dual_bound(prob, iters_cap=DUAL_ITERS_CAP)
    assert abs(got - want) <= RTOL * lp
    assert 0.0 < got <= lp * (1 + CERT_TOL)


def _gg_instances():
    """tests/test_optimality.py's TestGGBound instances: 60 seeded pods on
    small_catalog, and one 3-cpu pod on a 2- and a 4-cpu type."""
    rng = np.random.default_rng(7)
    pods = [cpu_pod(cpu_m=int(rng.integers(200, 1900)),
                    mem_mib=int(rng.integers(256, 3800)))
            for _ in range(60)]
    gap = [Pod(requests=ResourceList({CPU: 3000, MEMORY: 2**30}))]
    gap_cat = [make_type("s", 2, 64, 0.2), make_type("l", 4, 128, 0.4)]
    return {"mixed-60": tensorize(pods, small_catalog(), [NodePool()]),
            "integrality-gap": tensorize(gap, gap_cat, [NodePool()])}


GG_INSTANCES = ("mixed-60", "integrality-gap")
GG_ITERS = 3


def _pricing_optimum(duals, req, alloc, j, idx, ub):
    res = linprog(-duals[idx], A_ub=req[idx].T, b_ub=alloc[j],
                  bounds=np.stack([np.zeros(len(idx)), ub], axis=1),
                  method="highs")
    assert res.success
    return -res.fun


@pytest.mark.parametrize("name", GG_INSTANCES)
def test_gg_bound_on_the_device_screen(name, monkeypatch):
    prob = _gg_instances()[name]
    tprob = convert.problem_from_arrays(prob)
    screens = []
    real = port_gg._device_screen

    def record(jobs, duals, req, alloc, lp_device="cuda"):
        out = real(jobs, duals, req, alloc, lp_device)
        screens.append((jobs, duals, req, alloc, out))
        return out

    monkeypatch.setattr(port_gg, "_device_screen", record)
    plan, tplan = ref_solve(prob), port_solve(tprob, device="cpu")
    assert tplan.total_price == plan.total_price
    want, winfo = ref_gg.gg_bound(prob, iters=GG_ITERS, warm_plan=plan,
                                  device=True)
    got, info = port_gg.gg_bound(tprob, iters=GG_ITERS, warm_plan=tplan,
                                 device=True, lp_device="cpu")
    lp = ref_lb.class_lp_bound(prob)
    assert info["pricing_screen"] == winfo["pricing_screen"] == "device"
    assert info["iters"] == len(screens) >= 1
    assert abs(got - want) <= RTOL * lp
    assert lp - CERT_TOL <= got <= tplan.total_price + CERT_TOL
    checked = 0
    for jobs, duals, req, alloc, out in screens:
        assert sorted(out) == [j for j, _, _ in jobs]
        for j, idx, ub in jobs:
            assert out[j] >= _pricing_optimum(duals, req, alloc, j, idx,
                                              ub) - CERT_TOL
            checked += 1
    assert checked > 0


@pytest.mark.parametrize("name", GG_INSTANCES)
def test_gg_bound_and_integral_bracket_on_highs_equal_the_reference(
        name, monkeypatch):
    prob = _gg_instances()[name]
    tprob = convert.problem_from_arrays(prob)
    plan, tplan = ref_solve(prob), port_solve(tprob, device="cpu")
    want = ref_gg.gg_bound(prob, iters=GG_ITERS, warm_plan=plan)
    assert port_gg.gg_bound(tprob, iters=GG_ITERS, warm_plan=tplan) == want
    # the column generation's own value (Farley's, or the converged
    # master's), with no class LP under it, is equal too, and its max with
    # the class LP is the bound
    lp = ref_lb.class_lp_bound(prob)
    with monkeypatch.context() as m:
        m.setattr(ref_lb, "class_lp_bound", lambda p: -math.inf)
        m.setattr(port_lb, "class_lp_bound", lambda p: -math.inf)
        own_want = ref_gg.gg_bound(prob, iters=GG_ITERS, warm_plan=plan)
        own, info = port_gg.gg_bound(tprob, iters=GG_ITERS, warm_plan=tplan)
    assert (own, info) == own_want
    assert (max(lp, own), dict(info, base_lp=lp)) == want
    want = ref_gg.integral_bracket(prob, iters=GG_ITERS, warm_plan=plan)
    got = port_gg.integral_bracket(tprob, iters=GG_ITERS, warm_plan=tplan)
    assert got == want
    lb, ub, info = got
    assert lb <= ub
    assert ub <= tplan.total_price + CERT_TOL
    assert info["integral_columns_used"] >= 1


SMALL_CERTIFY = ["--pods", "400", "--types", "12", "--specs", "12",
                 "--gg", "--integral", "--gg-iters", "3"]


def test_certify_tool_on_the_cpu_prints_the_reference_keys(
        monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "_ref_certify", os.path.join(REPO, "tools", "certify.py"))
    ref_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_tool)
    monkeypatch.chdir(REPO)
    monkeypatch.setattr("sys.argv", ["certify.py", *SMALL_CERTIFY])
    assert ref_tool.main() == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_certify.main([*SMALL_CERTIFY, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(want)
    for key in ("pods", "types", "plan_cost", "nodes", "unschedulable",
                "class_lp_bound", "ratio_vs_class_lp"):
        assert got[key] == want[key], key
    lp = want["class_lp_bound"]
    for key in ("gg_bound", "integral_lb"):
        assert abs(got[key] - want[key]) <= RTOL * lp + 0.01, key
        assert lp - 0.01 <= got[key] <= got["plan_cost"] + 0.01
    assert got["integral_lb"] <= got["integral_ub"] + 0.01


def test_golden_certify_from_the_jax_package(monkeypatch):
    """tools/certify.py's default instance on the JAX package: the plan,
    the class LP (gg_bound's base), the column generation's own value
    after CERTIFY_GG_ITERS rounds on its HiGHS screen (gg_bound with no
    class LP under it), its column count and the bound, the max of the
    two, are GOLDEN_CERTIFY's, exactly.  chip_smoke.py holds the port on
    the card to them: the counts exactly, the values within CERTIFY_RTOL
    (HiGHS there is another scipy release, whose LP optimum may differ in
    its last digits; the device screen prices the same options exactly as
    HiGHS's, since it only lets more of them through to the MILP)."""
    gold = workloads.GOLDEN_CERTIFY
    rng = np.random.default_rng(workloads.CERTIFY_SEED)
    pods = bench.build_pods(workloads.CERTIFY_SPECS, workloads.CERTIFY_PODS,
                            rng, zone_frac=workloads.CERTIFY_ZONE_FRAC)
    prob = tensorize(pods, generate_catalog(workloads.CERTIFY_TYPES),
                     [NodePool()])
    plan = ref_solve(prob)
    assert plan.total_price == gold["plan_cost"]
    assert len(plan.nodes) == gold["nodes"]
    assert len(plan.unschedulable) == gold["unschedulable"]
    lp = ref_lb.class_lp_bound(prob)
    assert lp == gold["class_lp"]
    monkeypatch.setattr(ref_lb, "class_lp_bound", lambda p: -math.inf)
    own, info = ref_gg.gg_bound(prob, iters=gold["gg_iters"], warm_plan=plan)
    assert own == gold["own"]
    assert max(lp, own) == gold["gg"]
    assert info["iters"] == gold["gg_iters"]
    assert info["columns"] == gold["columns"]
    assert gold["class_lp"] <= gold["gg"] <= gold["plan_cost"]


def test_certify_problem_is_the_reference_tools():
    """`workloads.certify_problem()` is the problem tools/certify.py
    builds: the same classes, counts and options; the port's plan of it
    on the CPU is GOLDEN_CERTIFY's within CERTIFY_RTOL."""
    rng = np.random.default_rng(workloads.CERTIFY_SEED)
    pods = bench.build_pods(workloads.CERTIFY_SPECS, workloads.CERTIFY_PODS,
                            rng, zone_frac=workloads.CERTIFY_ZONE_FRAC)
    prob = tensorize(pods, generate_catalog(workloads.CERTIFY_TYPES),
                     [NodePool()])
    tprob = workloads.certify_problem()
    for f in ("class_requests", "class_counts", "class_compat",
              "option_alloc", "option_price"):
        np.testing.assert_array_equal(getattr(tprob, f), getattr(prob, f))
    gold = workloads.GOLDEN_CERTIFY
    plan = port_solve(tprob, device="cpu")
    assert len(plan.nodes) == gold["nodes"] and not plan.unschedulable
    assert abs(plan.total_price - gold["plan_cost"]) <= \
        CERTIFY_RTOL * gold["plan_cost"]


def test_kernel_error_in_the_screen_leaves_gg_bound(monkeypatch):
    prob = _gg_instances()["mixed-60"]
    tprob = convert.problem_from_arrays(prob)
    calls = []

    def planted(*a, **kw):
        raise KernelError("pdhg: planted launch failure")

    import scipy.optimize
    real = scipy.optimize.linprog

    def counted(*a, **kw):
        calls.append(kw.get("bounds"))
        return real(*a, **kw)

    monkeypatch.setattr(port_lp, "_pdhg_kernel", planted)
    monkeypatch.setattr(scipy.optimize, "linprog", counted)
    with pytest.raises(KernelError, match="planted"):
        port_gg.gg_bound(tprob, iters=3, device=True, lp_device="cpu")
    # the class LP and the first master, then the screen raised: no HiGHS
    # pricing LP (bounded per class) answered for it
    assert len(calls) == 2
    assert all(not isinstance(b, np.ndarray) for b in calls)
