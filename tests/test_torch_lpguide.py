"""The port's LP-guided solve against the JAX package's, on the CPU.

Both packages get the same `Problem` (carried across with
`convert.problem_from_arrays`); the port runs its plain versions
(`device="cpu"`).  Three groups:

  (b) `exact_lp_mix`: with HiGHS masters the port's x and z equal the JAX
      package's exactly (the same scipy calls on the same operands); with
      the PDHG master (`device=True`) z is within RTOL = 1e-3, x within
      2e-2 of the pod counts' scale, and the method, pricing rounds and
      support are equal; the demotion funnel of the DeviceLP ladder is the
      reference's;
  (c) `solve_classpack(guide="lp")` plans are identical under
      `workloads.plan_fingerprint`, each node's `used` and flexible
      alternatives included, on the cases of tests/test_lpguide.py and
      tests/test_refinery.py, and the full-width headline gives
      `workloads.GOLDEN_GUIDED` from both packages.

Both packages' mix, stale, support and warm-start caches are cleared
around every test."""

import dataclasses

import numpy as np
import pytest

import bench
from helpers import small_catalog
from karpenter_tpu.api.objects import NodePool, Pod
from karpenter_tpu.api.resources import CPU, MEMORY, ResourceList
from karpenter_tpu.catalog.generate import generate_catalog
from karpenter_tpu.ops import lpguide as ref_lg
from karpenter_tpu.ops import lpsolve as ref_lp
from karpenter_tpu.ops.classpack import solve_classpack as ref_solve
from karpenter_tpu.ops.health import lp_ladder as ref_ladder
from karpenter_tpu.ops.refinery import GuideRefinery as RefRefinery
from karpenter_tpu.ops.tensorize import tensorize
from karpenter_tpu_torch import convert, workloads
from karpenter_tpu_torch.ops import classpack as port_cp
from karpenter_tpu_torch.ops import classpack_kernels as ck
from karpenter_tpu_torch.ops import lpguide as port_lg
from karpenter_tpu_torch.ops import lpsolve as port_lp
from karpenter_tpu_torch.ops.health import LP_RUNGS, lp_ladder
from karpenter_tpu_torch.ops.refinery import GuideRefinery
from test_lpguide import _blend_pods, _catalog_2ratio
from torch_cases import one_torch_thread  # noqa: F401
from torch_refnative import reference_native_loaded  # noqa: F401

RTOL = 1e-3
BIG = 2**30


def _clear_all():
    for lg in (ref_lg, port_lg):
        with lg._MIX_LOCK:
            lg._MIX_CACHE.clear()
            lg._STALE_CACHE.clear()
            lg._SUPPORT_CACHE.clear()
    ref_lp.reset_caches()
    port_lp.reset_caches()


@pytest.fixture(autouse=True)
def _clean_caches():
    _clear_all()
    yield
    _clear_all()


def _node_sig(nd):
    return (dict(nd.used), [dataclasses.astuple(o) for o in nd.alternatives])


def assert_same_plan(prob, want, tprob, got):
    fw = workloads.plan_fingerprint(prob, want)
    fg = workloads.plan_fingerprint(tprob, got)
    for a, b in zip(fw[:5], fg[:5]):
        np.testing.assert_array_equal(a, b)
    assert fw[5] == fg[5]
    assert [_node_sig(n) for n in want.nodes] == \
        [_node_sig(n) for n in got.nodes]


def solve_both(prob, ref_kw=None, port_kw=None, **kw):
    """The default (guided) solve in both packages; asserts identical
    plans and returns (reference result, port result, port problem)."""
    tprob = convert.problem_from_arrays(prob)
    want = ref_solve(prob, **kw, **(ref_kw or {}))
    got = port_cp.solve_classpack(tprob, device="cpu", **kw,
                                  **(port_kw or {}))
    assert_same_plan(prob, want, tprob, got)
    return want, got, tprob


def _blend(n=200):
    return tensorize(_blend_pods(n), _catalog_2ratio(), [NodePool()])


def _operands(prob):
    ok = ref_lg._feasible_mask(prob)
    da, dp, dc, _ = ref_lg._dedup_with_inverse(
        prob.option_alloc.astype(np.float64),
        prob.option_price.astype(np.float64), ok)
    return (prob.class_requests.astype(np.float64),
            prob.class_counts.astype(np.float64), dc, da, dp)


def _tiny_master():
    """tests/test_lpsolve.py's 3-class / 4-option operands."""
    rng = np.random.default_rng(21)
    req = rng.uniform(1.0, 3.0, (3, 2))
    cnt = np.array([5, 3, 4])
    alloc = rng.uniform(8.0, 16.0, (4, 2))
    price = rng.uniform(1.0, 2.0, 4)
    return req, cnt, np.ones((3, 4), bool), alloc, price


# ---------------------------------------------------------------------------
# (b) exact_lp_mix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["tiny", "blend", "lp100"])
def test_highs_mix_is_identical(case):
    ops = {"tiny": _tiny_master, "blend": lambda: _operands(_blend()),
           "lp100": lambda: workloads.lp_instance(
               100, workloads.LP_TYPES,
               np.random.default_rng(workloads.LP_SEED))}[case]()
    x_r, z_r, info_r = ref_lg.exact_lp_mix(*ops)
    x_p, z_p, info_p = port_lg.exact_lp_mix(*ops)
    assert z_p == z_r
    np.testing.assert_array_equal(x_p, x_r)
    for k in ("method", "rounds", "proven", "dual_check", "options_used"):
        assert info_p[k] == info_r[k]
    np.testing.assert_array_equal(info_p["support"], info_r["support"])


@pytest.mark.parametrize("case", ["tiny", "blend", "lp100"])
def test_device_mix_matches_reference(case):
    ops = {"tiny": _tiny_master, "blend": lambda: _operands(_blend()),
           "lp100": lambda: workloads.lp_instance(
               100, workloads.LP_TYPES,
               np.random.default_rng(workloads.LP_SEED))}[case]()
    h_r, h_p = ref_ladder(clock=lambda: 0.0), lp_ladder(clock=lambda: 0.0)
    x_r, z_r, info_r = ref_lg.exact_lp_mix(*ops, device=True, lp_health=h_r)
    x_p, z_p, info_p = port_lg.exact_lp_mix(*ops, device=True, lp_health=h_p,
                                            lp_device="cpu")
    assert info_p["method"] == info_r["method"] == "colgen-lp-device"
    assert info_p["rounds"] == info_r["rounds"]
    np.testing.assert_array_equal(info_p["support"], info_r["support"])
    assert z_p == pytest.approx(z_r, rel=RTOL)
    _, z_h, _ = ref_lg.exact_lp_mix(*ops)
    assert z_p == pytest.approx(z_h, rel=RTOL)
    scale = max(1.0, float(np.max(ops[1])))
    np.testing.assert_allclose(x_p, x_r, atol=2e-2 * scale)
    assert h_p.active_rung("device_lp") == "device_lp"
    assert h_p._state["device_lp"].failures == 0


def _capped_solve_lp(c, A_eq=None, b_eq=None, A_ub=None, b_ub=None,
                     upper=None, warm_key=None, **kw):
    return port_lp.LPSolution(
        x=np.zeros(len(c)), y=np.zeros(len(b_eq)), lam=np.zeros(len(b_ub)),
        obj=0.0, status=port_lp.STATUS_CAP,
        iterations=port_lp.DEFAULT_ITERS_CAP, restarts=0, primal_res=1.0,
        dual_res=1.0, gap=1.0)


def test_capped_masters_demote_like_the_reference(monkeypatch):
    """Two capped device masters demote device_lp → highs; every call
    still answers with HiGHS's mix, identical to the reference's; a
    demoted ladder skips the device master entirely."""
    ops = _tiny_master()
    monkeypatch.setattr(port_lp, "solve_lp", _capped_solve_lp)
    h = lp_ladder(clock=lambda: 0.0)
    x_h, z_h, _ = ref_lg.exact_lp_mix(*ops)
    for strike in (1, 2):
        x, z, info = port_lg.exact_lp_mix(*ops, device=True, lp_health=h,
                                          lp_device="cpu")
        assert info["method"] == "colgen-lp"
        assert z == z_h
        np.testing.assert_array_equal(x, x_h)
        if strike == 1:
            assert h._state["device_lp"].failures == 1
            assert h.active_rung("device_lp") == "device_lp"
    assert h.active_rung("device_lp") == "highs"
    assert h.transitions == {"device_lp>highs:cap": 1}
    calls = []
    monkeypatch.setattr(port_lp, "solve_lp",
                        lambda *a, **kw: calls.append(1) or
                        _capped_solve_lp(*a, **kw))
    x, _, _ = port_lg.exact_lp_mix(*ops, device=True, lp_health=h,
                                   lp_device="cpu")
    assert x is not None and calls == []


def test_certificate_flip_counts_one_failure(monkeypatch):
    ops = _tiny_master()
    real = port_lp.solve_lp

    def flipped(*a, **kw):
        sol = real(*a, **kw)
        sol.y = -sol.y
        return sol

    monkeypatch.setattr(port_lp, "solve_lp", flipped)
    h = lp_ladder(clock=lambda: 0.0)
    x, z, info = port_lg.exact_lp_mix(*ops, device=True, lp_health=h,
                                      lp_device="cpu")
    assert x is not None and info["method"] == "colgen-lp"
    assert h._state["device_lp"].failures == 1
    assert h.active_rung("device_lp") == "device_lp"


def test_device_master_errors_are_not_demotions(monkeypatch):
    """A PDHG launch that fails raises through the guide: it is never taken
    for a capped master that silently demotes to HiGHS."""
    def broken(*a, **kw):
        raise RuntimeError("pdhg: CUDA error 700 (an illegal memory access)")

    monkeypatch.setattr(port_lp, "solve_lp", broken)
    h = lp_ladder(clock=lambda: 0.0)
    with pytest.raises(RuntimeError, match="pdhg"):
        port_lg.exact_lp_mix(*_tiny_master(), device=True, lp_health=h,
                             lp_device="cpu")
    with pytest.raises(RuntimeError, match="pdhg"):
        port_cp.solve_classpack(convert.problem_from_arrays(_blend()),
                                device_lp=True, lp_health=h, device="cpu")
    assert h._state["device_lp"].total_failures == 0


def test_lp_ladder_matches_reference():
    assert LP_RUNGS == ("device_lp", "highs")
    clock = [0.0]
    ladders = (lp_ladder(clock=lambda: clock[0]),
               ref_ladder(clock=lambda: clock[0]))
    script = [("f", "cap"), ("f", "cap"), ("f", "highs"), ("t", 61.0),
              ("f", "cap"), ("t", 200.0), ("s", None)]
    for op, arg in script:
        for h in ladders:
            if op == "f":
                h.report_failure("highs" if arg == "highs" else "device_lp",
                                 arg)
            elif op == "s":
                h.report_success("device_lp")
        if op == "t":
            clock[0] = arg
        got = [(h.active_rung("device_lp"), h._state["device_lp"].failures,
                h._state["device_lp"].demotions,
                h._state["device_lp"].demoted_until) for h in ladders]
        assert got[0] == got[1], (op, arg)
    assert ladders[0].transitions == ladders[1].transitions


# ---------------------------------------------------------------------------
# (c) solve_classpack(guide="lp") plans
# ---------------------------------------------------------------------------

def test_pairing_trap_plans_identical():
    want, got, _ = solve_both(_blend())
    greedy = port_cp.solve_classpack(convert.problem_from_arrays(_blend()),
                                     guide=None, device="cpu")
    assert not got.unschedulable
    assert got.total_price < 0.8 * greedy.total_price


@pytest.mark.parametrize("n", [122, 200])
def test_pairing_trap_device_lp_plans_identical(n):
    """The DeviceLP master (PDHG) drives the guide: the mix comes from the
    device namespace of the cache, and the plans are the reference's."""
    solve_both(_blend(n), ref_kw=dict(device_lp=True,
                                      lp_health=ref_ladder(clock=lambda: 0.0)),
               port_kw=dict(device_lp=True,
                            lp_health=lp_ladder(clock=lambda: 0.0)))
    assert any(k[:1] == b"d" for k in port_lg._MIX_CACHE)


def test_hostname_capped_classes_plans_identical():
    """Per-node caps: the capped classes stay out of the pooled LP and go
    through the tuck (with a fresh per-node counter) and the remainder."""
    pods = _blend_pods(120) + [
        Pod(requests=ResourceList({CPU: 500, MEMORY: 512 * 2**20}))
        for _ in range(30)]
    prob = tensorize(pods, _catalog_2ratio(), [NodePool()])
    caps = np.full(prob.num_classes, BIG, np.int32)
    caps[-1] = 2
    prob.class_node_cap = caps
    solve_both(prob)


def test_max_nodes_below_the_lp_fleet_plans_identical():
    """The LP fleet alone exceeds max_nodes: the guide steps aside and the
    greedy kernels own the cap."""
    want, got, _ = solve_both(_blend(), max_nodes=4)
    assert len(got.nodes) <= 4 and got.unschedulable


def test_zero_remainder_budget_plans_identical():
    """The striped fleet consumes the whole launch budget: the remainder
    solve gets no catalog, and its pods come back unschedulable."""
    free = port_cp.solve_classpack(convert.problem_from_arrays(_blend()),
                                   device="cpu")
    for budget in (len(free.nodes), len(free.nodes) - 1):
        _clear_all()
        want, got, _ = solve_both(_blend(), max_nodes=budget)
        assert len(got.nodes) <= budget


def test_tiny_fleet_acceptance_gate_plans_identical():
    """Ceil slack dominates a 12-pod instance: the 1.08·z_lp gate prices
    the greedy alternative, and the rejection is remembered."""
    pods = [Pod(requests=ResourceList({CPU: 3500, MEMORY: 2**30}))
            for _ in range(6)] + \
        [Pod(requests=ResourceList({CPU: 100, MEMORY: 64 * 2**20}))
         for _ in range(6)]
    prob = tensorize(pods, small_catalog(), [NodePool()])
    for _ in range(2):            # cold, then the remembered rejection
        want, got, _ = solve_both(prob)
    assert [h[5] for h in port_lg._MIX_CACHE.values()] == \
        [h[5] for h in ref_lg._MIX_CACHE.values()]


def test_refinery_cold_stale_warm_plans_identical():
    """With a refinery: a cold tick answers greedy and queues one job; the
    refined mix upgrades the next identical tick; a tick whose counts
    changed is served the rescaled stale mix inside the ttl."""
    clock = [1000.0]
    refs = (RefRefinery(stale_ttl=50.0, clock=lambda: clock[0], start=False),
            GuideRefinery(stale_ttl=50.0, clock=lambda: clock[0],
                          start=False))
    prob200, prob150 = _blend(200), _blend(150)
    want, got, _ = solve_both(prob200, ref_kw=dict(refinery=refs[0]),
                           port_kw=dict(refinery=refs[1]))
    assert refs[0].pending() == refs[1].pending() == 1
    for r in refs:
        r.start()
        assert r.drain(timeout=60.0)
    assert refs[1].take_upgrade() is refs[0].take_upgrade() is True
    warm_r, warm_p, _ = solve_both(prob200, ref_kw=dict(refinery=refs[0]),
                                port_kw=dict(refinery=refs[1]))
    assert warm_p.total_price < got.total_price
    clock[0] += 10.0
    solve_both(prob150, ref_kw=dict(refinery=refs[0]),
               port_kw=dict(refinery=refs[1]))
    for r in refs:
        r.stop()


def test_stale_mix_carried_across_plans_identical():
    """`convert.lp_caches_from_arrays` carries the JAX package's mix,
    stale, support and warm-start caches into the port: a warm re-solve
    and a stale rescale then give the reference's plans."""
    prob200, prob150 = _blend(200), _blend(150)
    ref_solve(prob200)                                  # JAX caches fill
    ref_solve(prob200, device_lp=True,
              lp_health=ref_ladder(clock=lambda: 0.0))  # and the warm starts
    assert ref_lp.warm_cache_len() >= 1
    convert.lp_caches_from_arrays(ref_lg.snapshot_caches(),
                                  ref_lp.snapshot_caches())
    assert set(port_lg._MIX_CACHE) == set(ref_lg._MIX_CACHE)
    assert port_lp.warm_cache_len() == ref_lp.warm_cache_len()
    solve_both(prob200)                                 # warm hit, both
    refs = (RefRefinery(start=False), GuideRefinery(start=False))
    solve_both(prob150, ref_kw=dict(refinery=refs[0]),
               port_kw=dict(refinery=refs[1]))          # stale, both
    assert refs[0].pending() == refs[1].pending() == 1


def test_guided_replacement_matches_reference():
    """DisruptionController's fresh replacement solve (no survivor) runs
    the LP guide with the default lp_guide=True in both controllers."""
    from helpers import cpu_pod, make_type
    from karpenter_tpu.controllers.disruption import \
        DisruptionController as RefController
    from test_consolidation_sweep import env, provision
    from test_torch_consolidation import port_twin
    catalog = [make_type("a.small", 2, 4, 0.10),
               make_type("a.large", 8, 16, 0.40),
               make_type("s.small", 2, 4, 0.12, spot_discount=0.4)]
    clock, cloud, provider, cluster, prov, ctrl = env(catalog=catalog)
    big = cpu_pod(cpu_m=6000, mem_mib=4000)
    provision(cluster, prov, [big])
    cluster.add_pods([cpu_pod(cpu_m=1000, mem_mib=1000)])
    prov.provision()
    cluster.delete_pod(big)
    ctrl = RefController(provider, cluster, ctrl.nodepools, clock=clock,
                         stabilization_s=0.0)
    tctrl = port_twin(provider, cluster, ctrl)
    assert tctrl.lp_guide and ctrl.lp_guide
    want = ctrl.consolidation_action(ctrl.candidates())
    got = tctrl.consolidation_action(tctrl.candidates())
    assert workloads.action_signature(got) == \
        workloads.action_signature(want)
    assert got is not None and got.simulation is not None


def test_guided_cpu_solve_launches_no_kernel():
    ck.reset_launches()
    port_cp.solve_classpack(convert.problem_from_arrays(_blend()),
                            device="cpu")
    assert all(v == 0 for v in ck.LAUNCHES.values())


def test_headline_guided_golden_from_both_packages():
    """The full-width headline (50k pods × 600 types): the default guided
    solve (HiGHS masters) gives GOLDEN_GUIDED from both packages."""
    import scipy
    pods = bench.build_pods(rng=np.random.default_rng(workloads.HEADLINE_SEED),
                            **workloads.HEADLINE)
    prob = tensorize(pods, generate_catalog(workloads.HEADLINE_TYPES),
                     [NodePool()])
    gold = workloads.GOLDEN_GUIDED
    want, got, tprob = solve_both(prob)
    for p, res in ((prob, want), (tprob, got)):
        digest, total = workloads.plan_digest(p, res)
        assert (digest, total, len(res.nodes)) == \
            (gold["digest"], gold["total"], gold["nodes"]), scipy.__version__
    assert not got.unschedulable
    (hit,) = port_lg._MIX_CACHE.values()
    assert hit[3] == pytest.approx(gold["z_lp"], rel=1e-9)
