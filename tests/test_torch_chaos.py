"""The port's chaos injector (karpenter_tpu_torch/utils/chaos.py) and its
seams against the JAX package's, case by case with tests/test_chaos.py's
cases, on the CPU.  Each case runs on both packages and returns plain
observations that must be equal.

  * the injector: the same seed gives the same schedule (and the two
    packages the same one: one numpy stream a rule, drawn only by a
    matching call), a different seed another, unmatched calls draw
    nothing, windows, counts and keys, a cloud error code, injected
    latency, the disarmed injector, bad rules, the `--chaos-spec` DSL and
    arming from Options;
  * the stack: the operator's controller set under sustained chaos (spot
    interruptions, reclaims, one-shot API errors, ICE) converges with
    every pod bound and no leaked instance, and a blacklisted catalog
    leaves pods pending and recovers;
  * the seams of the port: `cloud.api` in the fake cloud after
    `next_error` and the throttle window, `controller.reconcile` in the
    manager, and the sim's `chaos:` block rebased on the virtual clock and
    disarmed after the run.

Both packages' injectors are process-global; every test disarms both.
"""

import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest

from torch_cases import clear_lp_caches as clear_package_caches
from torch_cases import one_torch_thread  # noqa: F401
from torch_refnative import reference_native_loaded  # noqa: F401

MODULES = dict(chaos="utils.chaos", operator="operator",
               manager="operator.manager", options="operator.options",
               objects="api.objects", resources="api.resources",
               gen="catalog.generate", fake="cloud.fake", sim="sim",
               scenario="sim.scenario")


def _package(name, extra):
    return SimpleNamespace(name=name, extra=extra, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in MODULES.items()})


REF = _package("karpenter_tpu", {})
PORT = _package("karpenter_tpu_torch", {"device": "cpu"})


@pytest.fixture(autouse=True)
def _disarm_chaos():
    clear_package_caches("karpenter_tpu", "karpenter_tpu_torch")
    yield
    REF.chaos.CHAOS.reset()
    PORT.chaos.CHAOS.reset()
    clear_package_caches("karpenter_tpu", "karpenter_tpu_torch")


def both(case):
    ref, port = case(REF), case(PORT)
    assert ref == port
    return port


# ---------------------------------------------------------------------------
# the deterministic injector: same seed => same schedule
# ---------------------------------------------------------------------------

def _drive(m, inj, rules, seed, n=200):
    """Call one rate-limited point n times on a stepping clock; return the
    injection pattern as a bit-string."""
    clock = [0.0]
    inj.configure(rules, seed=seed, clock=lambda: clock[0],
                  sleep=lambda s: None)
    bits = []
    for _ in range(n):
        clock[0] += 1.0
        try:
            inj.inject("cloud.api", key="create_fleet")
            bits.append("0")
        except (m.chaos.ChaosError, m.fake.CloudError):
            bits.append("1")
    return "".join(bits)


def test_registries_equal_the_reference():
    points, actions = both(lambda m: (sorted(m.chaos.POINTS),
                                      m.chaos.ACTIONS))
    assert len(points) == 6 and actions == ("error", "latency", "hang")
    assert issubclass(PORT.chaos.ChaosError, RuntimeError)


def test_same_seed_same_schedule():
    def case(m):
        a, b = m.chaos.ChaosInjector(), m.chaos.ChaosInjector()
        rule = m.chaos.ChaosRule("cloud.api", key="create_fleet", rate=0.3)
        pat_a, pat_b = _drive(m, a, [rule], 42), _drive(m, b, [rule], 42)
        assert pat_a == pat_b
        assert "1" in pat_a and "0" in pat_a      # rate actually partial
        assert a.counts() == b.counts()
        return pat_a, a.counts(), a.fired_total()
    both(case)


def test_different_seed_different_schedule():
    def case(m):
        rule = m.chaos.ChaosRule("cloud.api", key="create_fleet", rate=0.3)
        pats = [_drive(m, m.chaos.ChaosInjector(), [rule], s) for s in (1, 2)]
        assert pats[0] != pats[1]
        return pats
    both(case)


def test_unmatched_calls_consume_no_rng():
    """Only (point, key)-matching calls draw from a rule's stream, so
    unrelated traffic cannot desync the schedule."""
    def case(m):
        rule = m.chaos.ChaosRule("cloud.api", key="create_fleet", rate=0.3)
        b = m.chaos.ChaosInjector()
        clock = [0.0]
        b.configure([rule], seed=7, clock=lambda: clock[0],
                    sleep=lambda s: None)
        for _ in range(50):  # noise on other points/keys before the run
            b.inject("solver.pack", key="jax")
            b.inject("cloud.api", key="describe_instances")
        bits, clock[0] = [], 0.0
        for _ in range(200):
            clock[0] += 1.0
            try:
                b.inject("cloud.api", key="create_fleet")
                bits.append("0")
            except m.chaos.ChaosError:
                bits.append("1")
        got = "".join(bits)
        assert got == _drive(m, m.chaos.ChaosInjector(), [rule], 7)
        return got
    both(case)


def test_window_count_and_key_semantics():
    def case(m):
        inj = m.chaos.ChaosInjector()
        clock = [0.0]
        inj.configure([m.chaos.ChaosRule("solver.pack", key="jax", at_s=10.0,
                                         until_s=20.0, count=2)],
                      seed=0, clock=lambda: clock[0], sleep=lambda s: None)
        inj.inject("solver.pack", key="jax")       # t=0: before window
        inj.inject("solver.pack", key="native")    # key mismatch
        clock[0] = 10.0
        with pytest.raises(m.chaos.ChaosError):
            inj.inject("solver.pack", key="jax")   # window open
        clock[0] = 15.0
        with pytest.raises(m.chaos.ChaosError, match=r"solver\.pack\[jax\]"):
            inj.inject("solver.pack", key="jax")
        inj.inject("solver.pack", key="jax")       # count=2 exhausted
        clock[0] = 25.0
        inj.inject("solver.pack", key="jax")       # past until_s
        with pytest.raises(ValueError, match="unregistered"):
            inj.inject("no.such.point")
        return inj.fired_total(), inj.counts()
    assert both(case) == (2, {"solver.pack/error": 2})


def test_error_code_raises_cloud_error():
    def case(m):
        inj = m.chaos.ChaosInjector()
        inj.configure([m.chaos.ChaosRule("cloud.api", key="create_fleet",
                                         error_code="RequestLimitExceeded")],
                      seed=0, clock=lambda: 0.0, sleep=lambda s: None)
        with pytest.raises(m.fake.CloudError) as ei:
            inj.inject("cloud.api", key="create_fleet")
        return ei.value.code
    assert both(case) == "RequestLimitExceeded"


def test_latency_and_hang_use_the_injected_sleep_not_wall():
    def case(m):
        inj = m.chaos.ChaosInjector()
        slept = []
        inj.configure([m.chaos.ChaosRule("refinery.refine", action="latency",
                                         latency_s=2.5),
                       m.chaos.ChaosRule("solver.sweep", action="hang",
                                         latency_s=9.0, count=1)],
                      seed=0, clock=lambda: 0.0, sleep=slept.append)
        inj.inject("refinery.refine")
        inj.inject("solver.sweep")
        inj.inject("solver.sweep")
        return slept, inj.counts()
    assert both(case) == ([2.5, 9.0], {"refinery.refine/latency": 1,
                                       "solver.sweep/hang": 1})


def test_disabled_injector_is_inert():
    def case(m):
        inj = m.chaos.ChaosInjector()
        out = [inj.enabled]
        inj.inject("solver.pack", key="jax")       # no-op
        inj.configure([m.chaos.ChaosRule("solver.pack")], seed=0,
                      clock=lambda: 0.0, sleep=lambda s: None)
        out.append(inj.enabled)
        inj.reset()
        out += [inj.enabled, inj.rules]
        inj.inject("solver.pack", key="jax")       # disarmed again
        return out
    assert both(case) == [False, True, False, []]


def test_configure_rejects_bad_rules():
    def case(m):
        inj, R = m.chaos.ChaosInjector(), m.chaos.ChaosRule
        for rule, match in ((R("not.a.point"), "unknown point"),
                            (R("solver.pack", action="explode"),
                             "unknown action"),
                            (R("solver.pack", rate=0.0), "rate")):
            with pytest.raises(ValueError, match=match):
                inj.configure([rule])
        return inj.enabled
    assert both(case) is False


def test_parse_spec_round_trip():
    def case(m):
        rules = m.chaos.parse_spec(
            "point=controller.reconcile,key=disruption,action=error,"
            "rate=0.5; point=cloud.api,action=latency,latency_s=0.2,count=3,"
            "at_s=10,until_s=99,error_code=Throttling")
        for spec, match in (("point=cloud.api,bogus=1", "unknown field"),
                            ("action=error", "needs point=")):
            with pytest.raises(ValueError, match=match):
                m.chaos.parse_spec(spec)
        assert m.chaos.parse_spec("") == []
        return [vars(r) for r in rules]
    r0, r1 = both(case)
    assert (r0["point"], r0["key"], r0["rate"]) == \
        ("controller.reconcile", "disruption", 0.5)
    assert (r1["latency_s"], r1["count"], r1["at_s"], r1["until_s"],
            r1["error_code"]) == (0.2, 3, 10.0, 99.0, "Throttling")


def test_options_arm_the_injector():
    """`maybe_configure_from_options` (the operator's startup) arms the
    process-global injector from `--chaos-spec` / `--chaos-seed`; an empty
    spec leaves it disarmed."""
    def case(m):
        O = m.options.Options
        out = [m.chaos.maybe_configure_from_options(O()),
               m.chaos.CHAOS.enabled]
        opts = O.from_args(["--chaos-spec", "point=cloud.api,key=x,rate=0.5",
                            "--chaos-seed", "3"])
        out += [m.chaos.maybe_configure_from_options(opts),
                m.chaos.CHAOS.enabled, len(m.chaos.CHAOS.rules),
                opts.chaos_seed]
        bits = []
        for _ in range(40):
            try:
                m.chaos.CHAOS.inject("cloud.api", key="x")
                bits.append(0)
            except m.chaos.ChaosError:
                bits.append(1)
        m.chaos.CHAOS.reset()
        return out, bits
    out, bits = both(case)
    assert out == [False, False, True, True, 1, 3] and 0 < sum(bits) < 40


# ---------------------------------------------------------------------------
# the seams
# ---------------------------------------------------------------------------

def test_cloud_api_seam_follows_next_error_and_the_throttle():
    """`cloud.api` fires at the end of `_maybe_raise`, keyed on the API:
    a one-shot `next_error` and the throttle window raise first and draw
    nothing from the rule's stream."""
    def case(m):
        f = m.fake
        clock = [0.0]
        cloud = f.FakeCloud(clock=lambda: clock[0])
        m.chaos.CHAOS.configure(
            [m.chaos.ChaosRule("cloud.api", key="terminate_instances",
                               count=1, error_code="InternalError")],
            seed=0, clock=lambda: clock[0], sleep=lambda s: None)
        ov = f.FleetOverride("a.small", "zone-a", "on-demand", 0.1)
        inst = cloud.create_fleet([ov]).instances[0]   # another API
        out = []
        cloud.next_error = f.CloudError("Boom", "one shot")
        cloud.throttle_until = 5.0
        for _ in range(3):
            try:
                cloud.terminate_instances([inst.id])
                out.append("ok")
            except f.CloudError as e:
                out.append(e.code)
            clock[0] += 3.0
        out.append(cloud.terminate_instances([inst.id]))
        return out, m.chaos.CHAOS.counts(), cloud.calls
    out, counts, calls = both(case)
    assert out[:3] == ["Boom", "RequestLimitExceeded", "InternalError"]
    assert counts == {"cloud.api/error": 1}


def _operator(m, clock, n_types=25):
    """tests/test_chaos.py's stack: 25 instance types over a seeded fake
    cloud, an interruption queue and a 0.5 s batch window."""
    f = m.fake
    op = m.operator.Operator(
        m.options.Options(interruption_queue="q", batch_idle_duration=0.5),
        catalog=m.gen.generate_catalog(n_types), clock=lambda: clock[0],
        **m.extra)
    op.cloud.subnets = [f.SubnetInfo("s-a", "zone-a", 10_000, {}),
                        f.SubnetInfo("s-b", "zone-b", 10_000, {})]
    op.cloud.security_groups = [f.SecurityGroupInfo("sg", "nodes", {})]
    op.cloud.images = [f.ImageInfo("img-1", "std", "amd64", 1.0)]
    op.params.parameters = {
        "/karpenter-tpu/images/standard/1.28/amd64/latest": "img-1"}
    mgr = m.manager.ControllerManager(op, m.operator.build_controllers(op),
                                      clock=lambda: clock[0])
    return op, mgr


def _pod(m, rng):
    R = m.resources
    return m.objects.Pod(requests=R.ResourceList({
        R.CPU: int(rng.integers(200, 3000)),
        R.MEMORY: int(rng.integers(256, 4096)) * 2**20}))


def test_controller_reconcile_seam_is_booked_by_the_supervisor():
    """An injected `controller.reconcile` fault is contained like any
    controller fault: the supervisor books it, sibling controllers keep
    their turn, and the pods bind."""
    def case(m):
        clock = [10_000.0]
        op, mgr = _operator(m, clock, n_types=10)
        m.chaos.CHAOS.configure(
            [m.chaos.ChaosRule("controller.reconcile", key="disruption")],
            seed=0, clock=lambda: clock[0], sleep=lambda s: None)
        rng = np.random.default_rng(2)
        op.cluster.add_pods([_pod(m, rng) for _ in range(5)])
        seen = []
        for _ in range(4):
            res = mgr.tick()
            seen.append(sorted(res))
            clock[0] += 11.0
        sups = mgr.supervisors
        return (seen, sups["disruption"].total_failures,
                sups["provisioning"].total_failures,
                len(op.cluster.pending_pods()),
                m.chaos.CHAOS.counts())
    seen, dis, prov, pending, counts = both(case)
    assert dis > 0 and prov == 0 and pending == 0
    assert counts == {"controller.reconcile/error": dis}


def test_converges_under_sustained_chaos():
    """60 pods; every tick flips a coin between spot interruption, hard
    instance reclaim, one-shot API error, and random offering ICE.  The
    loop must end with every pod bound and no leaked instances — in both
    packages, tick for tick."""
    def case(m):
        clock = [10_000.0]
        op, mgr = _operator(m, clock)
        rng = np.random.default_rng(7)
        op.cluster.add_pods([_pod(m, rng) for _ in range(60)])
        CloudError = m.fake.CloudError

        def safe_running():
            try:
                return op.cloud.running()
            except CloudError:
                return []  # the injected one-shot error fired on us

        trace = []
        for _ in range(120):
            clock[0] += rng.uniform(2.0, 12.0)
            running = safe_running()
            roll = rng.random()
            if running and roll < 0.25:
                victim = running[int(rng.integers(len(running)))]
                op.cloud.interrupt(victim.id)          # 2-minute warning
            elif running and roll < 0.35:
                victim = running[int(rng.integers(len(running)))]
                op.cloud.reclaim(victim.id)            # hard kill
            elif roll < 0.45:
                op.cloud.next_error = CloudError("RequestLimitExceeded",
                                                 "chaos")
            elif roll < 0.6:
                it = op.catalog[int(rng.integers(len(op.catalog)))]
                o = it.offerings[int(rng.integers(len(it.offerings)))]
                op.unavailable.mark_unavailable("chaos", it.name, o.zone,
                                                o.capacity_type)
            try:
                mgr.tick()
                trace.append(len(op.cluster.pending_pods()))
            except CloudError:
                trace.append(None)
        op.cloud.next_error = None
        for _ in range(30):
            clock[0] += 5.0
            mgr.tick()
        bound = sum(len(n.pods) for n in op.cluster.nodes.values())
        known = {n.provider_id for n in op.cluster.nodes.values()}
        leaked = [i.id for i in op.cloud.running() if i.id not in known]
        return (trace, bound, len(op.cluster.pending_pods()), leaked,
                sorted(i.instance_type for i in op.cloud.running()))
    trace, bound, pending, leaked, _ = both(case)
    assert bound == 60 and pending == 0 and leaked == []


def test_all_offerings_blacklisted_then_recovery():
    """Blacklisting the whole catalog leaves pods pending (no crash);
    flushing the ICE cache recovers."""
    def case(m):
        clock = [10_000.0]
        op, mgr = _operator(m, clock)
        rng = np.random.default_rng(1)
        for it in op.catalog:
            for o in it.offerings:
                op.unavailable.mark_unavailable("chaos", it.name, o.zone,
                                                o.capacity_type)
        op.cluster.add_pods([_pod(m, rng) for _ in range(5)])
        mgr.tick()
        clock[0] += 1.0
        mgr.tick()
        out = [len(op.cluster.pending_pods()), len(op.cloud.running())]
        op.unavailable.flush()
        for _ in range(2):
            clock[0] += 1.0
            mgr.tick()
        return out + [len(op.cluster.pending_pods()),
                      sorted(i.instance_type for i in op.cloud.running())]
    got = both(case)
    assert got[:3] == [5, 0, 0] and got[3]


def test_sim_chaos_block_rebases_and_disarms():
    """A scenario's `chaos:` block arms the injector for the run, its rules
    rebased onto the virtual clock (a `solver.pack` fault 60 s after the
    start lands on the wave at 60 s), and disarms it after; the report
    grows the gated `chaos` section."""
    doc = {"name": "x", "duration_s": 600, "settle_s": 60,
           "catalog_size": 6,
           "workload": [{"kind": "step", "name": "w", "at_s": 60,
                         "count": 6, "duration_s": 0}],
           "chaos": {"rules": [{"point": "solver.pack", "key": "jax",
                                "at_s": 50, "count": 1}]}}

    def case(m):
        sc = m.scenario.scenario_from_dict(doc)
        run = m.sim.SimHarness(sc, seed=3, **m.extra).run()
        assert not m.chaos.CHAOS.enabled
        return m.sim.report_to_json(run.report)
    chaos = json.loads(both(case))["chaos"]
    assert chaos["injections"] == {"solver.pack/error": 1}
    assert chaos["solver_transitions"] == {}
