"""The port's degradation ladder (ops/health.py), watchdog
(utils/watchdog.py) and the two ladders that walk them — the
Provisioner's pack and the DisruptionController's simulations and batched
sweep — against the JAX package's, case by case with tests/test_health.py's
cases, on the CPU.  Each case runs on both packages and returns plain
observations that must be equal; the port solves on the CPU.

  * the ladder state machine: demotion after two errors or one timeout,
    the doubling window, half-open probes, the undemotable greedy floor;
  * the watchdog: direct calls at timeout 0, results and exceptions passed
    through (a `KernelError` raised in the worker arrives as itself), a
    hang abandoned at its deadline;
  * the stack (`Operator` + `build_controllers`, one SolverHealth shared by
    both controllers): poisoned upper rungs still bind every pod through
    the native packer and the greedy floor and recover; the happy path
    books nothing; a hung "jax" solve trips the watchdog to the native
    rung with the plan the unarmed solve gives;
  * the disruption ladder: `solver.pack` faults demote its simulations to
    the native packer, a `solver.sweep` fault is booked by the
    disruption supervisor, and a hung sweep books a timeout against "jax"
    and finishes the tick on the sequential path;
  * the port's rule that no rung answers for the card: a `KernelError`
    raised by a kernel's plain version (K1 in a provisioning solve, K5 in
    a consolidation sweep), with chaos armed, propagates out of both
    ladders and out of `ControllerManager.tick()` with nothing booked,
    and so does a KernelContractError, K1's wrapper refusing operands that
    break its contract (a wrong dtype, mixed devices).

The watchdog abandons a hung worker; the cases that trip it release the
hang and join the worker before the next step.  Both packages' injectors
are process-global; every test disarms both.
"""

import importlib
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from torch_cases import clear_lp_caches as clear_package_caches
from torch_cases import one_torch_thread  # noqa: F401
import torch

from karpenter_tpu_torch._build import KernelContractError, KernelError
from karpenter_tpu_torch.ops import classpack as cp
from karpenter_tpu_torch.ops import classpack_kernels as ck

MODULES = dict(health="ops.health", watchdog="utils.watchdog",
               chaos="utils.chaos", operator="operator",
               manager="operator.manager", options="operator.options",
               objects="api.objects", resources="api.resources",
               gen="catalog.generate", fake="cloud.fake")


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


def _ladder(m, clock, **kw):
    return m.health.SolverHealth(clock=lambda: clock[0], **kw)


# ---------------------------------------------------------------------------
# ladder state machine
# ---------------------------------------------------------------------------

def test_rung_order_is_the_documented_ladder():
    assert both(lambda m: m.health.RUNGS) == ("sharded", "jax", "native",
                                             "greedy")


def test_demotes_after_consecutive_errors_not_one():
    def case(m):
        clock = [0.0]
        h = _ladder(m, clock)
        out = [h.active_rung("jax")]
        h.report_failure("jax", reason="error")
        out.append(h.active_rung("jax"))       # one strike is not out
        h.report_failure("jax", reason="error")
        out.append(h.active_rung("jax"))       # two consecutive: demoted
        return out, h.transitions
    assert both(case) == (["jax", "jax", "native"], {"jax>native:error": 1})


def test_success_resets_the_error_streak():
    def case(m):
        h = _ladder(m, [0.0])
        h.report_failure("jax", reason="error")
        h.report_success("jax")
        h.report_failure("jax", reason="error")
        return h.active_rung("jax")
    assert both(case) == "jax"


def test_timeout_demotes_immediately():
    def case(m):
        h = _ladder(m, [0.0])
        h.report_failure("jax", reason="timeout")
        return h.active_rung("jax"), h.transitions
    assert both(case) == ("native", {"jax>native:timeout": 1})


def test_greedy_is_the_undemotable_floor():
    def case(m):
        h = _ladder(m, [0.0])
        for _ in range(10):
            h.report_failure("greedy", reason="timeout")
        return (h.active_rung("greedy"), h.transitions,
                h.snapshot()["rungs"]["greedy"]["total_failures"])
    assert both(case) == ("greedy", {}, 10)


def test_window_doubles_per_consecutive_demotion_and_caps():
    def case(m):
        clock = [0.0]
        h = _ladder(m, clock, window_s=60.0, window_max_s=600.0)
        windows = []
        for _ in range(6):
            h.report_failure("jax", reason="timeout")
            windows.append(h.snapshot()["rungs"]["jax"]["demoted_for_s"])
            clock[0] += windows[-1] + 1.0
            assert h.active_rung("jax") == "jax"   # half-open probe
        return windows
    assert both(case) == [60.0, 120.0, 240.0, 480.0, 600.0, 600.0]


def test_probe_failure_redemotes_without_a_second_strike():
    def case(m):
        clock = [0.0]
        h = _ladder(m, clock)
        h.report_failure("jax", reason="timeout")
        clock[0] += 61.0
        out = [h.active_rung("jax"), h.snapshot()["rungs"]["jax"]["probing"]]
        h.report_failure("jax", reason="error")    # ONE failure in probe
        return out + [h.active_rung("jax"), h.transitions]
    assert both(case) == ["jax", True, "native", {"jax>native:timeout": 1,
                                                  "jax>native:error": 1}]


def test_probe_success_promotes_and_records_recovery():
    def case(m):
        clock = [0.0]
        h = _ladder(m, clock)
        h.report_failure("jax", reason="timeout")
        out = [h.active_rung("jax")]
        clock[0] += 61.0
        out.append(h.active_rung("jax"))           # expired window: probe
        h.report_success("jax")
        snap = h.snapshot()["rungs"]["jax"]
        out += [snap["demoted"], snap["probing"],
                snap["consecutive_demotions"], dict(h.transitions)]
        h.report_failure("jax", reason="timeout")  # the window starts over
        return out + [h.snapshot()["rungs"]["jax"]["demoted_for_s"]]
    got = both(case)
    assert got[:5] == ["native", "jax", False, False, 0]
    assert got[5]["jax>jax:recovered"] == 1 and got[6] == 60.0


def test_requested_rung_caps_the_ladder_top():
    def case(m):
        h = _ladder(m, [0.0])
        out = [h.active_rung("sharded"), h.active_rung("native")]
        h.report_failure("native", reason="timeout")
        return out + [h.active_rung("native"), h.active_rung("jax")]
    assert both(case) == ["sharded", "native", "greedy", "jax"]


def test_two_identical_ladders_replay_identically():
    script = [("fail", "jax", "error"), ("fail", "jax", "error"),
              ("tick", 61.0), ("fail", "jax", "timeout"),
              ("tick", 200.0), ("ok", "jax")]

    def case(m):
        clock = [100.0]
        h = _ladder(m, clock)
        for step in script:
            if step[0] == "tick":
                clock[0] += step[1]
                h.active_rung("jax")
            elif step[0] == "fail":
                h.report_failure(step[1], reason=step[2])
            else:
                h.report_success(step[1])
        return h.snapshot(), h.transitions
    both(case)


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def test_watchdog_zero_timeout_is_a_direct_call():
    def case(m):
        run = m.watchdog.run_with_deadline
        return (run(lambda: threading.current_thread().name, 0.0,
                    "provision.solve"),
                run(lambda: 7, -1.0, "provision.solve"))
    assert both(case) == ("MainThread", 7)


def test_watchdog_passes_result_and_exception_through():
    def case(m):
        run = m.watchdog.run_with_deadline
        with pytest.raises(KeyError):
            run(lambda: {}["missing"], 5.0, "disruption.simulate")
        return run(lambda: "ok", 5.0, "provision.solve")
    assert both(case) == "ok"


def test_watchdog_passes_a_kernel_error_through_as_itself():
    """A device fault raised in the worker reaches the ladder as the
    fault, never as a WatchdogTimeout or a bare RuntimeError."""
    def fault():
        raise KernelError("classpack_scan: CUDA error 700")
    for phase in sorted(PORT.watchdog.PHASES):
        with pytest.raises(KernelError, match="CUDA error 700") as ei:
            PORT.watchdog.run_with_deadline(fault, 5.0, phase)
        assert type(ei.value) is KernelError


def test_watchdog_trips_on_hang_and_abandons_the_worker():
    def case(m):
        release = threading.Event()
        t0 = time.monotonic()
        with pytest.raises(m.watchdog.WatchdogTimeout) as ei:
            m.watchdog.run_with_deadline(lambda: release.wait(30.0), 0.05,
                                         "provision.solve")
        assert time.monotonic() - t0 < 5.0
        release.set()  # unblock the abandoned daemon worker
        _join_watchdog_workers()
        return ei.value.phase, ei.value.timeout_s
    assert both(case) == ("provision.solve", 0.05)


def test_watchdog_rejects_unregistered_phases():
    def case(m):
        with pytest.raises(ValueError, match="unregistered watchdog phase"):
            m.watchdog.run_with_deadline(lambda: 1, 0.0, "made.up.phase")
        return sorted(m.watchdog.PHASES)
    assert "provision.solve" in both(case)


def _join_watchdog_workers(timeout=120.0):
    """Wait out every abandoned watchdog worker, so none runs into the
    next step."""
    for t in threading.enumerate():
        if t.name.startswith("watchdog:"):
            t.join(timeout)
            assert not t.is_alive(), t.name


# ---------------------------------------------------------------------------
# the stack: one SolverHealth shared by both controllers
# ---------------------------------------------------------------------------

def _stack(m, clock, n_types=25, gates=(), **opts):
    """tests/test_health.py's stack: 25 instance types over a seeded fake
    cloud, an interruption queue and a 0.5 s batch window; `gates` sets
    feature gates."""
    f = m.fake
    options = m.options.Options(interruption_queue="q",
                                batch_idle_duration=0.5, **opts)
    options.feature_gates.update(gates)
    op = m.operator.Operator(
        options,
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


def _solve_tick(m, op, mgr, clock, rng, n=5):
    """Add pods and tick until the batch window ripens and provisioning
    solves (two ticks: observe, then ripe after the idle window)."""
    op.cluster.add_pods([_pod(m, rng) for _ in range(n)])
    mgr.tick()
    clock[0] += 1.0
    mgr.tick()


def _rungs(h):
    return {r: (s["total_failures"], s["demoted"])
            for r, s in h.snapshot()["rungs"].items()}


def _plan(op):
    """The launched claims with their bound pod counts."""
    pods = {n.provider_id: len(n.pods) for n in op.cluster.nodes.values()}
    return sorted((c.instance_type, c.zone, c.capacity_type,
                   pods.get(c.provider_id, -1))
                  for c in op.cluster.nodeclaims.values())


def test_build_controllers_shares_one_ladder():
    def case(m):
        clock = [10_000.0]
        op, mgr = _stack(m, clock, solve_timeout_s=7.0)
        prov = mgr.controllers["provisioning"]
        dis = mgr.controllers["disruption"]
        return (prov.health is dis.health is not None,
                prov.watchdog_timeout_s, dis.watchdog_timeout_s)
    assert both(case) == (True, 7.0, 7.0)


def test_poisoned_upper_rungs_still_bind_pods_via_greedy():
    """Every device-path rung erroring: the ladder walks down to the NumPy
    greedy floor inside the same solve (the native packer answers for the
    card's rung only when it is not poisoned), binds all pods, records the
    demotions, and promotes back after the fault clears."""
    def case(m):
        clock = [10_000.0]
        op, mgr = _stack(m, clock)
        rng = np.random.default_rng(3)
        health = mgr.controllers["provisioning"].health
        m.chaos.CHAOS.configure([m.chaos.ChaosRule("solver.pack", key="jax"),
                                 m.chaos.ChaosRule("solver.pack",
                                                   key="native")],
                                seed=0, clock=lambda: clock[0],
                                sleep=lambda s: None)
        out = []
        for dt in (0.0, 30.0, 5.0):
            clock[0] += dt
            _solve_tick(m, op, mgr, clock, rng)
            assert not op.cluster.pending_pods(), "greedy floor failed"
            out.append((_rungs(health), dict(health.transitions)))
        m.chaos.CHAOS.reset()
        clock[0] += 120.0
        _solve_tick(m, op, mgr, clock, rng)
        assert not op.cluster.pending_pods()
        out.append((_rungs(health), dict(health.transitions), _plan(op)))
        return out
    out = both(case)
    assert out[0][0]["jax"] == (1, False) and out[0][0]["native"] == (1, False)
    assert out[1][1] == {"jax>native:error": 1, "native>greedy:error": 1}
    assert out[2][0]["jax"][0] == 2                # not attempted again
    assert out[3][1]["jax>jax:recovered"] == 1
    assert out[3][0]["jax"] == (2, False)


def test_poisoned_jax_rung_binds_via_the_native_packer():
    """Only "jax" poisoned: the native C++ packer answers inside the same
    solve, twice, and the ladder then starts on it."""
    def case(m):
        clock = [10_000.0]
        op, mgr = _stack(m, clock)
        rng = np.random.default_rng(6)
        health = mgr.controllers["provisioning"].health
        m.chaos.CHAOS.configure([m.chaos.ChaosRule("solver.pack", key="jax")],
                                seed=0, clock=lambda: clock[0],
                                sleep=lambda s: None)
        for dt in (0.0, 30.0, 5.0):
            clock[0] += dt
            _solve_tick(m, op, mgr, clock, rng)
            assert not op.cluster.pending_pods()
        return (_rungs(health), dict(health.transitions), _plan(op),
                m.chaos.CHAOS.counts())
    rungs, transitions, _, counts = both(case)
    assert transitions == {"jax>native:error": 1}
    assert rungs["native"] == (0, False) and rungs["greedy"] == (0, False)
    assert counts == {"solver.pack/error": 2}


def test_happy_path_ladder_is_invisible():
    """With no chaos armed the wired ladder changes nothing: pods bind, no
    transitions, no failures booked."""
    def case(m):
        clock = [10_000.0]
        op, mgr = _stack(m, clock)
        _solve_tick(m, op, mgr, clock, np.random.default_rng(4))
        health = mgr.controllers["provisioning"].health
        return (len(op.cluster.pending_pods()), health.transitions,
                _rungs(health), _plan(op))
    pending, transitions, rungs, _ = both(case)
    assert pending == 0 and transitions == {}
    assert all(f == 0 for f, _ in rungs.values())


def test_health_snapshot_exposed_via_manager():
    def case(m):
        clock = [10_000.0]
        op, mgr = _stack(m, clock)
        _solve_tick(m, op, mgr, clock, np.random.default_rng(5))
        snap = mgr.health_snapshot()
        return (sorted(snap["solver"]["rungs"]),
                snap["controllers"]["provisioning"]["state"])
    assert both(case) == (sorted(PORT.health.RUNGS), "closed")


def test_hung_jax_solve_trips_the_watchdog_to_the_native_rung():
    """A `hang` on the "jax" rung longer than `solve_timeout_s`: the
    watchdog abandons the solve, books `jax>native:timeout`, and the
    native packer's plan is the one the unarmed solve gives."""
    def case(m, armed):
        clock = [10_000.0]
        op, mgr = _stack(m, clock, solve_timeout_s=0.5)
        gate = threading.Event()
        if armed:
            m.chaos.CHAOS.configure(
                [m.chaos.ChaosRule("solver.pack", key="jax", action="hang",
                                   latency_s=60.0, count=1)],
                seed=0, clock=lambda: clock[0], sleep=gate.wait)
        try:
            _solve_tick(m, op, mgr, clock, np.random.default_rng(8), n=12)
        finally:
            gate.set()
            _join_watchdog_workers()
        health = mgr.controllers["provisioning"].health
        return _plan(op), dict(health.transitions), \
            len(op.cluster.pending_pods())
    for m in (REF, PORT):
        clean = case(m, armed=False)
        got = case(m, armed=True)
        assert got[0] == clean[0] and got[2] == 0
        assert got[1] == {"jax>native:timeout": 1}
    assert case(PORT, True)[0] == case(REF, True)[0]


# ---------------------------------------------------------------------------
# the disruption ladder
# ---------------------------------------------------------------------------

def _consolidation_stack(m, clock, **opts):
    """A fleet worth consolidating: 300 pods provisioned, four in five of
    them deleted, the clock past the nodes' stabilization."""
    op, mgr = _stack(m, clock, **opts)
    rng = np.random.default_rng(11)
    pods = [_pod(m, rng) for _ in range(300)]
    op.cluster.add_pods(pods)
    mgr.tick()
    clock[0] += 1.0
    mgr.tick()
    assert not op.cluster.pending_pods()
    for i, p in enumerate(pods):
        if i % 5:
            op.cluster.delete_pod(p)
    clock[0] += 10_000.0
    return op, mgr


def _disruption_tick(m, op, mgr, clock):
    res = mgr.tick()
    dis = mgr.controllers["disruption"]
    act = getattr(res.get("disruption"), "action", None)
    return ((act.kind, act.reason, len(act.candidates)) if act else None,
            dict(dis.health.transitions), _rungs(dis.health),
            mgr.supervisors["disruption"].total_failures,
            m.chaos.CHAOS.counts(), len(op.cluster.nodes))


def test_disruption_simulations_demote_to_the_native_packer():
    """`solver.pack` faults on "jax" in the consolidation tick: the
    sequential path's simulations fall to the native packer inside each
    simulation, the shared ladder books the demotion, and the tick decides
    as the reference's does."""
    def case(m):
        clock = [10_000.0]
        op, mgr = _consolidation_stack(m, clock)
        dis = mgr.controllers["disruption"]
        dis.batched_sweep = False
        m.chaos.CHAOS.configure([m.chaos.ChaosRule("solver.pack", key="jax")],
                                seed=0, clock=lambda: clock[0],
                                sleep=lambda s: None)
        return _disruption_tick(m, op, mgr, clock)
    act, transitions, rungs, sup_failures, counts, _ = both(case)
    assert transitions == {"jax>native:error": 1}
    assert rungs["native"] == (0, False) and sup_failures == 0
    assert counts["solver.pack/error"] >= 2 and act is not None


def test_disruption_sweep_fault_is_booked_by_its_supervisor():
    """A `solver.sweep` fault raises out of the batched sweep (it sits in
    front of the arena's kernels, not under the ladder): the disruption
    supervisor books it and the ladder books nothing."""
    def case(m):
        clock = [10_000.0]
        op, mgr = _consolidation_stack(m, clock)
        m.chaos.CHAOS.configure([m.chaos.ChaosRule("solver.sweep")],
                                seed=0, clock=lambda: clock[0],
                                sleep=lambda s: None)
        return _disruption_tick(m, op, mgr, clock)
    act, transitions, _, sup_failures, counts, _ = both(case)
    assert act is None and transitions == {} and sup_failures == 1
    assert counts == {"solver.sweep/error": 1}


def test_hung_sweep_books_a_timeout_and_finishes_sequentially():
    """A `hang` in the batched sweep past the deadline: a timeout is booked
    against "jax", and the tick finishes on the sequential path, whose
    simulations consult the demoted ladder (the native packer)."""
    def case(m):
        clock = [10_000.0]
        op, mgr = _consolidation_stack(m, clock, solve_timeout_s=1.0)
        gate = threading.Event()
        m.chaos.CHAOS.configure(
            [m.chaos.ChaosRule("solver.sweep", action="hang", latency_s=60.0,
                               count=1)],
            seed=0, clock=lambda: clock[0], sleep=gate.wait)
        try:
            return _disruption_tick(m, op, mgr, clock)
        finally:
            gate.set()
            _join_watchdog_workers()
    act, transitions, rungs, sup_failures, counts, _ = both(case)
    assert transitions == {"jax>native:timeout": 1}
    assert rungs["jax"] == (1, True) and sup_failures == 0
    assert counts == {"solver.sweep/hang": 1} and act is not None


# ---------------------------------------------------------------------------
# no rung answers for the card
# ---------------------------------------------------------------------------

def _raise_once(monkeypatch, name):
    """Make `classpack_kernels.<name>` raise KernelError on its next call
    (then run as before); returns the call log."""
    real = getattr(ck, name)
    calls = []

    def faulty(*a, **k):
        calls.append(name)
        if len(calls) == 1:
            raise KernelError(f"{name}: CUDA error 700 (an illegal memory "
                              f"access)")
        return real(*a, **k)
    monkeypatch.setattr(ck, name, faulty)
    return calls


def _nothing_booked(mgr):
    health = mgr.controllers["provisioning"].health
    assert health is mgr.controllers["disruption"].health
    assert health.transitions == {}
    assert all(f == 0 for f, _ in _rungs(health).values())
    assert all(s.total_failures == 0 for s in mgr.supervisors.values())


def _armed(clock):
    """A chaos schedule that is armed but does not fire on these paths."""
    PORT.chaos.CHAOS.configure(
        [PORT.chaos.ChaosRule("solver.pack", key="native"),
         PORT.chaos.ChaosRule("cloud.api", key="describe_instances",
                              rate=0.5, at_s=1e12)],
        seed=0, clock=lambda: clock[0], sleep=lambda s: None)


def test_a_kernel_fault_in_a_provisioning_solve_leaves_the_tick(monkeypatch):
    """K1's plain version raises KernelError in a 300-pod provisioning
    solve (the class-granular path, the LP guide off so that the kernels
    place every pod): the fault leaves `tick()` as itself, no rung, ladder
    or supervisor books it, and no pod is bound."""
    clock = [10_000.0]
    op, mgr = _stack(PORT, clock, gates={"LPGuide": False})
    _armed(clock)
    calls = _raise_once(monkeypatch, "classpack_precompute_plain")
    rng = np.random.default_rng(12)
    op.cluster.add_pods([_pod(PORT, rng) for _ in range(300)])
    mgr.tick()
    clock[0] += 1.0
    with pytest.raises(KernelError, match="classpack_precompute_plain"):
        mgr.tick()
    assert calls == ["classpack_precompute_plain"]
    assert PORT.chaos.CHAOS.enabled and PORT.chaos.CHAOS.fired_total() == 0
    _nothing_booked(mgr)
    assert len(op.cluster.pending_pods()) == 300 and not op.cluster.nodes


def _breach_k1(monkeypatch, how):
    """Give K1's wrapper operands that break its contract on the next
    provisioning solve: int64 requests to a wrapper that takes the
    operands as on the card ("dtype"), or a price on another device than
    the rest ("device").  Returns the call log."""
    real = cp.classpack_precompute
    calls = []

    def breached(requests, node_cap, compat_packed, alloc, price, rank,
                 *a, **k):
        calls.append(how)
        if how == "device":
            price = torch.empty(price.shape, dtype=price.dtype,
                                device="meta")
            return real(requests, node_cap, compat_packed, alloc, price,
                        rank, *a, **k)
        with monkeypatch.context() as mp:
            mp.setattr(ck, "_on_cuda", lambda *t: True)
            return real(requests.to(torch.int64), node_cap, compat_packed,
                        alloc, price, rank, *a, **k)
    monkeypatch.setattr(cp, "classpack_precompute", breached)
    return calls


@pytest.mark.parametrize("how,match", [("dtype", "requests: dtype"),
                                       ("device", "mixed")])
def test_a_kernel_contract_breach_leaves_the_tick(monkeypatch, how, match):
    """K1's wrapper refuses operands that break its contract, before any
    launch, in a 300-pod provisioning solve under an armed chaos schedule:
    the refusal is a KernelContractError (a KernelError that is also a
    TypeError and a ValueError), it leaves `tick()` as itself, no rung,
    ladder or supervisor books it, and no pod is bound."""
    clock = [10_000.0]
    op, mgr = _stack(PORT, clock, gates={"LPGuide": False})
    _armed(clock)
    calls = _breach_k1(monkeypatch, how)
    rng = np.random.default_rng(12)
    op.cluster.add_pods([_pod(PORT, rng) for _ in range(300)])
    mgr.tick()
    clock[0] += 1.0
    with pytest.raises(KernelContractError, match=match) as got:
        mgr.tick()
    assert isinstance(got.value, TypeError)
    assert isinstance(got.value, ValueError)
    assert calls == [how]
    assert PORT.chaos.CHAOS.enabled and PORT.chaos.CHAOS.fired_total() == 0
    _nothing_booked(mgr)
    assert len(op.cluster.pending_pods()) == 300 and not op.cluster.nodes


def test_a_kernel_fault_in_a_consolidation_sweep_leaves_the_tick(
        monkeypatch):
    """K5's plain version raises KernelError in the consolidation tick's
    batched sweep: the fault leaves `tick()` as itself, through the
    sweep's watchdog worker, and nothing is booked."""
    clock = [10_000.0]
    op, mgr = _consolidation_stack(PORT, clock, solve_timeout_s=30.0)
    nodes = len(op.cluster.nodes)
    _armed(clock)
    calls = _raise_once(monkeypatch, "classpack_sweep_plain")
    with pytest.raises(KernelError, match="classpack_sweep_plain"):
        mgr.tick()
    assert calls == ["classpack_sweep_plain"]
    _nothing_booked(mgr)
    assert len(op.cluster.nodes) == nodes
    assert not any(n.marked_for_deletion for n in op.cluster.nodes.values())
