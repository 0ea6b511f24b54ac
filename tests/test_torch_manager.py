"""The port's controller manager and supervisors (operator/manager.py,
operator/supervisor.py) against the JAX package's, case by case with
tests/test_supervisor.py's cases that need no metrics and
tests/test_operator.py's manager cases that need no LeaderElector (the
batch window, the ticks and their cadences, the HTTP endpoints on a free
port, the `/v1` surface, /v1/solve racing the tick loop under the shared
state lock).  Each case runs on both packages and returns plain
observations that must be equal; the port solves on the CPU.

Then the port's own boundaries: a fault of the card or of a kernel
(`DEVICE_FAULTS`) raised inside a tick propagates out of `tick()` with
nothing booked on the supervisor, and answers `/v1/solve` with a 500; the
endpoints once unported answer as the reference's do: B9a's `/metrics`,
`/debug/traces` and `/debug/pprof`, and B9b's `/debug/incidents`,
`/debug/slo` and `/debug/ledger` with their gates off (404; with the gates
on, tests/test_torch_obs.py); the readiness ladder without a leader.
"""

import importlib
import json
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from torch_cases import clear_lp_caches as clear_package_caches
from torch_cases import one_torch_thread  # noqa: F401
from torch_refnative import reference_native_loaded  # noqa: F401
from karpenter_tpu_torch._build import KernelError

MODULES = dict(operator="operator", manager="operator.manager",
               supervisor="operator.supervisor", options="operator.options",
               objects="api.objects", resources="api.resources",
               labels="api.labels", gen="catalog.generate", fake="cloud.fake",
               events="utils.events", serialize="api.serialize")


def _package(name, extra):
    return SimpleNamespace(name=name, extra=extra, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in MODULES.items()})


REF = _package("karpenter_tpu", {})
PORT = _package("karpenter_tpu_torch", {"device": "cpu"})


@pytest.fixture(autouse=True)
def _clean_lp_caches():
    clear_package_caches("karpenter_tpu", "karpenter_tpu_torch")
    yield
    clear_package_caches("karpenter_tpu", "karpenter_tpu_torch")


def both(case):
    ref, port = case(REF), case(PORT)
    assert ref == port
    return port


def pod(m, cpu=500, **kw):
    R = m.resources
    return m.objects.Pod(requests=R.ResourceList(
        {R.CPU: cpu, R.MEMORY: 512 * 2**20}), **kw)


# ---------------------------------------------------------------------------
# tests/test_supervisor.py: backoff policy and the supervisor state machine
# ---------------------------------------------------------------------------

def test_jitter_is_deterministic_bounded_and_decorrelated():
    def case(m):
        js = [m.supervisor._jitter(n, f)
              for n in ("disruption", "lifecycle", "provisioning", "a")
              for f in range(1, 12)]
        assert all(0.5 <= j < 1.0 for j in js)
        return js
    assert len(set(both(case))) > 1


def test_backoff_grows_exponentially_and_caps():
    def case(m):
        pol = m.supervisor.BackoffPolicy(base_s=1.0, factor=2.0, max_s=300.0)
        return [pol.delay("x", f) for f in range(1, 12)]
    delays = both(case)
    raw = [d / PORT.supervisor._jitter("x", f)
           for f, d in enumerate(delays, start=1)]
    assert raw[0] == pytest.approx(1.0) and raw[-1] == pytest.approx(300.0)


def _sup(m, threshold=3, base=1.0, **kw):
    S = m.supervisor
    return S.ControllerSupervisor(
        "t", policy=S.BackoffPolicy(base_s=base, max_s=300.0),
        circuit_threshold=threshold, **kw)


def test_happy_path_is_invisible():
    def case(m):
        sup = _sup(m)
        for now in (0.0, 5.0, 10.0):
            assert sup.allow(now)
            sup.record_success(now)
        return sup.snapshot(), sup.next_allowed()
    snap, nxt = both(case)
    assert snap["state"] == "closed" and nxt == float("-inf")


def test_failures_back_off_and_skips_do_not_advance():
    def case(m):
        sup = _sup(m, threshold=10)
        sup.record_failure(100.0, RuntimeError("boom"))
        out = [sup.failures, sup.retry_at, sup.allow(sup.retry_at - 0.01),
               sup.total_skips, sup.allow(sup.retry_at)]
        sup.record_failure(sup.retry_at, RuntimeError("boom"))
        return out + [sup.failures, sup.next_allowed()]
    out = both(case)
    assert 100.5 <= out[1] < 101.0 and out[2:5] == [False, 1, True]


def test_circuit_opens_at_threshold_probes_and_recovers():
    def case(m):
        sup, trail, now = _sup(m, threshold=3), [], 0.0
        for _ in range(3):
            now = max(now + 0.01, sup.retry_at)
            assert sup.allow(now)
            sup.record_failure(now, ValueError("bad"))
        trail.append(sup.snapshot())
        trail.append(sup.allow(now + 0.01))
        now = sup.retry_at
        trail += [sup.allow(now), sup.state]
        sup.record_failure(now, ValueError("still bad"))
        trail.append(sup.snapshot())
        now = sup.retry_at
        trail.append(sup.allow(now))
        sup.record_success(now)
        return trail + [sup.snapshot()]
    trail = both(case)
    assert trail[0]["state"] == "open" and trail[0]["total_quarantines"] == 1
    assert trail[3] == "half_open" and trail[4]["state"] == "open"
    assert trail[-1]["state"] == "closed"


def test_two_identical_supervisors_replay_identically():
    schedule = [(1.0, False), (3.0, False), (9.0, True), (20.0, False),
                (40.0, False), (90.0, False), (200.0, True)]

    def case(m):
        snaps = []
        for sup in (_sup(m, threshold=4), _sup(m, threshold=4)):
            for now, ok in schedule:
                sup.allow(now)
                if ok:
                    sup.record_success(now)
                else:
                    sup.record_failure(now, RuntimeError("x"))
            snaps.append(sup.snapshot())
        assert snaps[0] == snaps[1]
        return snaps[0]
    both(case)


def test_quarantine_publishes_recorder_event_and_snapshot_shape():
    def case(m):
        clock = [50.0]
        rec = m.events.Recorder(clock=lambda: clock[0])
        sup = m.supervisor.ControllerSupervisor(
            "disruption", circuit_threshold=2, recorder=rec)
        sup.record_failure(50.0, RuntimeError("kaput"))
        clock[0] = 60.0
        sup.record_failure(60.0, KeyError("k"))
        evs = rec.events(reason="Quarantined")
        return ([(e.type, e.name, e.message) for e in evs], sup.snapshot())
    evs, snap = both(case)
    assert evs == [("Warning", "disruption",
                    "controller quarantined: KeyError: 'k'")]
    assert snap["last_error"].startswith("KeyError")


# ---------------------------------------------------------------------------
# tests/test_supervisor.py: the manager's isolation contract
# ---------------------------------------------------------------------------

class _Counting:
    def __init__(self):
        self.runs = 0

    def reconcile(self):
        self.runs += 1


class _Crashing:
    def __init__(self, once=False):
        self.calls = 0
        self.once = once

    def reconcile(self):
        self.calls += 1
        if not self.once or self.calls == 1:
            raise RuntimeError("poisoned controller")


def _fake_mgr(m, controllers, clock):
    """tests/test_supervisor.py's `_FakeOperator`: just enough operator
    surface for ControllerManager, with the lock the operator owns."""
    cluster = SimpleNamespace(pending_pods=lambda: [])
    op = SimpleNamespace(
        options=m.options.Options(supervisor_circuit_threshold=5),
        clock=clock, recorder=m.events.Recorder(clock=clock),
        state_lock=threading.RLock(), cluster=cluster, node_classes={})
    return m.manager.ControllerManager(op, controllers, clock=clock)


def test_crash_loop_does_not_steal_sibling_cadence():
    def case(m):
        clock = [0.0]
        healthy = {f"h{i}": _Counting() for i in range(3)}
        bad = _Crashing()
        mgr = _fake_mgr(m, {**healthy, "bad": bad}, lambda: clock[0])
        for e in mgr._entries:
            e.interval = 1.0
        for _ in range(1000):
            clock[0] += 1.0
            mgr.tick()
        assert all(c.runs >= 950 for c in healthy.values())
        assert bad.calls < 100
        return ([c.runs for c in healthy.values()], bad.calls,
                mgr.health_snapshot())
    runs, calls, snap = both(case)
    assert snap["controllers"]["bad"]["total_quarantines"] >= 1
    assert "solver" not in snap     # no provisioning controller wired


def test_cadence_resumes_immediately_after_recovery():
    def case(m):
        clock = [10.0]
        flaky = _Crashing(once=True)
        mgr = _fake_mgr(m, {"flaky": flaky}, lambda: clock[0])
        mgr._entries[0].interval = 10.0
        first = mgr.tick()              # fails; backoff <= 1s
        clock[0] = 20.0                 # next interval, window long expired
        second = mgr.tick()
        return (sorted(first), sorted(second), flaky.calls,
                mgr.supervisors["flaky"].snapshot())
    out = both(case)
    assert out[:3] == ([], ["flaky"], 2)


# ---------------------------------------------------------------------------
# tests/test_operator.py: the batch window and the manager's ticks
# ---------------------------------------------------------------------------

def test_pod_batch_window():
    """TestPodBatchWindow's four cases: idle then ripe, new arrivals extend
    the window, max_timeout caps a stream, an empty count resets."""
    def case(m):
        t = [0.0]
        W = m.manager.PodBatchWindow
        out = []
        w = W(idle=1.0, max_timeout=10.0, clock=lambda: t[0])
        w.observe(3)
        out.append(w.ripe())
        t[0] = 0.9
        w.observe(3)
        out.append(w.ripe())
        t[0] = 1.05
        out.append(w.ripe())
        t[0] = 0.0
        w = W(idle=1.0, max_timeout=10.0, clock=lambda: t[0])
        w.observe(1)
        t[0] = 0.8
        w.observe(2)
        t[0] = 1.5
        out.append(w.ripe())
        t[0] = 1.9
        out.append(w.ripe())
        t[0] = 0.0
        w = W(idle=1.0, max_timeout=10.0, clock=lambda: t[0])
        for i in range(20):
            w.observe(i + 1)
            t[0] += 0.6
            if w.ripe():
                break
        out.append(round(t[0], 6))
        w = W(idle=1.0, clock=lambda: t[0])
        w.observe(2)
        w.observe(0)
        t[0] += 5
        out.append(w.ripe())
        return out
    assert both(case) == [False, False, True, False, True, 10.2, False]


def _operator(m, clock, **opts):
    """TestControllerManager's operator: ten instance types over a seeded
    fake cloud."""
    f = m.fake
    op = m.operator.Operator(
        m.options.Options(batch_idle_duration=1.0, batch_max_duration=10.0,
                          **opts),
        catalog=m.gen.generate_catalog(10), clock=lambda: clock[0],
        **m.extra)
    op.cloud.subnets = [f.SubnetInfo("s-a", "zone-a", 100, {}),
                        f.SubnetInfo("s-b", "zone-b", 100, {})]
    op.cloud.security_groups = [f.SecurityGroupInfo("sg", "nodes", {})]
    op.cloud.images = [f.ImageInfo("img-1", "std", "amd64", 1.0)]
    op.params.parameters = {
        "/karpenter-tpu/images/standard/1.28/amd64/latest": "img-1"}
    return op


def _manager(m, clock, **opts):
    op = _operator(m, clock, **opts)
    ctrls = m.operator.build_controllers(op)
    mgr = m.manager.ControllerManager(op, ctrls, clock=lambda: clock[0])
    return op, ctrls, mgr


def _claims(op):
    return sorted((c.instance_type, c.zone, c.capacity_type)
                  for c in op.cluster.nodeclaims.values())


def test_tick_provisions_after_batch_window():
    def case(m):
        clock = [100.0]
        op, _, mgr = _manager(m, clock)
        op.cluster.add_pods([pod(m) for _ in range(4)])
        first = mgr.tick()
        assert "provisioning" not in first      # window just opened
        clock[0] += 1.1                          # idle elapses
        res = mgr.tick()
        return (sorted(first), sorted(res), res["provisioning"].scheduled,
                len(op.cloud.running()), _claims(op))
    out = both(case)
    assert out[2] == 4 and out[3] >= 1


def test_tick_respects_intervals():
    def case(m):
        clock = [100.0]
        _, _, mgr = _manager(m, clock)
        ran = [sorted(mgr.tick()), sorted(mgr.tick())]
        clock[0] += 11
        ran.append(sorted(mgr.tick()))
        return ran
    ran = both(case)
    assert "disruption" in ran[0] and "disruption" not in ran[1]
    assert "disruption" in ran[2]


def test_apply_nodepool_reaches_running_controllers():
    """TestApply: a pool applied after the controllers were built is
    solvable on the next ripe tick."""
    def case(m):
        clock = [1000.0]
        op, _, mgr = _manager(m, clock)
        pool = m.objects.NodePool(
            name="team-b",
            template=m.objects.NodePoolTemplate(labels={"team": "b"}))
        op.apply(m.serialize.nodepool_to_manifest(pool))
        op.cluster.add_pods([pod(m, node_selector={"team": "b"})])
        mgr.tick()
        clock[0] += 1.1
        res = mgr.tick()
        node = next(iter(op.cluster.nodes.values()))
        return res["provisioning"].scheduled, node.nodepool, _claims(op)
    assert both(case)[:2] == (1, "team-b")


# ---------------------------------------------------------------------------
# tests/test_operator.py: the endpoints and the /v1 surface over HTTP
# ---------------------------------------------------------------------------

def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _post(port, path, obj):
    data = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _served(m, case):
    clock = [100.0]
    op, ctrls, mgr = _manager(m, clock)
    port = mgr.serve_endpoints(metrics_port=0)
    try:
        for nc in op.node_classes.values():
            ctrls["nodeclass"].reconcile(nc)
        return case(m, op, mgr, port, clock)
    finally:
        mgr.stop()


def _manifests(prefix, n, cpu="500m", mem="512Mi"):
    return {"pods": [
        {"metadata": {"name": f"{prefix}{i}"},
         "spec": {"containers": [{"resources": {"requests": {
             "cpu": cpu, "memory": mem}}}]}} for i in range(n)]}


def test_healthz_and_debug_health():
    def case(m, op, mgr, port, clock):
        mgr.tick()
        code, live = _get(port, "/healthz")
        code2, health = _get(port, "/debug/health")
        return (code, live["live"], live["wedges"], live["circuits_open"],
                code2, sorted(health["controllers"]),
                sorted(health["solver"]))
    out = both(lambda m: _served(m, case))
    assert out[:2] == (200, True) and out[4] == 200


def test_solve_endpoint_returns_launch_plan():
    def case(m, op, mgr, port, clock):
        code, out = _post(port, "/v1/solve", _manifests("p", 6))
        assert code == 200 and not out["unschedulable"]
        placed = sum(len(n["pods"]) for n in out["nodes"]) + \
            len(out["boundToExisting"])
        assert placed == 6 and out["nodes"][0]["alternatives"]
        bad = _post(port, "/v1/solve", b"{}")
        # solve is stateless: nothing bound, nothing launched
        return out, len(op.cluster.nodes), bad[0], sorted(bad[1])
    out = both(lambda m: _served(m, case))
    assert out[1:] == (0, 400, ["error"])


def test_solve_endpoint_concurrent_with_tick_loop():
    """/v1/solve reads a point-in-time node snapshot under the state lock
    and solves off it: hammering the endpoint while the tick loop churns
    cluster state never surfaces a race, and every request gets a plan."""
    def case(m, op, mgr, port, clock):
        stop = threading.Event()
        tick_errs = []

        def churn():
            while not stop.is_set():
                op.cluster.add_pods([pod(m, cpu=100)])
                clock[0] += 2.0
                try:
                    mgr.tick()
                except Exception as e:  # pragma: no cover
                    tick_errs.append(repr(e))

        t = threading.Thread(target=churn)
        t.start()
        try:
            got = [_post(port, "/v1/solve", _manifests("q", 4, "200m",
                                                       "128Mi"))
                   for _ in range(25)]
        finally:
            stop.set()
            t.join()
        assert not tick_errs, tick_errs
        assert all(code == 200 for code, _ in got)
        assert all(len(o["nodes"]) + len(o["boundToExisting"]) >= 1
                   for _, o in got)
        return True
    both(lambda m: _served(m, case))


def test_v1_operable_surface():
    """/v1 as an operable control surface: an external client configures a
    pool through admission (/v1/apply), reads it back (/v1/nodepools),
    solves, reports an ICE on the launched pool (/v1/feedback), and
    re-solves onto different capacity — with the tick loop running between
    calls; bad requests are 400s that apply nothing."""
    def case(m, op, mgr, port, clock):
        obs = []
        mf = m.serialize.nodepool_to_manifest(
            m.objects.NodePool(name="ext", weight=5))
        obs.append(_post(port, "/v1/apply", mf))
        bad = dict(mf, spec=dict(mf["spec"], weight=-3))
        code, err = _post(port, "/v1/apply", bad)
        obs.append((code, "ext" in err["error"]))
        code, listed = _get(port, "/v1/nodepools")
        obs.append(sorted(i["metadata"]["name"] for i in listed["items"]))
        obs.append(_get(port, "/v1/nodeclasses"))
        mgr.tick()
        pods = _manifests("p", 4)
        code, plan = _post(port, "/v1/solve", pods)
        obs.append(plan)
        nd = plan["nodes"][0]
        ice = {"instanceType": nd["instanceType"], "zone": nd["zone"],
               "capacityType": nd["capacityType"], "ok": False,
               "error": "InsufficientInstanceCapacity"}
        obs.append(_post(port, "/v1/feedback", {"results": [ice]}))
        mgr.tick()
        code, plan2 = _post(port, "/v1/solve", pods)
        offending = (nd["instanceType"], nd["zone"], nd["capacityType"])
        assert all((n["instanceType"], n["zone"], n["capacityType"])
                   != offending for n in plan2["nodes"])
        obs.append(plan2)
        obs.append(_post(port, "/v1/feedback", {"results": [
            dict(ice, error="RequestLimitExceeded")]}))
        good = m.serialize.nodepool_to_manifest(
            m.objects.NodePool(name="atomic-probe"))
        obs.append(_post(port, "/v1/apply",
                         {"manifests": [good, bad]})[0])
        code, listed2 = _get(port, "/v1/nodepools")
        obs.append("atomic-probe" in {i["metadata"]["name"]
                                      for i in listed2["items"]})
        obs.append(_post(port, "/v1/solve", {"pods": "oops"})[0])
        obs.append(_post(port, "/v1/feedback", {"results": ["oops"]})[0])
        obs.append(_post(port, "/v1/feedback", {"results": [
            dict(ice, instanceType="x"), {"ok": False}]})[0])
        obs.append(_post(port, "/v1/feedback", {"results": [
            {"instanceType": "y", "zone": "z", "capacityType": "spot",
             "ok": True}]}))
        obs.append(_post(port, "/v1/solve", b"{not json")[0])
        obs.append(_post(port, "/v1/nope", {})[0])
        return obs
    obs = both(lambda m: _served(m, case))
    assert obs[0] == (200, {"applied": [{"kind": "NodePool",
                                         "name": "ext"}]})
    assert obs[1] == (400, True) and {"ext", "default"} <= set(obs[2])
    assert obs[5][1]["markedUnavailable"] == 1
    assert obs[7][1]["markedUnavailable"] == 0
    assert obs[8:] == [400, False, 400, 400, 400, obs[13], 400, 404]
    assert obs[13][1]["unavailableSeq"] == obs[7][1]["unavailableSeq"]


def test_debug_pods_provenance_endpoint():
    def case(m, op, mgr, port, clock):
        stuck = pod(m, name="stuck-pod",
                    node_selector={m.labels.ZONE: "zone-nowhere"})
        op.cluster.add_pods([stuck])
        mgr.tick()
        clock[0] += 1.1
        mgr.tick()
        code, body = _get(port, "/debug/pods/stuck-pod")
        body.pop("ts", None)      # the wall clock at the record
        return code, body, _get(port, "/debug/pods/nobody")[0]
    code, body, missing = both(lambda m: _served(m, case))
    assert (code, missing) == (200, 404)
    assert body["pod"] == "stuck-pod" and body["constraint"] == "zone"


# ---------------------------------------------------------------------------
# the port's own boundaries
# ---------------------------------------------------------------------------

def _span_tree(t):
    """A trace's names, nesting and annotation keys (ids and times
    differ between runs)."""
    return (t["name"], sorted(t["annotations"]),
            [_span_tree(c) for c in t["children"]])


def _scrape(m, op, mgr, port, clock):
    """B9a's endpoints after one provisioning tick from fresh registries:
    the /metrics family names, the provision traces' span trees, and
    /debug/pprof's answer (403: profiling is off)."""
    m.manager.metrics.REGISTRY.reset()
    m.manager.tracing.TRACER.reset()
    m.manager.metrics.register_parity_families()
    op.cluster.add_pods([pod(m) for _ in range(3)])
    mgr.tick()
    clock[0] += 1.1
    mgr.tick()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as r:
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    families = sorted(ln.split()[2] for ln in text.splitlines()
                      if ln.startswith("# TYPE "))
    code_t, traces = _get(port, "/debug/traces?span=provision")
    return {"/metrics": (200, families),
            "/debug/traces": (code_t, [_span_tree(t)
                                       for t in traces["traces"]]),
            "/debug/pprof": _get(port, "/debug/pprof")}


@pytest.mark.parametrize("path", ["/metrics", "/debug/traces",
                                  "/debug/incidents", "/debug/incidents/x",
                                  "/debug/slo", "/debug/ledger",
                                  "/debug/pprof"])
def test_unported_endpoints_answer_501_naming_b9(path):
    """The endpoints that answered 501 until their features were ported
    answer as the reference's (the name keeps the case's history): B9a's
    after a provisioning tick, B9b's with their gates off (404, naming the
    flag that turns them on)."""
    if path in ("/metrics", "/debug/traces", "/debug/pprof"):
        code, body = both(lambda m: _served(m, _scrape)[path])
        if path == "/metrics":
            assert code == 200 and "karpenter_pods_state" in body \
                and "karpenter_trace_span_duration_seconds" in body
        elif path == "/debug/traces":
            assert code == 200 and body and body[0][0] == "provision"
        else:
            assert code == 403 and "--enable-profiling" in body["error"]
        return

    def case(m, op, mgr, port, clock):
        mgr.tick()
        return _get(port, path)
    code, body = both(lambda m: _served(m, case))
    assert code == 404 and "disabled" in body["error"]


def test_readiness_ladder_and_parity_probe():
    """startup() walks PROBING then LEADING (no leader, no restore): the
    arena's parity probe runs once the cluster has nodes; /readyz answers
    503 before and 200 after; stop() drains."""
    clock = [100.0]
    op, _, mgr = _manager(PORT, clock)
    port = mgr.serve_endpoints(metrics_port=0)
    try:
        code, before = _get(port, "/readyz")
        assert (code, before["phase"], before["ready"]) == \
            (503, "STARTING", False)
        op.cluster.add_pods([pod(PORT) for _ in range(4)])
        mgr.tick()
        clock[0] += 1.1
        mgr.tick()
        assert op.cluster.nodes
        assert mgr.startup() == "none"
        code, after = _get(port, "/readyz")
        assert code == 200 and after == {
            "ready": True, "phase": "LEADING", "role": "single",
            "restore": "none", "probe": "ok", "cloud": True,
            "fence_epoch": None}
        assert mgr.phase_transitions == {"LEADING": 2, "PROBING": 1}
    finally:
        mgr.stop()
    assert mgr.phase == "DRAINING"


def test_all_circuits_open_is_a_liveness_wedge():
    clock = [0.0]
    mgr = _fake_mgr(PORT, {"a": _Crashing(), "b": _Crashing()},
                    lambda: clock[0])
    for e in mgr._entries:
        e.interval = 0.0
    for _ in range(40):
        clock[0] += 400.0
        mgr.tick()
    report, live = mgr.liveness_report()
    assert not live and report["wedges"] == ["all_circuits_open"]


def _faulting(exc):
    def provision(*a, **kw):
        raise exc
    return provision


@pytest.mark.parametrize("exc", [KernelError("kernel launch failed"),
                                 ValueError("a solve's own fault")],
                         ids=["device-fault", "controller-fault"])
def test_kernel_fault_in_a_tick_propagates_and_books_nothing(exc):
    """A DEVICE_FAULTS exception inside the provisioning tick raises out of
    tick() and the supervisor books no failure (no fallback hides a kernel
    fault); any other fault is booked and contained, as in the
    reference."""
    clock = [100.0]
    op, ctrls, mgr = _manager(PORT, clock)
    ctrls["provisioning"].provision = _faulting(exc)
    op.cluster.add_pods([pod(PORT) for _ in range(2)])
    mgr.tick()
    clock[0] += 1.1
    sup = mgr.supervisors["provisioning"]
    if isinstance(exc, KernelError):
        with pytest.raises(KernelError, match="kernel launch failed"):
            mgr.tick()
        assert sup.total_failures == 0 and sup.failures == 0
        assert sup.state == "closed"
    else:
        mgr.tick()
        assert sup.total_failures == 1 and sup.last_error.startswith(
            "ValueError")


def test_kernel_fault_in_a_v1_solve_answers_500():
    def case(m, op, mgr, port, clock):
        mgr.controllers["provisioning"].solve = _faulting(
            KernelError("kernel launch failed"))
        return _post(port, "/v1/solve", _manifests("p", 2))
    code, body = _served(PORT, case)
    assert code == 500 and "kernel launch failed" in body["error"]


def test_state_lock_is_shared_and_reentrant():
    clock = [100.0]
    op, _, mgr = _manager(PORT, clock)
    assert mgr._state_lock is op.state_lock
    with op.state_lock:             # a /v1 handler's hold
        mgr.tick()                  # the tick re-enters on the same thread
    blocked = threading.Event()

    def tick_elsewhere():
        mgr.tick()
        blocked.set()

    with op.state_lock:
        t = threading.Thread(target=tick_elsewhere)
        t.start()
        assert not blocked.wait(0.3)   # another thread's tick waits
    t.join(timeout=30)
    assert blocked.is_set()
