"""The port's simulator (karpenter_tpu_torch/sim/) against the JAX
package's, case by case with tests/test_sim.py's cases that need no SLO
block: the clock and heap primitives, the scenario DSL (with its
`forecast:`, `chaos:`, `ha:` and `gang:` blocks), the clock-scheduled
interruption pipeline, determinism (the same seed gives a byte-identical log and
report), the harness's cases, and the CLI.  Each case runs on both packages
and returns plain observations that must be equal; the port's controllers
solve on the CPU.

Then the canned goldens of tests/golden/ that carry no gated section but
`forecast`, `chaos` and `gang` — diurnal, spot-reclaim-storm,
ice-starvation, steady-state-drip, long-soak, chaos-storm, diurnal-forecast,
spot-reclaim-storm-forecast, gang-churn-storm and mixed-priority-diurnal
at tests/test_sim.py's horizons — replayed by the port on the CPU byte for
byte, with the arena gate off for drip, soak, chaos-storm and the four
forecast and gang scenarios, the IngestBatch gate on for drip, and the
goldens recorded before gang scheduling replayed with the GangScheduling
(and, where the scenario has no forecast block, the Forecast) gate
explicitly off; and the port's own boundaries: no `time.sleep` in its
sim/, and the scenario blocks, harness overrides and CLI flags once refused
(the `ha:` block and the `warm_restart` / `ha_failover` overrides until B7
was ported, the `slo:` block, the `flight_recorder` / `slo` overrides and
`--flight-recorder` / `--slo` until B9) run as the reference's, their
reports compared with `workloads.slo_wall_free`
(tests/test_torch_failover.py replays the failover-drill golden,
tests/test_torch_obs.py the gated replays).
"""

import dataclasses
import importlib
import json
import os
from types import SimpleNamespace

import pytest

from torch_cases import clear_lp_caches as clear_package_caches
from torch_cases import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = os.path.join(REPO, "scenarios")
GOLDEN = os.path.join(REPO, "tests", "golden")


def _package(name, extra):
    sim = importlib.import_module(f"{name}.sim")
    return SimpleNamespace(
        name=name, extra=extra, sim=sim,
        ev=importlib.import_module(f"{name}.sim.events"),
        scenario=importlib.import_module(f"{name}.sim.scenario"),
        cli=importlib.import_module(f"{name}.sim.__main__"),
        fake=importlib.import_module(f"{name}.cloud.fake"),
        queue=importlib.import_module(f"{name}.cloud.queue"),
        chaos=importlib.import_module(f"{name}.utils.chaos"),
        metrics=importlib.import_module(f"{name}.utils.metrics"),
        obs=importlib.import_module(f"{name}.obs"))


REF = _package("karpenter_tpu", {})
PORT = _package("karpenter_tpu_torch", {"device": "cpu"})


@pytest.fixture(autouse=True)
def _clean_lp_caches():
    clear_package_caches("karpenter_tpu", "karpenter_tpu_torch")
    yield
    REF.chaos.CHAOS.reset()
    PORT.chaos.CHAOS.reset()
    clear_package_caches("karpenter_tpu", "karpenter_tpu_torch")


def both(case):
    ref, port = case(REF), case(PORT)
    assert ref == port
    return port


def harness(m, sc, **kw):
    return m.sim.SimHarness(sc, **kw, **m.extra)


def small_scenario(m, **kw):
    """tests/test_sim.py's `small_scenario`."""
    defaults = dict(
        name="small", duration_s=1800.0, settle_s=300.0, catalog_size=10,
        workload=[m.scenario.Wave(kind="step", name="svc", at_s=60.0,
                                  count=8, duration_s=0.0, cpu_m=(250, 1000),
                                  mem_mib=(256, 1024))])
    defaults.update(kw)
    return m.sim.Scenario(**defaults)


# ---------------------------------------------------------------------------
# clock + heap primitives
# ---------------------------------------------------------------------------

def test_virtual_clock_advances_reads_and_refuses_rewind():
    def case(m):
        c = m.sim.VirtualClock(100.0)
        out = [c(), c.now()]
        c.advance(5.0)
        c.advance_to(110.0)
        out.append(c.now())
        with pytest.raises(ValueError):
            c.advance_to(109.0)
        return out
    assert both(case) == [100.0, 100.0, 110.0]


def test_event_heap_orders_by_time_then_insertion():
    def case(m):
        h = m.sim.EventHeap()
        h.push(5.0, "late")
        h.push(1.0, "a")
        h.push(1.0, "b")        # same instant: insertion order preserved
        out = [h.peek_time(), [e for _, e in h.pop_due(1.0)], len(h),
               bool(h), h.pop_due(10.0), bool(h), h.peek_time()]
        return out
    assert both(case) == [1.0, ["a", "b"], 1, True, [(5.0, "late")], False,
                          None]


# ---------------------------------------------------------------------------
# scenario DSL
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("doc,match", [
    ({"name": "x", "durations": 1,
      "workload": [{"kind": "step", "name": "w"}]}, "unknown scenario field"),
    ({"name": "x", "workload": [{"kind": "sawtooth", "name": "w"}]},
     "unknown kind"),
    ({"name": "x", "workload": []}, "no workload"),
    ({"name": "x", "workload": [{"kind": "step", "name": "w",
                                 "colour": 1}]}, "unknown field"),
    ({"name": "x", "workload": [{"kind": "step", "name": "w",
                                 "cpu_m": [5]}]}, "expected"),
    ({"name": "x", "batch_idle_s": 5, "batch_max_s": 1,
      "workload": [{"kind": "step", "name": "w"}]}, "batch windows"),
    ({"name": "x", "intervals": {"nope": 1},
      "workload": [{"kind": "step", "name": "w"}]}, "unknown controller"),
    ({"name": "x", "workload": [{"kind": "step", "name": "w"}],
      "faults": [{"kind": "ice_window", "at_s": 5}]}, "needs pools"),
    ({"name": "x", "workload": [{"kind": "step", "name": "w"},
                                {"kind": "step", "name": "w"}]},
     "duplicate wave names"),
])
def test_scenario_validation_errors(doc, match):
    def case(m):
        with pytest.raises(m.scenario.ScenarioError, match=match) as e:
            m.scenario.scenario_from_dict(doc)
        return str(e.value)
    both(case)


@pytest.mark.parametrize("fname", ["diurnal.yaml", "spot-reclaim-storm.yaml",
                                   "ice-starvation.yaml",
                                   "steady-state-drip.yaml", "long-soak.yaml",
                                   "diurnal-forecast.yaml",
                                   "spot-reclaim-storm-forecast.yaml",
                                   "gang-churn-storm.yaml",
                                   "mixed-priority-diurnal.yaml"])
def test_canned_scenarios_load_and_expand(fname):
    def case(m):
        # the first two virtual hours (long-soak's day is 690k pods)
        sc = dataclasses.replace(
            m.sim.load_scenario(os.path.join(SCENARIOS, fname)),
            duration_s=7200.0)
        stream = m.sim.expand(sc, seed=0)[:4000]
        assert stream
        assert all(stream[i][0] <= stream[i + 1][0]
                   for i in range(len(stream) - 1))
        return [(at, json.dumps(e.to_log(), sort_keys=True),
                 [(p.name, sorted(p.requests.items()), sorted(p.labels.items()))
                  for p in getattr(e, "pods", [])]) for at, e in stream]
    both(case)


def test_expansion_deterministic_and_seed_sensitive():
    def case(m):
        sc = m.sim.load_scenario(os.path.join(SCENARIOS, "diurnal.yaml"))

        def fingerprint(seed):
            return [(round(at, 9), tuple((p.name, p.requests.get("cpu", 0))
                                         for p in e.pods))
                    for at, e in m.sim.expand(sc, seed)
                    if isinstance(e, m.ev.PodArrival)]
        assert fingerprint(0) == fingerprint(0)
        assert fingerprint(0) != fingerprint(1)
        return fingerprint(3)
    both(case)


def test_adding_a_wave_never_perturbs_siblings():
    def case(m):
        def svc(sc):
            return [(at, tuple(p.name for p in e.pods))
                    for at, e in m.sim.expand(sc, 7)
                    if isinstance(e, m.ev.PodArrival) and e.wave == "svc"]
        sc2 = small_scenario(m)
        sc2.workload.append(m.scenario.Wave(
            kind="batch", name="extra", at_s=100.0, count=3, cohorts=2,
            every_s=600.0, runtime_s=300.0))
        base = svc(small_scenario(m))
        assert base == svc(sc2)
        return base
    both(case)


def test_gang_wave_fields_fold_cohorts_into_gangs():
    """A wave's gang fields expand alike: cohorts fold into gangs of
    `gang_size`, the remainder stays loose."""
    def case(m):
        sc = small_scenario(m, workload=[m.scenario.Wave(
            kind="step", name="g", at_s=10.0, count=7, gang_size=3,
            gang_tier=1)])
        return [(p.name, p.gang_name, p.gang_size, p.gang_tier)
                for _, e in m.sim.expand(sc, 1)
                if isinstance(e, m.ev.PodArrival) for p in e.pods]
    assert sum(1 for _, g, _, _ in both(case) if g) == 6


# ---------------------------------------------------------------------------
# clock-scheduled interruption delivery (the fake cloud's half)
# ---------------------------------------------------------------------------

def _cloud_with_instance(m, start=1000.0):
    """tests/test_sim.py's `_cloud_with_instance`."""
    clock = m.sim.VirtualClock(start)
    cloud = m.fake.FakeCloud(clock=clock, queue=m.queue.FakeQueue(clock=clock))
    with cloud._lock:
        cloud._instances["i-1"] = m.fake.CloudInstance(
            id="i-1", instance_type="t.small", zone="z-a",
            capacity_type="spot", price=0.1, launched_at=start)
    return clock, cloud


@pytest.mark.parametrize("drain,lead", [(False, 300.0), (True, 300.0),
                                        (False, 30.0)],
                         ids=["forced", "honored", "short-notice"])
def test_warning_then_reclaim_on_the_virtual_clock(drain, lead):
    """tests/test_sim.py's TestScheduledInterruption: the warning fires
    120 s ahead (at once for a short notice), the reclaim at the deadline,
    honored when the controllers drained the instance first."""
    def case(m):
        clock, cloud = _cloud_with_instance(m)
        cloud.interrupt("i-1", at=clock.now() + lead, warning_s=120.0)
        out = [cloud.next_due(), [sorted(r.items())
                                  for r in cloud.deliver_due()],
               len(cloud.queue)]
        clock.advance_to(1180.0)
        out.append([sorted(r.items()) for r in cloud.deliver_due()])
        out += [len(cloud.queue), cloud._instances["i-1"].state]
        if drain:
            cloud.terminate_instances(["i-1"])
        clock.advance_to(1300.0)
        out.append([sorted(r.items()) for r in cloud.deliver_due()])
        out += [cloud.next_due(), cloud._instances["i-1"].state]
        return out
    out = both(case)
    if lead == 300.0:
        assert out[0] == pytest.approx(1180.0)
        assert [dict(r)["action"] for r in out[3]] == ["spot_warning"]
        assert [dict(r)["honored"] for r in out[6]] == [drain]
    else:
        assert [dict(r)["action"] for r in out[1]] == ["spot_warning"]


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------

def test_same_seed_byte_identical_log_and_report():
    def case(m):
        runs = [harness(m, small_scenario(m), seed=3).run() for _ in range(2)]
        logs = [json.dumps(r.log, sort_keys=True) for r in runs]
        reports = [m.sim.report_to_json(r.report) for r in runs]
        assert logs[0] == logs[1]
        assert reports[0] == reports[1]
        return logs[0], reports[0]
    both(case)


def test_step_wave_binds_everything():
    def case(m):
        run = harness(m, small_scenario(m), seed=0).run()
        w = run.report["workload"]
        assert (w["pods_arrived"], w["pods_bound"],
                w["pods_pending_at_end"]) == (8, 8, 0)
        assert run.report["errors"]["tick_exceptions"] == 0
        assert run.report["cost"]["dollar_hours"] > 0
        return m.sim.report_to_json(run.report), run.events_delivered
    both(case)


def test_spot_reclaim_storm_flows_through_interruption_controller():
    def case(m):
        sc = small_scenario(m, duration_s=3600.0, faults=[m.scenario.Fault(
            kind="spot_reclaim_storm", at_s=1200.0, count=2,
            warning_s=120.0, repeat=1)])
        run = harness(m, sc, seed=0).run()
        spot = run.report["spot"]
        assert (spot["warnings"], spot["reclaims"],
                spot["reclaims_honored"]) == (2, 2, 2)
        assert run.report["churn"]["interruption_recycled"] == 2
        return m.sim.report_to_json(run.report)
    both(case)


def test_node_ready_latency_delays_binds():
    def case(m):
        fast = harness(m, small_scenario(m), seed=0).run()
        slow = harness(m, small_scenario(m, node_ready_latency_s=90.0),
                       seed=0).run()
        assert slow.report["time_to_bind_s"]["p50"] >= \
            fast.report["time_to_bind_s"]["p50"] + 60.0
        return m.sim.report_to_json(slow.report)
    both(case)


def test_ice_throttle_and_price_drift_faults():
    """The fault kinds the canned goldens do not all carry: an ICE window
    on wildcard pools, an API throttle burst and a jittered price drift."""
    def case(m):
        F = m.scenario.Fault
        sc = small_scenario(m, duration_s=2400.0, faults=[
            F(kind="ice_window", at_s=30.0, duration_s=300.0,
              pools=[("spot", "*", "zone-a")]),
            F(kind="api_throttle", at_s=500.0, duration_s=60.0),
            F(kind="price_drift", at_s=900.0, factor=1.3, jitter=0.1),
            F(kind="node_ready_latency", at_s=0.0, latency_s=30.0)])
        run = harness(m, sc, seed=2).run()
        return m.sim.report_to_json(run.report), json.dumps(run.log)
    both(case)


def test_harness_gate_off_detaches_arena():
    """tests/test_arena_delta.py's case: the harness's IncrementalArena
    override decides whether the cluster carries an arena."""
    def case(m):
        sc = m.sim.Scenario(
            name="gate", duration_s=600.0, settle_s=60.0, catalog_size=4,
            workload=[m.scenario.Wave(kind="step", name="svc", at_s=30.0,
                                      count=2, duration_s=0.0,
                                      cpu_m=(250, 500), mem_mib=(256, 512))])
        return [type(harness(m, sc, seed=0, **kw).cluster.arena).__name__
                for kw in ({"incremental_arena": False}, {},
                           {"incremental_arena": True},
                           {"ingest_batch": True})]
    assert both(case) == ["NoneType", "ClusterArena", "ClusterArena",
                          "IngestBatcher"]


def test_cli_writes_report_and_log(tmp_path):
    spec = tmp_path / "tiny.yaml"
    spec.write_text(
        "name: tiny\nduration_s: 900\nsettle_s: 120\ncatalog_size: 8\n"
        "workload:\n  - kind: step\n    name: w\n    at_s: 30\n"
        "    count: 4\n    duration_s: 0\n")

    def case(m):
        out = tmp_path / f"{m.name}.json"
        logf = tmp_path / f"{m.name}.jsonl"
        rc = m.cli.main([str(spec), "--seed", "1", "--out", str(out),
                         "--log", str(logf)], **m.extra)
        assert rc == 0
        report = json.loads(out.read_text())
        assert report["scenario"] == "tiny" and report["seed"] == 1
        return rc, out.read_text(), logf.read_text()
    both(case)


def test_cli_rejects_bad_scenario(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("name: bad\nworkload: []\n")
    assert both(lambda m: m.cli.main([str(bad)], **m.extra)) == 2


def test_no_wall_sleeps_in_the_sim_path():
    import karpenter_tpu_torch.sim as sim_pkg
    root = os.path.dirname(sim_pkg.__file__)
    names = sorted(f for f in os.listdir(root) if f.endswith(".py"))
    assert len(names) == 7
    for fname in names:
        with open(os.path.join(root, fname)) as fh:
            assert "time.sleep" not in fh.read(), fname


# ---------------------------------------------------------------------------
# refusals of unported features
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block,item", [("ha", "B7"), ("slo", "B9")])
def test_scenario_blocks_of_unported_features_are_refused(block, item):
    """The `ha:` block (refused until B7 was ported) and the `slo:` block
    (refused until B9) give the reference's scenario, and the port refuses
    the reference's bad blocks with its messages."""
    from karpenter_tpu_torch.sim.scenario import scenario_from_dict
    doc = {"name": "x", "workload": [{"kind": "step", "name": "w"}]}
    good, bads = {
        "ha": ({"enabled": True, "ttl_s": 7},
               (({"ttl_s": 0}, "ttl_s must be positive"),
                ({"lease": 1}, "unknown field"),
                ("x", "must be a mapping"))),
        "slo": ({"enabled": True, "eval_cadence_s": 30,
                 "drift_threshold": 0.2},
                (({"eval_cadence_s": 0}, "eval_cadence_s must be positive"),
                 ({"drift_threshold": -1}, "drift_threshold must be positive"),
                 ({"cadence": 5}, "unknown field"),
                 ("x", "must be a mapping")))}[block]
    got = both(lambda m: _port_fields(m.scenario.scenario_from_dict(
        dict(doc, **{block: good}))))
    assert got[block] == {k: float(v) if k != "enabled" else v
                          for k, v in good.items()}
    assert both(lambda m: _port_fields(m.scenario.scenario_from_dict(
        dict(doc, **{block: {}}))))[block] is not None
    for bad, match in bads:
        with pytest.raises(PORT.scenario.ScenarioError, match=match):
            scenario_from_dict(dict(doc, **{block: bad}))
        with pytest.raises(REF.scenario.ScenarioError, match=match):
            REF.scenario.scenario_from_dict(dict(doc, **{block: bad}))


@pytest.mark.parametrize("block", [
    {"forecast": {"enabled": True}},
    {"forecast": {"model": "ewma", "horizon_s": 300, "lead_s": 60,
                  "ttl_s": 120, "bucket_s": 30, "confidence": 1.0,
                  "max_cost_frac": 0.5, "season_s": 3600}},
    {"forecast": {"enabled": False}},
    {"gang": {"enabled": True}},
    {"gang": {}},
    {"forecast": {"model": "holtwinters"}, "gang": {"enabled": False}},
], ids=["forecast-on", "forecast-knobs", "forecast-off", "gang-on",
        "gang-empty", "both"])
def test_scenario_forecast_and_gang_blocks_parse_as_the_reference(block):
    """The `forecast:` and `gang:` blocks the port used to refuse: the same
    document gives the reference's scenario."""
    doc = {"name": "x", "workload": [{"kind": "step", "name": "w"}], **block}
    got = both(lambda m: _port_fields(m.scenario.scenario_from_dict(doc)))
    assert all(got[k] is not None for k in block)


@pytest.mark.parametrize("block,match", [
    ({"forecast": {"colour": 1}}, "unknown field"),
    ({"forecast": "x"}, "must be a mapping"),
    ({"forecast": {"ttl_s": 0}}, "ttl_s must be positive"),
    ({"forecast": {"bucket_s": -1}}, "bucket_s must be positive"),
    ({"forecast": {"max_cost_frac": 1.5}}, "max_cost_frac"),
    ({"forecast": {"model": "arima"}}, "unknown model"),
    ({"gang": {"size": 4}}, "unknown field"),
    ({"gang": "x"}, "must be a mapping"),
], ids=["forecast-field", "forecast-type", "ttl", "bucket", "cost", "model",
        "gang-field", "gang-type"])
def test_scenario_forecast_and_gang_block_errors_match_the_reference(
        block, match):
    doc = {"name": "x", "workload": [{"kind": "step", "name": "w"}], **block}

    def case(m):
        with pytest.raises(m.scenario.ScenarioError, match=match) as ei:
            m.scenario.scenario_from_dict(doc)
        return str(ei.value)
    both(case)


def test_scenario_chaos_block_parses_as_the_reference():
    """The `chaos:` block the port used to refuse: the same document gives
    the reference's scenario, rules and seed included."""
    doc = {"name": "x", "workload": [{"kind": "step", "name": "w"}],
           "chaos": {"enabled": True, "seed": 4, "rules": [
               {"point": "cloud.api", "key": "create_fleet", "rate": 0.8,
                "error_code": "RequestLimitExceeded", "at_s": 10,
                "until_s": 40},
               {"point": "solver.pack", "key": "jax", "count": 3}]}}
    got = both(lambda m: _port_fields(m.scenario.scenario_from_dict(doc)))
    assert got["chaos"]["seed"] == 4 and len(got["chaos"]["rules"]) == 2


@pytest.mark.parametrize("chaos,match", [
    ({"rules": []}, "at least one rule"),
    ({"rules": [{"point": "nope"}]}, "unknown point"),
    ({"rules": [{"point": "cloud.api", "action": "explode"}]},
     "unknown action"),
    ({"rules": [{"point": "cloud.api", "rate": 1.5}]}, "rate"),
    ({"rules": [{"point": "cloud.api", "at_s": -1}]}, "at_s"),
    ({"rules": [{"point": "cloud.api", "at_s": 5, "until_s": 5}]},
     "until_s"),
    ({"rules": [{"point": "cloud.api", "action": "hang"}]}, "latency_s"),
    ({"rules": [{"point": "cloud.api", "count": -1}]}, "count"),
    ({"rules": [{"point": "cloud.api", "colour": 1}]}, "unknown field"),
    ({"rules": [], "bogus": 1}, "unknown field"),
    ({"rules": ["x"]}, "must be a mapping"),
    ("x", "must be a mapping"),
], ids=["no-rules", "point", "action", "rate", "at", "until", "latency",
        "count", "rule-field", "field", "rule-type", "type"])
def test_scenario_chaos_block_errors_match_the_reference(chaos, match):
    doc = {"name": "x", "workload": [{"kind": "step", "name": "w"}],
           "chaos": chaos}

    def case(m):
        with pytest.raises(m.scenario.ScenarioError, match=match) as ei:
            m.scenario.scenario_from_dict(doc)
        return str(ei.value)
    both(case)


def _port_fields(sc):
    """A Scenario as a dict of the fields the port's dataclass has."""
    d = dataclasses.asdict(sc)
    return {f.name: d[f.name] for f in dataclasses.fields(PORT.sim.Scenario)}


def test_canned_chaos_storm_loads_as_the_reference():
    got = both(lambda m: _port_fields(m.sim.load_scenario(
        os.path.join(SCENARIOS, "chaos-storm.yaml"))))
    assert len(got["chaos"]["rules"]) == 3


@pytest.mark.parametrize("fname", [
    "diurnal-forecast.yaml", "spot-reclaim-storm-forecast.yaml",
    "gang-churn-storm.yaml", "mixed-priority-diurnal.yaml"])
def test_canned_forecast_and_gang_scenarios_load_as_the_reference(fname):
    got = both(lambda m: _port_fields(m.sim.load_scenario(
        os.path.join(SCENARIOS, fname))))
    assert got["forecast"] is not None or got["gang"] is not None


@pytest.mark.parametrize("fname,item", [("failover-drill.yaml", "B7")])
def test_canned_scenarios_of_unported_features_are_refused(fname, item):
    """failover-drill (its `ha:` and `chaos:` blocks), refused until B7 was
    ported, loads as the reference's scenario."""
    got = both(lambda m: _port_fields(m.sim.load_scenario(
        os.path.join(SCENARIOS, fname))))
    assert got["ha"] == {"enabled": True, "ttl_s": 30.0}
    assert len(got["chaos"]["rules"]) == 2


@pytest.mark.parametrize("override,item", [
    ("warm_restart", "B7"), ("ha_failover", "B7"),
    ("flight_recorder", "B9"), ("slo", "B9")])
def test_harness_overrides_of_unported_gates_are_refused(override, item):
    """The overrides refused until their features were ported (B7's, then
    B9's) run the replay as the reference's do: the report of the small
    scenario equal to the reference's (`tick_duration`'s wall-clock fields
    by outcome), with an `ha` section under `ha_failover`, `incidents`
    under `flight_recorder`, `slo.budgets` and `ledger` under `slo`."""
    from karpenter_tpu_torch.workloads import slo_wall_free

    def case(m):
        m.metrics.REGISTRY.reset()
        run = harness(m, small_scenario(m), **{override: True}).run()
        return slo_wall_free(json.loads(m.sim.report_to_json(run.report)))
    report = both(case)
    assert ("ha" in report) == (override == "ha_failover")
    assert ("incidents" in report) == (override == "flight_recorder")
    assert ("ledger" in report) == ("budgets" in report["slo"]) \
        == (override == "slo")
    assert not PORT.obs.BUS.armed and not PORT.obs.LEDGER.enabled


def test_cli_flags_of_unported_features_are_refused(tmp_path):
    """`--flight-recorder` and `--slo`, refused until B9 was ported, write
    the reference's gated report (`tick_duration`'s wall-clock fields by
    outcome)."""
    from karpenter_tpu_torch.workloads import slo_wall_free
    spec = tmp_path / "tiny.yaml"
    spec.write_text("name: tiny\nduration_s: 60\nworkload:\n"
                    "  - kind: step\n    name: w\n")
    for flag, section in (("--flight-recorder", "incidents"),
                          ("--slo", "ledger")):
        def case(m):
            m.metrics.REGISTRY.reset()
            out = tmp_path / f"{m.name}{flag}.json"
            assert m.cli.main([str(spec), flag, "--out", str(out)],
                              **m.extra) == 0
            return slo_wall_free(json.loads(out.read_text()))
        assert section in both(case)


def test_default_device_needs_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(Exception, match="(?i)cuda|card|device"):
        PORT.sim.SimHarness(small_scenario(PORT))


# ---------------------------------------------------------------------------
# the canned goldens, replayed by the port on the CPU
# ---------------------------------------------------------------------------

# tests/test_sim.py's GOLDEN_CASES without a gated section but forecast,
# chaos and gang (all but failover-drill)
GOLDEN_CASES = [
    ("diurnal", "diurnal.yaml", 7200.0),
    ("spot-reclaim-storm", "spot-reclaim-storm.yaml", 7200.0),
    ("ice-starvation", "ice-starvation.yaml", 5400.0),
    ("steady-state-drip", "steady-state-drip.yaml", 300.0),
    ("long-soak", "long-soak.yaml", 120.0),
    ("chaos-storm", "chaos-storm.yaml", 5400.0),
    ("diurnal-forecast", "diurnal-forecast.yaml", 7200.0),
    ("spot-reclaim-storm-forecast", "spot-reclaim-storm-forecast.yaml",
     7200.0),
    ("gang-churn-storm", "gang-churn-storm.yaml", 7200.0),
    ("mixed-priority-diurnal", "mixed-priority-diurnal.yaml", 12600.0),
]
# the scenarios recorded before the GangScheduling gate existed, and those
# of them without a forecast block
PRE_GANG_CASES = GOLDEN_CASES[:8]
NO_FORECAST_CASES = GOLDEN_CASES[:6]


def _golden(name):
    with open(os.path.join(GOLDEN, f"sim-{name}.json")) as fh:
        return fh.read()


def _replay(name, fname, duration, **kw):
    sc = PORT.sim.load_scenario(os.path.join(SCENARIOS, fname))
    run = harness(PORT, sc, seed=0, duration_s=duration, **kw).run()
    # none but chaos-storm's injected faults (9 provisioning failures, its
    # golden's count) reach a supervisor
    assert run.report["errors"]["tick_exceptions"] == \
        (9 if name == "chaos-storm" else 0)
    assert not PORT.chaos.CHAOS.enabled        # disarmed after the run
    return PORT.sim.report_to_json(run.report)


@pytest.mark.parametrize("name,fname,duration", GOLDEN_CASES,
                         ids=[c[0] for c in GOLDEN_CASES])
def test_golden_report(name, fname, duration):
    assert _replay(name, fname, duration) == _golden(name)


@pytest.mark.parametrize("name,fname,duration", GOLDEN_CASES[3:],
                         ids=[c[0] for c in GOLDEN_CASES[3:]])
def test_golden_report_arena_gate_off(name, fname, duration):
    """The IncrementalArena gate is a pure optimization on the port too:
    with it off, drip, soak, chaos-storm and the forecast and gang
    scenarios reproduce their goldens."""
    assert _replay(name, fname, duration, incremental_arena=False) == \
        _golden(name)


@pytest.mark.parametrize("name,fname,duration", PRE_GANG_CASES,
                         ids=[c[0] for c in PRE_GANG_CASES])
def test_golden_report_gang_gate_off(name, fname, duration):
    """tests/test_sim.py's gate-off identity: the GangScheduling gate
    explicitly off leaves every pre-gang golden as it is, and so does the
    Forecast gate explicitly off where the scenario has no forecast
    block."""
    kw = dict(gang=False)
    if (name, fname, duration) in NO_FORECAST_CASES:
        kw["forecast"] = False
    assert _replay(name, fname, duration, **kw) == _golden(name)


def test_forecast_override_off_drops_the_section():
    """`forecast=False` on a forecast scenario replays it without the
    gate: no forecast section, and the reference's report."""
    name, fname, duration = GOLDEN_CASES[6]

    def case(m):
        sc = m.sim.load_scenario(os.path.join(SCENARIOS, fname))
        run = harness(m, sc, seed=0, duration_s=duration,
                      forecast=False).run()
        assert "forecast" not in run.report
        return m.sim.report_to_json(run.report)
    assert both(case) != _golden(name)


def test_golden_report_ingest_batch_gate_on():
    name, fname, duration = GOLDEN_CASES[3]
    assert _replay(name, fname, duration, ingest_batch=True) == _golden(name)


@pytest.mark.parametrize("name", ["diurnal", "spot-reclaim-storm"])
def test_golden_report_device_decode_gate_on(name):
    """tests/test_sim.py:379's gate-on replays: the slab decode's plans are
    bit-identical, so the goldens hold."""
    nm, fname, duration = next(c for c in GOLDEN_CASES if c[0] == name)
    assert _replay(nm, fname, duration, device_decode=True) == _golden(nm)
