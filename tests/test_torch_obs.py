"""The port's flight recorder, SLO engine and cost ledger
(karpenter_tpu_torch/obs/ and their call sites) against the JAX package's,
on the CPU:

- the FlightRecorder replays of chaos-storm and failover-drill: the
  reports equal byte for byte, and both packages give
  `workloads.GOLDEN_INCIDENTS`;
- the SLOEngine replays of spot-reclaim-storm (alone and with the
  FlightRecorder), each side from a reset metric registry: the reports
  equal with `tick_duration`'s `bad`, `budget_remaining`, `burn.*`,
  `alerts` and `alerting` compared by outcome (`workloads.slo_wall_free`:
  that SLI counts the reconciles longer than 1 s of wall time), and both
  packages give
  `workloads.GOLDEN_SLO`;
- every gated report, stripped of what the gates add, is its ungated
  golden in tests/golden/;
- the reference's SLO engine counts the registry's history from before it
  was armed, and the port's does the same;
- a gated snapshot's `incidents`, `slo` and `ledger` sections after a
  restore, and `/debug/incidents`, `/debug/incidents/<id>`, `/debug/slo`
  and `/debug/ledger` after a gated tick, equal the reference's;
- `trace_demo`'s incident index equals the reference's;
- `chip_smoke.py` phase 20's snapshot and kernel-fault checks, on the CPU;
- nothing in obs/ synchronizes the card or copies a tensor from it.
"""

import contextlib
import importlib
import io
import itertools
import json
import os
import re
import sys
from types import SimpleNamespace

import pytest
import torch

from torch_cases import clear_lp_caches
from torch_cases import one_torch_thread  # noqa: F401
from torch_ha import PORT as HA_PORT
from torch_ha import REF as HA_REF
from torch_ha import both as ha_both
from torch_ha import pod, stack

from karpenter_tpu_torch import workloads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = os.path.join(REPO, "scenarios")
GOLDEN = os.path.join(REPO, "tests", "golden")
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

MODULES = dict(sim="sim", metrics="utils.metrics", tracing="utils.tracing",
               obs="obs", ledger="obs.ledger", snapshot="state.snapshot",
               trace_demo="tools.trace_demo")


def _package(name, extra):
    return SimpleNamespace(name=name, extra=extra, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in MODULES.items()})


REF = _package("karpenter_tpu", {})
PORT = _package("karpenter_tpu_torch", {"device": "cpu"})
OF = {REF.name: REF, PORT.name: PORT}
HA = {HA_REF.name: HA_REF, HA_PORT.name: HA_PORT}


@pytest.fixture(autouse=True)
def _clean():
    """The bus, the ledger, the registry and the tracer are process
    globals: disarmed and emptied around each case, LP caches cleared."""
    def reset():
        for m in (REF, PORT):
            m.obs.BUS.disarm()
            m.obs.LEDGER.disarm()
            m.metrics.REGISTRY.reset()
            m.tracing.TRACER.reset()
            m.tracing._ids = itertools.count(1)
        clear_lp_caches("karpenter_tpu", "karpenter_tpu_torch")
    reset()
    yield
    reset()


def replay(m, name, **kw):
    return workloads.obs_replay(m.sim, m.metrics, SCENARIOS, name,
                                **kw, **m.extra).report


def golden_of(name):
    fname = workloads.OBS_REPLAYS[name][0]
    with open(os.path.join(GOLDEN, f"sim-{fname[:-5]}.json")) as fh:
        return fh.read()


# ---------------------------------------------------------------------------
# the gated replays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(workloads.GOLDEN_INCIDENTS))
def test_flight_recorder_replay_equals_the_reference(name):
    ref, port = replay(REF, name), replay(PORT, name)
    assert PORT.sim.report_to_json(port) == REF.sim.report_to_json(ref)
    assert workloads.obs_digest(ref) == workloads.obs_digest(port) \
        == workloads.GOLDEN_INCIDENTS[name]
    assert PORT.sim.report_to_json(workloads.without_obs(port)) \
        == golden_of(name)
    assert not PORT.obs.BUS.armed


@pytest.mark.parametrize("name", sorted(workloads.GOLDEN_SLO))
def test_slo_replay_equals_the_reference(name):
    ref, port = replay(REF, name), replay(PORT, name)
    assert workloads.slo_wall_free(port) == workloads.slo_wall_free(ref)
    assert workloads.obs_digest(ref) == workloads.obs_digest(port) \
        == workloads.GOLDEN_SLO[name]
    assert PORT.sim.report_to_json(workloads.without_obs(port)) \
        == golden_of(name)
    assert not PORT.obs.LEDGER.enabled and not PORT.obs.BUS.armed


def test_slo_engine_counts_the_registry_history_as_the_reference():
    """Two SLOEngine replays of a spot-reclaim-storm hour in one process
    without a registry reset between them: the second run's budgets count
    the first run's observations too, in both packages alike (ROADMAP.md
    §C: a reference behaviour the port reproduces on purpose)."""
    sc = "spot-reclaim-storm.yaml"

    def totals(m):
        m.metrics.REGISTRY.reset()
        out = []
        for _ in range(2):
            run = m.sim.SimHarness(
                m.sim.load_scenario(os.path.join(SCENARIOS, sc)), seed=0,
                duration_s=3600.0, slo=True, **m.extra).run()
            slos = run.report["slo"]["budgets"]["slos"]
            out.append({k: v["total"] for k, v in slos.items()})
        return out
    ref, port = totals(REF), totals(PORT)
    assert ref == port
    first, second = port
    assert first["bind_latency"] > 0
    assert second["bind_latency"] == 2 * first["bind_latency"]
    assert second["tick_duration"] > first["tick_duration"]


# ---------------------------------------------------------------------------
# the snapshot's sections and the endpoints
# ---------------------------------------------------------------------------

GATES = ("WarmRestart", "FlightRecorder", "SLOEngine")


def _slo_state(state):
    """An `slo` snapshot section with `tick_duration`'s wall-clock
    counters by outcome: 0 <= bad <= total, its bad tip no greater than
    its total tip, each last burn >= 0, alerts >= 0, alert_active a
    bool."""
    out = json.loads(json.dumps(state))
    b = out["budgets"][workloads.WALL_SLI]
    b["bad"] = 0.0 <= b["bad"] <= b["total"]
    b["last_bad_tip"] = 0.0 <= b["last_bad_tip"] <= b["last_total_tip"]
    b["last_burns"] = {w: v >= 0.0 for w, v in b["last_burns"].items()}
    b["alerts"] = b["alerts"] >= 0
    b["alert_active"] = isinstance(b["alert_active"], bool)
    return out


def test_gated_snapshot_sections_after_a_restore(tmp_path):
    """tests/test_slo.py's chaos-restart drill with both gates on: six pods
    provisioned, a minute on, a solver demotion; the snapshot's
    `incidents`, `slo` and `ledger` sections, and what a fresh operator
    restores from them, equal the reference's."""
    def case(m, d):
        x = OF[m.name]
        x.tracing._ids = itertools.count(1)
        clk = [1000.0]
        path = str(d / "snap.bin")
        op, mgr = stack(m, lambda: clk[0], path, GATES)
        op.cluster.add_pods([pod(m) for _ in range(6)])
        mgr.tick()
        clk[0] += 61.0
        mgr.tick()
        mgr.controllers["provisioning"].health.report_failure(
            "jax", reason="timeout")
        assert x.snapshot.write_snapshot(path, op, mgr)
        sections, status = x.snapshot.load_sections(path)
        assert status == "ok"
        written = {k: sections[k] for k in ("incidents", "ledger")}
        written["slo"] = _slo_state(sections["slo"])
        x.obs.LEDGER.disarm()               # kill -9: in-memory state gone
        x.obs.BUS.disarm()
        op2, mgr2 = stack(m, lambda: clk[0], path, GATES, cloud=op.raw_cloud)
        assert x.snapshot.restore_snapshot(path, op2, mgr2) == "restored"
        restored = {"incidents": mgr2.incidents_snapshot_state(),
                    "ledger": mgr2.ledger_snapshot_state(),
                    "slo": _slo_state(mgr2.slo_snapshot_state())}
        assert restored["ledger"] == written["ledger"]
        assert restored["incidents"]["restored"] == \
            written["incidents"]["bundles"]
        mgr2.stop()
        return written, restored
    written, _ = ha_both(case, tmp_path)
    assert [b["kind"] for b in written["incidents"]["bundles"]] == \
        ["solver_demotion"]
    assert written["ledger"]["entries_opened"] >= 1


def _served_gated(m):
    """A gated operator served on a free port: six pods provisioned, a
    solver demotion tripped; the four endpoints' answers (the bundle without
    its wall-clock payloads: trace timings and metric deltas)."""
    from urllib.error import HTTPError
    from urllib.request import urlopen

    def get(port, path):
        try:
            with urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
                return r.status, json.loads(r.read())
        except HTTPError as e:
            return e.code, json.loads(e.read())
    OF[m.name].tracing._ids = itertools.count(1)
    clk = [1000.0]
    op, mgr = stack(HA[m.name], lambda: clk[0], "", GATES[1:])
    port = mgr.serve_endpoints(metrics_port=0)
    try:
        op.cluster.add_pods([pod(HA[m.name]) for _ in range(6)])
        mgr.tick()
        clk[0] += 1.1
        mgr.tick()
        mgr.controllers["provisioning"].health.report_failure(
            "jax", reason="timeout")
        out = {p: get(port, p) for p in ("/debug/incidents", "/debug/slo",
                                         "/debug/ledger")}
        bid = out["/debug/incidents"][1]["bundles"][-1]["id"]
        code, bundle = get(port, f"/debug/incidents/{bid}")
        out["/debug/incidents/<id>"] = (code, {
            k: v for k, v in bundle.items() if k not in ("traces", "metrics")},
            sorted(bundle["metrics"]["changed"]), len(bundle["traces"]))
        out["missing"] = get(port, "/debug/incidents/nope")[0]
        code, slo = out["/debug/slo"]
        out["/debug/slo"] = (code, workloads.slo_wall_free(
            {"slo": {"budgets": slo}})["slo"]["budgets"])
        return out
    finally:
        mgr.stop()


def test_debug_endpoints_after_one_gated_tick():
    ref, port = _served_gated(REF), _served_gated(PORT)
    assert port == ref
    code, index = port["/debug/incidents"]
    assert code == 200 and index["by_kind"] == {"solver_demotion": 1}
    assert port["/debug/incidents/<id>"][1]["kind"] == "solver_demotion"
    assert port["missing"] == 404
    assert port["/debug/slo"][0] == port["/debug/ledger"][0] == 200
    assert port["/debug/ledger"][1]["entries_opened"] >= 1


def _demo_lines(m, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = m.trace_demo.main(*argv)
    text = out.getvalue()
    index = text[text.index("# /debug/incidents —"):]
    return rc, [ln for ln in index.splitlines()
                if ln.startswith(("# /debug/incidents", "  kind:",
                                  "  window:", "  traces captured:"))]


def test_trace_demo_incident_index_equals_the_reference():
    ref = _demo_lines(REF, ())
    port = _demo_lines(PORT, (["--device", "cpu"],))
    assert port == ref
    assert port[0] == 0
    assert "by kind {'solver_demotion': 1}" in port[1][0]


# ---------------------------------------------------------------------------
# chip_smoke.py phase 20 on the CPU, and the card left alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("check", ["obs_restart", "incident_fault"])
def test_phase20_checks_on_the_cpu(check):
    getattr(chip_smoke, check)(torch, "cpu", device="cpu")
    assert not PORT.obs.BUS.armed and not PORT.obs.LEDGER.enabled


def test_obs_never_touches_the_card():
    """The recorder's ring and the SLO engine read the host registry: no
    module of obs/ imports torch, synchronizes or copies from the card."""
    root = os.path.dirname(PORT.obs.__file__)
    names = sorted(f for f in os.listdir(root) if f.endswith(".py"))
    assert names == ["__init__.py", "bundle.py", "incidents.py", "ledger.py",
                     "recorder.py", "ring.py", "slo.py"]
    banned = re.compile(r"\.item\(\)|\.cpu\(\)|synchronize\(|import torch"
                        r"|from torch")
    for fname in names:
        with open(os.path.join(root, fname)) as fh:
            assert not banned.search(fh.read()), fname
