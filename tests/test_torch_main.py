"""The port's command line and process entry point against the JAX
package's: `Options.from_args` gives the reference's options on every flag
the port keeps, from flags and from the env defaults (the flags once
refused, naming their ROADMAP.md items, included), and argparse refuses
the flags the JAX package parses and never reads; and `python -m
karpenter_tpu_torch` (`__main__.main`, on the CPU through its `device`
keyword) reaches readiness, serves its endpoints and exits 0 on SIGTERM —
also as an elected, fenced replica with a warm restart (`--ha-failover
--warm-restart`), whose SIGTERM writes its final snapshot and releases its
lease, and whose successor restores that snapshot.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from karpenter_tpu.operator.options import Options as RefOptions
from karpenter_tpu_torch.operator.options import Options

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kept(opts):
    """The reference's options restricted to the port's fields."""
    ref = dataclasses.asdict(opts)
    return {f.name: ref[f.name] for f in dataclasses.fields(Options)}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("KARPENTER_TPU_"):
            monkeypatch.delenv(k)


@pytest.mark.parametrize("argv", [
    [],
    ["--cluster-name", "prod", "--interruption-queue", "q",
     "--feature-gates", "Drift=false,SpotToSpot=true"],
    ["--cluster-endpoint", "https://x", "--cluster-dns", "10.0.0.10",
     "--isolated-network"],
    ["--batch-idle-duration", "2.5", "--batch-max-duration", "20",
     "--metrics-port", "0"],
    ["--supervisor-circuit-threshold", "3", "--supervisor-backoff-base",
     "0.5", "--supervisor-backoff-max", "60", "--reconcile-soft-deadline",
     "0"],
    ["--solve-timeout", "2", "--cloud-retry-attempts", "2",
     "--cloud-retry-base", "0.1", "--cloud-breaker-threshold", "4",
     "--cloud-breaker-cooldown", "5"],
    ["--lp-refinery", "--incremental-arena", "--sharded-solve",
     "--device-decode", "--device-lp", "--ingest-batch",
     "--ingest-max-events", "77"],
    ["--feature-gates", "IncrementalArena=false,LPGuide=false"],
    ["--log-format", "text", "--trace-slow-ms", "0", "--chaos-seed", "0"],
], ids=["defaults", "flags", "cluster", "window-ports", "supervision",
        "hardening", "gates", "gates-off", "refused-at-default"])
def test_from_args_equals_the_reference(argv):
    assert dataclasses.asdict(Options.from_args(argv)) == \
        kept(RefOptions.from_args(argv))


def test_env_defaults_equal_the_reference(monkeypatch):
    env = {"CLUSTER_NAME": "from-env", "BATCH_IDLE_DURATION": "2.5",
           "ISOLATED_NETWORK": "true", "METRICS_PORT": "9100",
           "SUPERVISOR_BACKOFF_MAX_S": "12", "SOLVE_TIMEOUT_S": "3",
           "INGEST_MAX_EVENTS": "5", "FEATURE_GATES": "Drift=false",
           "TAGS": "team=a"}
    for k, v in env.items():
        monkeypatch.setenv(f"KARPENTER_TPU_{k}", v)
    for argv in ([], ["--cluster-name", "flag-wins",
                      "--feature-gates", "Drift=true"]):
        got = dataclasses.asdict(Options.from_args(argv))
        assert got == kept(RefOptions.from_args(argv))
    assert Options.from_args([]).cluster_name == "from-env"
    assert Options.from_args(["--cluster-name", "x"]).cluster_name == "x"


REFUSED = [
    (["--leader-elect"], "B7"), (["--lease-path", "/x"], "B7"),
    (["--lease-ttl", "3"], "B7"), (["--warm-restart"], "B7"),
    (["--snapshot-path", "/x"], "B7"), (["--snapshot-interval", "3"], "B7"),
    (["--ha-failover"], "B7"),
    (["--log-format", "json"], "B9a"), (["--trace-slow-ms", "5"], "B9a"),
    (["--enable-profiling"], "B9a"), (["--flight-recorder"], "B9"),
    (["--incident-dir", "/x"], "B9"), (["--incident-window", "5"], "B9"),
    (["--incident-dedup", "5"], "B9"), (["--incident-retention", "5"], "B9"),
    (["--obs-sample", "5"], "B9"), (["--obs-ring-slots", "5"], "B9"),
    (["--slo-engine"], "B9"), (["--slo-eval-cadence", "5"], "B9"),
    (["--ledger-retention", "5"], "B9"),
    (["--ledger-drift-threshold", "0.5"], "B9"),
]


@pytest.mark.parametrize("argv,item", REFUSED,
                         ids=[a[0] for a, _ in REFUSED])
def test_flags_of_unported_features_are_refused(argv, item):
    """The flags refused until their features were ported (B7: durability
    and HA; B9a: metrics and tracing; B9: the flight recorder, the SLO
    engine and the cost ledger) give the reference's options: the gate
    flags turn their gates on (`--ha-failover` also `leader_elect`), the
    others set their fields."""
    ref = RefOptions.from_args(argv)        # the reference takes them
    got = dataclasses.asdict(Options.from_args(argv))
    assert got == kept(ref)
    gate = {"--warm-restart": "WarmRestart", "--ha-failover": "HAFailover",
            "--flight-recorder": "FlightRecorder",
            "--slo-engine": "SLOEngine"}.get(argv[0])
    if gate is not None:
        assert got["feature_gates"][gate]
        assert not dataclasses.asdict(Options())["feature_gates"][gate]
    elif item in ("B9a", "B9"):
        field = {"--incident-window": "incident_window_s",
                 "--incident-dedup": "incident_dedup_s",
                 "--obs-sample": "obs_sample_s",
                 "--slo-eval-cadence": "slo_eval_cadence_s"}.get(
            argv[0], argv[0][2:].replace("-", "_"))
        assert got[field] == getattr(ref, field) != \
            dataclasses.asdict(RefOptions())[field]


# the forecast and gang flags, refused until their features were ported
FORECAST_GANG_FLAGS = [
    ["--forecast"], ["--forecast-horizon", "60"], ["--forecast-cadence", "5"],
    ["--forecast-lead", "5"], ["--forecast-ttl", "5"],
    ["--forecast-model", "ewma"], ["--gang-scheduling"],
    ["--forecast", "--gang-scheduling", "--forecast-model", "ewma",
     "--forecast-cadence", "15", "--forecast-horizon", "600",
     "--feature-gates", "Forecast=false"],
]


@pytest.mark.parametrize("argv", FORECAST_GANG_FLAGS,
                         ids=[a[0] for a in FORECAST_GANG_FLAGS[:-1]]
                         + ["all-and-a-gate-off"])
def test_forecast_and_gang_flags_equal_the_reference(argv):
    got = dataclasses.asdict(Options.from_args(argv))
    assert got == kept(RefOptions.from_args(argv))
    if argv == ["--forecast"]:
        assert got["feature_gates"]["Forecast"]
    if argv == ["--gang-scheduling"]:
        assert got["feature_gates"]["GangScheduling"]


def test_forecast_env_defaults_equal_the_reference(monkeypatch):
    for k, v in (("FORECAST_MODEL", "ewma"), ("FORECAST_CADENCE_S", "12"),
                 ("FORECAST_HORIZON_S", "300"), ("FORECAST_LEAD_S", "60"),
                 ("FORECAST_TTL_S", "90")):
        monkeypatch.setenv(f"KARPENTER_TPU_{k}", v)
    for argv in ([], ["--forecast-model", "holtwinters"]):
        assert dataclasses.asdict(Options.from_args(argv)) == \
            kept(RefOptions.from_args(argv))
    assert Options.from_args([]).forecast_model == "ewma"


@pytest.mark.parametrize("argv", [["--vm-memory-overhead-percent", "0.1"],
                                  ["--reserved-enis", "2"],
                                  ["--health-port", "9"]])
def test_flags_nothing_reads_are_refused(argv, capsys):
    RefOptions.from_args(argv)              # the reference parses them
    with pytest.raises(SystemExit) as exc:
        Options.from_args(argv)
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--chaos-spec", "point=cloud.api,action=error"],
    ["--chaos-seed", "3"],
    ["--chaos-spec", "point=controller.reconcile,key=disruption;"
     "point=cloud.api,action=error,error_code=RequestLimitExceeded",
     "--chaos-seed", "7"],
], ids=["spec", "seed", "spec-and-seed"])
def test_chaos_flags_equal_the_reference(argv):
    """`--chaos-spec` / `--chaos-seed`, refused before the chaos injector
    was ported, give the reference's options."""
    got = dataclasses.asdict(Options.from_args(argv))
    assert got == kept(RefOptions.from_args(argv))
    assert got["chaos_spec"] or got["chaos_seed"]


def test_chaos_env_defaults_equal_the_reference(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_CHAOS_SPEC", "point=cloud.api,rate=0.5")
    monkeypatch.setenv("KARPENTER_TPU_CHAOS_SEED", "9")
    for argv in ([], ["--chaos-seed", "2"]):
        assert dataclasses.asdict(Options.from_args(argv)) == \
            kept(RefOptions.from_args(argv))
    assert Options.from_args([]).chaos_seed == 9


# env default → (its value, the field it sets, what that field then holds)
ENV_ONCE_REFUSED = {
    "LEADER_ELECT": ("true", "leader_elect", True),
    "LOG_FORMAT": ("json", "log_format", "json"),
    "INCIDENT_DIR": ("/x", "incident_dir", "/x"),
    "INCIDENT_RETENTION": ("5", "incident_retention", 5),
    "SLO_EVAL_CADENCE_S": ("5", "slo_eval_cadence_s", 5.0),
    "LEDGER_DRIFT_THRESHOLD": ("0.5", "ledger_drift_threshold", 0.5),
}


@pytest.mark.parametrize("env,item", [("LEADER_ELECT", "B7"),
                                      ("LOG_FORMAT", "B9a"),
                                      ("INCIDENT_DIR", "B9b"),
                                      ("INCIDENT_RETENTION", "B9b"),
                                      ("SLO_EVAL_CADENCE_S", "B9b"),
                                      ("LEDGER_DRIFT_THRESHOLD", "B9b")],
                         ids=["LEADER_ELECT-B7", "LOG_FORMAT-B9",
                              "INCIDENT_DIR-B9b", "INCIDENT_RETENTION-B9b",
                              "SLO_EVAL_CADENCE_S-B9b",
                              "LEDGER_DRIFT_THRESHOLD-B9b"])
def test_env_defaults_of_unported_features_are_refused(monkeypatch, env,
                                                       item):
    """The env defaults once refused give the reference's options:
    B7's `KARPENTER_TPU_LEADER_ELECT`, B9a's `KARPENTER_TPU_LOG_FORMAT` and
    B9b's incident, SLO and ledger knobs (the id keeps the item it was
    refused under)."""
    value, field, want = ENV_ONCE_REFUSED[env]
    monkeypatch.setenv(f"KARPENTER_TPU_{env}", value)
    opts = Options.from_args([])
    assert dataclasses.asdict(opts) == kept(RefOptions.from_args([]))
    assert getattr(opts, field) == want


# the gates once refused, with their ROADMAP.md items: all are ported
GATES_ONCE_REFUSED = [("FlightRecorder", "B9"), ("HAFailover", "B7"),
                      ("SLOEngine", "B9"), ("WarmRestart", "B7")]


@pytest.mark.parametrize("gate,item", GATES_ONCE_REFUSED)
def test_unported_gates_on_the_command_line_are_refused(gate, item):
    """The gates once refused (B7's, then B9's) turn on from the command
    line as in the reference."""
    argv = ["--feature-gates", f"{gate}=true"]
    opts = Options.from_args(argv)
    assert opts.gate(gate)
    assert dataclasses.asdict(opts) == kept(RefOptions.from_args(argv))
    assert not Options.from_args(
        ["--feature-gates", f"{gate}=false"]).gate(gate)


def _serve_main(argv):
    """Start `main(argv, device="cpu")` in a child; returns (the process,
    its endpoints' port)."""
    code = ("import sys; from karpenter_tpu_torch.__main__ import main; "
            "sys.exit(main(sys.argv[1:], device='cpu'))")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", code, *argv], cwd=REPO,
                            env=env, stderr=subprocess.PIPE, text=True)
    port, deadline, lines = None, time.time() + 240, []
    while port is None and time.time() < deadline:
        line = proc.stderr.readline()
        if not line:
            break
        lines.append(line)
        if "karpenter-tpu up:" in line:
            port = int(line.split("endpoints=127.0.0.1:")[1].split()[0])
    assert port, f"no up line: {lines}"
    threading.Thread(target=proc.stderr.read, daemon=True).start()
    return proc, port, lines


def _get_json(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_main_leader_elects_and_restores_from_the_command_line(tmp_path):
    """`--ha-failover --warm-restart --snapshot-path --lease-path` (refused
    until B7 was ported): the process leads at fencing epoch 1 with
    /readyz naming its role, SIGTERM exits 0 after writing the final
    snapshot and releasing the lease, and a second process restores that
    snapshot and leads at epoch 2 at once (the released lease needs no TTL
    wait)."""
    from karpenter_tpu_torch.state.snapshot import load_sections
    snap, lease = tmp_path / "s.bin", tmp_path / "ha.lease"
    argv = ["--metrics-port", "0", "--ha-failover", "--warm-restart",
            "--snapshot-path", str(snap), "--lease-path", str(lease),
            "--lease-ttl", "30"]
    epochs = []
    for restore in ("missing", "restored"):
        proc, port, lines = _serve_main(argv)
        try:
            assert any(f"warm restart: {restore}" in ln for ln in lines)
            deadline = time.time() + 60
            code, ready = _get_json(port, "/readyz")
            while ready["phase"] != "LEADING" and time.time() < deadline:
                time.sleep(0.2)
                code, ready = _get_json(port, "/readyz")
            assert code == 200 and ready["role"] == "leader"
            assert ready["restore"] == restore
            epochs.append(ready["fence_epoch"])
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        sections, reason = load_sections(str(snap))
        assert reason == "ok"
        assert sections["meta"]["fence_epoch"] == epochs[-1]
        with open(lease) as fh:
            held = json.load(fh)
        assert held["epoch"] == epochs[-1]
        assert time.time() - held["renewed"] >= 30     # released in place
    assert epochs == [1, 2]


def test_main_reaches_readiness_and_exits_0_on_sigterm():
    """`python -m karpenter_tpu_torch`'s `main` on the CPU in a child
    process: its "up" line names the port, /readyz answers 200 after the
    parity probe, /healthz 200, /metrics the registry's exposition with
    the reference's families, /debug/traces the tracer's ring,
    /debug/incidents the reference's 404 with the FlightRecorder gate off,
    and SIGTERM drains it to exit code 0."""
    code = ("import sys; from karpenter_tpu_torch.__main__ import main; "
            "sys.exit(main(sys.argv[1:], device='cpu'))")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "--metrics-port", "0",
         "--cluster-name", "main-test"],
        cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
    try:
        port, deadline = None, time.time() + 240
        while port is None and time.time() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            if "karpenter-tpu up:" in line:
                assert "cluster=main-test" in line
                port = int(line.split("endpoints=127.0.0.1:")[1].split()[0])
        assert port, "no up line"
        # keep the child's log pipe drained while it serves
        threading.Thread(target=proc.stderr.read, daemon=True).start()

        def get(path):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{path}", timeout=30) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())
        code_r, ready = get("/readyz")
        assert code_r == 200 and ready["phase"] == "LEADING"
        assert ready["probe"] == "skipped"       # no nodes yet
        assert get("/healthz")[0] == 200
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as r:
            text = r.read().decode()
        assert r.status == 200
        from karpenter_tpu.utils import metrics as ref_metrics
        ref_metrics.register_parity_families()
        assert {ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE ")} >= \
            {m.name for m in ref_metrics.REGISTRY._metrics.values()}
        code_t, traces = get("/debug/traces?span=provision")
        assert code_t == 200 and isinstance(traces["traces"], list)
        # the flight recorder's endpoint, gate off: the reference's 404
        code_i, inc = get("/debug/incidents")
        assert code_i == 404 and "--flight-recorder" in inc["error"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


class _OneHolder:
    """The state lock, but a second acquire on any thread fails after 5 s
    where a plain lock would hang."""

    def __init__(self):
        self._lock = threading.Lock()

    def __enter__(self):
        assert self._lock.acquire(timeout=5), "the state lock, taken twice"

    def __exit__(self, *exc):
        self._lock.release()


def test_a_signal_during_a_tick_ends_the_loop_without_the_state_lock():
    """SIGTERM lands on the main thread, where a tick may hold the state
    lock (the snapshot cadence writes under it): the entry point's handler
    takes no state lock, `run()` ends after the tick, and `stop()` then
    drains.  The handler once called `stop()` itself, which took the lock
    again on the same thread and hung the process."""
    from types import SimpleNamespace

    from karpenter_tpu_torch import __main__ as entry
    from karpenter_tpu_torch.operator.manager import ControllerManager
    from karpenter_tpu_torch.utils.events import Recorder
    clock = lambda: 0.0  # noqa: E731
    op = SimpleNamespace(
        options=Options(), clock=clock, recorder=Recorder(clock=clock),
        state_lock=threading.Lock(),
        cluster=SimpleNamespace(pending_pods=lambda: []), node_classes={})
    mgr = ControllerManager(op, {}, clock=clock)
    mgr._state_lock = _OneHolder()
    handler = entry._stop_on_signal(mgr)
    with mgr._state_lock:                    # a tick, mid-snapshot
        handler(signal.SIGTERM, None)
        assert mgr._stop.wait(5)
    t0 = time.monotonic()
    mgr.run(tick_seconds=0.01)               # the stop is already asked
    mgr.stop()
    assert time.monotonic() - t0 < 5
    assert mgr.phase == "DRAINING"
