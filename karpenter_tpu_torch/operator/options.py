"""Operator options: the fields the port reads, with the JAX package's
defaults, the feature-gate table, and the command line with its env-var
defaults.

A trimmed copy of the JAX package's `operator/options.py` (which
re-implements karpenter:pkg/operator/options/options.go:53-63).
Precedence is the reference's: explicit flag > env var > default.
`from_args` parses the reference's whole command line.  `--log-format`,
`--trace-slow-ms` and `--enable-profiling` (and their env defaults) are
read as the reference's: `__main__` configures logging from the first,
`Operator` sets the tracer's slow-span threshold from the second, and the
manager serves `/debug/pprof` only with the third.  The durability and HA
flags are read as the reference's: `--warm-restart` and `--ha-failover` turn their gates on
(`--ha-failover` also `leader_elect`), `--leader-elect`, `--lease-path`,
`--lease-ttl`, `--snapshot-path` and `--snapshot-interval` set their
fields.  The flight-recorder, SLO-engine and ledger flags are read as the
reference's: `--flight-recorder` and `--slo-engine` turn their gates on,
the `--incident-*`, `--obs-*`, `--slo-eval-cadence` and `--ledger-*` flags
set their fields.  The four options the JAX package parses and never
reads (`--vm-memory-overhead-percent`, `--reserved-enis`, `--health-port`,
the env's tags) are not parsed: argparse refuses those flags.  The legacy
settings merge (`merge_settings`) has no caller in the JAX package and is
left out.  A field this dataclass does not have is refused at
construction, never silently ignored.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field, fields
from typing import Dict, Optional, Sequence

ENV_PREFIX = "KARPENTER_TPU_"

# Defaults cited from the reference where they exist.
DEFAULT_BATCH_IDLE = 1.0                # settings.md:17 batch-idle-duration
DEFAULT_BATCH_MAX = 10.0                # settings.md:18 batch-max-duration
DEFAULT_METRICS_PORT = 8000

# every feature gate with its default (the reference's options.py:134-146;
# its comments there say what each gate turns on)
FEATURE_GATES: Dict[str, bool] = {
    "Drift": True, "LPGuide": True, "LPRefinery": False, "Forecast": False,
    "IncrementalArena": True, "ShardedSolve": False, "WarmRestart": False,
    "IngestBatch": False, "DeviceDecode": False, "DeviceLP": False,
    "HAFailover": False, "FlightRecorder": False, "SLOEngine": False,
    "GangScheduling": False}

# fields with no command-line flag: a scenario's `forecast:` block sets
# them (sim/harness.py), as in the reference, whose from_args never reads
# them either
SCENARIO_ONLY_FIELDS = frozenset({
    "forecast_bucket_s", "forecast_confidence", "forecast_max_cost_frac",
    "forecast_season_s"})


def _true(v: str) -> bool:
    return v.lower() == "true"


# the reference's options that take an env default (every field of its
# Options that `from_args` reads), with the cast of the env string
_ENV_CASTS = {
    **{k: str for k in ("cluster_name", "cluster_endpoint", "cluster_dns",
                        "interruption_queue", "log_format", "forecast_model",
                        "chaos_spec", "snapshot_path", "lease_path",
                        "incident_dir", "feature_gates")},
    **{k: _true for k in ("isolated_network", "leader_elect",
                          "enable_profiling")},
    **{k: int for k in ("metrics_port", "supervisor_circuit_threshold",
                        "cloud_retry_attempts", "cloud_breaker_threshold",
                        "chaos_seed", "ingest_max_events", "obs_ring_slots",
                        "incident_retention", "ledger_retention")},
    **{k: float for k in ("batch_idle_duration",
                          "batch_max_duration", "trace_slow_ms",
                          "forecast_cadence_s", "forecast_horizon_s",
                          "forecast_lead_s", "forecast_ttl_s",
                          "supervisor_backoff_base_s",
                          "supervisor_backoff_max_s",
                          "reconcile_soft_deadline_s", "solve_timeout_s",
                          "cloud_retry_base_s", "cloud_breaker_cooldown_s",
                          "snapshot_interval_s", "lease_ttl_s",
                          "obs_sample_s", "incident_window_s",
                          "incident_dedup_s", "slo_eval_cadence_s",
                          "ledger_drift_threshold")},
}


def _parse_kv_list(raw: str, into: Dict, cast=lambda v: v) -> None:
    """Parse `k=v,k2=v2` option strings into a dict (feature gates)."""
    for item in filter(None, raw.split(",")):
        k, _, v = item.partition("=")
        into[k.strip()] = cast(v.strip())


@dataclass
class Options:
    cluster_name: str = "default"
    cluster_endpoint: str = "https://cluster.local"
    cluster_dns: str = ""                # empty == discover from control plane
    isolated_network: bool = False       # isolated-vpc analog: no pricing API
    interruption_queue: str = ""         # empty == interruption disabled
    batch_idle_duration: float = DEFAULT_BATCH_IDLE
    batch_max_duration: float = DEFAULT_BATCH_MAX
    metrics_port: int = DEFAULT_METRICS_PORT  # the endpoints' one server
    leader_elect: bool = False           # lease-file leader election
    enable_profiling: bool = False       # settings.md:23 --enable-profiling
    # structured logging + tracing (utils/tracing.py): "text" keeps the
    # classic line format, "json" emits one JSON object per line with
    # trace/span ids; spans slower than trace_slow_ms log a WARN (0 = off)
    log_format: str = "text"
    trace_slow_ms: float = 0.0
    feature_gates: Dict[str, bool] = field(
        default_factory=lambda: dict(FEATURE_GATES))
    # controller supervision (operator/supervisor.py) and the soft deadline
    supervisor_circuit_threshold: int = 5   # consecutive errors → quarantine
    supervisor_backoff_base_s: float = 1.0  # first retry delay
    supervisor_backoff_max_s: float = 300.0  # backoff ceiling
    reconcile_soft_deadline_s: float = 5.0  # warn past this (0 = off)
    # cloud-call hardening and the solver deadline: all default OFF so a
    # stepped clock never wall-sleeps and every golden stays as it is
    solve_timeout_s: float = 0.0            # hard solver deadline (0 = off)
    cloud_retry_attempts: int = 0           # extra tries per cloud call
    cloud_retry_base_s: float = 0.2         # retry backoff base
    cloud_breaker_threshold: int = 0        # failures → open circuit (0 = off)
    cloud_breaker_cooldown_s: float = 30.0  # open-circuit fast-fail window
    chaos_spec: str = ""                    # utils/chaos.py rule DSL (off)
    chaos_seed: int = 0                     # chaos schedule seed
    ingest_max_events: int = 100_000        # IngestBatch pending cap → rebuild
    # durability knobs (WarmRestart gate, state/snapshot.py)
    snapshot_path: str = ""                 # snapshot file ("" = disabled)
    snapshot_interval_s: float = 30.0       # cadence between snapshots
    # HA leadership knobs (used with --leader-elect; HAFailover adds the
    # fencing on top)
    lease_path: str = ""                    # lease file ("" = derive from
                                            # the cluster name in tmpdir)
    lease_ttl_s: float = 15.0               # leadership lease TTL
    # flight-recorder knobs (FlightRecorder gate, obs/recorder.py)
    obs_sample_s: float = 30.0              # metric-ring sampling cadence
    obs_ring_slots: int = 512               # bounded ring capacity
    incident_window_s: float = 600.0        # forensic lookback per bundle
    incident_dedup_s: float = 300.0         # per-kind publish rate limit
    incident_retention: int = 32            # bundles kept (memory + disk)
    incident_dir: str = ""                  # bundle directory ("" = memory-only)
    # SLO-engine + cost-ledger knobs (SLOEngine gate, obs/slo.py, obs/ledger.py)
    slo_eval_cadence_s: float = 60.0        # recording-rule evaluation cadence
    ledger_retention: int = 256             # closed ledger entries kept
    ledger_drift_threshold: float = 0.15    # |realized-expected|/expected trip
    # forecast/headroom knobs (read only with the Forecast gate on); the
    # first five have flags, the rest come from a scenario's forecast block
    forecast_cadence_s: float = 30.0       # HeadroomController reconcile cadence
    forecast_horizon_s: float = 900.0      # forecast window length
    forecast_lead_s: float = 180.0         # window starts this far ahead
    forecast_ttl_s: float = 600.0          # placeholder lifetime
    forecast_model: str = "holtwinters"    # "ewma" | "holtwinters"
    forecast_bucket_s: float = 60.0        # demand-series bucket width
    forecast_confidence: float = 1.64      # z for the upper band (~p95)
    forecast_max_cost_frac: float = 0.10   # headroom $/h cap vs cluster rate
    forecast_season_s: float = 86_400.0    # Holt-Winters season (diurnal)

    @classmethod
    def from_args(cls, argv: Optional[Sequence[str]] = None) -> "Options":
        """Parse the reference's flags with env-var defaults (options.go
        AddFlags)."""
        env = cls._env_defaults()
        p = argparse.ArgumentParser(prog="karpenter-tpu")
        p.add_argument("--cluster-name",
                       default=env.get("cluster_name", "default"))
        p.add_argument("--cluster-endpoint",
                       default=env.get("cluster_endpoint",
                                       "https://cluster.local"))
        p.add_argument("--cluster-dns", default=env.get("cluster_dns", ""))
        p.add_argument("--isolated-network", action="store_true",
                       default=env.get("isolated_network", False))
        p.add_argument("--interruption-queue",
                       default=env.get("interruption_queue", ""))
        p.add_argument("--batch-idle-duration", type=float,
                       default=env.get("batch_idle_duration",
                                       DEFAULT_BATCH_IDLE))
        p.add_argument("--batch-max-duration", type=float,
                       default=env.get("batch_max_duration",
                                       DEFAULT_BATCH_MAX))
        p.add_argument("--metrics-port", type=int,
                       default=env.get("metrics_port", DEFAULT_METRICS_PORT))
        p.add_argument("--leader-elect", action="store_true",
                       default=env.get("leader_elect", False))
        p.add_argument("--enable-profiling", action="store_true",
                       default=env.get("enable_profiling", False))
        p.add_argument("--log-format", choices=("text", "json"),
                       default=env.get("log_format", "text"))
        p.add_argument("--trace-slow-ms", type=float,
                       default=env.get("trace_slow_ms", 0.0))
        p.add_argument("--lp-refinery", action="store_true", default=False,
                       help="shorthand for --feature-gates LPRefinery=true")
        p.add_argument("--forecast", action="store_true", default=False)
        p.add_argument("--forecast-cadence", type=float,
                       dest="forecast_cadence_s",
                       default=env.get("forecast_cadence_s", 30.0))
        p.add_argument("--forecast-horizon", type=float,
                       dest="forecast_horizon_s",
                       default=env.get("forecast_horizon_s", 900.0))
        p.add_argument("--forecast-lead", type=float, dest="forecast_lead_s",
                       default=env.get("forecast_lead_s", 180.0))
        p.add_argument("--forecast-ttl", type=float, dest="forecast_ttl_s",
                       default=env.get("forecast_ttl_s", 600.0))
        p.add_argument("--forecast-model", choices=("ewma", "holtwinters"),
                       default=env.get("forecast_model", "holtwinters"))
        p.add_argument("--incremental-arena", action="store_true",
                       default=False,
                       help="shorthand for --feature-gates "
                            "IncrementalArena=true (on by default)")
        p.add_argument("--sharded-solve", action="store_true", default=False,
                       help="shorthand for --feature-gates ShardedSolve=true")
        p.add_argument("--device-decode", action="store_true", default=False,
                       help="shorthand for --feature-gates DeviceDecode=true")
        p.add_argument("--device-lp", action="store_true", default=False,
                       help="shorthand for --feature-gates DeviceLP=true")
        p.add_argument("--supervisor-circuit-threshold", type=int,
                       default=env.get("supervisor_circuit_threshold", 5),
                       help="consecutive reconcile errors before a "
                            "controller's circuit opens (quarantine)")
        p.add_argument("--supervisor-backoff-base", type=float,
                       dest="supervisor_backoff_base_s",
                       default=env.get("supervisor_backoff_base_s", 1.0),
                       help="first crash-loop retry delay in seconds")
        p.add_argument("--supervisor-backoff-max", type=float,
                       dest="supervisor_backoff_max_s",
                       default=env.get("supervisor_backoff_max_s", 300.0),
                       help="crash-loop backoff ceiling in seconds")
        p.add_argument("--reconcile-soft-deadline", type=float,
                       dest="reconcile_soft_deadline_s",
                       default=env.get("reconcile_soft_deadline_s", 5.0),
                       help="warn on reconciles slower than this many "
                            "seconds (0 disables)")
        p.add_argument("--solve-timeout", type=float, dest="solve_timeout_s",
                       default=env.get("solve_timeout_s", 0.0),
                       help="hard cancellable deadline for solver calls "
                            "(0 disables)")
        p.add_argument("--cloud-retry-attempts", type=int,
                       default=env.get("cloud_retry_attempts", 0))
        p.add_argument("--cloud-retry-base", type=float,
                       dest="cloud_retry_base_s",
                       default=env.get("cloud_retry_base_s", 0.2))
        p.add_argument("--cloud-breaker-threshold", type=int,
                       default=env.get("cloud_breaker_threshold", 0))
        p.add_argument("--cloud-breaker-cooldown", type=float,
                       dest="cloud_breaker_cooldown_s",
                       default=env.get("cloud_breaker_cooldown_s", 30.0))
        p.add_argument("--chaos-spec",
                       default=env.get("chaos_spec", ""),
                       help="chaos rule DSL 'point=...,action=...;...' "
                            "(utils/chaos.py; empty disables injection)")
        p.add_argument("--chaos-seed", type=int,
                       default=env.get("chaos_seed", 0),
                       help="seed for the deterministic chaos schedule")
        p.add_argument("--warm-restart", action="store_true", default=False)
        p.add_argument("--ingest-batch", action="store_true", default=False,
                       help="shorthand for --feature-gates IngestBatch=true")
        p.add_argument("--snapshot-path",
                       default=env.get("snapshot_path", ""))
        p.add_argument("--snapshot-interval", type=float,
                       dest="snapshot_interval_s",
                       default=env.get("snapshot_interval_s", 30.0))
        p.add_argument("--ingest-max-events", type=int,
                       default=env.get("ingest_max_events", 100_000),
                       help="pending coalesced events before the batcher "
                            "degrades to a full arena rebuild")
        p.add_argument("--ha-failover", action="store_true", default=False)
        p.add_argument("--lease-path", default=env.get("lease_path", ""))
        p.add_argument("--lease-ttl", type=float, dest="lease_ttl_s",
                       default=env.get("lease_ttl_s", 15.0))
        p.add_argument("--flight-recorder", action="store_true", default=False,
                       help="arm the incident flight recorder: metric "
                            "history ring + trip-site trigger bus + "
                            "forensic bundles (shorthand for "
                            "--feature-gates FlightRecorder=true)")
        p.add_argument("--incident-dir",
                       default=env.get("incident_dir", ""),
                       help="directory for forensic incident bundles "
                            "(empty keeps them in-memory only)")
        p.add_argument("--incident-window", type=float,
                       dest="incident_window_s",
                       default=env.get("incident_window_s", 600.0),
                       help="seconds of metric/trace history folded into "
                            "each forensic bundle")
        p.add_argument("--incident-dedup", type=float,
                       dest="incident_dedup_s",
                       default=env.get("incident_dedup_s", 300.0),
                       help="per-kind incident rate-limit window in seconds")
        p.add_argument("--incident-retention", type=int,
                       default=env.get("incident_retention", 32),
                       help="forensic bundles retained (memory and disk)")
        p.add_argument("--obs-sample", type=float, dest="obs_sample_s",
                       default=env.get("obs_sample_s", 30.0),
                       help="metric history ring sampling cadence in seconds")
        p.add_argument("--obs-ring-slots", type=int,
                       default=env.get("obs_ring_slots", 512),
                       help="metric history ring capacity in samples")
        p.add_argument("--slo-engine", action="store_true", default=False,
                       help="arm the SLO engine + per-decision cost "
                            "ledger: error budgets, burn-rate alerts, "
                            "and $·h attribution (shorthand for "
                            "--feature-gates SLOEngine=true)")
        p.add_argument("--slo-eval-cadence", type=float,
                       dest="slo_eval_cadence_s",
                       default=env.get("slo_eval_cadence_s", 60.0),
                       help="seconds between SLO recording-rule "
                            "evaluations")
        p.add_argument("--ledger-retention", type=int,
                       default=env.get("ledger_retention", 256),
                       help="closed cost-ledger entries retained")
        p.add_argument("--ledger-drift-threshold", type=float,
                       default=env.get("ledger_drift_threshold", 0.15),
                       help="relative expected-vs-realized $·h drift per "
                            "nodepool that trips a cost_drift incident")
        p.add_argument("--gang-scheduling", action="store_true",
                       default=False)
        p.add_argument("--feature-gates", default="",
                       help="comma list Gate=true|false")
        ns = p.parse_args(argv)
        opts = cls(**{f.name: getattr(ns, f.name) for f in fields(cls)
                      if f.name != "feature_gates"
                      and f.name not in SCENARIO_ONLY_FIELDS})
        # env-provided gates apply first; explicit --feature-gates wins
        _parse_kv_list(str(env.get("feature_gates", "")), opts.feature_gates,
                       cast=lambda v: v.lower() != "false")
        for flag, gate in (("lp_refinery", "LPRefinery"),
                           ("forecast", "Forecast"),
                           ("incremental_arena", "IncrementalArena"),
                           ("sharded_solve", "ShardedSolve"),
                           ("device_decode", "DeviceDecode"),
                           ("device_lp", "DeviceLP"),
                           ("warm_restart", "WarmRestart"),
                           ("ingest_batch", "IngestBatch"),
                           ("ha_failover", "HAFailover"),
                           ("flight_recorder", "FlightRecorder"),
                           ("slo_engine", "SLOEngine"),
                           ("gang_scheduling", "GangScheduling")):
            if getattr(ns, flag):
                opts.feature_gates[gate] = True
        if ns.ha_failover:
            opts.leader_elect = True  # fencing is meaningless without a lease
        _parse_kv_list(ns.feature_gates, opts.feature_gates,
                       cast=lambda v: v.lower() != "false")
        return opts

    @staticmethod
    def _env_defaults() -> Dict[str, object]:
        """`KARPENTER_TPU_<FIELD>` env vars of the reference's options."""
        out: Dict[str, object] = {}
        for name, cast in _ENV_CASTS.items():
            raw = os.environ.get(ENV_PREFIX + name.upper())
            if raw is not None:
                out[name] = cast(raw)
        return out

    def gate(self, name: str) -> bool:
        return self.feature_gates.get(name, False)
