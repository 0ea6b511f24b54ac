"""Operator options: the fields the port's `Operator` and `build_controllers`
read, with the JAX package's defaults, and the feature-gate table.

A trimmed copy of the JAX package's `operator/options.py` (which
re-implements karpenter:pkg/operator/options/options.go).  The reference's
command line (`from_args`), its env-var defaults and the legacy settings
merge (`merge_settings`) come with ROADMAP.md queue B3, beside `__main__.py`
and the controller manager that read them; so do the options only those
read (ports, leader election, snapshots, logging, supervision, the flight
recorder and the SLO engine, the forecast knobs).  A field this dataclass
does not have is refused at construction, never silently ignored.
`operator.Operator` raises NotImplementedError for the gates and the chaos
spec whose features are not ported yet, naming their ROADMAP.md item.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

# every feature gate with its default (the reference's options.py:134-146;
# its comments there say what each gate turns on)
FEATURE_GATES: Dict[str, bool] = {
    "Drift": True, "LPGuide": True, "LPRefinery": False, "Forecast": False,
    "IncrementalArena": True, "ShardedSolve": False, "WarmRestart": False,
    "IngestBatch": False, "DeviceDecode": False, "DeviceLP": False,
    "HAFailover": False, "FlightRecorder": False, "SLOEngine": False,
    "GangScheduling": False}


@dataclass
class Options:
    cluster_name: str = "default"
    cluster_endpoint: str = "https://cluster.local"
    cluster_dns: str = ""                # empty == discover from control plane
    isolated_network: bool = False       # isolated-vpc analog: no pricing API
    interruption_queue: str = ""         # empty == interruption disabled
    feature_gates: Dict[str, bool] = field(
        default_factory=lambda: dict(FEATURE_GATES))
    # cloud-call hardening and the solver deadline: all default OFF so a
    # stepped clock never wall-sleeps and every golden stays as it is
    solve_timeout_s: float = 0.0            # hard solver deadline (0 = off)
    cloud_retry_attempts: int = 0           # extra tries per cloud call
    cloud_retry_base_s: float = 0.2         # retry backoff base
    cloud_breaker_threshold: int = 0        # failures → open circuit (0 = off)
    cloud_breaker_cooldown_s: float = 30.0  # open-circuit fast-fail window
    chaos_spec: str = ""                    # fault-injection rules (B5; off)
    ingest_max_events: int = 100_000        # IngestBatch pending cap → rebuild

    def gate(self, name: str) -> bool:
        return self.feature_gates.get(name, False)
