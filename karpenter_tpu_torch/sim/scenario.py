"""Scenario DSL: declarative workload waves + fault schedule.

A copy of the JAX package's `sim/scenario.py` with its `forecast:`,
`chaos:` (a seeded fault schedule for utils/chaos.py), `ha:` (the fenced
leadership drill), `slo:` (the SLO engine and cost ledger) and `gang:`
blocks.

A scenario is a YAML document (or the `Scenario` dataclass directly)
describing what hits the cluster over a virtual-time window:

  * **workload waves** — a diurnal sinusoid of arrivals, a step burst, or
    batch-job cohorts with completion times;
  * **faults** — spot-reclaim storms, ICE windows per capacity pool, spot
    price drift, API throttle bursts, node-ready latency shifts.

`expand(scenario, seed)` lowers the spec to a flat, time-sorted list of
typed events, deterministically: the same (scenario, seed) pair always
yields the same pods with the same names, requests, and arrival times.
Each wave/fault draws from its own `numpy` Generator keyed on
``[seed, stream-index]`` so adding a wave never perturbs its siblings.

Schema reference: docs/simulation.md.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..api.objects import Pod
from ..api.resources import CPU, MEMORY, ResourceList
from .events import (ApiThrottle, IceClose, IceOpen, NodeReadyLatency,
                     PodArrival, PodDeparture, PriceDrift, SimEvent,
                     SpotReclaim)


class ScenarioError(ValueError):
    """A scenario document failed validation; the message names the field."""


# ---------------------------------------------------------------------------
# spec dataclasses
# ---------------------------------------------------------------------------

WAVE_KINDS = ("diurnal", "step", "batch")
FAULT_KINDS = ("spot_reclaim_storm", "ice_window", "price_drift",
               "api_throttle", "node_ready_latency")

# sim-friendly controller cadences: virtual seconds between reconciles.
# Coarser than the live defaults (manager.DEFAULT_INTERVALS) because at
# >1000x time compression a 10s consolidation cadence burns wall time
# re-evaluating an unchanged cluster; scenarios may override per entry.
DEFAULT_SIM_INTERVALS: Dict[str, float] = {
    "termination": 5.0,
    "disruption": 300.0,
    "lifecycle": 5.0,
    "garbagecollection": 120.0,
    "tagging": 300.0,
    "nodeclass": 3600.0,
    "interruption": 5.0,
    "pricing": 600.0,
    "forecast": 300.0,
}


@dataclass
class Wave:
    """One workload stream.

    kind=diurnal — arrivals follow a sinusoidal Poisson rate
        rate(t) = base_per_hour * (1 + amplitude * sin(2π (t-phase)/period))
      bucketed into `bucket_s` cohorts; each cohort departs `lifetime_s`
      after arrival (0 = stays forever).
    kind=step — `count` pods arrive at `at_s`, depart `duration_s` later
      (0 = stay forever).
    kind=batch — `cohorts` cohorts of `count` pods, the first at `at_s`,
      then one every `every_s`; each completes (departs) `runtime_s` after
      arrival.
    """
    kind: str
    name: str
    # shared pod shape
    cpu_m: Tuple[int, int] = (250, 2000)
    mem_mib: Tuple[int, int] = (256, 4096)
    # diurnal
    base_per_hour: float = 30.0
    amplitude: float = 0.8
    period_s: float = 86_400.0
    phase_s: float = 0.0
    bucket_s: float = 300.0
    lifetime_s: float = 7_200.0
    # step / batch
    at_s: float = 0.0
    count: int = 10
    duration_s: float = 0.0
    cohorts: int = 1
    every_s: float = 21_600.0
    runtime_s: float = 1_800.0
    # gang scheduling (docs/gang.md): gang_size > 0 folds each cohort's
    # pods into consecutive all-or-nothing gangs of that size (pods past
    # the last full gang stay ungrouped).  Pod shapes draw from the SAME
    # rng stream as ungrouped waves — adding gang fields never perturbs
    # sibling randomness or pre-gang goldens.
    gang_size: int = 0
    gang_tier: int = 0
    gang_topology: str = "zone"

    def validate(self) -> None:
        if self.kind not in WAVE_KINDS:
            raise ScenarioError(
                f"wave {self.name!r}: unknown kind {self.kind!r} "
                f"(expected one of {WAVE_KINDS})")
        if not self.name:
            raise ScenarioError("every wave needs a name")
        for fld in ("cpu_m", "mem_mib"):
            lo, hi = getattr(self, fld)
            if not (0 < lo <= hi):
                raise ScenarioError(
                    f"wave {self.name!r}: {fld} range must satisfy "
                    f"0 < lo <= hi, got {(lo, hi)}")
        if self.kind == "diurnal":
            if self.base_per_hour <= 0 or self.period_s <= 0 or self.bucket_s <= 0:
                raise ScenarioError(
                    f"wave {self.name!r}: base_per_hour, period_s and "
                    "bucket_s must be positive")
            if not 0 <= self.amplitude <= 1:
                raise ScenarioError(
                    f"wave {self.name!r}: amplitude must be in [0, 1]")
        if self.kind in ("step", "batch") and self.count <= 0:
            raise ScenarioError(f"wave {self.name!r}: count must be positive")
        if self.kind == "batch" and (self.cohorts <= 0 or self.every_s <= 0
                                     or self.runtime_s <= 0):
            raise ScenarioError(
                f"wave {self.name!r}: cohorts, every_s, runtime_s must be "
                "positive")
        if self.gang_size < 0 or self.gang_tier < 0:
            raise ScenarioError(
                f"wave {self.name!r}: gang_size and gang_tier must be >= 0")
        if self.gang_topology not in ("zone", "hostname"):
            raise ScenarioError(
                f"wave {self.name!r}: gang_topology must be 'zone' or "
                f"'hostname', got {self.gang_topology!r}")


@dataclass
class Fault:
    """One fault-schedule entry (kinds in FAULT_KINDS)."""
    kind: str
    at_s: float
    name: str = ""
    # spot_reclaim_storm
    count: int = 1
    warning_s: float = 120.0
    repeat: int = 1
    every_s: float = 600.0
    # ice_window — pool triples [capacity_type, instance_type, zone];
    # "*" wildcards resolve against the catalog at delivery
    pools: List[Tuple[str, str, str]] = field(default_factory=list)
    duration_s: float = 600.0
    # price_drift
    factor: float = 1.0
    jitter: float = 0.0
    # node_ready_latency
    latency_s: float = 0.0

    def validate(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ScenarioError(
                f"fault {self.name or self.kind!r}: unknown kind "
                f"{self.kind!r} (expected one of {FAULT_KINDS})")
        if self.at_s < 0:
            raise ScenarioError(f"fault {self.name!r}: at_s must be >= 0")
        if self.kind == "spot_reclaim_storm":
            if self.count <= 0 or self.repeat <= 0 or self.every_s <= 0:
                raise ScenarioError(
                    f"fault {self.name!r}: count, repeat, every_s must be "
                    "positive")
        if self.kind == "ice_window":
            if not self.pools:
                raise ScenarioError(
                    f"fault {self.name!r}: ice_window needs pools")
            for p in self.pools:
                if len(p) != 3:
                    raise ScenarioError(
                        f"fault {self.name!r}: pool {p!r} must be "
                        "[capacity_type, instance_type, zone]")
            if self.duration_s <= 0:
                raise ScenarioError(
                    f"fault {self.name!r}: duration_s must be positive")
        if self.kind == "price_drift" and self.factor <= 0:
            raise ScenarioError(f"fault {self.name!r}: factor must be > 0")
        if self.kind == "api_throttle" and self.duration_s <= 0:
            raise ScenarioError(
                f"fault {self.name!r}: duration_s must be positive")
        if self.kind == "node_ready_latency" and self.latency_s < 0:
            raise ScenarioError(
                f"fault {self.name!r}: latency_s must be >= 0")


@dataclass
class ChaosRuleSpec:
    """One chaos fault stream (docs/simulation.md, utils/chaos.py).  Times
    are scenario-relative seconds; the harness rebases them onto the
    virtual clock before arming the injector.  `until_s: 0` means "until
    the end of the run"."""
    point: str
    key: str = ""
    action: str = "error"
    rate: float = 1.0
    at_s: float = 0.0
    until_s: float = 0.0
    latency_s: float = 0.0
    count: int = 0
    error_code: str = ""

    def validate(self, ctx: str) -> None:
        from ..utils.chaos import ACTIONS, POINTS
        if self.point not in POINTS:
            raise ScenarioError(f"{ctx}: unknown point {self.point!r} "
                                f"(expected one of {sorted(POINTS)})")
        if self.action not in ACTIONS:
            raise ScenarioError(f"{ctx}: unknown action {self.action!r} "
                                f"(expected one of {ACTIONS})")
        if not 0.0 < self.rate <= 1.0:
            raise ScenarioError(f"{ctx}: rate must be in (0, 1]")
        if self.at_s < 0:
            raise ScenarioError(f"{ctx}: at_s must be >= 0")
        if self.until_s and self.until_s <= self.at_s:
            raise ScenarioError(f"{ctx}: until_s must be > at_s (or 0 for "
                                "open-ended)")
        if self.action in ("latency", "hang") and self.latency_s <= 0:
            raise ScenarioError(
                f"{ctx}: {self.action} needs latency_s > 0")
        if self.count < 0:
            raise ScenarioError(f"{ctx}: count must be >= 0")


@dataclass
class ForecastSpec:
    """Forecast/headroom configuration for a scenario (docs/forecast.md).
    `enabled: true` turns the Forecast gate on for the simulated operator;
    the knobs map 1:1 onto the forecast_* Options fields."""
    enabled: bool = True
    horizon_s: float = 900.0
    lead_s: float = 180.0
    ttl_s: float = 600.0
    bucket_s: float = 60.0
    confidence: float = 1.64
    max_cost_frac: float = 0.10
    model: str = "holtwinters"
    season_s: float = 86_400.0

    def validate(self) -> None:
        for fld in ("horizon_s", "lead_s", "ttl_s", "bucket_s",
                    "confidence", "season_s"):
            if getattr(self, fld) <= 0:
                raise ScenarioError(f"forecast: {fld} must be positive")
        if not 0.0 < self.max_cost_frac <= 1.0:
            raise ScenarioError("forecast: max_cost_frac must be in (0, 1]")
        if self.model not in ("ewma", "holtwinters"):
            raise ScenarioError(
                f"forecast: unknown model {self.model!r} "
                "(expected ewma or holtwinters)")


@dataclass
class ChaosSpec:
    """Deterministic fault-injection schedule for a scenario.  `seed: null`
    derives the chaos streams from the run seed, so `--seed` replays move
    the whole schedule together; an explicit seed pins the schedule while
    workload randomness still follows the run seed."""
    enabled: bool = True
    seed: Optional[int] = None
    rules: List[ChaosRuleSpec] = field(default_factory=list)

    def validate(self) -> None:
        if not self.rules:
            raise ScenarioError("chaos: needs at least one rule")
        for i, r in enumerate(self.rules):
            r.validate(f"chaos.rules[{i}]")


@dataclass
class HASpec:
    """HA failover configuration for a scenario.  `enabled: true` turns
    the HAFailover gate on for the simulated operator: a virtual-clock
    `LeaderElector` is wired in (so lease expiry, chaos at `leader.lease`,
    and fencing refusals all play out deterministically) and the report
    grows an "ha" section."""
    enabled: bool = True
    ttl_s: float = 15.0

    def validate(self) -> None:
        if self.ttl_s <= 0:
            raise ScenarioError("ha: ttl_s must be positive")


@dataclass
class SLOSpec:
    """SLO engine + cost ledger configuration for a scenario.
    `enabled: true` turns the SLOEngine gate on for the simulated
    operator: recording rules evaluate over the virtual clock and the
    report grows gated `slo.budgets` / `ledger` sections."""
    enabled: bool = True
    eval_cadence_s: float = 60.0
    drift_threshold: float = 0.15

    def validate(self) -> None:
        if self.eval_cadence_s <= 0:
            raise ScenarioError("slo: eval_cadence_s must be positive")
        if self.drift_threshold <= 0:
            raise ScenarioError("slo: drift_threshold must be positive")


@dataclass
class GangSpec:
    """Gang scheduling configuration for a scenario (docs/gang.md).
    `enabled: true` turns the GangScheduling gate on for the simulated
    operator — all-or-nothing admission, topology-domain enforcement and
    tier preemption run over the virtual clock, and the report grows a
    "gang" section.  The spec lives in the scenario (not a harness flag)
    so the golden-regeneration one-liner needs no per-case arguments."""
    enabled: bool = True

    def validate(self) -> None:
        pass


@dataclass
class Scenario:
    name: str
    duration_s: float = 86_400.0
    start_s: float = 10_000.0        # nonzero so age math never sees t=0
    slo_bind_s: float = 300.0        # time-to-bind SLO for the report
    settle_s: float = 0.0            # post-workload quiesce window
    # cluster substrate
    catalog_size: int = 25
    zones: Tuple[str, ...] = ("zone-a", "zone-b")
    # manager knobs (virtual seconds)
    batch_idle_s: float = 1.0
    batch_max_s: float = 10.0
    node_ready_latency_s: float = 0.0
    intervals: Dict[str, float] = field(
        default_factory=lambda: dict(DEFAULT_SIM_INTERVALS))
    workload: List[Wave] = field(default_factory=list)
    faults: List[Fault] = field(default_factory=list)
    # proactive headroom provisioning (None = Forecast gate stays off)
    forecast: Optional[ForecastSpec] = None
    # deterministic fault injection (None = injector stays disarmed)
    chaos: Optional[ChaosSpec] = None
    # fenced leadership drill (None = HAFailover gate stays off)
    ha: Optional[HASpec] = None
    # SLO recording rules + cost ledger (None = SLOEngine gate stays off)
    slo: Optional[SLOSpec] = None
    # gang scheduling (None = GangScheduling gate stays off)
    gang: Optional[GangSpec] = None

    def validate(self) -> None:
        if not self.name:
            raise ScenarioError("scenario needs a name")
        if self.duration_s <= 0:
            raise ScenarioError("duration_s must be positive")
        if self.catalog_size <= 0:
            raise ScenarioError("catalog_size must be positive")
        if not self.zones:
            raise ScenarioError("at least one zone required")
        if self.batch_idle_s <= 0 or self.batch_max_s < self.batch_idle_s:
            raise ScenarioError(
                "batch windows must satisfy 0 < batch_idle_s <= batch_max_s")
        if not self.workload:
            raise ScenarioError("scenario has no workload waves")
        for w in self.workload:
            w.validate()
        for f in self.faults:
            f.validate()
        if self.forecast is not None:
            self.forecast.validate()
        if self.chaos is not None:
            self.chaos.validate()
        if self.ha is not None:
            self.ha.validate()
        if self.slo is not None:
            self.slo.validate()
        if self.gang is not None:
            self.gang.validate()
        names = [w.name for w in self.workload]
        if len(set(names)) != len(names):
            raise ScenarioError(f"duplicate wave names: {names}")
        for k in self.intervals:
            if k not in DEFAULT_SIM_INTERVALS:
                raise ScenarioError(
                    f"intervals: unknown controller {k!r} (expected one of "
                    f"{sorted(DEFAULT_SIM_INTERVALS)})")


# ---------------------------------------------------------------------------
# YAML loading
# ---------------------------------------------------------------------------

_SCENARIO_SCALARS = {
    "duration_s": float, "start_s": float, "slo_bind_s": float,
    "settle_s": float, "catalog_size": int, "batch_idle_s": float,
    "batch_max_s": float, "node_ready_latency_s": float,
}
_WAVE_FIELDS = {
    "kind": str, "name": str, "base_per_hour": float, "amplitude": float,
    "period_s": float, "phase_s": float, "bucket_s": float,
    "lifetime_s": float, "at_s": float, "count": int, "duration_s": float,
    "cohorts": int, "every_s": float, "runtime_s": float,
    "gang_size": int, "gang_tier": int, "gang_topology": str,
}
_FAULT_FIELDS = {
    "kind": str, "name": str, "at_s": float, "count": int,
    "warning_s": float, "repeat": int, "every_s": float,
    "duration_s": float, "factor": float, "jitter": float,
    "latency_s": float,
}
_FORECAST_FIELDS = {
    "enabled": bool, "horizon_s": float, "lead_s": float, "ttl_s": float,
    "bucket_s": float, "confidence": float, "max_cost_frac": float,
    "model": str, "season_s": float,
}
_CHAOS_RULE_FIELDS = {
    "point": str, "key": str, "action": str, "rate": float, "at_s": float,
    "until_s": float, "latency_s": float, "count": int, "error_code": str,
}
_HA_FIELDS = {
    "enabled": bool, "ttl_s": float,
}
_SLO_FIELDS = {
    "enabled": bool, "eval_cadence_s": float, "drift_threshold": float,
}
_GANG_FIELDS = {
    "enabled": bool,
}


def _coerce(ctx: str, doc: Dict, schema: Dict) -> Dict:
    out = {}
    for key, val in doc.items():
        if key not in schema:
            continue  # handled by caller (ranges, lists) or rejected there
        try:
            out[key] = schema[key](val)
        except (TypeError, ValueError) as e:
            raise ScenarioError(f"{ctx}: field {key!r}={val!r}: {e}") from e
    return out


def _range(ctx: str, val, default: Tuple[int, int]) -> Tuple[int, int]:
    if val is None:
        return default
    if not isinstance(val, (list, tuple)) or len(val) != 2:
        raise ScenarioError(f"{ctx}: expected [lo, hi], got {val!r}")
    return (int(val[0]), int(val[1]))


def scenario_from_dict(doc: Dict) -> Scenario:
    """Lower a parsed YAML document to a validated `Scenario`."""
    if not isinstance(doc, dict):
        raise ScenarioError(f"scenario document must be a mapping, "
                            f"got {type(doc).__name__}")
    known = {"name", "zones", "intervals", "workload", "faults",
             "forecast", "chaos", "ha", "slo", "gang", *_SCENARIO_SCALARS}
    for key in doc:
        if key not in known:
            raise ScenarioError(f"unknown scenario field {key!r} "
                                f"(expected one of {sorted(known)})")
    kw = _coerce("scenario", doc, _SCENARIO_SCALARS)
    kw["name"] = str(doc.get("name", ""))
    if "zones" in doc:
        kw["zones"] = tuple(str(z) for z in doc["zones"])
    if "intervals" in doc:
        if not isinstance(doc["intervals"], dict):
            raise ScenarioError("intervals must be a mapping")
        iv = dict(DEFAULT_SIM_INTERVALS)
        iv.update({str(k): float(v) for k, v in doc["intervals"].items()})
        kw["intervals"] = iv
    waves = []
    for i, w in enumerate(doc.get("workload", []) or []):
        if not isinstance(w, dict):
            raise ScenarioError(f"workload[{i}] must be a mapping")
        ctx = f"workload[{i}]"
        for key in w:
            if key not in _WAVE_FIELDS and key not in ("cpu_m", "mem_mib"):
                raise ScenarioError(f"{ctx}: unknown field {key!r}")
        wkw = _coerce(ctx, w, _WAVE_FIELDS)
        wkw["cpu_m"] = _range(ctx, w.get("cpu_m"), (250, 2000))
        wkw["mem_mib"] = _range(ctx, w.get("mem_mib"), (256, 4096))
        waves.append(Wave(**wkw))
    kw["workload"] = waves
    faults = []
    for i, f in enumerate(doc.get("faults", []) or []):
        if not isinstance(f, dict):
            raise ScenarioError(f"faults[{i}] must be a mapping")
        ctx = f"faults[{i}]"
        for key in f:
            if key not in _FAULT_FIELDS and key != "pools":
                raise ScenarioError(f"{ctx}: unknown field {key!r}")
        fkw = _coerce(ctx, f, _FAULT_FIELDS)
        if "pools" in f:
            fkw["pools"] = [tuple(str(x) for x in p) for p in f["pools"]]
        faults.append(Fault(**fkw))
    kw["faults"] = faults
    if doc.get("forecast") is not None:
        fdoc = doc["forecast"]
        if not isinstance(fdoc, dict):
            raise ScenarioError("forecast must be a mapping")
        for key in fdoc:
            if key not in _FORECAST_FIELDS:
                raise ScenarioError(f"forecast: unknown field {key!r}")
        kw["forecast"] = ForecastSpec(
            **_coerce("forecast", fdoc, _FORECAST_FIELDS))
    if doc.get("chaos") is not None:
        cdoc = doc["chaos"]
        if not isinstance(cdoc, dict):
            raise ScenarioError("chaos must be a mapping")
        for key in cdoc:
            if key not in ("enabled", "seed", "rules"):
                raise ScenarioError(f"chaos: unknown field {key!r}")
        rules = []
        for i, r in enumerate(cdoc.get("rules", []) or []):
            if not isinstance(r, dict):
                raise ScenarioError(f"chaos.rules[{i}] must be a mapping")
            for key in r:
                if key not in _CHAOS_RULE_FIELDS:
                    raise ScenarioError(
                        f"chaos.rules[{i}]: unknown field {key!r}")
            rules.append(ChaosRuleSpec(
                **_coerce(f"chaos.rules[{i}]", r, _CHAOS_RULE_FIELDS)))
        kw["chaos"] = ChaosSpec(
            enabled=bool(cdoc.get("enabled", True)),
            seed=None if cdoc.get("seed") is None else int(cdoc["seed"]),
            rules=rules)
    if doc.get("ha") is not None:
        hdoc = doc["ha"]
        if not isinstance(hdoc, dict):
            raise ScenarioError("ha must be a mapping")
        for key in hdoc:
            if key not in _HA_FIELDS:
                raise ScenarioError(f"ha: unknown field {key!r}")
        kw["ha"] = HASpec(**_coerce("ha", hdoc, _HA_FIELDS))
    if doc.get("slo") is not None:
        sdoc = doc["slo"]
        if not isinstance(sdoc, dict):
            raise ScenarioError("slo must be a mapping")
        for key in sdoc:
            if key not in _SLO_FIELDS:
                raise ScenarioError(f"slo: unknown field {key!r}")
        kw["slo"] = SLOSpec(**_coerce("slo", sdoc, _SLO_FIELDS))
    if doc.get("gang") is not None:
        gdoc = doc["gang"]
        if not isinstance(gdoc, dict):
            raise ScenarioError("gang must be a mapping")
        for key in gdoc:
            if key not in _GANG_FIELDS:
                raise ScenarioError(f"gang: unknown field {key!r}")
        kw["gang"] = GangSpec(**_coerce("gang", gdoc, _GANG_FIELDS))
    sc = Scenario(**kw)
    sc.validate()
    return sc


def load_scenario(path: str) -> Scenario:
    import yaml
    try:
        with open(path) as fh:
            doc = yaml.safe_load(fh)
    except OSError as e:
        raise ScenarioError(f"cannot read scenario {path!r}: {e}") from e
    except yaml.YAMLError as e:
        raise ScenarioError(f"bad YAML in {path!r}: {e}") from e
    return scenario_from_dict(doc)


# ---------------------------------------------------------------------------
# deterministic expansion
# ---------------------------------------------------------------------------

def _make_pod(wave: Wave, name: str, rng: np.random.Generator) -> Pod:
    cpu = int(rng.integers(wave.cpu_m[0], wave.cpu_m[1] + 1))
    mem = int(rng.integers(wave.mem_mib[0], wave.mem_mib[1] + 1)) * 2 ** 20
    return Pod(name=name, uid=name,
               requests=ResourceList({CPU: cpu, MEMORY: mem}),
               labels={"sim.karpenter.sh/wave": wave.name})


def _cohort(wave: Wave, tag: str, n: int, rng: np.random.Generator) -> List[Pod]:
    pods = [_make_pod(wave, f"{wave.name}-{tag}-{j:04d}", rng)
            for j in range(n)]
    if wave.gang_size > 0:
        # consecutive full gangs by pod index — deterministic, no extra
        # rng draws.  The cohort tail past the last full gang stays
        # ungrouped: a permanently-short gang would be unschedulable by
        # construction under all-or-nothing admission.
        full = (n // wave.gang_size) * wave.gang_size
        for j in range(full):
            p = pods[j]
            p.gang_name = f"{wave.name}-{tag}-g{j // wave.gang_size:03d}"
            p.gang_size = wave.gang_size
            p.gang_tier = wave.gang_tier
            p.gang_topology = wave.gang_topology
    return pods


def _expand_wave(wave: Wave, wi: int, sc: Scenario, seed: int
                 ) -> List[Tuple[float, SimEvent]]:
    # one independent stream per wave: inserting a wave never reshuffles
    # the randomness of its siblings
    rng = np.random.default_rng([int(seed), 1000 + wi])
    t0, dur = sc.start_s, sc.duration_s
    out: List[Tuple[float, SimEvent]] = []

    def arrive(at: float, pods: List[Pod], lifetime: float):
        if not pods:
            return
        out.append((at, PodArrival(pods=pods, wave=wave.name)))
        if lifetime > 0:
            out.append((at + lifetime,
                        PodDeparture(uids=[p.uid for p in pods],
                                     wave=wave.name)))

    if wave.kind == "diurnal":
        buckets = int(math.ceil(dur / wave.bucket_s))
        for b in range(buckets):
            rel = b * wave.bucket_s
            width = min(wave.bucket_s, dur - rel)
            mid = rel + width / 2.0
            rate = wave.base_per_hour * (
                1.0 + wave.amplitude * math.sin(
                    2.0 * math.pi * (mid - wave.phase_s) / wave.period_s))
            lam = max(0.0, rate) * width / 3600.0
            n = int(rng.poisson(lam))
            at = t0 + rel + float(rng.uniform(0.0, width))
            arrive(at, _cohort(wave, f"b{b:05d}", n, rng), wave.lifetime_s)
    elif wave.kind == "step":
        at = t0 + wave.at_s
        arrive(at, _cohort(wave, "step", wave.count, rng), wave.duration_s)
    elif wave.kind == "batch":
        for k in range(wave.cohorts):
            at = t0 + wave.at_s + k * wave.every_s
            if at - t0 >= dur:
                break
            arrive(at, _cohort(wave, f"c{k:03d}", wave.count, rng),
                   wave.runtime_s)
    return out


def _expand_fault(fault: Fault, fi: int, sc: Scenario, seed: int
                  ) -> List[Tuple[float, SimEvent]]:
    name = fault.name or f"{fault.kind}-{fi}"
    t0 = sc.start_s
    out: List[Tuple[float, SimEvent]] = []
    if fault.kind == "spot_reclaim_storm":
        for r in range(fault.repeat):
            at = t0 + fault.at_s + r * fault.every_s
            if at - t0 >= sc.duration_s:
                break
            out.append((at, SpotReclaim(count=fault.count,
                                        warning_s=fault.warning_s,
                                        fault=name)))
    elif fault.kind == "ice_window":
        at = t0 + fault.at_s
        out.append((at, IceOpen(pools=list(fault.pools), fault=name)))
        out.append((at + fault.duration_s,
                    IceClose(pools=list(fault.pools), fault=name)))
    elif fault.kind == "price_drift":
        out.append((t0 + fault.at_s,
                    PriceDrift(factor=fault.factor, jitter=fault.jitter,
                               fault=name)))
    elif fault.kind == "api_throttle":
        out.append((t0 + fault.at_s,
                    ApiThrottle(duration_s=fault.duration_s, fault=name)))
    elif fault.kind == "node_ready_latency":
        out.append((t0 + fault.at_s,
                    NodeReadyLatency(latency_s=fault.latency_s, fault=name)))
    return out


def expand(sc: Scenario, seed: int) -> List[Tuple[float, SimEvent]]:
    """Lower the scenario to a flat, time-sorted event list.

    Deterministic: same (scenario, seed) -> identical events, pods, and
    order.  Ties in time keep (workload-before-faults, spec order) — a
    stable key, never object identity."""
    sc.validate()
    entries: List[Tuple[float, int, SimEvent]] = []
    seq = 0
    for wi, wave in enumerate(sc.workload):
        for at, ev in _expand_wave(wave, wi, sc, seed):
            entries.append((at, seq, ev))
            seq += 1
    for fi, fault in enumerate(sc.faults):
        for at, ev in _expand_fault(fault, fi, sc, seed):
            entries.append((at, seq, ev))
            seq += 1
    entries.sort(key=lambda e: (e[0], e[1]))
    return [(at, ev) for at, _, ev in entries]
