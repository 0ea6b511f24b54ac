"""Declarative SLI registry + error-budget / burn-rate engine.

A copy of the JAX package's `obs/slo.py`, its SLIs and burn windows byte
for byte.  Like the reference's, the engine counts the whole history of
the process-global registry when it is armed, and `tick_duration` reads
wall-clock reconcile time.

The repo *records* everything (metric ring, trace ring, incident
bundles) but *judges* nothing: no layer turns raw counters into "are we
meeting our objectives, and how fast are we spending the error budget".
This module is that layer, computed entirely as recording rules over the
existing `MetricsRing` — windowed counter deltas and gauge samples on
the *injectable* clock, so the sim evaluates 4 virtual hours of SLOs
deterministically and DT001 never sees a wall read.

Three SLI computation modes cover the registry:

  * ``histogram_threshold`` — good = observations in the cumulative
    bucket at ``threshold`` (``F_bucket{le=...}``), total = ``F_count``;
    time-to-bind and tick-duration SLIs.
  * ``counter_ratio`` — bad/good counter families summed across labels;
    unschedulable-ratio and fence-refusal SLIs.
  * ``gauge_uptime`` — fraction of evaluations where every series of a
    gauge family sits at-or-below ``max_value`` (absent series = healthy,
    the gauge was never set); solver/decode ladder uptime.

Error budgets accumulate from registry tips with a counter-reset guard
(a warm restart zeroes the registry; ``tip < last_seen`` treats the tip
itself as the delta, so pre-restart history — restored from the
snapshot's ``slo`` section — is never double-counted).  Burn rates are
evaluated multi-window multi-burn-rate (SRE workbook): a fast 5m/1h
pair at 14.4x and a slow 30m/6h pair at 6x; an alert activates only
when BOTH windows of a pair burn, and the activation edge publishes one
``slo_burn`` incident through the `IncidentBus` — whose per-kind dedup
turns a flapping burn into exactly one bundle per window.

graftlint OB007 reads ``DEFAULT_SLIS`` statically: every family literal
in an ``SLI(...)`` spec must resolve to a registered metric family.
"""

from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .incidents import publish_incident
from .ring import MetricsRing

# (short_window_s, long_window_s, burn-rate threshold) — the SRE-workbook
# pairing: the fast pair catches cliffs, the slow pair slow leaks.
BURN_WINDOW_PAIRS: Tuple[Tuple[float, float, float], ...] = (
    (300.0, 3600.0, 14.4),
    (1800.0, 21600.0, 6.0),
)

SLI_MODES = ("histogram_threshold", "counter_ratio", "gauge_uptime")


@dataclass(frozen=True)
class SLI:
    """One service-level indicator, declared against literal metric
    family names (the OB007 contract: every name here must be a
    registered family, modulo the ``_count``/``_bucket``/``_sum``
    histogram suffixes)."""
    name: str
    objective: float                 # e.g. 0.99 → 1% error budget
    mode: str
    description: str = ""
    families: Tuple[str, ...] = ()   # histogram_threshold / gauge_uptime
    bad_families: Tuple[str, ...] = ()    # counter_ratio numerator
    good_families: Tuple[str, ...] = ()   # counter_ratio denominator part
    threshold: float = 0.0           # histogram_threshold bucket bound
    max_value: float = 0.0           # gauge_uptime healthy ceiling

    def validate(self) -> None:
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"SLI {self.name}: objective must be in (0,1)")
        if self.mode not in SLI_MODES:
            raise ValueError(f"SLI {self.name}: unknown mode {self.mode!r}")
        if self.mode in ("histogram_threshold", "gauge_uptime") \
                and not self.families:
            raise ValueError(f"SLI {self.name}: needs families")
        if self.mode == "counter_ratio" and not self.bad_families:
            raise ValueError(f"SLI {self.name}: needs bad_families")

    def all_families(self) -> Tuple[str, ...]:
        return self.families + self.bad_families + self.good_families


DEFAULT_SLIS: Tuple[SLI, ...] = (
    SLI(name="bind_latency", objective=0.99, mode="histogram_threshold",
        families=("karpenter_pods_bound_duration_seconds",),
        threshold=10.0,
        description="pods bound within the latency bucket bound"),
    SLI(name="tick_duration", objective=0.99, mode="histogram_threshold",
        families=("controller_runtime_reconcile_time_seconds",),
        threshold=1.0,
        description="controller reconciles completing within 1s"),
    SLI(name="unschedulable_ratio", objective=0.95, mode="counter_ratio",
        bad_families=("karpenter_provenance_records_total",),
        good_families=("karpenter_pods_bound_duration_seconds_count",),
        description="pods placed vs unschedulable-provenance records"),
    SLI(name="solver_uptime", objective=0.999, mode="gauge_uptime",
        families=("karpenter_degradation_active_rung",),
        max_value=2.0,
        description="solver ladder above the greedy floor"),
    SLI(name="decode_uptime", objective=0.999, mode="gauge_uptime",
        families=("karpenter_decode_demoted",),
        max_value=0.0,
        description="device decode not demoted to host assembly"),
    SLI(name="fence_refusal", objective=0.999, mode="counter_ratio",
        bad_families=("karpenter_leader_fence_refusals_total",),
        good_families=("karpenter_nodeclaims_launched",
                       "karpenter_snapshot_writes_total"),
        description="guarded mutations vs stale-fence refusals"),
)


def _family_series_sum(snap: Dict[str, float], family: str) -> float:
    """Sum every series of `family` in one ring payload (exact name or
    any labeled variant)."""
    total = snap.get(family, 0.0)
    prefix = family + "{"
    for key, value in snap.items():
        if key.startswith(prefix):
            total += value
    return total


def _bucket_series_sum(snap: Dict[str, float], family: str,
                       threshold: float) -> float:
    """Cumulative-bucket sum for `family` at `le=threshold` across all
    label sets (series keys carry sorted labels, so ``le=`` may sit
    anywhere inside the braces)."""
    needle = f'le="{threshold!r}"'
    prefix = f"{family}_bucket{{"
    total = 0.0
    for key, value in snap.items():
        if key.startswith(prefix) and needle in key:
            total += value
    return total


@dataclass
class _BudgetState:
    """Cumulative good/bad accounting for one SLI, with the last-seen
    tips the counter-reset guard compares against."""
    bad: float = 0.0
    total: float = 0.0
    last_bad_tip: float = 0.0
    last_total_tip: float = 0.0
    alert_active: bool = False
    alerts: int = 0
    last_burns: Dict[str, float] = field(default_factory=dict)


def _guarded_delta(tip: float, last: float) -> float:
    """Counter delta with restart guard: a tip below the last-seen value
    means the registry reset (kill -9 warm restart) — the tip itself is
    the post-restart delta."""
    return tip - last if tip >= last else tip


class SLOEngine:
    """Recording rules + error budgets + multi-window burn alerts over a
    `MetricsRing`.  Mirrors the `FlightRecorder` lifecycle: constructed
    by the manager under the `SLOEngine` gate, ticked from the manager
    loop, snapshot/restored through the operator snapshot's ``slo``
    section.  When the flight recorder is also armed the engine shares
    its ring (one sampling pass); otherwise it owns one and samples it
    on its own cadence."""

    def __init__(self, clock: Callable[[], float], *,
                 registry=None,
                 ring: Optional[MetricsRing] = None,
                 slis: Tuple[SLI, ...] = DEFAULT_SLIS,
                 eval_cadence_s: float = 60.0,
                 sample_cadence_s: float = 30.0,
                 ring_slots: int = 512,
                 window_pairs: Tuple[Tuple[float, float, float], ...]
                 = BURN_WINDOW_PAIRS):
        if registry is None:
            from ..utils import metrics
            registry = metrics.REGISTRY
        for sli in slis:
            sli.validate()
        self._clock = clock
        self.registry = registry
        self._owns_ring = ring is None
        self.ring = ring if ring is not None else MetricsRing(
            clock, cadence_s=sample_cadence_s, slots=ring_slots)
        self.slis = tuple(slis)
        self.eval_cadence_s = float(eval_cadence_s)
        self.window_pairs = tuple(window_pairs)
        self._budget: Dict[str, _BudgetState] = {
            s.name: _BudgetState() for s in self.slis}
        self._last_eval: Optional[float] = None
        self._window_cache: Dict = {}
        # per-SLI {sample_t: healthy} memo — a ring sample is immutable,
        # so its gauge verdict never changes; without this every eval
        # re-scans every sample in the 6h window against the registry
        self._gauge_memo: Dict[str, Dict[float, bool]] = {}
        self.evals = 0

    # ---- tick -------------------------------------------------------------
    def tick(self) -> bool:
        """Sample (when the engine owns its ring) and evaluate on the
        cadence.  Returns True iff an evaluation ran."""
        now = self._clock()
        if self._owns_ring:
            self.ring.sample(self.registry)
        if self._last_eval is not None and \
                (now - self._last_eval) < self.eval_cadence_s:
            return False
        if not len(self.ring):
            return False
        self._last_eval = now
        self.evals += 1
        tip = self._tip_snap()
        from ..utils import metrics
        metrics.slo_evaluations().inc()
        # one ring scan per unique window per eval, shared by every SLI
        # (deltas sorts the whole tip payload — per-SLI recomputation
        # would multiply that by the registry size)
        self._window_cache = {}
        for sli in self.slis:
            self._evaluate(sli, tip, now)
        self._window_cache = {}
        return True

    def _tip_snap(self) -> Dict[str, float]:
        # newest ring payload = the registry as of the latest sample
        return self.ring.tip()[1] if len(self.ring) else {}

    # ---- per-SLI evaluation ----------------------------------------------
    def _counters_of(self, sli: SLI, snap: Dict[str, float]
                     ) -> Tuple[float, float]:
        """(bad, total) cumulative counters for one SLI from one ring
        payload."""
        if sli.mode == "histogram_threshold":
            family = sli.families[0]
            total = _family_series_sum(snap, f"{family}_count")
            good = _bucket_series_sum(snap, family, sli.threshold)
            return max(0.0, total - good), total
        if sli.mode == "counter_ratio":
            bad = sum(_family_series_sum(snap, f)
                      for f in sli.bad_families)
            good = sum(_family_series_sum(snap, f)
                       for f in sli.good_families)
            return bad, bad + good
        raise AssertionError(sli.mode)   # gauge_uptime handled separately

    def _gauge_healthy(self, sli: SLI, snap: Dict[str, float]) -> bool:
        """Every series of the gauge family at-or-below the ceiling;
        absent series are healthy (the gauge was never set)."""
        for family in sli.families:
            if snap.get(family, 0.0) > sli.max_value:
                return False
            prefix = family + "{"
            for key, value in snap.items():
                if key.startswith(prefix) and value > sli.max_value:
                    return False
        return True

    def _evaluate(self, sli: SLI, tip: Dict[str, float],
                  now: float) -> None:
        from ..utils import metrics
        state = self._budget[sli.name]
        budget_frac = 1.0 - sli.objective
        if sli.mode == "gauge_uptime":
            healthy = self._gauge_healthy(sli, tip)
            state.total += 1.0
            if not healthy:
                state.bad += 1.0
            burns = self._gauge_burns(sli, now, budget_frac)
        else:
            bad_tip, total_tip = self._counters_of(sli, tip)
            state.bad += max(0.0, _guarded_delta(bad_tip,
                                                 state.last_bad_tip))
            state.total += max(0.0, _guarded_delta(total_tip,
                                                   state.last_total_tip))
            state.last_bad_tip = bad_tip
            state.last_total_tip = total_tip
            burns = self._counter_burns(sli, now, budget_frac)
        state.last_burns = burns
        for window, burn in burns.items():
            metrics.slo_burn_rate().set(burn, {"slo": sli.name,
                                               "window": window})
        metrics.slo_budget_remaining().set(
            self._budget_remaining(sli, state), {"slo": sli.name})
        self._update_alert(sli, state, burns, now)

    def _window_deltas(self, window_s: float, now: float) -> Dict[str, float]:
        key = ("d", window_s)
        cached = self._window_cache.get(key)
        if cached is None:
            cached = self.ring.deltas(window_s, now)["changed"]
            self._window_cache[key] = cached
        return cached

    def _window_samples(self, window_s: float, now: float):
        key = ("w", window_s)
        cached = self._window_cache.get(key)
        if cached is None:
            cached = self.ring.window(now - window_s, now)
            self._window_cache[key] = cached
        return cached

    def _counter_burns(self, sli: SLI, now: float,
                       budget_frac: float) -> Dict[str, float]:
        burns: Dict[str, float] = {}
        for short_s, long_s, _thr in self.window_pairs:
            for window_s in (short_s, long_s):
                key = f"{int(window_s)}s"
                if key in burns:
                    continue
                delta = self._window_deltas(window_s, now)
                bad_w, total_w = self._counters_of(sli, delta)
                if total_w <= 0.0:
                    burns[key] = 0.0
                else:
                    burns[key] = round(
                        (bad_w / total_w) / budget_frac, 6)
        return burns

    def _gauge_burns(self, sli: SLI, now: float,
                     budget_frac: float) -> Dict[str, float]:
        memo = self._gauge_memo.setdefault(sli.name, {})
        max_w = max(long_s for _s, long_s, _t in self.window_pairs)
        samples = self._window_samples(max_w, now)
        for t, snap in samples:
            if t not in memo:
                memo[t] = self._gauge_healthy(sli, snap)
        if len(memo) > 2 * len(samples) + 16:
            cutoff = now - max_w
            for t in [t for t in memo if t < cutoff]:
                del memo[t]
        # samples are time-ordered: one prefix-sum of bad verdicts serves
        # every window via bisect instead of a scan per window
        ts = [t for t, _snap in samples]
        bad_prefix = [0]
        for t in ts:
            bad_prefix.append(bad_prefix[-1] + (0 if memo[t] else 1))
        burns: Dict[str, float] = {}
        for short_s, long_s, _thr in self.window_pairs:
            for window_s in (short_s, long_s):
                key = f"{int(window_s)}s"
                if key in burns:
                    continue
                i = bisect_left(ts, now - window_s)
                count = len(ts) - i
                if count <= 0:
                    burns[key] = 0.0
                    continue
                bad = bad_prefix[-1] - bad_prefix[i]
                burns[key] = round(
                    (bad / count) / budget_frac, 6)
        return burns

    def _update_alert(self, sli: SLI, state: _BudgetState,
                      burns: Dict[str, float], now: float) -> None:
        active = any(
            burns.get(f"{int(short_s)}s", 0.0) > thr and
            burns.get(f"{int(long_s)}s", 0.0) > thr
            for short_s, long_s, thr in self.window_pairs)
        if active and not state.alert_active:
            state.alerts += 1
            from ..utils import metrics
            metrics.slo_burn_alerts().inc({"slo": sli.name})
            publish_incident("slo_burn", {
                "slo": sli.name, "objective": sli.objective,
                "burns": dict(sorted(burns.items())),
                "budget_remaining": round(
                    self._budget_remaining(sli, state), 6),
                "at": now})
        state.alert_active = active

    @staticmethod
    def _budget_remaining(sli: SLI, state: _BudgetState) -> float:
        if state.total <= 0.0:
            return 1.0
        consumed = (state.bad / state.total) / (1.0 - sli.objective)
        return 1.0 - consumed

    # ---- surfaces ---------------------------------------------------------
    def summary(self) -> Dict:
        """Deterministic rollup for /debug/slo and the sim report's
        gated ``slo.budgets`` sub-section."""
        slos: Dict[str, Dict] = {}
        for sli in self.slis:
            state = self._budget[sli.name]
            slos[sli.name] = {
                "objective": sli.objective,
                "mode": sli.mode,
                "bad": round(state.bad, 6),
                "total": round(state.total, 6),
                "budget_remaining": round(
                    self._budget_remaining(sli, state), 6),
                "burn": dict(sorted(state.last_burns.items())),
                "alerting": state.alert_active,
                "alerts": state.alerts,
            }
        return {"evaluations": self.evals,
                "ring_samples": len(self.ring),
                "slos": slos}

    # ---- warm-restart support (the `slo` snapshot section) ----------------
    def snapshot_state(self) -> Dict:
        return {
            "last_eval": self._last_eval,
            "evals": self.evals,
            "ring": self.ring.snapshot_state() if self._owns_ring else None,
            "budgets": {
                name: {"bad": st.bad, "total": st.total,
                       "last_bad_tip": st.last_bad_tip,
                       "last_total_tip": st.last_total_tip,
                       "alert_active": st.alert_active,
                       "alerts": st.alerts,
                       "last_burns": dict(st.last_burns)}
                for name, st in sorted(self._budget.items())},
        }

    def restore_state(self, state: Dict) -> None:
        last_eval = state.get("last_eval")
        self._last_eval = float(last_eval) if last_eval is not None else None
        self.evals = int(state.get("evals", 0))
        if self._owns_ring and state.get("ring") is not None:
            self.ring.restore_state(state["ring"])
        for name, st in state.get("budgets", {}).items():
            cur = self._budget.get(name)
            if cur is None:
                continue    # SLI registry changed across restart
            cur.bad = float(st.get("bad", 0.0))
            cur.total = float(st.get("total", 0.0))
            cur.last_bad_tip = float(st.get("last_bad_tip", 0.0))
            cur.last_total_tip = float(st.get("last_total_tip", 0.0))
            cur.alert_active = bool(st.get("alert_active", False))
            cur.alerts = int(st.get("alerts", 0))
            cur.last_burns = {str(k): float(v) for k, v
                              in dict(st.get("last_burns", {})).items()}
