"""Simulation report: one deterministic JSON document per run.

Everything in the report derives from virtual time and harness-tracked
state — cost integral in $·h, pod time-to-bind percentiles, node churn and
disruption counts by reason, SLO-violation and unschedulable-provenance
rollups.  Wall-clock measurements (speedup) are deliberately excluded so
two same-seed runs serialize byte-identically; they live on `SimRun`
instead.

A copy of the JAX package's `sim/report.py` with every ungated section and
the gated `forecast`, `chaos`, `ha`, `incidents`, `slo.budgets`, `ledger`,
cost-breakdown and `gang` sections.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence


def percentile(sorted_values: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile over an already-sorted sequence
    (numpy's default method, inlined so the report never depends on float
    printing quirks of array scalars)."""
    if not sorted_values:
        return 0.0
    if len(sorted_values) == 1:
        return float(sorted_values[0])
    pos = (len(sorted_values) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(sorted_values) - 1)
    frac = pos - lo
    return float(sorted_values[lo] * (1 - frac) + sorted_values[hi] * frac)


def _r(x: float, digits: int = 4) -> float:
    return round(float(x), digits)


def build_report(harness) -> Dict:
    """Assemble the report from a finished `SimHarness`."""
    from ..forecast.headroom import is_headroom
    sc = harness.scenario
    binds: List[float] = sorted(harness._bind_t.values())
    arrived = len(harness._arrive_t)
    bound = len(binds)
    # pods placed on a node still booting at sim end never started running:
    # they are pending, not bound (their bind clock stops at NodeReady)
    # — headroom placeholders are capacity reservations, not workload, so
    # they never count as pending (with forecast off this filter is a no-op)
    still_booting = sum(
        1 for uids in harness._booting.values() for uid in uids
        if uid not in harness._bind_t and uid in harness.cluster.pods
        and not is_headroom(harness.cluster.pods[uid]))
    pending_at_end = sum(
        1 for p in harness.cluster.pending_pods()
        if not is_headroom(p)) + still_booting
    slo = sc.slo_bind_s
    late = sum(1 for b in binds if b > slo)
    # pods that never bound and are still waiting (or left unbound) breach
    # the SLO just as surely as a late bind
    violations = late + pending_at_end + harness._departed_unbound

    with harness.cloud._lock:
        instances = list(harness.cloud._instances.values())
    launched = len(instances)
    terminated = sum(1 for i in instances if i.state != "running")
    running_at_end = launched - terminated

    provenance: Dict[str, int] = {}
    for rec in harness.op.provenance.all():
        provenance[rec.constraint] = provenance.get(rec.constraint, 0) + 1

    total_reclaims = harness._reclaims_honored + harness._reclaims_forced
    virtual = harness.clock.now() - sc.start_s
    virtual_h = virtual / 3600.0 if virtual > 0 else 1.0

    report = {
        "scenario": sc.name,
        "seed": harness.seed,
        "virtual_seconds": _r(virtual, 3),
        "workload": {
            "pods_arrived": arrived,
            "pods_bound": bound,
            "pods_pending_at_end": pending_at_end,
            "pods_departed_unbound": harness._departed_unbound,
        },
        "time_to_bind_s": {
            "p50": _r(percentile(binds, 0.50), 3),
            "p95": _r(percentile(binds, 0.95), 3),
            "p99": _r(percentile(binds, 0.99), 3),
            "max": _r(binds[-1], 3) if binds else 0.0,
            "mean": _r(sum(binds) / len(binds), 3) if binds else 0.0,
        },
        "slo": {
            "bind_slo_s": _r(slo, 3),
            "violations": violations,
            "violation_rate": _r(violations / arrived, 6) if arrived else 0.0,
        },
        "cost": {
            "dollar_hours": _r(harness._cost_dollar_hours, 4),
            "dollars_per_hour_avg": _r(
                harness._cost_dollar_hours / virtual_h, 4),
            "node_hours": _r(harness._node_hours, 4),
            "peak_nodes": harness._peak_nodes,
        },
        "churn": {
            "nodes_launched": launched,
            "nodes_terminated": terminated,
            "nodes_running_at_end": running_at_end,
            "disruption_actions": dict(sorted(harness._disruptions.items())),
            "interruption_recycled": harness._interruption_recycled,
            "liveness_terminated": harness._liveness_terminated,
        },
        "spot": {
            "warnings": harness._warnings,
            "reclaims": total_reclaims,
            "reclaims_honored": harness._reclaims_honored,
            "reclaims_forced": harness._reclaims_forced,
            "warning_honor_rate": _r(
                harness._reclaims_honored / total_reclaims, 6)
                if total_reclaims else 1.0,
        },
        "events": {
            "total": sum(harness._events_by_kind.values()),
            "by_kind": dict(sorted(harness._events_by_kind.items())),
        },
        "unschedulable_provenance": dict(sorted(provenance.items())),
        "errors": {
            "tick_exceptions": harness._tick_exceptions,
        },
    }
    forecast = harness.mgr.controllers.get("forecast")
    if forecast is not None:
        # present ONLY when the Forecast gate ran — reports without the
        # gate carry no forecast section at all
        report["forecast"] = {k: forecast.stats[k]
                              for k in sorted(forecast.stats)}
    if getattr(harness, "_chaos_enabled", False):
        # present ONLY when the scenario armed the injector, so every
        # chaos-off report stays byte-identical.  Everything here is
        # deterministic: injection counts come from the seeded schedule,
        # supervisor and ladder totals from virtual-clock state machines.
        from ..utils.chaos import CHAOS
        sups = getattr(harness.mgr, "supervisors", {})
        chaos_sec = {
            "injections": CHAOS.counts(),
            "injections_total": CHAOS.fired_total(),
            "controller_failures": {
                n: s.total_failures for n, s in sorted(sups.items())
                if s.total_failures},
            "controller_skips": {
                n: s.total_skips for n, s in sorted(sups.items())
                if s.total_skips},
            "quarantines": {
                n: s.total_quarantines for n, s in sorted(sups.items())
                if s.total_quarantines},
        }
        prov = harness.mgr.controllers.get("provisioning")
        health = getattr(prov, "health", None)
        if health is not None:
            chaos_sec["solver_transitions"] = dict(
                sorted(health.transitions.items()))
        report["chaos"] = chaos_sec
    if getattr(harness, "_ha_enabled", False):
        # present ONLY when the HAFailover gate ran — same conditional
        # contract as forecast/chaos, so every HA-off report stays
        # byte-identical.  Everything is deterministic: lease transitions
        # follow the virtual clock and the chaos schedule, fencing
        # refusals the seeded injections.
        leader = harness.leader
        mgr = harness.mgr
        fence = getattr(mgr, "fence", None)
        report["ha"] = {
            "acquisitions": leader.acquisitions,
            "losses": leader.losses,
            "releases": leader.releases,
            "fence_epoch": leader.fence_epoch(),
            "lease_errors": mgr._lease_errors,
            "skipped_ticks": mgr._skipped_ticks,
            "midtick_aborts": mgr._midtick_aborts,
            "promotions": mgr.promotions,
            "phase_at_end": mgr.phase,
            "fence_refusals": dict(sorted(fence.refusals.items()))
            if fence is not None else {},
        }
    if getattr(harness, "_fr_enabled", False) and \
            getattr(harness.mgr, "flight", None) is not None:
        # present ONLY when the FlightRecorder gate ran — same conditional
        # contract as forecast/chaos/ha, so every recorder-off report
        # (all pre-existing goldens) stays byte-identical.  The summary is
        # deterministic: bundle ids are virtual-clock millisecond stamps,
        # dedup windows follow the same clock, and no wall-clock payloads
        # (trace timings, health latencies) are included.
        report["incidents"] = harness.mgr.flight.summary()
    if getattr(harness, "_slo_enabled", False) and \
            getattr(harness.mgr, "slo", None) is not None:
        # present ONLY when the SLOEngine gate ran — same conditional
        # contract as forecast/chaos/ha/incidents, so every gate-off
        # report (all pre-existing goldens) stays byte-identical.  The
        # budgets ride as a sub-key of the existing "slo" section (which
        # every golden already carries); "ledger" and the cost breakdowns
        # are new keys and therefore safely absent gate-off.  The ledger
        # summary is taken at the sim-end clock so open entries accrue to
        # exactly the instant the cost integral stopped — per-source
        # expected $·h sums match `cost.dollar_hours` to within the
        # launch-intent-vs-landing (ICE) divergence.
        from ..obs.ledger import LEDGER
        report["slo"]["budgets"] = harness.mgr.slo.summary()
        ledger_sum = LEDGER.summary(harness.clock.now())
        report["ledger"] = ledger_sum
        report["cost"]["by_nodepool"] = {
            k: v["realized_dh"]
            for k, v in ledger_sum["by_nodepool"].items()}
        report["cost"]["by_decision_source"] = {
            k: v["realized_dh"]
            for k, v in ledger_sum["by_decision_source"].items()}
    if getattr(harness, "_gang_enabled", False):
        # present ONLY when the GangScheduling gate ran — same conditional
        # contract as forecast/chaos/ha/incidents/slo, so every gate-off
        # report (all pre-existing goldens) stays byte-identical.  The
        # time-to-full percentiles come from the harness sampler (virtual
        # clock); admission/preemption counters from the provisioner's
        # gang registry, which the sim drives deterministically.
        fulls: List[float] = sorted(harness._gang_full_t.values())
        gang_sec: Dict = {
            "gangs_seen": len(harness._gang_arrive_t),
            "gangs_full": len(fulls),
            "time_to_full_gang_s": {
                "p50": _r(percentile(fulls, 0.50), 3),
                "p95": _r(percentile(fulls, 0.95), 3),
                "max": _r(fulls[-1], 3) if fulls else 0.0,
            },
        }
        prov = harness.mgr.controllers.get("provisioning")
        registry = getattr(prov, "gang_registry", None)
        if registry is not None:
            summary = registry.summary()
            gang_sec["admissions"] = sum(
                g["admissions"] for g in summary.values())
            gang_sec["rejections"] = sum(
                g["rejections"] for g in summary.values())
            gang_sec["preempted_pods"] = sum(
                g["preempted"] for g in summary.values())
            gang_sec["rejected_gangs_at_end"] = sorted(
                n for n, g in summary.items()
                if not g["admitted"] and g["rejections"])
        report["gang"] = gang_sec
    return report


def report_to_json(report: Dict) -> str:
    """Canonical serialization: sorted keys, two-space indent, trailing
    newline — the byte-identical artifact the determinism tests and golden
    files compare."""
    return json.dumps(report, sort_keys=True, indent=2) + "\n"
