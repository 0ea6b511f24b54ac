"""Deterministic virtual-clock cluster simulator (the port of the JAX
package's `sim/`; the controllers solve on the card).

Wires the *real* controller stack (provisioning, disruption, interruption,
lifecycle, termination, garbage collection) plus `FakeCloud` onto a shared
`VirtualClock` driven by an event heap, so days of cluster time replay in
seconds of wall time with zero sleeps.  The evaluation bed CvxCluster and
"Priority Matters" (PAPERS.md) use for allocation policies, grown here for
the karpenter-tpu stack.

Layout:
  * clock.py    — `VirtualClock` (the injectable clock callable) and the
                  deterministic `EventHeap`;
  * events.py   — typed simulation events (pod arrival/departure, spot
                  reclaim with its 2-minute warning, ICE windows, price
                  drift, node-ready latency, API throttle bursts);
  * scenario.py — declarative scenario spec (YAML or dataclass) expanded
                  deterministically from a seed;
  * harness.py  — the event loop: advance the clock to the next event,
                  deliver it, tick the controller stack, append to the
                  event log;
  * report.py   — the one-JSON-document run report (cost integral,
                  time-to-bind percentiles, churn, SLO/provenance rollups).

CLI: ``python -m karpenter_tpu_torch.sim scenarios/diurnal.yaml --seed 0``.
See docs/simulation.md for the schema and report glossary.

The names below load their module at first use: the scenario modules are
host code, and `tools/simcheck.py`, which needs only them, imports neither
the controller stack nor torch.
"""

import importlib

_SOURCES = {
    "EventHeap": "clock", "VirtualClock": "clock",
    "SimHarness": "harness", "SimRun": "harness",
    "Scenario": "scenario", "ScenarioError": "scenario",
    "expand": "scenario", "load_scenario": "scenario",
    "build_report": "report", "report_to_json": "report",
}
_SUBMODULES = frozenset({"clock", "events", "harness", "report", "scenario"})

__all__ = [
    "EventHeap", "VirtualClock", "SimHarness", "SimRun",
    "Scenario", "ScenarioError", "expand", "load_scenario",
    "build_report", "report_to_json",
]


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name not in _SOURCES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_SOURCES[name]}"),
                    name)
    globals()[name] = value
    return value
