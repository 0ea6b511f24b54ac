"""Flight recorder: incident trigger bus, metric history ring, bundles.

A copy of the JAX package's `obs/` package.  The fault-handling stack
(supervisor circuits, watchdogs, the solver and decode ladders, fencing
refusals, cold-restore fallbacks) already *counts* everything, but
counters are point-in-time: by the time a human looks at a 3am
circuit-open, the evidence is gone.  This package captures it at the
moment of the trip:

  * `incidents` — the process-global trigger bus every trip site
    publishes to (`publish_incident`).  Disarmed by default: a single
    boolean check and the trip site has paid its entire cost.
  * `ring` — a bounded metrics time-series ring sampled on the
    *injectable* clock, so the sim records virtual time deterministically.
  * `bundle` — atomic (tmp + os.replace) forensic bundle files with
    bounded retention and corruption-tolerant read-back.
  * `recorder` — the `FlightRecorder` that ties them together behind the
    `FlightRecorder` feature gate (default off; gate-off runs are
    byte-identical).
  * `slo` — the declarative SLI registry + error-budget/burn-rate engine
    evaluated as recording rules over the ring (the `SLOEngine` gate).
  * `ledger` — the per-decision cost ledger attributing $·h to the
    launch/terminate decisions that spent it, with expected-vs-realized
    drift detection (same gate as `slo`).

Everything here is host work over the metric registry: no module of the
package synchronizes the card or copies a tensor back from it.

Import discipline: `incidents` is stdlib-only so the low-level trip
sites (utils/watchdog.py, utils/fencing.py, ops/health.py, …) can import
it without cycles; `ledger` and `slo` keep their utils.metrics imports
lazy for the same reason (the provider's launch funnel hooks the
ledger); only `recorder` reaches back into utils eagerly.
"""

from .incidents import BUS, INCIDENT_KINDS, IncidentBus, publish_incident
from .ledger import DECISION_SOURCES, LEDGER, CostLedger

__all__ = ["BUS", "INCIDENT_KINDS", "IncidentBus", "publish_incident",
           "DECISION_SOURCES", "LEDGER", "CostLedger"]
