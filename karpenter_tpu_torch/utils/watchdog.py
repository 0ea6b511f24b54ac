"""Hard deadlines for device-bound solve calls.

A copy of the JAX package's `utils/watchdog.py`.  Python cannot cancel a
compute-bound thread, so the watchdog runs the guarded call on a daemon
worker and abandons it when the deadline trips: the caller gets
`WatchdogTimeout` immediately (feeding the degradation ladder,
ops/health.py) while the hung call is left to finish or hang in the
background.  `timeout_s <= 0` is a direct call with zero overhead, which is
the default everywhere.  Tracing context crosses the thread boundary via
`TRACER.capture()` / `attach()`, so spans opened inside the guarded call
still parent correctly.  A trip publishes a `watchdog_trip` incident
(obs/incidents.py).
"""

from __future__ import annotations

import threading
from typing import Callable, TypeVar

from ..obs.incidents import publish_incident
from . import metrics

T = TypeVar("T")

# The closed phase registry (graftlint RS003): every literal
# `run_with_deadline(..., phase="<name>")` must name a member so the
# `phase` label of karpenter_watchdog_trips_total stays enumerable.
PHASES = frozenset({
    "provision.solve",
    "disruption.simulate",
    "disruption.sweep",
})


class WatchdogTimeout(RuntimeError):
    """The guarded call outlived its hard deadline and was abandoned."""

    def __init__(self, phase: str, timeout_s: float):
        super().__init__(
            f"watchdog tripped: {phase} exceeded {timeout_s:.3f}s hard "
            "deadline (call abandoned)")
        self.phase = phase
        self.timeout_s = timeout_s


def run_with_deadline(fn: Callable[[], T], timeout_s: float,
                      phase: str) -> T:
    """Run `fn` under a hard deadline.  `timeout_s <= 0` calls `fn`
    directly (no thread).  On a trip, increments
    karpenter_watchdog_trips_total{phase} and raises `WatchdogTimeout`; the worker
    thread is abandoned (daemon) — its eventual result is discarded and
    its eventual exception swallowed."""
    if phase not in PHASES:
        raise ValueError(f"unregistered watchdog phase {phase!r} "
                         f"(expected one of {sorted(PHASES)})")
    if timeout_s is None or timeout_s <= 0:
        return fn()
    from . import tracing
    parent = tracing.TRACER.capture()
    box: dict = {}
    done = threading.Event()

    def worker() -> None:
        try:
            with tracing.TRACER.attach(parent):
                box["value"] = fn()
        except BaseException as e:  # delivered to the caller below
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=worker, name=f"watchdog:{phase}",
                         daemon=True)
    t.start()
    done.wait(timeout_s)
    if not done.is_set():
        metrics.watchdog_trips().inc({"phase": phase})
        publish_incident("watchdog_trip",
                         {"phase": phase, "timeout_s": timeout_s})
        raise WatchdogTimeout(phase, timeout_s)
    t.join()  # worker is past its try block; join returns immediately
    if "error" in box:
        raise box["error"]
    return box["value"]
