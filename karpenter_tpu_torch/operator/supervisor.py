"""Per-controller supervision: crash-loop backoff and circuit breaking.

The manager's tick loop used to retry a crash-looping controller at full
cadence forever (`except Exception: log` and move on) — a poisoned
controller burned its whole interval budget re-raising the same error
and, worse, a *hung* one froze everybody behind the state lock.  The
supervisor gives each `_entries` controller an isolated failure budget:

  * consecutive failures back the controller off exponentially with
    deterministic jitter (no RNG — the jitter is a hash of the
    controller name and failure count, so the sim's virtual-clock runs
    stay byte-identical);
  * after `circuit_threshold` consecutive failures the circuit OPENS
    (quarantine): the controller is skipped until the backoff window
    expires, then probed half-open — one success closes the circuit,
    one failure re-opens it for a longer window;
  * every OTHER controller keeps its normal interval throughout — the
    skip happens per entry inside the tick, never by stalling the tick.

State is exported via gauges (only written on the failure/recovery path),
`/debug/health` snapshots, a "controller quarantined: <last error>"
Recorder event and a `circuit_open` incident when the circuit opens.

A copy of the JAX package's `operator/supervisor.py`;
`snapshot_state` / `restore_state` are each supervisor's part of the
warm-restart snapshot (state/snapshot.py).  The manager never books a fault
of the card or of a kernel here: it re-raises them first
(`manager.ControllerManager`).
"""

from __future__ import annotations

import logging
import zlib
from dataclasses import dataclass
from typing import Dict, Optional

from ..obs.incidents import publish_incident
from ..utils import metrics

log = logging.getLogger("karpenter_tpu_torch.supervisor")

# Circuit states, also the gauge encoding.
CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


def _jitter(name: str, failures: int) -> float:
    """Deterministic jitter factor in [0.5, 1.0): a hash, not an RNG, so
    supervised runs replay byte-identically under the sim clock while
    distinct controllers still decorrelate their retry storms."""
    h = zlib.crc32(f"{name}:{failures}".encode()) & 0xFFFFFFFF
    return 0.5 + (h / 2**32) * 0.5


@dataclass(frozen=True)
class BackoffPolicy:
    base_s: float = 1.0
    factor: float = 2.0
    max_s: float = 300.0

    def delay(self, name: str, failures: int) -> float:
        raw = min(self.max_s, self.base_s * self.factor ** max(0, failures - 1))
        return raw * _jitter(name, failures)


class ControllerSupervisor:
    """Failure bookkeeping for one controller.  All calls happen under
    the manager's state lock, from the tick loop."""

    def __init__(self, name: str, policy: Optional[BackoffPolicy] = None,
                 circuit_threshold: int = 5, recorder=None):
        self.name = name
        self.policy = policy or BackoffPolicy()
        self.circuit_threshold = max(1, int(circuit_threshold))
        self.recorder = recorder
        self.state = CLOSED
        self.failures = 0          # consecutive, since last success
        self.retry_at = float("-inf")
        self.last_error = ""
        self.total_failures = 0
        self.total_skips = 0
        self.total_quarantines = 0

    # ------------------------------------------------------------------
    def allow(self, now: float) -> bool:
        """True when the controller may reconcile now.  Inside a backoff
        window the attempt is counted as a skip (the entry's `last_run`
        must NOT advance, so cadence resumes immediately on recovery).
        An expired open circuit becomes a half-open probe."""
        if self.failures == 0:
            return True  # fast path: healthy controller, no clock math
        if now < self.retry_at:
            self.total_skips += 1
            metrics.supervisor_backoff_skips().inc({"controller": self.name})
            return False
        if self.state == OPEN:
            self._set_state(HALF_OPEN)
            log.info("controller %s: half-open probe after quarantine",
                     self.name)
        return True

    def next_allowed(self) -> float:
        """Earliest clock value at which `allow` can pass (-inf when
        healthy) — the sim's due-time scan folds this in so backoff
        windows are jumped, not crawled."""
        return self.retry_at if self.failures else float("-inf")

    # ------------------------------------------------------------------
    def record_success(self, now: float) -> None:
        if self.failures == 0 and self.state == CLOSED:
            return  # happy path: no state to clear
        if self.state != CLOSED:
            log.info("controller %s: recovered (circuit %s -> closed)",
                     self.name, self.state)
        self.failures = 0
        self.retry_at = float("-inf")
        self.last_error = ""
        self._set_state(CLOSED)
        metrics.supervisor_consecutive_failures().set(
            0, {"controller": self.name})

    def record_failure(self, now: float, err: BaseException) -> None:
        self.failures += 1
        self.total_failures += 1
        self.last_error = f"{type(err).__name__}: {err}"
        self.retry_at = now + self.policy.delay(self.name, self.failures)
        metrics.supervisor_consecutive_failures().set(
            self.failures, {"controller": self.name})
        if self.state == HALF_OPEN:
            self._set_state(OPEN)  # failed probe: straight back to open
        elif self.state == CLOSED and self.failures >= self.circuit_threshold:
            self._quarantine()

    def _quarantine(self) -> None:
        self._set_state(OPEN)
        self.total_quarantines += 1
        metrics.supervisor_quarantines().inc({"controller": self.name})
        publish_incident("circuit_open", {
            "controller": self.name, "failures": self.failures,
            "last_error": self.last_error, "retry_at": self.retry_at})
        msg = f"controller quarantined: {self.last_error}"
        log.warning("%s: %s (%d consecutive failures, retry at %.1f)",
                    self.name, msg, self.failures, self.retry_at)
        if self.recorder is not None:
            from ..utils.events import Event
            try:
                self.recorder.publish(Event(
                    kind="Controller", name=self.name, type="Warning",
                    reason="Quarantined", message=msg))
            except Exception:
                log.exception("recorder publish failed for %s", self.name)

    def _set_state(self, state: str) -> None:
        if state == self.state:
            return
        self.state = state
        metrics.supervisor_state().set(_STATE_CODE[state],
                                       {"controller": self.name})

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict:
        return {
            "state": self.state,
            "consecutive_failures": self.failures,
            "retry_at": self.retry_at if self.failures else None,
            "last_error": self.last_error or None,
            "total_failures": self.total_failures,
            "total_skips": self.total_skips,
            "total_quarantines": self.total_quarantines,
        }

    # ---- warm restart (state/snapshot.py) ----------------------------
    def snapshot_state(self) -> Dict:
        """Plain-data export for the WarmRestart snapshot — unlike
        `snapshot()` (a display form) this round-trips exactly."""
        return {
            "state": self.state,
            "failures": self.failures,
            "retry_at": self.retry_at,
            "last_error": self.last_error,
            "total_failures": self.total_failures,
            "total_skips": self.total_skips,
            "total_quarantines": self.total_quarantines,
        }

    def restore_state(self, data: Dict) -> None:
        self.state = str(data["state"])
        self.failures = int(data["failures"])
        self.retry_at = float(data["retry_at"])
        self.last_error = str(data["last_error"])
        self.total_failures = int(data["total_failures"])
        self.total_skips = int(data["total_skips"])
        self.total_quarantines = int(data["total_quarantines"])
