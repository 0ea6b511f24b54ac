"""SolverHealth: one degradation ladder over the solver paths.

A copy of the JAX package's `ops/health.py` state machine: repeated errors
(or a single watchdog timeout) demote a rung for a backoff window that
doubles per consecutive demotion; when the window expires the next solve is
a half-open probe — success promotes back instantly, failure re-demotes for
a longer window.  The bottom rung never demotes.

Two ladders use it: the packing ladder (`RUNGS`), which
`Provisioner._pack_supervised` and `DisruptionController._simulate_pack`
walk, sharing one instance in the operator (sharded ──▶ jax ──▶ native ──▶
greedy; "sharded" is the partitioned mesh driver under the ShardedSolve
gate, which hands small or unshardable batches to "jax" inline; "native"
is the C++ packer on the host, karpenter_tpu_torch/native; "greedy" the
host NumPy FFD; a device fault is raised past the ladder), and the LP
ladder (`lp_ladder`: device_lp ──▶ highs).  The ladder state round-trips
through `snapshot_state` / `restore_state`; `snapshot()` is the reference's
deterministic /debug/health view.  Every transition is logged, annotated
onto the active span, tallied in `transitions` and counted in
karpenter_degradation_transitions_total{from,to,reason}; each demotion
publishes a `solver_demotion` incident (obs/incidents.py).  A device fault
never reaches the ladder, so it never publishes one.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from ..obs.incidents import publish_incident
from ..utils import metrics, tracing

log = logging.getLogger("karpenter_tpu_torch.health")

# Ladder order, best rung first (the reference's names).
RUNGS = ("sharded", "jax", "native", "greedy")

# The LP solver ladder (DeviceLP gate): the PDHG kernel of ops/lpsolve.py
# above the host HiGHS path, which is exact, host-only and never demotes.
LP_RUNGS = ("device_lp", "highs")

DEMOTE_AFTER_ERRORS = 2       # consecutive errors before demotion
DEFAULT_WINDOW_S = 60.0       # first demotion window
DEFAULT_WINDOW_MAX_S = 600.0  # doubling cap


@dataclass
class _RungState:
    failures: int = 0            # consecutive errors since last success
    demotions: int = 0           # consecutive demotions (window doubling)
    demoted_until: float = float("-inf")
    probing: bool = False        # a half-open probe is in flight
    total_failures: int = 0
    total_demotions: int = 0


class SolverHealth:
    """Shared ladder state.  Callers serialize the solve paths that consult
    it, so there is no internal locking."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 demote_after: int = DEMOTE_AFTER_ERRORS,
                 window_s: float = DEFAULT_WINDOW_S,
                 window_max_s: float = DEFAULT_WINDOW_MAX_S,
                 rungs: tuple = RUNGS):
        self.clock = clock
        self.demote_after = max(1, int(demote_after))
        self.window_s = float(window_s)
        self.window_max_s = float(window_max_s)
        self.rungs = tuple(rungs)
        if len(self.rungs) < 2:
            raise ValueError("ladder needs at least two rungs")
        self.rung_index = {r: i for i, r in enumerate(self.rungs)}
        self._state: Dict[str, _RungState] = {r: _RungState()
                                              for r in self.rungs}
        # deterministic transition tally: "from>to:reason" → n
        self.transitions: Dict[str, int] = {}

    def active_rung(self, requested: Optional[str] = None) -> str:
        """Best non-demoted rung at or below `requested`.  An expired
        demotion window turns the rung into a half-open probe: it is
        offered exactly once; failure re-demotes, success promotes."""
        if requested is None:
            requested = "jax" if "jax" in self.rung_index else self.rungs[0]
        now = self.clock()
        for rung in self.rungs[self.rung_index[requested]:]:
            st = self._state[rung]
            if st.demoted_until <= now:
                if st.demotions and not st.probing:
                    st.probing = True
                    log.info("solver rung %s: half-open probe", rung)
                return rung
        return self.rungs[-1]  # unreachable: bottom rung never demotes

    def next_rung(self, rung: str) -> Optional[str]:
        i = self.rung_index[rung] + 1
        return self.rungs[i] if i < len(self.rungs) else None

    def report_success(self, rung: str) -> None:
        st = self._state[rung]
        if st.probing or st.demotions:
            self._transition(rung, rung, "recovered")
        st.failures = 0
        st.demotions = 0
        st.probing = False
        st.demoted_until = float("-inf")
        self._export_rung()

    def report_failure(self, rung: str, reason: str = "error") -> None:
        """`reason` "timeout" demotes immediately; any other reason demotes
        after `demote_after` consecutive failures, or immediately when the
        failure hit a half-open probe."""
        st = self._state[rung]
        st.failures += 1
        st.total_failures += 1
        if rung == self.rungs[-1]:
            return  # bottom rung: never demoted, failures only counted
        if reason == "timeout" or st.probing or \
                st.failures >= self.demote_after:
            st.probing = False
            st.failures = 0
            st.demotions += 1
            st.total_demotions += 1
            window = min(self.window_s * (2.0 ** (st.demotions - 1)),
                         self.window_max_s)
            st.demoted_until = self.clock() + window
            self._transition(rung, self.next_rung(rung) or rung, reason)
        self._export_rung()

    def _transition(self, frm: str, to: str, reason: str) -> None:
        key = f"{frm}>{to}:{reason}"
        self.transitions[key] = self.transitions.get(key, 0) + 1
        metrics.degradation_transitions().inc(
            {"from": frm, "to": to, "reason": reason})
        if reason != "recovered":
            publish_incident("solver_demotion", {
                "from": frm, "to": to, "reason": reason,
                "transitions": dict(self.transitions)})
        tracing.annotate(degradation=key)
        if reason == "recovered":
            log.info("solver ladder: rung %s recovered", frm)
        else:
            log.warning("solver ladder: %s demoted to %s (%s), window %.0fs",
                        frm, to, reason,
                        self._state[frm].demoted_until - self.clock())

    def _export_rung(self) -> None:
        now = self.clock()
        for i, rung in enumerate(self.rungs):
            if self._state[rung].demoted_until <= now:
                metrics.degradation_rung().set(i)
                return

    # ---- warm restart ----------------------------------------------------
    def snapshot_state(self) -> Dict:
        """Round-trippable export of the whole ladder.  `demoted_until`
        values are absolute clock readings, so they only transfer between
        processes sharing a clock domain (a virtual clock, or a wall-clock
        restart where stale windows simply read as expired)."""
        return {
            "rungs": {
                rung: {
                    "failures": st.failures,
                    "demotions": st.demotions,
                    "demoted_until": st.demoted_until,
                    "probing": st.probing,
                    "total_failures": st.total_failures,
                    "total_demotions": st.total_demotions,
                } for rung, st in self._state.items()
            },
            "transitions": dict(self.transitions),
        }

    def restore_state(self, data: Dict) -> None:
        for rung, st in data["rungs"].items():
            if rung not in self._state:
                continue
            cur = self._state[rung]
            cur.failures = int(st["failures"])
            cur.demotions = int(st["demotions"])
            cur.demoted_until = float(st["demoted_until"])
            cur.probing = bool(st["probing"])
            cur.total_failures = int(st["total_failures"])
            cur.total_demotions = int(st["total_demotions"])
        self.transitions = dict(data["transitions"])

    def snapshot(self) -> Dict:
        """Deterministic ladder state (the reference's /debug/health
        view)."""
        now = self.clock()
        return {
            "rungs": {
                rung: {
                    "demoted": st.demoted_until > now,
                    "demoted_for_s": round(max(0.0, st.demoted_until - now), 3),
                    "consecutive_failures": st.failures,
                    "consecutive_demotions": st.demotions,
                    "probing": st.probing,
                    "total_failures": st.total_failures,
                    "total_demotions": st.total_demotions,
                } for rung in self.rungs for st in (self._state[rung],)
            },
            "transitions": dict(sorted(self.transitions.items())),
        }

    def failures(self, rung: str) -> int:
        """Consecutive failures of `rung` since its last success or
        demotion."""
        return self._state[rung].failures


def lp_ladder(clock: Callable[[], float] = time.monotonic,
              demote_after: int = DEMOTE_AFTER_ERRORS,
              window_s: float = DEFAULT_WINDOW_S,
              window_max_s: float = DEFAULT_WINDOW_MAX_S) -> SolverHealth:
    """The DeviceLP degradation ladder: device_lp ──▶ highs.  A capped PDHG
    master or a failed dual certificate reports a failure on "device_lp";
    after `demote_after` consecutive failures the guide answers from HiGHS
    until the window expires."""
    return SolverHealth(clock=clock, demote_after=demote_after,
                        window_s=window_s, window_max_s=window_max_s,
                        rungs=LP_RUNGS)
