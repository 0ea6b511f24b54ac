"""Controller manager: singleton reconcile loops, pod batch windows, leader
election and the health and `/v1` endpoints.

A copy of the JAX package's `operator/manager.py`.  Analogs of the
reference runtime:
  * pod batching ahead of provisioning — idle 1s / max 10s windows
    (karpenter:website/content/en/docs/reference/settings.md:17-18);
  * controller-runtime's singleton loops with per-controller requeue
    intervals (reconcile cadences cited per entry below);
  * /healthz + /readyz + /debug/health HTTP endpoints and the `/v1`
    control surface (operator.go manager options);
  * leader election for 2-replica HA (charts/karpenter/values.yaml:32-33) —
    here a TTL'd lease file with fencing epochs (`LeaderElector`), since
    replicas share a host.

Durability and HA: under the WarmRestart gate (with a `snapshot_path`) a
`SnapshotWriter` (state/snapshot.py) writes on a cadence at the end of each
tick and once more in `stop()`, and `startup()` walks STARTING → RESTORING
(the warm restore) → PROBING (the arena parity probe) → LEADING or STANDBY.
With a leader, `tick()` first renews the lease: a replica that cannot prove
leadership (a rival's lease, or lease I/O that fails: `leader.lease` is a
chaos seam) skips the whole tick and counts it, and a tick that outlives
its lease aborts before its next mutating phase.  Under the HAFailover gate
the manager's `LeaseFence` (utils/fencing.py) guards the snapshot writes
and the CloudProvider's launch and terminate funnels.  `stop()` drains the
in-flight tick, writes the final snapshot, then releases the lease in
place, so a standby promotes at its next tick.

No fallback hides a fault of the card or of a kernel: `_supervised`
re-raises `DEVICE_FAULTS` (ops/classpack.py) before its supervisor books
anything, so such a fault propagates out of `tick()` — never counted as a
lease error and never followed by that tick's cadence write — and a `/v1`
handler answers it with a 500, never with a plan from somewhere else.
Each supervised reconcile first passes the chaos seam
`controller.reconcile` (utils/chaos.py, keyed on the controller's name);
an injected `ChaosError` is booked like any fault of the controller's own.

The elector, the readiness lifecycle and the supervised reconciles feed
the reference's leader, readiness and controller families, `/v1/solve`
runs under its `http.solve` span, and the server answers `/metrics` (the
registry's exposition), `/debug/traces` (the tracer's ring, filtered by
`?min_ms=` and `?span=`) and `/debug/pprof` (thread stacks and traces;
403 without `--enable-profiling`) as the reference's does.  Under the
FlightRecorder gate the manager arms the incident bus with a
`FlightRecorder` (obs/recorder.py) that samples the metric registry each
tick and captures a bundle per trip, with the health, chaos, fence,
provenance and trace context; under the SLOEngine gate it arms the SLO
engine (sharing the recorder's ring when both gates are on) and the cost
ledger.  Their state rides the snapshot's `incidents`, `slo` and `ledger`
sections, `stop()` disarms them, and the server answers
`/debug/incidents`, `/debug/incidents/<id>`, `/debug/slo` and
`/debug/ledger` (404 with the gate off).  The elector publishes
`leader_loss` and the parity probe `parity_mismatch`.  Sampling and
evaluation read the host registry only: neither touches the card.  With
the Forecast gate the
`forecast` entry runs at `forecast_cadence_s`, and real pending pods evict
headroom placeholders (`preempt_for_pending`) right before each
provisioning solve.
"""

from __future__ import annotations

import contextlib
import http.server
import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..analysis.lockorder import named_lock
from ..obs.incidents import publish_incident
from ..ops.classpack import DEVICE_FAULTS
from ..utils import metrics, tracing
from ..utils.chaos import CHAOS
from .supervisor import BackoffPolicy, ControllerSupervisor

log = logging.getLogger("karpenter_tpu_torch.manager")


class BadRequest(ValueError):
    """Client error on the /v1 surface: the request itself is malformed
    or fails admission — fix and resend.  ONLY this type maps to HTTP
    400; internal solver bugs that raise bare ValueError/KeyError/
    TypeError surface as 500 like any other server fault, so a genuine
    fault is never disguised as a client error."""


class PodBatchWindow:
    """Decides when a pending-pod batch is ripe for one solve: window opens
    on the first pending pod, closes after `idle` with no new arrivals or
    `max_timeout` overall (settings.md:17-18 batch-idle/max-duration)."""

    def __init__(self, idle: float = 1.0, max_timeout: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.idle = idle
        self.max_timeout = max_timeout
        self.clock = clock
        self._opened: Optional[float] = None
        self._last_add: Optional[float] = None
        self._last_count = 0

    def observe(self, pending_count: int) -> None:
        """Report the current pending-pod count (called each tick)."""
        now = self.clock()
        if pending_count <= 0:
            self._opened = self._last_add = None
            self._last_count = 0
            return
        if self._opened is None:
            self._opened = self._last_add = now
        elif pending_count != self._last_count:
            self._last_add = now
        self._last_count = pending_count

    def ripe(self) -> bool:
        if self._opened is None:
            return False
        now = self.clock()
        return (now - self._last_add >= self.idle or
                now - self._opened >= self.max_timeout)

    def reset(self) -> None:
        self._opened = self._last_add = None
        self._last_count = 0


class LeaderElector:
    """File-lease leader election with fencing epochs: acquire/renew a
    TTL'd lease file (HA analog of the chart's leader-elected 2 replicas).

    The lease carries a monotone `epoch` that bumps on every acquisition
    by a new leadership term (a different holder, an expired or corrupt
    lease, or a restarted process re-winning its own old lease) and
    stays fixed across renewals.  `holds_fence()` is the write-side
    check: the lease must still name this process at the epoch it
    acquired — the token every guarded snapshot/cloud mutation validates
    (utils/fencing.py).  `release()` is the graceful-handover half:
    expire our own lease in place so a standby promotes immediately
    instead of waiting out the TTL.  `acquisitions`, `losses` and
    `releases` count the transitions of this elector's terms."""

    def __init__(self, lease_path: str, identity: str, ttl: float = 15.0,
                 clock: Callable[[], float] = time.time):
        self.lease_path = lease_path
        self.identity = identity
        self.ttl = ttl
        self.clock = clock
        # fencing state: epoch of OUR current leadership term (0 = never
        # led); `_leading` is the last known verdict so acquire/lose
        # transitions count exactly once per term
        self._epoch = 0
        self._leading = False
        self.acquisitions = 0
        self.losses = 0
        self.releases = 0

    def _read_lease(self) -> Optional[tuple]:
        """(holder, renewed, epoch), or None when missing/corrupt — a
        lease we cannot parse can never prove anyone's leadership."""
        try:
            with open(self.lease_path) as f:
                lease = json.load(f)
            return (str(lease["holder"]), float(lease["renewed"]),
                    int(lease.get("epoch", 0)))
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _note_acquired(self, new_term: bool) -> None:
        if new_term or not self._leading:
            self.acquisitions += 1
            metrics.leader_transitions().inc({"event": "acquired"})
        self._leading = True
        metrics.leader_fence_epoch().set(self._epoch)

    def _note_lost(self) -> None:
        if self._leading:
            self._leading = False
            self.losses += 1
            metrics.leader_transitions().inc({"event": "lost"})
            publish_incident("leader_loss", {
                "identity": self.identity, "epoch": self._epoch,
                "losses": self.losses})

    def _write_lease(self, renewed: float, epoch: int) -> None:
        tmp = f"{self.lease_path}.{self.identity}.tmp"
        with open(tmp, "w") as f:
            json.dump({"holder": self.identity, "renewed": renewed,
                       "epoch": epoch}, f)
        os.replace(tmp, self.lease_path)

    @contextlib.contextmanager
    def _flocked(self):
        """The lease's kernel flock, taken without blocking: yields False
        when another process holds it.  Closing the fd releases it, so a
        holder that crashes leaves nothing behind."""
        import fcntl
        fd = os.open(f"{self.lease_path}.lock", os.O_CREAT | os.O_WRONLY,
                     0o644)
        try:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                yield False
                return
            yield True
        finally:
            os.close(fd)

    def try_acquire(self) -> bool:
        """Read-decide-write under a kernel flock so two replicas racing at
        lease expiry cannot both win.  flock (not create/unlink) because the
        kernel releases it when the holder's fd closes — a crash mid-update
        can neither deadlock election nor leave a stale artifact another
        replica might delete out from under a live holder."""
        CHAOS.inject("leader.lease", key="acquire")
        with self._flocked() as locked:
            if not locked:
                return self.is_leader()  # someone else is mid-update
            now = self.clock()
            lease = self._read_lease()
            # missing/corrupt lease: a new term past our own last epoch —
            # corruption must never let the epoch regress (a stale token
            # stamped under our old epoch would validate again)
            renewal, epoch = False, self._epoch + 1
            if lease is not None:
                holder, renewed, cur_epoch = lease
                valid = now - renewed < self.ttl
                if holder == self.identity and valid and \
                        cur_epoch == self._epoch and self._epoch > 0:
                    renewal, epoch = True, cur_epoch  # uninterrupted term
                elif holder != self.identity and valid:
                    self._note_lost()
                    return False
                else:
                    # expired, corrupt-then-rewritten, or a previous
                    # incarnation of ourselves: a new term begins — bump
                    # the fencing epoch past everything either side has
                    # seen, so anything stamped under an old one is
                    # refusable forever
                    epoch = max(cur_epoch, self._epoch) + 1
            self._write_lease(now, epoch)
            self._epoch = epoch
            self._note_acquired(new_term=not renewal)
            return True

    def is_leader(self) -> bool:
        lease = self._read_lease()
        return lease is not None and lease[0] == self.identity and \
            self.clock() - lease[1] < self.ttl

    # ---- fencing surface (utils/fencing.LeaseFence delegates here) ----
    def fence_epoch(self) -> int:
        """Epoch of our current/last leadership term (0 = never led)."""
        return self._epoch

    def holds_fence(self) -> bool:
        """True only while the lease still names us at our epoch — the
        strict form every guarded write validates.  A rival's interim
        term (even one that already ended) shows up as an epoch ahead of
        ours and reads as stale."""
        lease = self._read_lease()
        return (lease is not None and self._epoch > 0
                and lease[0] == self.identity
                and lease[2] == self._epoch
                and self.clock() - lease[1] < self.ttl)

    def lease_remaining(self) -> float:
        """Seconds of validity left on our lease (0 when deposed) — the
        mid-tick guard's budget check."""
        lease = self._read_lease()
        if lease is None or lease[0] != self.identity or \
                lease[2] != self._epoch:
            return 0.0
        return max(0.0, self.ttl - (self.clock() - lease[1]))

    def release(self) -> bool:
        """Graceful handover (the SIGTERM drain): rewrite our own lease
        already expired, epoch intact, so the standby's next acquire
        succeeds immediately (and bumps the epoch past ours).  Failover
        costs one election round, not TTL + clock drift."""
        CHAOS.inject("leader.lease", key="release")
        with self._flocked() as locked:
            if not locked:
                return False
            lease = self._read_lease()
            if lease is None or lease[0] != self.identity or \
                    lease[2] != self._epoch or self._epoch == 0:
                self._note_lost()   # nothing of ours left to release
                return False
            self._write_lease(self.clock() - self.ttl, self._epoch)
            if self._leading:
                self._leading = False
                self.releases += 1
                metrics.leader_transitions().inc({"event": "released"})
            return True


@dataclass
class _Entry:
    name: str
    reconcile: Callable[[], object]
    interval: float
    last_run: float = float("-inf")


class ControllerManager:
    """Runs the controller set as cooperative singleton loops with
    per-controller cadence — one thread, deterministic tick order (matches
    the reference's singleton controllers; intervals cited inline)."""

    # reconcile cadences: disruption ~10s (designs/consolidation.md:64),
    # GC adaptive 10s→2m (garbagecollection/controller.go:57), interruption
    # long-poll (immediate re-poll), nodeclass requeue 5m (controller.go:86-98),
    # pricing 12h (its controller owns the interval and no-ops between).
    DEFAULT_INTERVALS = {
        "provisioning": 0.0,     # gated by the PodBatchWindow instead
        "termination": 1.0,
        "disruption": 10.0,
        "lifecycle": 1.0,
        "garbagecollection": 10.0,
        "tagging": 5.0,
        "nodeclass": 300.0,
        "interruption": 0.5,
        "pricing": 60.0,
        "forecast": 30.0,
    }

    def __init__(self, operator, controllers: Dict[str, object],
                 clock: Callable[[], float] = time.time,
                 leader: Optional[LeaderElector] = None):
        self.operator = operator
        self.controllers = controllers
        self.clock = clock
        self.leader = leader
        self.batch_window = PodBatchWindow(  # guarded-by: caller(_state_lock)
            idle=operator.options.batch_idle_duration,
            max_timeout=operator.options.batch_max_duration,
            clock=clock)
        self._entries: List[_Entry] = []
        for name, ctrl in controllers.items():
            if name == "provisioning":
                continue  # special-cased through the batch window
            if name == "nodeclass":
                reconcile = self._nodeclass_tick(ctrl)
            else:
                reconcile = ctrl.reconcile
            interval = self.DEFAULT_INTERVALS.get(name, 10.0)
            if name == "forecast":
                interval = operator.options.forecast_cadence_s
            self._entries.append(_Entry(name, reconcile, interval))
            # static controller-runtime gauges, set once: singleton loops
            # have concurrency 1, and active_workers reads 0 from any
            # scrape because reconciles run under the same state lock the
            # collector takes
            metrics.controller_max_concurrent().set(1, {"controller": name})
            metrics.controller_active_workers().set(0, {"controller": name})
        # one supervisor per controller (provisioning included): isolates
        # crash loops with backoff + circuit breaking while every other
        # entry keeps cadence (operator/supervisor.py)
        opts = operator.options
        policy = BackoffPolicy(base_s=opts.supervisor_backoff_base_s,
                               max_s=opts.supervisor_backoff_max_s)
        self.supervisors: Dict[str, ControllerSupervisor] = {
            name: ControllerSupervisor(
                name, policy=policy,
                circuit_threshold=opts.supervisor_circuit_threshold,
                recorder=operator.recorder)
            for name in list(controllers)}
        self._soft_deadline_s = opts.reconcile_soft_deadline_s
        self._stop = threading.Event()
        self._http: Optional[http.server.ThreadingHTTPServer] = None
        # serializes cluster-state access between the tick loop, the /v1
        # worker threads, and the metrics collector — shared with the
        # operator so every reader of cluster state takes the SAME lock
        self._state_lock = getattr(operator, "state_lock", None) or \
            named_lock("state")
        # warm-restart snapshot cadence (state/snapshot.py): written from
        # inside the tick (under the state lock) and once more on stop()
        self._snapshotter = None
        if opts.gate("WarmRestart") and opts.snapshot_path:
            from ..state.snapshot import SnapshotWriter
            self._snapshotter = SnapshotWriter(
                opts.snapshot_path, operator, manager=self,
                interval_s=opts.snapshot_interval_s)
        # readiness lifecycle (STARTING→RESTORING→PROBING→{LEADING,STANDBY}
        # →DRAINING): `startup()` walks the restore/probe phases once,
        # `tick()` keeps the role phases honest afterwards.  /readyz flips
        # only in LEADING/STANDBY; /healthz reports liveness independently.
        self.phase = "STARTING"
        self.phase_transitions: Dict[str, int] = {}
        self.promotions = 0
        self.restore_outcome = "none"
        self.probe_outcome = "none"
        self._lease_errors = 0
        self._lease_err_streak = 0
        self._midtick_aborts = 0
        self._skipped_ticks = 0
        metrics.ready_state().set(1, {"phase": self.phase})
        # fenced leadership (utils/fencing.py, HAFailover gate): every
        # snapshot write and cloud mutation validates the fencing epoch;
        # without the gate (or without a leader) everything runs unfenced
        self.fence = None
        if leader is not None and opts.gate("HAFailover"):
            from ..utils.fencing import LeaseFence
            self.fence = LeaseFence(leader)
            cloud = getattr(operator, "cloud_provider", None)
            if cloud is not None:
                cloud.fence = self.fence
            if self._snapshotter is not None:
                self._snapshotter.fence = self.fence
        # incident flight recorder (obs/, FlightRecorder gate): metric
        # history ring sampled each tick on this manager's injectable
        # clock + the process-global trip-site trigger bus.  Gate off →
        # `self.flight is None` and the bus stays disarmed, so every trip
        # site pays one boolean check and nothing else.
        self.flight = None
        if opts.gate("FlightRecorder"):
            from ..obs.recorder import FlightRecorder
            self.flight = FlightRecorder(
                clock,
                cadence_s=opts.obs_sample_s,
                window_s=opts.incident_window_s,
                dedup_s=opts.incident_dedup_s,
                retention=opts.incident_retention,
                ring_slots=opts.obs_ring_slots,
                dirpath=opts.incident_dir or None)
            self.flight.health_cb = self.health_snapshot
            self.flight.chaos_cb = self._chaos_state
            self.flight.fence_cb = self._fence_state
            self.flight.provenance_cb = self._provenance_records
            self.flight.traces_cb = tracing.TRACER.traces
            self.flight.arm()
        # SLO engine + cost ledger (SLOEngine gate): recording rules over
        # the metric ring and per-decision $·h attribution.  When both
        # gates are on the engine reads the recorder's ring (one sampling
        # pass, two consumers); alone it owns a private ring.  The ledger
        # is the process-global seam the provider's launch/terminate
        # funnels append to — armed here, disarmed in stop().
        self.slo = None
        if opts.gate("SLOEngine"):
            from ..obs.ledger import LEDGER
            from ..obs.slo import SLOEngine
            self.slo = SLOEngine(
                clock,
                eval_cadence_s=opts.slo_eval_cadence_s,
                sample_cadence_s=opts.obs_sample_s,
                ring_slots=opts.obs_ring_slots,
                ring=self.flight.ring if self.flight is not None else None)
            LEDGER.arm(
                clock,
                retention=opts.ledger_retention,
                drift_threshold=opts.ledger_drift_threshold)

    def _chaos_state(self) -> Dict:
        return {"enabled": CHAOS.enabled, "counts": CHAOS.counts(),
                "fired_total": CHAOS.fired_total()}

    def _fence_state(self) -> Dict:
        out: Dict[str, object] = {
            "epoch": self.leader.fence_epoch()
            if self.leader is not None else None,
            "phase": self.phase,
            "skipped_ticks": self._skipped_ticks,
            "midtick_aborts": self._midtick_aborts,
            "lease_errors": self._lease_errors,
        }
        if self.fence is not None:
            out["refusals"] = dict(self.fence.refusals)
        return out

    def _provenance_records(self, pods: List[str]) -> List[Dict]:
        """Provenance context for a bundle: the named pods' records, or
        (when the trip names none) the most recent records, bounded."""
        store = getattr(self.operator, "provenance", None)
        if store is None:
            return []
        if pods:
            recs = [r for r in (store.get(p) for p in pods) if r is not None]
        else:
            recs = store.all()[-20:]
        return [r.to_dict() for r in recs]

    def _nodeclass_tick(self, ctrl):
        def run():
            for nc in list(self.operator.node_classes.values()):
                ctrl.reconcile(nc)
        return run

    # ------------------------------------------------------------------
    def tick(self) -> Dict[str, object]:
        """One cooperative pass: run every controller whose interval lapsed,
        plus provisioning when the pod batch window is ripe.  Returns
        results per controller that ran.  With a leader, a tick that
        cannot prove leadership is skipped whole (counted) and returns
        {}."""
        if self.leader is not None:
            try:
                self.leader.try_acquire()
                leading = self.leader.is_leader()
            except Exception as err:
                # lease I/O failed (chaos or a sick disk): leadership is
                # unprovable, so this tick must not mutate anything.  One
                # WARN per outage, not per tick
                self._lease_errors += 1
                metrics.leader_lease_errors().inc()
                # published per error, deduped per kind by the bus — a
                # blackout window yields a tiling of bundles (window_s >
                # dedup_s), not one per tick and not just the first
                publish_incident("leader_loss", {
                    "reason": "lease_io_error",
                    "error": f"{type(err).__name__}: {err}",
                    "lease_errors": self._lease_errors})
                if self._lease_err_streak == 0:
                    log.warning("lease I/O failed; skipping ticks until it "
                                "recovers: %s", err)
                self._lease_err_streak += 1
                leading = False
            else:
                if self._lease_err_streak:
                    log.info("lease I/O recovered after %d failed tick(s)",
                             self._lease_err_streak)
                self._lease_err_streak = 0
            if not leading:
                self._skipped_ticks += 1
                if self.phase in ("STARTING", "LEADING"):
                    self._set_phase("STANDBY")
                return {}
        if self.phase in ("STARTING", "STANDBY"):
            self._enter_role_phase()
        with self._state_lock:
            return self._tick_locked()

    def _tick_locked(self) -> Dict[str, object]:
        now = self.clock()
        results: Dict[str, object] = {}
        # flight-recorder history sample: cadence-bounded, read-only over
        # the metric registry, and safe before the lease guard (a deposed
        # replica's history is exactly what the post-mortem wants)
        if self.flight is not None:
            self.flight.sample()
        # SLO recording rules ride the same cadence discipline: sample
        # (no-op when the recorder already owns the ring), then evaluate
        # budgets/burn-rates on the engine's own eval cadence
        if self.slo is not None:
            self.slo.tick()
        # mid-tick lease guard: waiting on the state lock may have eaten
        # the whole lease; a deposed tick must abort before any mutation
        if not self._lease_live():
            return results
        # IngestBatch: the window of events absorbed since the last tick
        # lands as ONE arena delta before any controller reads the slab
        arena = getattr(self.operator.cluster, "arena", None)
        if arena is not None and hasattr(arena, "flush"):
            arena.flush()
        prov = self.controllers.get("provisioning")
        if prov is not None:
            pending = len(self.operator.cluster.pending_pods())
            self.batch_window.observe(pending)
            ripe = self.batch_window.ripe()
            # one-shot early re-solve: the refinery just landed a refined
            # mix that beats the greedy plan by more than its upgrade
            # threshold — solving still-pending pods now captures the
            # saving instead of waiting out the batch window
            refinery = getattr(prov, "refinery", None)
            if not ripe and pending and refinery is not None \
                    and refinery.take_upgrade():
                ripe = True
            if ripe and self.supervisors["provisioning"].allow(now):
                # real pending pods evict headroom placeholders BEFORE the
                # solve so the freed warm capacity is schedulable this tick
                forecast = self.controllers.get("forecast")
                if forecast is not None:
                    forecast.preempt_for_pending()
                if self._supervised(now, "provisioning", prov.provision,
                                    results):
                    # the window survives a failed solve: the pods are
                    # still pending and the batch is still ripe, so the
                    # supervisor's backoff (not a reopened window) paces
                    # the retry
                    self.batch_window.reset()
        for e in self._entries:
            if now - e.last_run < e.interval:
                continue
            if not self.supervisors[e.name].allow(now):
                continue  # backoff window: last_run stays put, so cadence
                          # resumes the moment the supervisor re-allows
            e.last_run = now
            self._supervised(now, e.name, e.reconcile, results)
        # re-check before the final mutating phase: the controller sweep
        # above is the long part of a tick and can outlive the lease
        if self._snapshotter is not None and self._lease_live():
            self._snapshotter.maybe_write(now)
        return results

    def _lease_live(self) -> bool:
        """Mid-tick guard: True when no leader is wired or our lease still
        has time left.  Re-checked before each mutating phase so a tick
        that outlived its lease aborts (counted in `_midtick_aborts`)
        instead of acting while deposed; the per-write fence is the
        backstop underneath."""
        if self.leader is None:
            return True
        try:
            if self.leader.lease_remaining() > 0.0:
                return True
        except Exception:
            log.warning("mid-tick lease check failed; aborting",
                        exc_info=True)
        self._midtick_aborts += 1
        metrics.leader_midtick_aborts().inc()
        return False

    def _supervised(self, now: float, name: str,
                    reconcile: Callable[[], object],
                    results: Dict[str, object]) -> bool:
        """Run one reconcile under its supervisor.  Failures are contained
        here (counted, backed off, possibly quarantined) so sibling
        controllers always reach their turn — except a fault of the card
        or of a kernel, which propagates before anything is booked.
        Returns success."""
        sup = self.supervisors[name]
        t0 = time.perf_counter()
        try:
            CHAOS.inject("controller.reconcile", key=name)
            results[name] = reconcile()
            sup.record_success(now)
            return True
        except DEVICE_FAULTS:
            raise
        except Exception as err:
            sup.record_failure(now, err)
            metrics.controller_reconcile_errors().inc({"controller": name})
            log.exception("controller %s reconcile failed", name)
            return False
        finally:
            elapsed = time.perf_counter() - t0
            metrics.controller_reconciles().inc({"controller": name})
            metrics.controller_reconcile_time().observe(
                elapsed, {"controller": name})
            if 0 < self._soft_deadline_s < elapsed:
                tracing.annotate(soft_deadline_exceeded=name)
                log.warning("controller %s reconcile took %.3fs "
                            "(soft deadline %.1fs)",
                            name, elapsed, self._soft_deadline_s)

    def health_snapshot(self) -> Dict:
        """Supervision + solver-ladder state for /debug/health."""
        prov = self.controllers.get("provisioning")
        health = getattr(prov, "health", None) if prov is not None else None
        snap: Dict[str, object] = {
            "controllers": {name: sup.snapshot()
                            for name, sup in sorted(self.supervisors.items())},
        }
        if health is not None:
            snap["solver"] = health.snapshot()
        return snap

    # ---- readiness lifecycle ------------------------------------------
    def _set_phase(self, phase: str) -> None:
        if phase == self.phase:
            return
        prev, self.phase = self.phase, phase
        self.phase_transitions[phase] = \
            self.phase_transitions.get(phase, 0) + 1
        if phase == "LEADING" and prev == "STANDBY":
            self.promotions += 1
        metrics.ready_state().set(0, {"phase": prev})
        metrics.ready_state().set(1, {"phase": phase})
        metrics.ready_transitions().inc({"phase": phase})
        log.info("readiness: %s -> %s", prev, phase)

    def _enter_role_phase(self) -> None:
        if self.phase == "DRAINING":
            return
        if self.leader is None or self.leader.is_leader():
            self._set_phase("LEADING")
        else:
            self._set_phase("STANDBY")

    def startup(self) -> str:
        """Walk the readiness ladder before taking traffic: RESTORING
        (warm restore when gated), PROBING (arena parity probe), then the
        role phase.  Returns the restore outcome ("none" when WarmRestart
        is off) so __main__ can log it."""
        opts = self.operator.options
        if opts.gate("WarmRestart") and opts.snapshot_path:
            self._set_phase("RESTORING")
            from ..state.snapshot import restore_snapshot
            with self._state_lock:
                self.restore_outcome = restore_snapshot(
                    opts.snapshot_path, self.operator, manager=self)
        self._set_phase("PROBING")
        with self._state_lock:
            self.probe_outcome = self.parity_probe()
        self._enter_role_phase()
        return self.restore_outcome

    def parity_probe(self, sample: int = 16) -> str:
        """Prove the (possibly restored) arena sane before /readyz flips:
        `gather()` over a
        deterministic pod sample must be bit-identical to a cold
        `tensorize_nodes` on the same nodes.  A mismatch invalidates the
        arena (so the first real solve rebuilds cold — degraded but
        correct) instead of letting a silently-wrong slab serve packing
        decisions."""
        import numpy as np
        cluster = self.operator.cluster
        arena = getattr(cluster, "arena", None)
        outcome = "skipped"
        if arena is not None and cluster.nodes:
            reps = [cluster.pods[uid]
                    for uid in sorted(cluster.pods)][:sample]
            warm = arena.gather(reps)
            if warm is not None:
                nodes, alloc, used, compat = warm
                cold = cluster.tensorize_nodes(reps)
                same = ([n.name for n in nodes] ==
                        [n.name for n in cold[0]]
                        and np.array_equal(alloc, cold[1])
                        and np.array_equal(used, cold[2])
                        and np.array_equal(compat, cold[3]))
                outcome = "ok" if same else "mismatch"
                if not same:
                    arena.invalidate("parity_probe")
                    publish_incident("parity_mismatch", {
                        "sampled_pods": len(reps),
                        "phase": self.phase})
                    log.error("arena parity probe FAILED: warm gather "
                              "diverges from cold tensorize; arena "
                              "invalidated")
        metrics.ready_probes().inc({"outcome": outcome})
        return outcome

    def liveness_report(self) -> tuple:
        """/healthz payload: process-level liveness — supervisor circuits,
        the solver ladder, watchdog trips and snapshot freshness.  `live`
        goes False (503)
        only on a wedge the process cannot dig itself out of: every
        controller circuit open at once, or the snapshot cadence stuck
        past 3x its interval while we still hold the fence."""
        now = self.clock()
        sups = {name: sup.snapshot()
                for name, sup in sorted(self.supervisors.items())}
        open_circuits = sorted(n for n, s in sups.items()
                               if s.get("state") == "open")
        wedges = []
        if self.supervisors and \
                len(open_circuits) == len(self.supervisors):
            wedges.append("all_circuits_open")
        snap_age = None
        sw = self._snapshotter
        if sw is not None and sw._last_written != float("-inf"):
            snap_age = max(0.0, now - sw._last_written)
            if snap_age > 3.0 * sw.interval_s and \
                    (self.fence is None or self.fence.held()):
                wedges.append("snapshot_stale")
        trips = sum(v for _, _, v in metrics.watchdog_trips().samples())
        report: Dict[str, object] = {
            "live": not wedges,
            "wedges": wedges,
            "phase": self.phase,
            "circuits_open": open_circuits,
            "watchdog_trips": int(trips),
            "snapshot_age_s": round(snap_age, 3)
            if snap_age is not None else None,
        }
        prov = self.controllers.get("provisioning")
        health = getattr(prov, "health", None) if prov is not None else None
        if health is not None:
            report["solver"] = health.snapshot()
        return report, not wedges

    def readiness_report(self) -> tuple:
        """/readyz payload: restored + probed + role.  Ready only in
        LEADING/STANDBY (restore and parity probe behind us, role settled)
        AND with the cloud breaker closed (cloud/provider.py
        liveness_probe)."""
        cloud = getattr(self.operator, "cloud_provider", None)
        cloud_ok = cloud is None or bool(cloud.liveness_probe())
        ready = self.phase in ("LEADING", "STANDBY") and cloud_ok
        role = "single" if self.leader is None else \
            ("leader" if self.phase == "LEADING" else "standby")
        return ({"ready": ready, "phase": self.phase, "role": role,
                 "restore": self.restore_outcome,
                 "probe": self.probe_outcome,
                 "cloud": cloud_ok,
                 "fence_epoch": self.leader.fence_epoch()
                 if self.leader is not None else None}, ready)

    def ha_snapshot_state(self) -> Dict:
        """Leader/readiness state for the WarmRestart snapshot: the
        counters a promoted successor carries forward, plus the epoch
        the snapshot was stamped under (forensic — the successor's own
        acquisition decides the live epoch, never the snapshot)."""
        return {
            "phase": self.phase,
            "epoch": self.leader.fence_epoch()
            if self.leader is not None else 0,
            "transitions": dict(self.phase_transitions),
            "promotions": self.promotions,
            "skipped_ticks": self._skipped_ticks,
            "midtick_aborts": self._midtick_aborts,
            "lease_errors": self._lease_errors,
        }

    def ha_restore_state(self, data: Dict) -> None:
        """Restore the HA counters (the phase itself is not restored: the
        restoring process walks its own readiness ladder and must not
        teleport into the predecessor's phase)."""
        self.phase_transitions = {str(k): int(v) for k, v in
                                  dict(data.get("transitions") or {}).items()}
        self.promotions = int(data.get("promotions", 0))
        self._skipped_ticks = int(data.get("skipped_ticks", 0))
        self._midtick_aborts = int(data.get("midtick_aborts", 0))
        self._lease_errors = int(data.get("lease_errors", 0))

    def incidents_snapshot_state(self) -> Optional[Dict]:
        """Flight-recorder cursor + dedup state for the WarmRestart
        snapshot (None when the FlightRecorder gate is off).  Carrying
        the dedup clocks forward is what keeps a warm restart from
        re-publishing incidents the predecessor already bundled."""
        if self.flight is None:
            return None
        return self.flight.snapshot_state()

    def incidents_restore_state(self, data: Dict) -> None:
        if self.flight is not None and data:
            self.flight.restore_state(data)

    def slo_snapshot_state(self) -> Optional[Dict]:
        """Error-budget state for the WarmRestart snapshot (None when the
        SLOEngine gate is off).  Carrying the last-seen counter tips
        forward is what lets the reset guard distinguish a restarted
        registry from genuine new errors — no double-counting."""
        if self.slo is None:
            return None
        return self.slo.snapshot_state()

    def slo_restore_state(self, data: Dict) -> None:
        if self.slo is not None and data:
            self.slo.restore_state(data)

    def ledger_snapshot_state(self) -> Optional[Dict]:
        """Cost-ledger entries (open + closed aggregates) for the
        WarmRestart snapshot (None when the SLOEngine gate is off)."""
        if self.slo is None:
            return None
        from ..obs.ledger import LEDGER
        return LEDGER.snapshot_state()

    def ledger_restore_state(self, data: Dict) -> None:
        if self.slo is None or not data:
            return
        from ..obs.ledger import LEDGER
        LEDGER.restore_state(data)

    def gang_snapshot_state(self) -> Optional[Dict]:
        """Gang admission registry for the WarmRestart snapshot (None when
        the GangScheduling gate is off).  Every gang is either fully
        admitted or fully pending at the checkpoint, and the restored
        operator starts from exactly that ledger."""
        reg = getattr(self.controllers.get("provisioning"), "gang_registry",
                      None)
        if reg is None:
            return None
        return reg.snapshot_state()

    def gang_restore_state(self, data: Dict) -> None:
        reg = getattr(self.controllers.get("provisioning"), "gang_registry",
                      None)
        if reg is not None and data:
            reg.restore_state(data)

    def run(self, tick_seconds: float = 0.25,
            stop_after: Optional[float] = None) -> None:
        """Blocking loop (main.go op.Start analog)."""
        deadline = None if stop_after is None else self.clock() + stop_after
        while not self._stop.is_set():
            self.tick()
            if deadline is not None and self.clock() >= deadline:
                break
            self._stop.wait(tick_seconds)

    def request_stop(self) -> None:
        """End `run()` after its current tick, taking no lock (the process
        entry point's signal handler calls it); `stop()` then drains."""
        self._stop.set()

    def stop(self) -> None:
        self._stop.set()
        first = self.phase != "DRAINING"
        self._set_phase("DRAINING")
        # graceful handover, in order and under the state lock: any
        # in-flight tick drains first, then one final fenced snapshot,
        # then the lease is released in place — the standby's next
        # acquire succeeds immediately (<TTL failover, not TTL+drift)
        with self._state_lock:
            if self._snapshotter is not None and first:
                self._snapshotter.write_final()
            if self.leader is not None and first:
                try:
                    self.leader.release()
                except Exception:
                    log.warning("lease release failed during drain",
                                exc_info=True)
        if self.flight is not None:
            self.flight.disarm()
        if self.slo is not None:
            from ..obs.ledger import LEDGER
            LEDGER.disarm()
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None
        refinery = getattr(self.controllers.get("provisioning"), "refinery",
                           None)
        if refinery is not None:
            refinery.stop()

    # ------------------------------------------------------------------
    def solve_request(self, payload: Dict) -> Dict:
        """One stateless solve for the /v1/solve seam: k8s Pod manifests in,
        launch plan out.  `schedule_on_existing` (default true) packs
        against live cluster capacity first, like the provisioner does.
        The state lock is held only for a point-in-time node snapshot
        (microseconds) — the solve itself runs OFF the lock, so a slow
        external solve never stalls the tick loop and concurrent solves
        don't queue behind each other.
        Placements failing the post-solve batch-topology audit are
        reported as `deferred`, exactly the pods the internal path would
        strand and re-solve."""
        from ..api.serialize import pod_from_manifest
        from ..ops.constraints import find_batch_topology_violations
        with tracing.span("http.solve") as _http_span:
            return self._solve_request(payload, pod_from_manifest,
                                       find_batch_topology_violations,
                                       _http_span)

    def _solve_request(self, payload, pod_from_manifest,
                       find_batch_topology_violations, span) -> Dict:
        prov = self.controllers.get("provisioning")
        if prov is None:
            raise ValueError("no provisioning controller wired")
        raw = payload.get("pods", [])
        if not isinstance(raw, list) or any(not isinstance(p, dict)
                                            for p in raw):
            raise BadRequest("\"pods\" must be a list of Pod manifests")
        try:
            pods = [pod_from_manifest(p) for p in raw]
        except (ValueError, KeyError, TypeError, AttributeError) as e:
            raise BadRequest(f"bad pod manifest: {e}") from e
        if not pods:
            raise BadRequest("no pods in request")
        span.annotate(pods=len(pods))
        with self._state_lock:
            nodes = self.operator.cluster.snapshot_nodes()
            # pool limit filtering iterates live nodes and updates gauge
            # bookkeeping — snapshot it under the lock too
            pools = prov._pools_within_limits()
        problem, packing = prov.solve(
            pods, schedule_on_existing=bool(
                payload.get("scheduleOnExisting", True)),
            nodes=nodes, pools=pools)
        stranded = set(find_batch_topology_violations(
            problem, packing, packing._existing_nodes))
        nodes = []
        for nd in packing.nodes:
            keep = [i for i in nd.pod_indices if i not in stranded]
            if not keep:
                continue
            nodes.append({
                "instanceType": nd.option.instance_type,
                "zone": nd.option.zone,
                "capacityType": nd.option.capacity_type,
                "nodepool": nd.option.pool,
                "pods": [problem.pods[i].name for i in keep],
                "alternatives": [
                    {"instanceType": a.instance_type, "zone": a.zone,
                     "capacityType": a.capacity_type}
                    for a in nd.alternatives[:20]],
            })
        bound = [{"pod": problem.pods[i].name,
                  "node": packing._existing_nodes[slot].name}
                 for i, slot in packing.existing_assignments.items()
                 if i not in stranded]
        return {
            "nodes": nodes,
            "boundToExisting": bound,
            "unschedulable": [problem.pods[i].name
                              for i in packing.unschedulable
                              if i is not None],
            # batch-internal anti-affinity/spread carriers: re-request these
            # after binding the rest (the in-process provisioner does the
            # same strand-and-resolve)
            "deferred": [problem.pods[i].name for i in sorted(stranded)],
            "totalPricePerHour": round(packing.total_price, 4),
        }

    def apply_request(self, payload: Dict) -> Dict:
        """POST /v1/apply — admission-checked manifest ingestion over
        HTTP.  Accepts one manifest or
        {"manifests": [...]}; each goes through the same
        `Operator.apply` seam the in-process path uses — legacy
        conversion, schema validation, defaulting, update-immutability —
        under the state lock (it registers into live controller state).
        Admission failures are client errors (400) naming the object."""
        manifests = payload.get("manifests")
        if manifests is None:
            manifests = [payload] if payload.get("kind") else []
        if not manifests:
            raise BadRequest("no manifests in request (expected a manifest "
                             "object or {\"manifests\": [...]})")
        for m in manifests:
            if not isinstance(m, dict):
                raise BadRequest(f"bad manifest entry {m!r}: not an object")
        with self._state_lock:
            # two-phase inside Operator.apply_batch so a 400 means NOTHING
            # was applied — admission runs for the whole batch (including
            # intra-batch update-immutability) before any registration
            try:
                objs = self.operator.apply_batch(manifests)
            except (ValueError, KeyError, TypeError, AttributeError) as e:
                raise BadRequest(f"admission failed: {e}") from e
        return {"applied": [{"kind": m.get("kind"),
                             "name": getattr(o, "name", None)}
                            for m, o in zip(manifests, objs)]}

    def list_request(self, kind: str) -> Dict:
        """GET /v1/nodepools | /v1/nodeclasses — the configured objects as
        manifests, so an external client can read back what it applied."""
        from ..api.serialize import nodeclass_to_manifest, nodepool_to_manifest
        with self._state_lock:
            if kind == "nodepools":
                items = [nodepool_to_manifest(p)
                         for p in self.operator.nodepools.values()]
            elif kind == "nodeclasses":
                items = [nodeclass_to_manifest(nc)
                         for nc in self.operator.node_classes.values()]
            else:
                raise BadRequest(f"unknown kind {kind!r}")
        return {"items": items}

    def feedback_request(self, payload: Dict) -> Dict:
        """POST /v1/feedback — launch-result feedback from the external
        actuator.  Failed launches whose error CLASSIFIES as exhausted
        capacity (the same cloud/errors.py taxonomy the internal launch
        path gates on — an external RequestLimitExceeded throttle must
        not blacklist healthy capacity) mark the offering unavailable, so
        the next /v1/solve avoids the pool.  The whole batch is validated
        BEFORE any entry takes effect: a 400 means nothing was applied,
        so 'fix and resend' is safe."""
        from ..cloud.errors import is_unfulfillable_capacity
        from ..cloud.fake import CloudError
        results = payload.get("results")
        if not isinstance(results, list) or not results:
            raise BadRequest("no results in request (expected "
                             "{\"results\": [{instanceType, zone, "
                             "capacityType, ok, error?}, ...]})")
        failures = []
        for r in results:
            if not isinstance(r, dict):
                raise BadRequest(f"bad result entry {r!r}: not an object")
            if bool(r.get("ok", False)):
                continue
            try:
                failures.append((str(r.get("error", "LaunchFailed")),
                                 r["instanceType"], r["zone"],
                                 r["capacityType"]))
            except KeyError as e:
                raise BadRequest(f"bad result entry {r!r}: missing {e}") \
                    from e
        unavailable = self.operator.cloud_provider.unavailable
        marked = ignored = 0
        for code, itype, zone, captype in failures:
            if is_unfulfillable_capacity(CloudError(code)):
                unavailable.mark_unavailable_for_fleet_err(
                    code, itype, zone, captype)
                marked += 1
            else:
                ignored += 1   # transient fault — retry, don't blacklist
        return {"markedUnavailable": marked, "ignored": ignored,
                "unavailableSeq": unavailable.seq_num}

    def serve_endpoints(self, metrics_port: Optional[int] = None):
        """Start /metrics, /healthz, /readyz, /debug/traces, /debug/health,
        /debug/pods/<uid>, /debug/pprof and the /v1 surface on a background
        thread.  A single server hosts them
        all (ports collapsed for the local substrate: the reference's
        `health_port` is read by nothing); returns the bound port."""
        manager = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, payload, code=200):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                from urllib.parse import parse_qs, urlparse
                url = urlparse(self.path)
                if self.path == "/metrics":
                    body = metrics.REGISTRY.expose().encode()
                    ctype = "text/plain; version=0.0.4"
                elif url.path == "/debug/traces":
                    # recent completed traces from the tracer ring buffer,
                    # ?min_ms= filters out fast ones, ?span= keeps only
                    # traces whose root span name starts with the prefix
                    query = parse_qs(url.query)
                    try:
                        min_ms = float(query.get("min_ms", ["0"])[0])
                    except ValueError:
                        self._json({"error": "min_ms must be a number"}, 400)
                        return
                    span = query.get("span", [None])[0]
                    self._json({"traces":
                                tracing.TRACER.traces(min_ms, span=span)})
                    return
                elif url.path == "/debug/incidents":
                    # flight-recorder bundle index + bus/ring counters
                    if manager.flight is None:
                        self._json({"error": "flight recorder disabled; "
                                             "start with --flight-recorder"},
                                   404)
                        return
                    self._json(manager.flight.summary())
                    return
                elif url.path.startswith("/debug/incidents/"):
                    # one full forensic bundle by id
                    if manager.flight is None:
                        self._json({"error": "flight recorder disabled; "
                                             "start with --flight-recorder"},
                                   404)
                        return
                    bid = url.path[len("/debug/incidents/"):]
                    bundle = manager.flight.get_bundle(bid)
                    if bundle is None:
                        self._json({"error": f"no bundle {bid!r}"}, 404)
                        return
                    self._json(bundle)
                    return
                elif url.path == "/debug/slo":
                    # per-SLO error budgets + multi-window burn rates
                    if manager.slo is None:
                        self._json({"error": "SLO engine disabled; "
                                             "start with --slo-engine"},
                                   404)
                        return
                    self._json(manager.slo.summary())
                    return
                elif url.path == "/debug/ledger":
                    # per-decision cost attribution + drift rollup
                    if manager.slo is None:
                        self._json({"error": "cost ledger disabled; "
                                             "start with --slo-engine"},
                                   404)
                        return
                    from ..obs.ledger import LEDGER
                    out = LEDGER.summary(manager.clock())
                    out["recent"] = LEDGER.recent(20)
                    self._json(out)
                    return
                elif url.path == "/debug/health":
                    # supervisor circuits + solver degradation ladder
                    self._json(manager.health_snapshot())
                    return
                elif url.path.startswith("/debug/pods/"):
                    # per-pod scheduling provenance (why is this pod pending)
                    name = url.path[len("/debug/pods/"):]
                    store = getattr(manager.operator, "provenance", None)
                    rec = store.get(name) if store is not None else None
                    if rec is None:
                        self._json({"error": f"no provenance for pod {name!r}"},
                                   404)
                        return
                    self._json(rec.to_dict())
                    return
                elif url.path.startswith("/debug/pprof"):
                    # profiling surface behind --enable-profiling
                    # (reference settings.md:23): all-thread stack dump plus
                    # a tracer ring-buffer snapshot, as JSON
                    if not manager.operator.options.enable_profiling:
                        self._json({"error": "profiling disabled; start with "
                                             "--enable-profiling"}, 403)
                        return
                    import sys
                    import traceback
                    names = {t.ident: t.name for t in threading.enumerate()}
                    threads = [
                        {"thread_id": tid,
                         "name": names.get(tid, ""),
                         "frames": [ln.rstrip("\n") for ln in
                                    traceback.format_stack(frame)]}
                        for tid, frame in sys._current_frames().items()]
                    self._json({"threads": threads,
                                "traces": tracing.TRACER.traces()})
                    return
                elif self.path in ("/v1/nodepools", "/v1/nodeclasses"):
                    try:
                        out = manager.list_request(self.path.rsplit("/", 1)[1])
                        body = json.dumps(out).encode()
                    except Exception as e:  # pragma: no cover — static kinds
                        body = json.dumps({"error": str(e)}).encode()
                        self.send_response(500)
                        self.send_header("Content-Type", "application/json")
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    ctype = "application/json"
                elif url.path == "/healthz":
                    # liveness: is the PROCESS healthy (circuits, ladder)
                    # — not whether it should take traffic; that's /readyz
                    payload, live = manager.liveness_report()
                    self._json(payload, 200 if live else 503)
                    return
                elif url.path == "/readyz":
                    # readiness: parity-probed + role settled + cloud
                    # breaker closed
                    payload, ready = manager.readiness_report()
                    self._json(payload, 200 if ready else 503)
                    return
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.end_headers()
                self.wfile.write(body)

            POSTS = {"/v1/solve": "solve_request",
                     "/v1/apply": "apply_request",
                     "/v1/feedback": "feedback_request"}

            def do_POST(self):
                """The /v1 control surface: an out-of-process
                controller (e.g. a Go control plane against a real
                apiserver) configures pools (/v1/apply), ships Pod
                manifests for a launch plan (/v1/solve — stateless, binds
                nothing), and reports launch results back (/v1/feedback)
                so ICE'd pools drop out of the next solve."""
                method = self.POSTS.get(self.path)
                if method is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        payload = json.loads(self.rfile.read(n) or b"{}")
                    except ValueError as e:
                        raise BadRequest(f"bad JSON body: {e}") from e
                    body = json.dumps(
                        getattr(manager, method)(payload)).encode()
                    code = 200
                except BadRequest as e:
                    # malformed request — the client should fix and resend
                    body = json.dumps({"error": str(e)}).encode()
                    code = 400
                except Exception as e:   # server fault — client may retry
                    log.exception("%s request failed", self.path)
                    body = json.dumps({"error": str(e)}).encode()
                    code = 500
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)

        port = metrics_port if metrics_port is not None \
            else self.operator.options.metrics_port
        self._http = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
        t = threading.Thread(target=self._http.serve_forever, daemon=True)
        t.start()
        return self._http.server_address[1]
