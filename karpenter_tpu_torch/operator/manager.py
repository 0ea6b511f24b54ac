"""Controller manager: singleton reconcile loops, pod batch windows and
the health and `/v1` endpoints.

A copy of the JAX package's `operator/manager.py`.  Analogs of the
reference runtime:
  * pod batching ahead of provisioning — idle 1s / max 10s windows
    (karpenter:website/content/en/docs/reference/settings.md:17-18);
  * controller-runtime's singleton loops with per-controller requeue
    intervals (reconcile cadences cited per entry below);
  * /healthz + /readyz + /debug/health HTTP endpoints and the `/v1`
    control surface (operator.go manager options).

No fallback hides a fault of the card or of a kernel: `_supervised`
re-raises `DEVICE_FAULTS` (ops/classpack.py) before its supervisor books
anything, so such a fault propagates out of `tick()`, and a `/v1` handler
answers it with a 500, never with a plan from somewhere else.  Each
supervised reconcile first passes the chaos seam `controller.reconcile`
(utils/chaos.py, keyed on the controller's name); an injected `ChaosError`
is booked like any fault of the controller's own.

Left out, each with the ROADMAP.md queue B item that ports it:
`LeaderElector`, the lease guards, the snapshotter and the fence, and
`startup()`'s restore branch (B7); the flight recorder (with the chaos
state it records), the SLO engine, the cost ledger, the metric and span
calls, and the endpoints `/metrics`, `/debug/traces`, `/debug/incidents`,
`/debug/slo`, `/debug/ledger` and `/debug/pprof`, which answer 501 naming
B9 (B9); the gang snapshot hooks (`gang_snapshot_state` /
`gang_restore_state`, B7: the snapshot is their only caller).  With the
Forecast gate the `forecast` entry runs at `forecast_cadence_s`, and real
pending pods evict headroom placeholders (`preempt_for_pending`) right
before each provisioning solve.
"""

from __future__ import annotations

import http.server
import json
import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..ops.classpack import DEVICE_FAULTS
from ..utils.chaos import CHAOS
from .supervisor import BackoffPolicy, ControllerSupervisor

log = logging.getLogger("karpenter_tpu_torch.manager")

# endpoints of the reference whose features are not ported → ROADMAP.md item
UNPORTED_ENDPOINTS = ("/metrics", "/debug/traces", "/debug/incidents",
                      "/debug/slo", "/debug/ledger", "/debug/pprof")


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
                 clock: Callable[[], float] = time.time):
        self.operator = operator
        self.controllers = controllers
        self.clock = clock
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
        # serializes cluster-state access between the tick loop and the /v1
        # worker threads — shared with the operator so every reader of
        # cluster state takes the SAME lock
        self._state_lock = operator.state_lock
        # readiness lifecycle (STARTING→PROBING→LEADING→DRAINING without a
        # leader): `startup()` walks the probe phase once, `tick()` keeps
        # the role phase honest afterwards.  /readyz flips only in
        # LEADING; /healthz reports liveness independently.
        self.phase = "STARTING"
        self.phase_transitions: Dict[str, int] = {}
        self.probe_outcome = "none"

    def _nodeclass_tick(self, ctrl):
        def run():
            for nc in list(self.operator.node_classes.values()):
                ctrl.reconcile(nc)
        return run

    # ------------------------------------------------------------------
    def tick(self) -> Dict[str, object]:
        """One cooperative pass: run every controller whose interval lapsed,
        plus provisioning when the pod batch window is ripe.  Returns
        results per controller that ran."""
        if self.phase == "STARTING":
            self._enter_role_phase()
        with self._state_lock:
            return self._tick_locked()

    def _tick_locked(self) -> Dict[str, object]:
        now = self.clock()
        results: Dict[str, object] = {}
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
        return results

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
            log.exception("controller %s reconcile failed", name)
            return False
        finally:
            elapsed = time.perf_counter() - t0
            if 0 < self._soft_deadline_s < elapsed:
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
        log.info("readiness: %s -> %s", prev, phase)

    def _enter_role_phase(self) -> None:
        if self.phase != "DRAINING":
            self._set_phase("LEADING")

    def startup(self) -> str:
        """Walk the readiness ladder before taking traffic: PROBING (arena
        parity probe), then the role phase.  Returns the restore outcome,
        "none" while WarmRestart is not ported (ROADMAP.md item B7)."""
        self._set_phase("PROBING")
        with self._state_lock:
            self.probe_outcome = self.parity_probe()
        self._enter_role_phase()
        return "none"

    def parity_probe(self, sample: int = 16) -> str:
        """Prove the arena sane before /readyz flips: `gather()` over a
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
                    log.error("arena parity probe FAILED: warm gather "
                              "diverges from cold tensorize; arena "
                              "invalidated")
        return outcome

    def liveness_report(self) -> tuple:
        """/healthz payload: process-level liveness — supervisor circuits
        and the solver ladder.  `live` goes False (503) only on a wedge the
        process cannot dig itself out of: every controller circuit open at
        once."""
        sups = {name: sup.snapshot()
                for name, sup in sorted(self.supervisors.items())}
        open_circuits = sorted(n for n, s in sups.items()
                               if s.get("state") == "open")
        wedges = []
        if self.supervisors and \
                len(open_circuits) == len(self.supervisors):
            wedges.append("all_circuits_open")
        report: Dict[str, object] = {
            "live": not wedges,
            "wedges": wedges,
            "phase": self.phase,
            "circuits_open": open_circuits,
        }
        prov = self.controllers.get("provisioning")
        health = getattr(prov, "health", None) if prov is not None else None
        if health is not None:
            report["solver"] = health.snapshot()
        return report, not wedges

    def readiness_report(self) -> tuple:
        """/readyz payload: probed + role.  Ready only in LEADING (parity
        probe behind us) AND with the cloud breaker closed (cloud/provider.py
        liveness_probe)."""
        cloud = getattr(self.operator, "cloud_provider", None)
        cloud_ok = cloud is None or bool(cloud.liveness_probe())
        ready = self.phase == "LEADING" and cloud_ok
        return ({"ready": ready, "phase": self.phase, "role": "single",
                 "restore": "none", "probe": self.probe_outcome,
                 "cloud": cloud_ok, "fence_epoch": None}, ready)

    def run(self, tick_seconds: float = 0.25,
            stop_after: Optional[float] = None) -> None:
        """Blocking loop (main.go op.Start analog)."""
        deadline = None if stop_after is None else self.clock() + stop_after
        while not self._stop.is_set():
            self.tick()
            if deadline is not None and self.clock() >= deadline:
                break
            self._stop.wait(tick_seconds)

    def stop(self) -> None:
        self._stop.set()
        self._set_phase("DRAINING")
        # any in-flight tick drains first
        with self._state_lock:
            pass
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
        """Start /healthz, /readyz, /debug/health, /debug/pods/<uid> and
        the /v1 surface on a background thread.  A single server hosts them
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
                from urllib.parse import urlparse
                url = urlparse(self.path)
                if any(url.path == p or url.path.startswith(p + "/")
                       for p in UNPORTED_ENDPOINTS):
                    self._json({"error": f"{url.path} is not ported yet "
                                         "(ROADMAP.md queue B, item B9)"},
                               501)
                    return
                if url.path == "/debug/health":
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
