"""The discrete-event simulation harness (a copy of the JAX package's
`sim/harness.py`, its solves on the card unless `device` says otherwise).

Wires the *real* controller stack — provisioning, disruption, interruption,
lifecycle, termination, GC, pricing — plus the fake cloud substrate onto a
shared `VirtualClock`, then replays a scenario's expanded event stream
against it.  Nothing in the loop sleeps: the harness advances the clock
straight to the next due moment (scenario event, scheduled cloud delivery,
controller cadence, or batch-window close), so a 24-hour diurnal day costs
seconds of wall time and two runs of the same (scenario, seed) produce
byte-identical event logs and reports.

Determinism notes (each bit matters):
  * module-global name counters (`state.cluster._names`, `api.objects._ids`,
    `cloud.queue._msg_ids`) are reset per run so node/message ids restart
    from 1 regardless of what ran earlier in the process (the reference
    also resets `cloud.fake._fleet_ids`, a counter its fake cloud never
    reads and the port's does not have);
  * the three request batchers keep their *wall* clock (their flusher
    threads would deadlock against a virtual clock nobody advances) but
    have their windows zeroed, so every call flushes immediately and
    batching adds no wall time and no ordering nondeterminism;
  * the harness's own randomness (reclaim victim selection, price jitter)
    comes from one `numpy` Generator keyed on the run seed, consumed in
    delivery order;
  * the report excludes every wall-clock-derived value — speedup goes to
    stderr only.

A scenario's `chaos:` block arms the process-global injector
(utils/chaos.py) for the run, its rules rebased onto the virtual clock and
its sleeps no-ops, and disarms it when the run ends.

A scenario's `forecast:` block (or the `forecast` override) turns the
Forecast gate on with the block's knobs, and its `gang:` block (or the
`gang` override) the GangScheduling gate; time-to-full-gang is tracked
either way, as in the reference, so an A/B run can read `_gang_full_t` on
the gate-off side.

A scenario's `ha:` block (or the `ha_failover` override) turns the
HAFailover gate on with a virtual-clock LeaderElector in the manager, whose
lease lives in a temporary directory the harness owns; `warm_restart`
overrides the WarmRestart gate (no snapshot path: the gate alone changes
nothing in a run, as in the reference).

The `flight_recorder` override turns the FlightRecorder gate on, and a
scenario's `slo:` block (or the `slo` override) the SLOEngine gate with its
cost ledger; both run on the virtual clock, and `run()` disarms the
process-global incident bus and ledger when it ends.
"""

from __future__ import annotations

import itertools
import logging
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import numpy as np

from ..api.taints import Taint
from ..catalog.generate import generate_catalog
from ..cloud.fake import (FakeCloud, ImageInfo, SecurityGroupInfo,
                          SubnetInfo)
from ..cloud.queue import FakeQueue
from ..cloud.services import FakeParameterStore
from ..operator.manager import ControllerManager
from ..operator.operator import Operator, build_controllers
from ..operator.options import Options
from ..ops.classpack import DEVICE_FAULTS
from ..utils import metrics
from ..utils.chaos import CHAOS, ChaosRule
from . import events as ev
from .clock import EventHeap, VirtualClock
from .scenario import Scenario, expand

log = logging.getLogger("karpenter_tpu_torch.sim")

# startup taint carried by booting nodes while their ready latency runs;
# node.kubernetes.io/ prefix so the lifecycle controller *waits* on it
# (it never clears condition-taints it does not own) until the harness's
# NodeReady event removes it
BOOT_TAINT = "node.kubernetes.io/sim-booting"

# bounded zero-advance: consecutive same-time passes allowed before the
# harness forces a minimum step (defends against due-time computation bugs
# ever turning into an infinite same-instant loop)
_MAX_ZERO_ADVANCES = 16
_FORCED_STEP_S = 0.5


@dataclass
class SimRun:
    """Everything one simulation produced.  `report` and `log` are fully
    deterministic; `wall_seconds`/`speedup` are measurements about the run
    and deliberately live outside the report document."""
    report: Dict
    log: List[Dict]
    virtual_seconds: float
    wall_seconds: float
    events_delivered: int

    @property
    def speedup(self) -> float:
        return self.virtual_seconds / self.wall_seconds \
            if self.wall_seconds > 0 else float("inf")


def _reset_global_counters() -> None:
    """Restart the module-global id/name counters so object names are a
    function of the run, not of process history."""
    from ..api import objects as api_objects
    from ..cloud import queue as cloud_queue
    from ..state import cluster as state_cluster
    api_objects._ids = itertools.count()
    state_cluster._names = itertools.count(1)
    cloud_queue._msg_ids = itertools.count(1)


class SimHarness:
    """One scenario replay over the real controller stack."""

    def __init__(self, scenario: Scenario, seed: int = 0,
                 duration_s: Optional[float] = None,
                 forecast: Optional[bool] = None,
                 incremental_arena: Optional[bool] = None,
                 sharded_solve: Optional[bool] = None,
                 warm_restart: Optional[bool] = None,
                 ingest_batch: Optional[bool] = None,
                 device_decode: Optional[bool] = None,
                 device_lp: Optional[bool] = None,
                 ha_failover: Optional[bool] = None,
                 flight_recorder: Optional[bool] = None,
                 slo: Optional[bool] = None,
                 gang: Optional[bool] = None,
                 device="cuda"):
        """`forecast` overrides the scenario's forecast.enabled so A/B
        comparisons can replay one scenario twice — knobs still come from
        the scenario's forecast block.  `gang` overrides the GangScheduling
        gate, else the scenario's `gang.enabled` decides (default off).
        `incremental_arena` overrides the IncrementalArena gate (default
        on): False replays the exact pre-arena full-rebuild code paths, the
        golden byte-identity escape hatch.  `sharded_solve` overrides the
        ShardedSolve gate (default off): goldens are recorded with the gate
        off, so the default replay stays byte-identical.  `ingest_batch`
        overrides the IngestBatch gate (default off).  `device_decode`
        overrides the DeviceDecode gate (default off): columnar slab decode
        with bit-identical plans, so gate-ON replays match the same goldens
        for scenarios whose batches clear the decode floor.  `device_lp`
        overrides the DeviceLP gate (default off): guide misses refine
        in-tick on the PDHG solver — mixes may legitimately differ from the
        HiGHS path's, so gate-ON runs have their own golden.
        `warm_restart` overrides the WarmRestart gate (default off).
        `ha_failover` overrides the HAFailover gate, else the scenario's
        `ha.enabled` decides (default off): a virtual-clock LeaderElector
        is wired into the manager so lease expiry, fencing refusals, and
        `leader.lease` chaos replay deterministically, and the report
        grows an `ha` section.  `flight_recorder` overrides the
        FlightRecorder gate (default off): the incident bus arms, the
        metric ring samples on the virtual clock, and the report grows a
        gated `incidents` section.  `slo` overrides the SLOEngine gate,
        else the scenario's `slo.enabled` decides (default off): error
        budgets and the cost ledger run on the virtual clock and the report
        grows gated `slo.budgets`, `ledger` and cost-breakdown sections.
        Every golden is recorded with both off.  `device` is where the
        controllers solve ("cuda" by default; "cpu" runs the kernels' plain
        versions)."""
        if duration_s is not None:
            scenario = replace(scenario, duration_s=float(duration_s))
        scenario.validate()
        self.scenario = scenario
        self.seed = int(seed)
        _reset_global_counters()

        self.clock = VirtualClock(scenario.start_s)
        self.heap = EventHeap()
        for at, event in expand(scenario, self.seed):
            self.heap.push(at, event)
        # harness-owned randomness (victim picks, price jitter): one stream,
        # consumed in delivery order — distinct from the expansion streams
        self._rng = np.random.default_rng([self.seed, 999])

        # -- substrate + operator over the virtual clock ------------------
        opts = Options(interruption_queue="sim-interruptions",
                       batch_idle_duration=scenario.batch_idle_s,
                       batch_max_duration=scenario.batch_max_s)
        for gate, value in (("IncrementalArena", incremental_arena),
                            ("ShardedSolve", sharded_solve),
                            ("WarmRestart", warm_restart),
                            ("IngestBatch", ingest_batch),
                            ("DeviceDecode", device_decode),
                            ("DeviceLP", device_lp)):
            if value is not None:
                opts.feature_gates[gate] = bool(value)
        self._fr_enabled = bool(flight_recorder) \
            if flight_recorder is not None else False
        if self._fr_enabled:
            opts.feature_gates["FlightRecorder"] = True
        ss = scenario.slo
        self._slo_enabled = bool(slo) if slo is not None \
            else (ss is not None and ss.enabled)
        if self._slo_enabled:
            opts.feature_gates["SLOEngine"] = True
            if ss is not None:
                opts.slo_eval_cadence_s = ss.eval_cadence_s
                opts.ledger_drift_threshold = ss.drift_threshold
        gs = scenario.gang
        self._gang_enabled = bool(gang) if gang is not None \
            else (gs is not None and gs.enabled)
        if self._gang_enabled:
            opts.feature_gates["GangScheduling"] = True
        ha = scenario.ha
        self._ha_enabled = bool(ha_failover) if ha_failover is not None \
            else (ha is not None and ha.enabled)
        if self._ha_enabled:
            opts.feature_gates["HAFailover"] = True
            opts.leader_elect = True
        fc = scenario.forecast
        fc_on = forecast if forecast is not None \
            else (fc is not None and fc.enabled)
        if fc_on:
            opts.feature_gates["Forecast"] = True
            if fc is not None:
                opts.forecast_horizon_s = fc.horizon_s
                opts.forecast_lead_s = fc.lead_s
                opts.forecast_ttl_s = fc.ttl_s
                opts.forecast_bucket_s = fc.bucket_s
                opts.forecast_confidence = fc.confidence
                opts.forecast_max_cost_frac = fc.max_cost_frac
                opts.forecast_model = fc.model
                opts.forecast_season_s = fc.season_s
        queue = FakeQueue(clock=self.clock)
        cloud = FakeCloud(clock=self.clock, queue=queue)
        cloud.subnets = [SubnetInfo(f"s-{z}", z, 1_000_000, {})
                         for z in scenario.zones]
        cloud.security_groups = [SecurityGroupInfo("sg-sim", "nodes", {})]
        cloud.images = [ImageInfo("img-sim-1", "std", "amd64", 1.0)]
        params = FakeParameterStore()
        params.parameters = {
            "/karpenter-tpu/images/standard/1.28/amd64/latest": "img-sim-1"}
        catalog = generate_catalog(scenario.catalog_size,
                                   zones=scenario.zones)
        # seed the spot market so price-drift faults have a base to move
        for it in catalog:
            for o in it.offerings:
                if o.capacity_type == "spot":
                    cloud.spot_prices[(it.name, o.zone)] = o.price
        self.op = Operator(opts, cloud=cloud, catalog=catalog,
                           params=params, queue=queue, clock=self.clock,
                           device=device)
        self.cloud = cloud
        self.cluster = self.op.cluster
        # batchers stay on the wall clock (their flusher threads would wait
        # forever on a clock only this thread advances) but with zero-width
        # windows every add() flushes immediately — no wall time, no
        # cross-call coalescing to perturb ordering
        for b in (self.op.batched_cloud.fleet, self.op.batched_cloud.describe,
                  self.op.batched_cloud.terminate):
            b.batcher.options.idle_timeout = 0.0
            b.batcher.options.max_timeout = 0.0

        controllers = build_controllers(self.op)
        # HAFailover: a real (virtual-clock) elector so the whole fencing
        # machinery — epoch bumps at lease expiry, mid-tick guards, chaos
        # at leader.lease — replays deterministically.  The lease lives in
        # a temporary directory owned by the harness; its path never
        # reaches the report.
        self.leader = None
        if self._ha_enabled:
            import os
            import tempfile
            from ..operator.manager import LeaderElector
            self._ha_dir = tempfile.TemporaryDirectory(
                prefix="karpenter-sim-ha-")
            self.leader = LeaderElector(
                os.path.join(self._ha_dir.name, "sim.lease"), "sim-leader",
                ttl=float(ha.ttl_s) if ha is not None else 15.0,
                clock=self.clock)
        self.mgr = ControllerManager(self.op, controllers, clock=self.clock,
                                     leader=self.leader)
        for entry in self.mgr._entries:
            entry.interval = scenario.intervals.get(entry.name,
                                                    entry.interval)
        self._terminator = controllers.get("termination")
        self._lifecycle = controllers.get("lifecycle")
        self._queue = queue

        # -- node-ready latency: intercept the sync register path ---------
        self._ready_latency = float(scenario.node_ready_latency_s)
        # booting node → pod uids bound there before it turned ready; their
        # time-to-bind clock stops at NodeReady, not at the API bind
        self._booting: Dict[str, List[str]] = {}
        self._wrap_register()
        self._wrap_bind()

        # -- run bookkeeping ----------------------------------------------
        self.log_entries: List[Dict] = []
        self._arrive_t: Dict[str, float] = {}      # pod uid → arrival time
        self._bind_t: Dict[str, float] = {}        # pod uid → time-to-bind
        # gang bookkeeping is tracked regardless of the gate so an A/B
        # run can read time-to-full-gang on the naive (gate-off) side;
        # only the report section is gated on _gang_enabled
        self._gang_of: Dict[str, str] = {}         # pod uid → gang name
        self._gang_members: Dict[str, set] = {}    # gang → member uids
        self._gang_arrive_t: Dict[str, float] = {}  # gang → first arrival
        self._gang_full_t: Dict[str, float] = {}   # gang → time to all-bound
        self._departed_unbound = 0
        self._cost_dollar_hours = 0.0
        self._node_hours = 0.0
        self._peak_nodes = 0
        self._events_by_kind: Dict[str, int] = {}
        self._disruptions: Dict[str, int] = {}     # "kind/reason" → count
        self._interruption_recycled = 0
        self._liveness_terminated = 0
        self._warnings = 0
        self._reclaims_honored = 0
        self._reclaims_forced = 0
        self._tick_exceptions = 0
        # provisioning faults are absorbed by its supervisor now, not
        # re-raised through tick(); the report's tick_exceptions counter
        # tracks the supervisor's failure total instead (same semantics)
        self._prov_failures_seen = 0
        ch = scenario.chaos
        self._chaos_enabled = bool(ch is not None and ch.enabled and ch.rules)

    # ------------------------------------------------------------------
    def _wrap_register(self) -> None:
        """Model node-ready latency without touching the provisioner: the
        sync path registers the node uninitialized and booting (a
        node.kubernetes.io/* taint the lifecycle controller waits on);
        a scheduled NodeReady event lifts the taint and the real
        LifecycleController performs initialization on its next pass."""
        original = self.cluster.register_nodeclaim
        harness = self

        def register(claim, allocatable, capacity=None, initialized=True,
                     rehydrate=False):
            if rehydrate or harness._ready_latency <= 0:
                return original(claim, allocatable, capacity,
                                initialized=initialized, rehydrate=rehydrate)
            node = original(claim, allocatable, capacity,
                            initialized=False, rehydrate=rehydrate)
            node.taints = list(node.taints) + [Taint(BOOT_TAINT)]
            harness.cluster.touch_node(node)
            harness._booting[node.name] = []
            harness.heap.push(harness.clock.now() + harness._ready_latency,
                              ev.NodeReady(node=node.name))
            return node

        self.cluster.register_nodeclaim = register

    def _wrap_bind(self) -> None:
        """Record each pod's first bind so the report's time-to-bind
        percentiles come straight from harness state."""
        original = self.cluster.bind_pod
        harness = self

        def bind(pod, node_name):
            if pod.uid not in harness._bind_t and \
                    pod.uid in harness._arrive_t:
                if node_name in harness._booting:
                    # node is still booting: the pod is placed but cannot
                    # run — its bind clock stops at the NodeReady event
                    harness._booting[node_name].append(pod.uid)
                else:
                    harness._bind_t[pod.uid] = \
                        harness.clock.now() - harness._arrive_t[pod.uid]
            original(pod, node_name)

        self.cluster.bind_pod = bind

    # ------------------------------------------------------------------
    # event delivery
    # ------------------------------------------------------------------
    def _log(self, at: float, payload: Dict) -> None:
        self.log_entries.append({"t": round(at - self.scenario.start_s, 6),
                                 **payload})

    def _deliver(self, at: float, event) -> None:
        self._events_by_kind[event.kind] = \
            self._events_by_kind.get(event.kind, 0) + 1
        metrics.sim_events_delivered().inc({"kind": event.kind})
        self._log(at, event.to_log())
        if isinstance(event, ev.PodArrival):
            now = self.clock.now()
            for p in event.pods:
                self._arrive_t[p.uid] = now
                if p.gang_name:
                    self._gang_of[p.uid] = p.gang_name
                    self._gang_members.setdefault(
                        p.gang_name, set()).add(p.uid)
                    self._gang_arrive_t.setdefault(p.gang_name, now)
            self.cluster.add_pods(event.pods)
        elif isinstance(event, ev.PodDeparture):
            for uid in event.uids:
                pod = self.cluster.pods.get(uid)
                if pod is None:
                    continue
                if uid not in self._bind_t:
                    self._departed_unbound += 1
                g = self._gang_of.pop(uid, None)
                if g is not None:
                    # departed members shrink the tracked set: a gang
                    # whose remainder is all bound still counts as full
                    members = self._gang_members.get(g)
                    if members is not None:
                        members.discard(uid)
                        if not members:
                            self._gang_members.pop(g, None)
                self.cluster.delete_pod(pod)
                self.op.provenance.clear(pod.name)
        elif isinstance(event, ev.SpotReclaim):
            self._start_reclaims(event)
        elif isinstance(event, ev.IceOpen):
            self.cloud.insufficient_capacity_pools |= \
                self._resolve_pools(event.pools)
        elif isinstance(event, ev.IceClose):
            self.cloud.insufficient_capacity_pools -= \
                self._resolve_pools(event.pools)
        elif isinstance(event, ev.PriceDrift):
            self._drift_prices(event)
        elif isinstance(event, ev.ApiThrottle):
            self.cloud.throttle_until = max(
                self.cloud.throttle_until,
                self.clock.now() + event.duration_s)
        elif isinstance(event, ev.NodeReadyLatency):
            self._ready_latency = float(event.latency_s)
        elif isinstance(event, ev.NodeReady):
            node = self.cluster.nodes.get(event.node)
            if node is not None:
                node.taints = [t for t in node.taints
                               if t.key != BOOT_TAINT]
                self.cluster.touch_node(node)
            now = self.clock.now()
            for uid in self._booting.pop(event.node, []):
                if uid not in self._bind_t and uid in self._arrive_t:
                    self._bind_t[uid] = now - self._arrive_t[uid]

    def _start_reclaims(self, event: ev.SpotReclaim) -> None:
        """Pick victims among running spot capacity and schedule the
        warn-then-reclaim pipeline on the cloud."""
        with self.cloud._lock:
            candidates = sorted(
                iid for iid, inst in self.cloud._instances.items()
                if inst.state == "running" and inst.capacity_type == "spot")
        n = min(event.count, len(candidates))
        if n == 0:
            return
        picks = sorted(self._rng.choice(len(candidates), size=n,
                                        replace=False).tolist())
        now = self.clock.now()
        for i in picks:
            self.cloud.interrupt(candidates[i], at=now + event.warning_s,
                                 warning_s=event.warning_s)

    def _resolve_pools(self, pools) -> set:
        """Expand "*" wildcards against the catalog/zones, deterministically
        (sorted iteration)."""
        cap_types = ("on-demand", "spot")
        type_names = sorted(it.name for it in self.op.catalog)
        zones = sorted(self.scenario.zones)
        out = set()
        for ct, itype, zone in pools:
            for c in (cap_types if ct == "*" else (ct,)):
                for t in (type_names if itype == "*" else (itype,)):
                    for z in (zones if zone == "*" else (zone,)):
                        out.add((c, t, z))
        return out

    def _drift_prices(self, event: ev.PriceDrift) -> None:
        for key in sorted(self.cloud.spot_prices):
            jitter = 1.0
            if event.jitter > 0:
                jitter = 1.0 + event.jitter * float(
                    self._rng.uniform(-1.0, 1.0))
            self.cloud.spot_prices[key] = round(
                self.cloud.spot_prices[key] * event.factor * jitter, 6)

    def _on_cloud_delivery(self, rec: Dict) -> None:
        if rec["action"] == "spot_warning":
            self._warnings += 1
            metrics.sim_reclaim_warnings().inc()
            self._log(rec["at"], {"kind": "spot_warning",
                                  "instance": rec["instance"]})
        else:
            honored = bool(rec.get("honored"))
            if honored:
                self._reclaims_honored += 1
            else:
                self._reclaims_forced += 1
                # a forced reclaim killed the instance without passing
                # through the provider's delete funnel — close its ledger
                # entry here or its realized $·h would accrue forever
                from ..obs.ledger import LEDGER
                if LEDGER.enabled:
                    LEDGER.record_close(rec["instance"], at=rec["at"],
                                        reason="spot_reclaim")
            metrics.sim_reclaims().inc(
                {"honored": "true" if honored else "false"})
            self._log(rec["at"], {"kind": "spot_reclaim_fired",
                                  "instance": rec["instance"],
                                  "honored": honored})

    def _check_gangs(self) -> None:
        """Sample gang completeness after each tick: the moment every
        member of a gang is simultaneously bound on ready (non-booting)
        nodes, record its time-to-full.  Sampling the cluster beats
        wrapping every (un)bind path — preemption, reclaim recycling,
        and consolidation all move pods, and a sample can't miss a
        transition that persists to the next tick."""
        if not self._gang_members:
            return
        now = self.clock.now()
        for g in sorted(self._gang_members):
            if g in self._gang_full_t:
                continue
            members = self._gang_members[g]
            full = True
            for uid in members:
                pod = self.cluster.pods.get(uid)
                if pod is None or not pod.node_name or \
                        pod.node_name in self._booting:
                    full = False
                    break
            if full and members:
                self._gang_full_t[g] = now - self._gang_arrive_t[g]

    # ------------------------------------------------------------------
    # controller ticking + due-time computation
    # ------------------------------------------------------------------
    def _tick(self) -> None:
        try:
            results = self.mgr.tick()
        except DEVICE_FAULTS:
            raise   # a fault of the card or a kernel ends the run
        except Exception as e:
            # the supervisors absorb controller faults, so anything that
            # reaches here is a harness/manager bug — still cost one tick,
            # not the run, and not a traceback per retry
            self._tick_exceptions += 1
            log.warning("sim tick failed at t=%.1f: %s",
                        self.clock.now(), e)
            return
        # provisioning faults (e.g. an injected throttle burst) used to
        # propagate out of tick(); its supervisor now catches them, so the
        # report counter follows the supervisor's running failure total
        prov_sup = self.mgr.supervisors.get("provisioning")
        if prov_sup is not None and \
                prov_sup.total_failures > self._prov_failures_seen:
            self._tick_exceptions += \
                prov_sup.total_failures - self._prov_failures_seen
            self._prov_failures_seen = prov_sup.total_failures
        disruption = results.get("disruption")
        if disruption is not None and disruption.action is not None:
            name = disruption.action.name
            self._disruptions[name] = self._disruptions.get(name, 0) + 1
        interruption = results.get("interruption")
        if interruption is not None:
            self._interruption_recycled += len(interruption.recycled)
        lifecycle = results.get("lifecycle")
        if lifecycle is not None:
            self._liveness_terminated += len(lifecycle.liveness_terminated)

    def _controller_due(self, now: float) -> float:
        """Earliest moment any controller has work: entry cadences (skipping
        no-op-prone loops with provably nothing to do) plus the pod batch
        window's close."""
        due = float("inf")
        queue_busy = len(self._queue) > 0 or bool(self._queue._inflight)
        termination_busy = bool(self._terminator and
                                self._terminator.pending)
        lifecycle_busy = bool(
            getattr(self._lifecycle, "_pending", None) or
            any(not c.initialized
                for c in self.cluster.nodeclaims.values()))
        for entry in self.mgr._entries:
            if entry.name == "interruption" and not queue_busy:
                continue
            if entry.name == "termination" and not termination_busy:
                continue
            if entry.name == "lifecycle" and not lifecycle_busy:
                continue
            edue = entry.last_run + entry.interval
            sup = self.mgr.supervisors.get(entry.name)
            if sup is not None:
                # a crash-looping controller's backoff window is jumped,
                # not crawled through the zero-advance guard
                edue = max(edue, sup.next_allowed())
            due = min(due, edue)
        window = self.mgr.batch_window
        if self.cluster.pending_pods():
            if window._opened is None:
                wdue = now              # next tick opens the window
            else:
                wdue = min(window._last_add + window.idle,
                           window._opened + window.max_timeout)
            # while a throttle burst has the cloud refusing every call —
            # or the provisioning supervisor is backing a crash loop off —
            # re-solving just burns ticks: hold the launch path to the
            # latest of the window close, the throttle end, and the
            # supervisor's retry time, like a live controller's retry
            prov_sup = self.mgr.supervisors.get("provisioning")
            prov_at = prov_sup.next_allowed() if prov_sup else float("-inf")
            due = min(due, max(wdue, self.cloud.throttle_until, prov_at))
        return due

    # ------------------------------------------------------------------
    def run(self) -> SimRun:
        try:
            return self._run_gated()
        finally:
            # the incident bus is process-global: it must not stay armed
            # past this run, or the next harness/test would publish into
            # a recorder whose clock and ring are gone
            if self._fr_enabled and self.mgr.flight is not None:
                self.mgr.flight.disarm()
            # likewise the cost ledger — but only after build_report read
            # its summary (report building happens inside the try)
            if self._slo_enabled:
                from ..obs.ledger import LEDGER
                LEDGER.disarm()

    def _run_gated(self) -> SimRun:
        if not self._chaos_enabled:
            return self._run_loop()
        ch = self.scenario.chaos
        sc = self.scenario
        # rebase scenario-relative rule times onto the virtual clock; the
        # no-op sleep keeps latency/hang rules from burning wall time (a
        # hang is only meaningful under a watchdog deadline, which uses
        # its own wall-clock wait)
        rules = [ChaosRule(point=r.point, key=r.key, action=r.action,
                           rate=r.rate, at_s=sc.start_s + r.at_s,
                           until_s=(sc.start_s + r.until_s) if r.until_s
                           else float("inf"),
                           latency_s=r.latency_s, count=r.count,
                           error_code=r.error_code)
                 for r in ch.rules]
        CHAOS.configure(rules,
                        seed=self.seed if ch.seed is None else int(ch.seed),
                        clock=self.clock, sleep=lambda s: None)
        try:
            # the report reads the injector's counters before this returns
            return self._run_loop()
        finally:
            CHAOS.reset()

    def _run_loop(self) -> SimRun:
        sc = self.scenario
        t_end = sc.start_s + sc.duration_s + sc.settle_s
        wall0 = time.perf_counter()
        zero_advances = 0
        while True:
            now = self.clock.now()
            for at, event in self.heap.pop_due(now):
                self._deliver(at, event)
            for rec in self.cloud.deliver_due():
                self._on_cloud_delivery(rec)
            self._tick()
            self._check_gangs()
            self._peak_nodes = max(self._peak_nodes,
                                   len(self.cluster.nodes))
            if now >= t_end:
                break
            target = min(t_end, self._next_due(now))
            if target <= now:
                zero_advances += 1
                if zero_advances < _MAX_ZERO_ADVANCES:
                    continue
                target = now + _FORCED_STEP_S   # progress guard
            zero_advances = 0
            self._accrue(now, target)
            self.clock.advance_to(target)
        wall = time.perf_counter() - wall0
        virtual = self.clock.now() - sc.start_s
        speedup = virtual / wall if wall > 0 else float("inf")
        metrics.sim_virtual_time_speedup().set(speedup)
        total_reclaims = self._reclaims_honored + self._reclaims_forced
        if total_reclaims:
            metrics.sim_reclaim_honor_rate().set(
                self._reclaims_honored / total_reclaims)
        from .report import build_report
        return SimRun(report=build_report(self), log=self.log_entries,
                      virtual_seconds=virtual, wall_seconds=wall,
                      events_delivered=sum(self._events_by_kind.values()))

    def _next_due(self, now: float) -> float:
        due = self._controller_due(now)
        head = self.heap.peek_time()
        if head is not None:
            due = min(due, head)
        cloud_due = self.cloud.next_due()
        if cloud_due is not None:
            due = min(due, cloud_due)
        return due

    def _accrue(self, t0: float, t1: float) -> None:
        dt_h = (t1 - t0) / 3600.0
        with self.cloud._lock:
            rate = sum(inst.price for inst in self.cloud._instances.values()
                       if inst.state == "running")
            n = sum(1 for inst in self.cloud._instances.values()
                    if inst.state == "running")
        self._cost_dollar_hours += rate * dt_h
        self._node_hours += n * dt_h
