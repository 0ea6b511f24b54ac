"""Disruption controller: consolidation, emptiness, expiration, drift —
decided and carried out.

A copy of the JAX package's `controllers/disruption.py` (karpenter-core's
disruption engine, karpenter:designs/consolidation.md and
karpenter:designs/deprovisioning.md):

  * candidate discovery with blockers — do-not-disrupt pods, PDB budgets,
    ownerless pods, recently-created nodes, in-flight nominations, live
    headroom placeholders;
  * the methods in the reference's order, expiration → drift → emptiness
    → consolidation, ONE action carried out per `reconcile()` tick;
  * consolidation's two actions: node *deletion* (pods fit on the remaining
    nodes) and node *replacement* (pods fit on remaining nodes + one cheaper
    node), decided by simulated scheduling; expiration and drift replace a
    node at any price, emptiness deletes every empty node at once;
  * disruption-cost candidate ranking weighted by remaining node lifetime;
  * execution: the `karpenter.sh/disruption:NoSchedule` taint, the
    replacements launched through the provider before anything is drained,
    the evicted pods rebound per the simulation, then termination through
    the TerminationController (`terminator`) or inline; a failed
    replacement launch rolls the action back
    (karpenter:website/content/en/docs/concepts/disruption.md:9-35).

The simulation is the class-granular packing solve: a probe family is 1-2
calls of the K1 + K5 sweep kernels on a cached `SimulationArena`, and the
one accepted action is re-validated by a decoded K1 + K2 + K3 solve with
the survivors as pre-opened columns — through the partitioned mesh driver
(parallel/driver.py, shard-batched kernels) first when the ShardedSolve
gate (`sharded_solve`) is on and the batch is shardable.  Every solve runs
on `device` ("cuda" by default; "cpu" runs the kernels' plain versions and
only when asked).

With a SolverHealth (`health`, the ladder the operator shares with the
Provisioner) each simulation walks the degradation ladder as the
Provisioner's pack does: "sharded" → "jax" (the classpack solve) →
"native" (the C++ packer on the host) → "greedy" (the host NumPy FFD), each
attempt behind the chaos seam `solver.pack` and, above greedy, the
watchdog's `watchdog_timeout_s` deadline.  The batched sweep runs under the
same deadline: a trip books a timeout against "jax" and finishes the tick
on the sequential path, whose probes consult the demoted ladder; the sweep
passes the chaos seam `solver.sweep` first.  A device fault
(`DEVICE_FAULTS`) is raised past every rung with nothing booked and leaves
`reconcile()` as it came; only the cloud calls of execution are caught.

With `gang_source` (the GangScheduling gate: the Provisioner's
`take_preemption_plan`), each tick first executes one queued gang
preemption plan, ahead of every other method.  The tick runs under the
reference's `disruption.*` and `sweep.*` spans and feeds its disruption
families; every launch and terminate of an executed action is tagged
with its reason for the cost ledger (obs/ledger.py).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..api import labels as wk
from ..api.objects import Node, NodeClaim, NodePool, Pod, pool_view
from ..api.taints import NO_SCHEDULE, Taint
from ..catalog.instancetype import InstanceType, effective_instance_type
from ..cloud.errors import is_not_found
from ..cloud.fake import CloudError
from ..cloud.provider import InsufficientCapacityError
from ..forecast.headroom import headroom_expiry, is_headroom
from ..ops.classpack import DEVICE_FAULTS, resolve_device, solve_classpack
from ..ops.constraints import (LEVEL_REQUIRED_ONLY,
                               find_batch_topology_violations, lower_pods,
                               make_zone_feasibility)
from ..ops.ffd import PackingResult, solve_ffd
from ..ops.tensorize import Problem, tensorize
from ..parallel.driver import maybe_solve_partitioned
from ..state.cluster import Cluster
from ..utils import metrics, tracing
from ..utils.chaos import CHAOS
from ..utils.events import Event
from ..utils.watchdog import WatchdogTimeout, run_with_deadline

log = logging.getLogger("karpenter_tpu_torch.disruption")

DISRUPTION_TAINT = Taint(wk.DISRUPTION_TAINT_KEY, NO_SCHEDULE, "disrupting")

# Tunables (karpenter:designs/consolidation.md:61-67,
# karpenter:designs/deprovisioning.md:27-33).
DEFAULT_STABILIZATION_S = 5 * 60.0   # min node lifetime before disruption
# spot→spot replacement keeps this many cheaper launch alternatives so the
# new node retains fleet flexibility (reference consolidation docs: ≥15
# cheaper offerings required for spot-to-spot consolidation)
SPOT_TO_SPOT_MIN_ALTERNATIVES = 15

# the reference's multi-node consolidation abandons an evaluation pass at
# this budget (karpenter-core MultiNodeConsolidation timeout)
CONSOLIDATION_TIMEOUT_S = 60.0

@dataclass
class Candidate:
    node: Node
    claim: Optional[NodeClaim]
    pool: NodePool
    reschedulable: List[Pod]
    disruption_cost: float
    price: float

    @property
    def name(self) -> str:
        return self.node.name


@dataclass
class Action:
    """One disruption decision: delete `candidates`, optionally launching
    replacements first (named {delete,replace}{Consolidation,Emptiness,
    Expiration,Drift} like the reference's action strings,
    karpenter:designs/deprovisioning.md:11-31)."""
    kind: str                       # "delete" | "replace"
    reason: str                     # "consolidation" | "emptiness" | ...
    candidates: List[Candidate]
    simulation: Optional[PackingResult] = None
    problem: Optional[Problem] = None
    surviving_nodes: List[Node] = field(default_factory=list)

    @property
    def name(self) -> str:
        return f"{self.kind}/{self.reason}"


@dataclass
class DisruptionResult:
    action: Optional[Action] = None
    launched: List[NodeClaim] = field(default_factory=list)
    deleted: List[str] = field(default_factory=list)
    error: str = ""


def pod_disruption_cost(pod: Pod) -> float:
    """Per-pod eviction cost: more pods, higher priority, and explicit
    pod-deletion-cost all make a node more expensive to disrupt
    (karpenter:designs/consolidation.md:25-42)."""
    return 1.0 + max(pod.priority, 0) / 1e4 + pod.deletion_cost / 1e3


def node_disruption_cost(node: Node, pool: NodePool, now: float) -> float:
    cost = sum(pod_disruption_cost(p) for p in node.pods)
    expire = pool.disruption.expire_after_s
    if expire:
        # nodes close to expiry are cheap to disrupt (lifetime weighting)
        remaining = max(0.0, 1.0 - (now - node.created_at) / expire)
        cost *= remaining
    return cost


def _search_frontier(lo: int, hi: int, cap: int = 31) -> List[int]:
    """Every mid the binary search over [lo, hi] can reach in its next few
    levels — whole levels of the mid decision tree while they fit in `cap`
    rows (one sweep bucket), always at least the first level.  Sibling
    subtrees cover disjoint ranges, so the mids are distinct and the tree
    over [1, N] has depth ~log₂N: cap=31 covers 5 levels per round, ≤2
    rounds at any realistic candidate count."""
    out: List[int] = []
    level = [(lo, hi)]
    while level:
        mids = [(l + h) // 2 for l, h in level if l <= h]
        if not mids or (out and len(out) + len(mids) > cap):
            break
        out.extend(mids)
        level = [iv for l, h in level if l <= h
                 for iv in ((l, (l + h) // 2 - 1), ((l + h) // 2 + 1, h))]
    return out


def _cands_match(old: List["Candidate"], new: List["Candidate"]) -> bool:
    """Cheap candidate-list equivalence for the lazy re-fingerprint: same
    nodes, prices, and reschedulable pod identities in the same order —
    O(candidate pods), never O(cluster)."""
    if len(old) != len(new):
        return False
    for a, b in zip(old, new):
        if (a.name != b.name or a.price != b.price or a.node is not b.node
                or len(a.reschedulable) != len(b.reschedulable)
                or any(x is not y for x, y in zip(a.reschedulable,
                                                  b.reschedulable))):
            return False
    return True


class DisruptionController:
    """Single-action disruption loop over cluster state.

    The signature is the reference's plus `device` and `mesh` (the
    ShardedSolve gate's mesh; default `parallel.make_pod_mesh` on `device`)."""

    def __init__(self, provider, cluster: Cluster,
                 nodepools,
                 clock: Callable[[], float] = time.time,
                 stabilization_s: float = DEFAULT_STABILIZATION_S,
                 drift_enabled: bool = True,
                 # the reference's multi-node consolidation considers at
                 # most 100 candidates per pass (karpenter-core
                 # MultiNodeConsolidation.firstNConsolidationOption)
                 max_candidates: int = 100,
                 terminator=None,
                 spot_min_flexibility: int = SPOT_TO_SPOT_MIN_ALTERNATIVES,
                 recorder=None,
                 lp_guide: bool = True,
                 # batched prefix/candidate probing on the cached
                 # simulation arena (≤3 sweep calls per tick); False = the
                 # sequential binary-search + per-candidate screen loop
                 batched_sweep: bool = True,
                 sharded_solve: bool = False,
                 health=None,
                 watchdog_timeout_s: float = 0.0,
                 gang_source: Optional[Callable] = None,
                 device="cuda",
                 mesh=None):
        from ..utils.events import Recorder
        self.device = resolve_device(device)
        self.provider = provider
        self.cluster = cluster
        self.nodepools = pool_view(nodepools)
        self.clock = clock
        self.terminator = terminator
        self.recorder = recorder or Recorder(log=False)
        self.stabilization_s = stabilization_s
        self.drift_enabled = drift_enabled
        self.max_candidates = max_candidates
        self.spot_min_flexibility = spot_min_flexibility
        self.lp_guide = lp_guide
        self.batched_sweep = batched_sweep
        self.sharded_solve = sharded_solve
        self.mesh = mesh
        # shared degradation ladder (ops/health.py) + per-simulate hard
        # deadline (utils/watchdog.py); None/0 keep the direct path
        self.health = health
        self.watchdog_timeout_s = watchdog_timeout_s
        # GangScheduling: the provisioner's queue of gang preemption plans
        # (Provisioner.take_preemption_plan); one plan executes per tick
        self.gang_source = gang_source
        self._empty_since: Dict[str, float] = {}  # node → first seen empty
        self._arena_cache = None  # (fingerprint, SimulationArena)
        # (mutation_epoch, catalog_key, candidates, fingerprint) — skips the
        # O(nodes+pods) arena_fingerprint walk while the cluster is unchanged
        self._fingerprint_cache = None

    # ------------------------------------------------------------------
    # candidate discovery
    # ------------------------------------------------------------------
    def candidates(self) -> List[Candidate]:
        """Disruptable nodes, cheapest disruption first. Blockers per
        karpenter:designs/consolidation.md:44-52."""
        now = self.clock()
        budgets = self.cluster.pdb_budgets()
        out: List[Candidate] = []
        for node in self.cluster.nodes.values():
            pool = self.nodepools.get(node.nodepool)
            if pool is None or node.marked_for_deletion:
                continue
            if now - node.created_at < self.stabilization_s:
                continue  # min node lifetime
            if node.nominated_until > now:
                continue  # in-flight pod nomination
            blocked = ""
            # live headroom is protected by TTL: consolidating a node that
            # carries an unexpired placeholder would strand capacity the
            # forecaster just bought.  Expired headroom neither blocks nor
            # reschedules.
            real = [p for p in node.pods
                    if not p.is_daemon and not is_headroom(p)]
            ttl_max = max((headroom_expiry(p) or 0.0
                           for p in node.pods if is_headroom(p)),
                          default=0.0)
            if ttl_max > now:
                blocked = "live headroom (protected by ttl)"
            for p in real:
                if p.do_not_disrupt:
                    blocked = f"pod {p.name} has do-not-disrupt"
                    break
                if not p.owner_kind:
                    blocked = f"pod {p.name} is ownerless"
                    break
            if blocked:
                # reference emits Unconsolidatable events so operators see
                # why capacity stays up; the recorder's dedupe window keeps
                # the per-tick republish quiet
                self.recorder.publish(Event(
                    "Node", node.name, "Unconsolidatable", blocked))
                continue
            resched = real
            if not self.cluster.evictable(resched, budgets):
                self.recorder.publish(Event(
                    "Node", node.name, "Unconsolidatable",
                    "pod disruption budget exhausted"))
                continue  # PDB budget exhausted
            claim = self.cluster.claim_for_provider_id(node.provider_id)
            out.append(Candidate(
                node=node, claim=claim, pool=pool, reschedulable=resched,
                disruption_cost=node_disruption_cost(node, pool, now),
                price=node.price))
        out.sort(key=lambda c: (c.disruption_cost, c.name))
        if len(out) > self.max_candidates:
            # no silent caps: a truncated discovery pass means this tick did
            # NOT sweep everything — say so and count it
            dropped = len(out) - self.max_candidates
            log.info("candidate discovery truncated: %d of %d kept "
                     "(max_candidates=%d), %d dropped",
                     self.max_candidates, len(out), self.max_candidates,
                     dropped)
            metrics.disruption_candidates_truncated().inc(by=dropped)
            out = out[:self.max_candidates]
        return out

    # ------------------------------------------------------------------
    # simulation: the scheduler re-used as the consolidation simulator
    # ------------------------------------------------------------------
    def _filtered_catalog(self, max_total_price: Optional[float]) -> List[InstanceType]:
        """Launch options for replacement simulations. `max_total_price`
        strictly bounds offering price — replacement must be cheaper
        (karpenter:designs/consolidation.md:15-21).

        Memoized per (catalog object, price cap): returning the SAME
        filtered list object lets the tensorize catalog-side cache hit
        instead of rebuilding its option tables every simulation.  The
        memo is filled with one atomic `setdefault`, so a watchdog worker
        the tick abandoned (utils/watchdog.py), racing the tick's own
        sequential path, gets the very list the tick keeps using and never
        replaces it under the tick."""
        catalog = self.provider.get_instance_types()
        if max_total_price is None:
            return catalog
        memo_cat, memo = getattr(self, "_filtcat_memo", (None, None))
        if memo_cat is not catalog:
            memo = {}
            self._filtcat_memo = (catalog, memo)
        hit = memo.get(max_total_price)
        if hit is not None:
            return hit
        out = []
        for it in catalog:
            offerings = [o for o in it.offerings
                         if o.available and o.price < max_total_price]
            if offerings:
                out.append(InstanceType(
                    name=it.name, requirements=it.requirements,
                    offerings=offerings, capacity=it.capacity,
                    kube_reserved=it.kube_reserved,
                    system_reserved=it.system_reserved,
                    eviction_threshold=it.eviction_threshold, info=it.info))
        if len(memo) >= 64:  # bound growth across many distinct price caps
            memo.clear()
        return memo.setdefault(max_total_price, out)

    def _orig(self, p: Pod) -> Pod:
        return self.cluster.original(p)

    def simulate(self, excluded: Sequence[Candidate],
                 allow_new: bool = False,
                 max_total_price: Optional[float] = None,
                 decode: bool = True
                 ) -> Tuple[Problem, PackingResult, List[Node]]:
        """Would the excluded candidates' pods schedule on the surviving
        nodes [+ cheaper new capacity]?  One batched solve over dense arrays
        instead of the reference's per-candidate replay.

        ``decode=False`` is the feasibility-probe mode (aggregate kernel, no
        per-pod binding, no batch-topology audit): only the ONE accepted
        action needs real assignments."""
        pods = [p for c in excluded for p in c.reschedulable]
        catalog = self._filtered_catalog(max_total_price) if allow_new else []
        pools = list(self.nodepools.values())
        exclude_names = [c.name for c in excluded]
        # required-only lowering: preferences never block consolidation, but
        # spread/anti-affinity must hold on the post-disruption cluster
        zones = sorted({o.zone for it in catalog for o in it.offerings
                        if o.available}
                       | {n.zone for n in self.cluster.nodes.values()
                          if n.name not in exclude_names and n.zone})
        pods = lower_pods(pods, nodes=self.cluster.nodes.values(),
                          option_zones=zones, exclude_nodes=exclude_names,
                          level=LEVEL_REQUIRED_ONLY,
                          zone_feasible=make_zone_feasibility(
                              catalog, self.cluster.nodes.values(),
                              exclude_nodes=exclude_names))
        problem = tensorize(pods, catalog, pools,
                            node_classes=getattr(self.provider,
                                                 "node_classes", None))
        node_list, alloc, used, compat = self.cluster.tensorize_nodes(
            problem.class_reps, problem.axes, exclude=exclude_names,
            scales=problem.scales)
        if len(node_list) == 0 and problem.num_options == 0:
            result = PackingResult(
                nodes=[], unschedulable=list(range(len(pods))),
                existing_assignments={}, total_price=0.0)
            return problem, result, node_list
        result = self._simulate_pack(problem, node_list, alloc, used,
                                     compat, decode)
        if decode:
            # intra-batch anti-affinity/spread the masks can't express: a
            # violated placement disqualifies the whole action, so count
            # the violating pods as unschedulable rather than executing a
            # bad bind
            violations = find_batch_topology_violations(problem, result,
                                                        node_list)
            if violations:
                result.unschedulable = sorted(
                    set(result.unschedulable) | violations)
        return problem, result, node_list

    def _simulate_pack(self, problem: Problem, node_list, alloc, used,
                       compat, decode: bool) -> PackingResult:
        """Simulation solve under the degradation ladder, mirroring
        Provisioner._pack_supervised: healthy = the direct path (sharded
        gate → classpack); failures fall one rung per attempt and are
        booked in the shared SolverHealth; greedy is deadline-free and
        re-raises — it is the floor.  A device fault is raised from any
        rung and not booked: no host rung answers for the card."""
        requested = "sharded" if (decode and self.sharded_solve) else "jax"
        if self.health is None:
            return self._simulate_rung(requested, problem, node_list,
                                       alloc, used, compat, decode)
        rung = self.health.active_rung(requested)
        while True:
            timeout = 0.0 if rung == "greedy" else self.watchdog_timeout_s
            try:
                result = run_with_deadline(
                    lambda: self._simulate_rung(rung, problem, node_list,
                                                alloc, used, compat, decode),
                    timeout, "disruption.simulate")
                self.health.report_success(rung)
                return result
            except WatchdogTimeout:
                self.health.report_failure(rung, reason="timeout")
            except DEVICE_FAULTS:
                raise
            except Exception:
                log.exception("simulation rung %s failed", rung)
                self.health.report_failure(rung, reason="error")
                if rung == "greedy":
                    raise
            rung = self.health.active_rung(
                self.health.next_rung(rung) or "greedy")

    def _simulate_rung(self, rung: str, problem: Problem, node_list,
                       alloc, used, compat, decode: bool) -> PackingResult:
        """One simulation attempt on one rung.  "jax" is the reference's
        name for the class-granular classpack rung; a sharded refusal falls
        through to it inline (routing, not failure).  The native and greedy
        rungs run the pod-granular FFD on the host — it always decodes,
        which a decode=False probe tolerates (the caller only reads the
        aggregate fields of the PackingResult)."""
        CHAOS.inject("solver.pack", key=rung)
        ekw = dict(existing_alloc=alloc if len(node_list) else None,
                   existing_used=used if len(node_list) else None,
                   existing_compat=compat if len(node_list) else None)
        if rung == "sharded":
            result = maybe_solve_partitioned(
                problem, path="disruption", max_nodes=2048,
                node_list=node_list, mesh=self.mesh, device=self.device,
                **ekw)
            if result is not None:
                return result
            rung = "jax"
        if rung == "jax":
            return solve_classpack(
                problem, decode=decode,
                # the LPGuide gate covers THIS path too: a fresh replacement
                # solve (all candidates excluded, no survivors) would
                # otherwise run the guide despite the escape hatch
                guide="lp" if self.lp_guide else None, device=self.device,
                **ekw)
        if rung == "native":   # raises where the library is unavailable
            return solve_ffd(problem, max_nodes=2048, backend="native", **ekw)
        return solve_ffd(problem, max_nodes=2048, backend="numpy", **ekw)

    # ------------------------------------------------------------------
    # methods, in the reference's order
    # ------------------------------------------------------------------
    def find_expired(self, cands: List[Candidate]) -> List[Candidate]:
        now = self.clock()
        return [c for c in cands
                if c.pool.disruption.expire_after_s
                and now - c.node.created_at > c.pool.disruption.expire_after_s]

    def find_drifted(self, cands: List[Candidate]) -> List[Candidate]:
        if not self.drift_enabled:
            return []
        out = []
        counted = self.__dict__.setdefault("_drift_counted", set())
        for c in cands:
            if c.claim is not None and self.provider.is_drifted(c.claim, c.pool):
                out.append(c)
                # transition counter: first detection only, not every tick
                # (reference karpenter_nodeclaims_drifted)
                if c.name not in counted:
                    counted.add(c.name)
                    metrics.nodeclaims_drifted().inc(
                        {"nodepool": c.node.nodepool or ""})
        # prune only nodes GONE from the cluster: a drifted node that
        # transiently leaves candidacy (nomination, PDB, truncation) stays
        # counted so its return doesn't inflate the transition counter
        counted.intersection_update(set(self.cluster.nodes))
        return out

    def find_empty(self, cands: List[Candidate]) -> List[Candidate]:
        """Emptiness: nodes with no reschedulable pods that have STAYED empty
        for consolidate_after_s (time since empty, not node age — a node
        that just lost its last pod gets the full delay)."""
        now = self.clock()
        empty_names = set()
        out = []
        for c in cands:
            if c.reschedulable:
                continue
            empty_names.add(c.name)
            since = self._empty_since.setdefault(c.name, now)
            after = c.pool.disruption.consolidate_after_s or 0.0
            if now - since < after:
                continue
            out.append(c)
        # nodes that regained pods (or vanished) reset their empty timer
        for name in list(self._empty_since):
            if name not in empty_names:
                del self._empty_since[name]
        return out

    # ------------------------------------------------------------------
    # the single-action reconcile
    # ------------------------------------------------------------------
    def reconcile(self) -> DisruptionResult:
        with tracing.span("disruption.reconcile") as sp:
            out = self._reconcile()
            sp.annotate(
                action=getattr(out.action, "name", "") if out.action else "",
                deleted=len(out.deleted), launched=len(out.launched))
            return out

    def _reconcile(self) -> DisruptionResult:
        eval_hist = metrics.disruption_evaluation_duration()
        eligible = metrics.disruption_eligible_nodes()
        with tracing.span("disruption.candidates") as csp:
            cands = self.candidates()
            # per-method eligibility gauges, all computed up-front so no
            # series goes stale when an earlier method short-circuits the
            # tick (calling find_empty every tick also keeps its empty-since
            # timers fresh)
            expired = self.find_expired(cands)
            drifted = self.find_drifted(cands)
            empty = self.find_empty(cands)
            underutil = [c for c in cands
                         if c.pool.disruption.consolidation_policy ==
                         "WhenUnderutilized"]
            eligible.set(len(expired), {"method": "expiration"})
            eligible.set(len(drifted), {"method": "drift"})
            eligible.set(len(empty), {"method": "emptiness"})
            eligible.set(len(underutil), {"method": "consolidation"})
            csp.annotate(candidates=len(cands), expired=len(expired),
                         drifted=len(drifted), empty=len(empty))

        # 0. gang preemption (GangScheduling): a waiting higher-tier gang
        #    outranks bound lower-tier pods; one queued plan executes per
        #    tick, ahead of every other method — admission latency for
        #    tiered gangs is the whole point of the cascade
        if self.gang_source is not None:
            plan = self.gang_source()
            if plan is not None:
                return self._execute_preemption(plan)

        if not cands:
            return DisruptionResult()

        def timed(method, fn):
            # span names come from one registry (graftlint OB005):
            # registered() asserts disruption.<method> is in SPAN_NAMES
            with tracing.span(tracing.registered(f"disruption.{method}")):
                t0 = time.perf_counter()
                try:
                    return fn()
                finally:
                    dt = time.perf_counter() - t0
                    eval_hist.observe(dt, {"method": method})
                    # the reference aborts a consolidation pass at its
                    # 1-minute budget and counts it; the batched simulator
                    # stays ~3 orders of magnitude under that, so the
                    # counter exists to prove the budget is honored, not
                    # because it ever fires
                    if dt > CONSOLIDATION_TIMEOUT_S:
                        metrics.consolidation_timeouts().inc({"method": method})

        # 1. expiration (graceful replace: pods rescheduled, new capacity allowed)
        if expired:
            action = timed("expiration",
                           lambda: self._replace_or_delete(expired[:1],
                                                           "expiration"))
            if action:
                return self.execute(action)

        # 2. drift
        if drifted:
            action = timed("drift",
                           lambda: self._replace_or_delete(drifted[:1],
                                                           "drift"))
            if action:
                return self.execute(action)

        # 3. emptiness — all empty candidates in one shot (reference's
        #    emptiness batch delete)
        if empty:
            return self.execute(Action(kind="delete", reason="emptiness",
                                       candidates=empty))

        # 4. consolidation (WhenUnderutilized pools only)
        action = timed("consolidation",
                       lambda: self.consolidation_action(underutil))
        if action:
            return self.execute(action)
        return DisruptionResult()

    def _execute_preemption(self, plan) -> DisruptionResult:
        """Evict one gang preemption plan's victims: each unbinds to
        pending (the consolidation-reschedule motion — the pod re-solves
        next provisioning round, the node keeps running for its other
        pods).  Victims that moved or exited since planning are skipped;
        if the freed room proves insufficient the next solve queues a
        deeper plan down the cascade."""
        evicted = 0
        for v in plan.victims:
            node = self.cluster.nodes.get(v.node)
            if node is None:
                continue
            pod = next((p for p in node.pods if p.uid == v.uid), None)
            if pod is None:
                continue
            self.cluster.unbind_pod(pod)
            metrics.gang_preemptions().inc({"tier": str(v.tier)})
            self.recorder.publish(Event(
                kind="Pod", name=pod.name, reason="GangPreempted",
                message=(f"evicted for gang {plan.gang}: tier {v.tier} "
                         f"yields to tier {plan.tier}"),
                type="Warning"))
            evicted += 1
        log.info("gang preemption for %s: evicted %d/%d victims in %s %r",
                 plan.gang, evicted, len(plan.victims), plan.topology,
                 plan.domain)
        return DisruptionResult(action=Action(kind="preempt", reason="gang",
                                              candidates=[]))

    def _replace_or_delete(self, targets: List[Candidate],
                           reason: str) -> Optional[Action]:
        """Expiration / drift: the pods must land somewhere — on the
        surviving nodes or on replacement capacity at any price."""
        problem, result, survivors = self.simulate(targets, allow_new=True)
        if result.unschedulable:
            log.info("%s of %s blocked: %d pods would be unschedulable",
                     reason, [c.name for c in targets],
                     len(result.unschedulable))
            return None
        kind = "replace" if result.nodes else "delete"
        return Action(kind=kind, reason=reason, candidates=targets,
                      simulation=result, problem=problem,
                      surviving_nodes=survivors)

    # ------------------------------------------------------------------
    # consolidation
    # ------------------------------------------------------------------
    def consolidation_action(self, cands: List[Candidate]) -> Optional[Action]:
        """Multi-node delete first (largest feasible prefix of the
        cost-sorted candidates), then single-node delete-or-replace.

        The batched path answers every probe the sequential algorithm would
        ask from AT MOST THREE sweep calls on a cached `SimulationArena`:
        the delete binary search's reachable mids as 1-2 batched frontier
        probes, then (only if no delete wins) one all-candidate replacement
        screen.  Fully-decoded solves remain only for the winning action —
        the decode-audit fallback is unchanged."""
        cands = [c for c in cands if self._consolidatable(c)]
        if not cands:
            return None
        if not self.batched_sweep:
            return self._consolidation_action_sequential(cands)
        timeout = self.watchdog_timeout_s if self.health is not None else 0.0
        try:
            return run_with_deadline(
                lambda: self._consolidation_action_batched(cands),
                timeout, "disruption.sweep")
        except WatchdogTimeout:
            # hung sweep: book it against the jax rung (the arena's kernels
            # live there) and finish THIS tick on the sequential path, whose
            # simulate() probes consult the now-demoted ladder
            self.health.report_failure("jax", reason="timeout")
            return self._consolidation_action_sequential(cands)

    def _consolidation_action_batched(self,
                                      cands: List[Candidate]
                                      ) -> Optional[Action]:
        CHAOS.inject("solver.sweep")
        sweep_hist = metrics.disruption_sweep_duration()
        t0 = time.perf_counter()
        with tracing.span("sweep.arena", candidates=len(cands)):
            arena = self._arena_for(cands)
        # PDB composition over prefix unions, computed incrementally on the
        # host in ONE pass (the sequential path rebuilt the union and
        # rescanned every PDB per binary-search step)
        evict_ok = self._prefix_evictable(cands)
        # replay the sequential binary search exactly, but evaluate its
        # probes in batched rounds: each round solves EVERY prefix the
        # search could still reach in its next few levels (whole levels of
        # the mid decision tree, ≤31 rows ⇒ ≤2 rounds at any N), then
        # walks the real outcomes.  The search only ever reads mids we
        # evaluated with the same oracle, so best_mid is identical to the
        # sequential result even when feasibility is non-monotone in the
        # prefix length
        device_calls = 0
        feas: Dict[int, bool] = {}
        lo, hi, best_mid = 1, len(cands), 0
        with tracing.span("sweep.prefix") as psp:
            while lo <= hi:
                mids = _search_frontier(lo, hi)
                need = [k for k in mids if k not in feas]
                if need:
                    sweep = arena.sweep_prefix_subset(need)
                    device_calls += sweep.device_calls
                    for i, k in enumerate(need):
                        feas[k] = evict_ok[k] and sweep.feasible_delete(i)
                while lo <= hi:
                    mid = (lo + hi) // 2
                    if mid not in feas:
                        break
                    if feas[mid]:
                        best_mid = mid
                        lo = mid + 1
                    else:
                        hi = mid - 1
            psp.annotate(device_calls=device_calls, best_mid=best_mid)
        sweep_hist.observe(time.perf_counter() - t0, {"phase": "prefix"})
        # the aggregate probe is optimistic about intra-batch topology
        # (spread/anti-affinity audits need assignments): decode the winner
        # — common case, ONE decoded solve total.  If the audit rejects it,
        # rerun the binary search with decoded probes over the remaining
        # range: the pre-probe algorithm, paid only when audits bite.
        with tracing.span("sweep.decode", best_mid=best_mid) as dsp:
            best = self._decoded_delete_action(cands[:best_mid]) if best_mid else None
            if best is None and best_mid > 1:
                dsp.annotate(audit_rejected=True)
                lo, hi = 1, best_mid - 1
                while lo <= hi:
                    mid = (lo + hi) // 2
                    a = self._decoded_delete_action(cands[:mid])
                    if a is not None:
                        best = a
                        lo = mid + 1
                    else:
                        hi = mid - 1
        if best is not None:
            metrics.disruption_sweep_probes().set(device_calls)
            return best

        # single-node pass: one batched screen over ALL candidates (the
        # sequential loop paid one aggregate solve per candidate), then the
        # decoded accept path candidate-by-candidate in discovery order —
        # first acceptance wins, exactly like the sequential loop.
        t1 = time.perf_counter()
        with tracing.span("sweep.single") as ssp:
            screen = arena.sweep_singles()
            sweep_hist.observe(time.perf_counter() - t1, {"phase": "single"})
            device_calls += screen.device_calls
            ssp.annotate(device_calls=screen.device_calls)
            metrics.disruption_sweep_probes().set(device_calls)
            for i, c in enumerate(cands):
                if not c.reschedulable:
                    continue
                if screen.unschedulable[i] or screen.new_nodes[i] > 1:
                    continue
                if screen.new_nodes[i] and screen.total_price[i] >= c.price:
                    continue
                action = self._decoded_single_action(c)
                if action is not None:
                    return action
            return None

    def _arena_for(self, cands: List[Candidate]):
        """Size-1 simulation-arena cache keyed on the cluster-state
        fingerprint: repeat probes within a tick and unchanged clusters
        across ticks reuse the tensorized arrays and swap only masks."""
        from ..api.resources import DEFAULT_AXES
        from ..ops.tensorize import (SimulationArena, _catside_fingerprint,
                                     arena_fingerprint)
        catalog = self.provider.get_instance_types()
        pools = list(self.nodepools.values())
        ncs = getattr(self.provider, "node_classes", None)
        cat_key = _catside_fingerprint(catalog, pools, DEFAULT_AXES,
                                       node_classes=ncs)
        # lazy re-fingerprint: arena_fingerprint walks every node and bound
        # pod (O(E+P)); the cluster's mutation_epoch is bumped by every
        # mutator, so an unchanged epoch + identical candidate list proves
        # the O(E+P) walk would produce the same key
        epoch = getattr(self.cluster, "mutation_epoch", None)
        fp = self._fingerprint_cache
        if (fp is not None and epoch is not None and fp[0] == epoch
                and fp[1] == cat_key and _cands_match(fp[2], cands)):
            key = fp[3]
        else:
            key = arena_fingerprint(cands, self.cluster.nodes.values(),
                                    cat_key)
            self._fingerprint_cache = (epoch, cat_key, list(cands), key)
        cached = self._arena_cache
        if cached is not None and cached[0] == key:
            metrics.disruption_arena_requests().inc({"outcome": "hit"})
            tracing.annotate(arena="hit")
            return cached[1]
        arena = SimulationArena(cands, self.cluster, catalog, pools,
                                node_classes=ncs, device=self.device)
        self._arena_cache = (key, arena)
        metrics.disruption_arena_requests().inc({"outcome": "build"})
        tracing.annotate(arena="build")
        return arena

    def _prefix_evictable(self, cands: List[Candidate]) -> List[bool]:
        """evict_ok[k] ⇔ evicting the union of cands[:k] clears every PDB
        budget — `cluster.evictable` over growing prefixes in one
        incremental pass (draws only grow, so the first failing prefix
        poisons all larger ones)."""
        n = len(cands)
        if not self.cluster.pdbs:
            return [True] * (n + 1)
        budgets = self.cluster.pdb_budgets()
        ok = [True]
        draw: Dict[str, int] = {}
        good = True
        for c in cands:
            if good:
                for p in c.reschedulable:
                    for pdb in self.cluster.pdbs.values():
                        if pdb.matches(p):
                            draw[pdb.name] = draw.get(pdb.name, 0) + 1
                good = all(budgets[name] >= v for name, v in draw.items())
            ok.append(good)
        return ok

    def _consolidation_action_sequential(self, cands: List[Candidate]
                                         ) -> Optional[Action]:
        """The pre-arena algorithm (binary search + per-candidate screen
        loop, one tensorize + aggregate solve per probe): the oracle the
        batched sweep's parity tests run against, and the escape hatch."""
        # multi-node / single-node DELETE: pods fit on surviving nodes alone.
        # The union of a subset's evictions must clear the PDB budgets too —
        # per-node checks in candidates() don't compose.
        lo, hi, best_mid = 1, len(cands), 0
        while lo <= hi:
            mid = (lo + hi) // 2
            subset = cands[:mid]
            union = [p for c in subset for p in c.reschedulable]
            if not self.cluster.evictable(union):
                hi = mid - 1
                continue
            _, result, _ = self.simulate(subset, allow_new=False, decode=False)
            if not result.unschedulable and not result.nodes:
                best_mid = mid
                lo = mid + 1
            else:
                hi = mid - 1
        best = self._decoded_delete_action(cands[:best_mid]) if best_mid else None
        if best is None and best_mid > 1:
            lo, hi = 1, best_mid - 1
            while lo <= hi:
                mid = (lo + hi) // 2
                a = self._decoded_delete_action(cands[:mid])
                if a is not None:
                    best = a
                    lo = mid + 1
                else:
                    hi = mid - 1
        if best is not None:
            return best

        # single-node pass: DELETE if the solver lands every pod on
        # survivors, else REPLACE with ONE strictly-cheaper node.  Aggregate
        # screen first; decode only accepted candidates.
        for c in cands:
            if not c.reschedulable:
                continue
            _, screen, _ = self.simulate(
                [c], allow_new=True, max_total_price=c.price, decode=False)
            if screen.unschedulable or len(screen.nodes) > 1:
                continue
            if screen.nodes and screen.total_price >= c.price:
                continue
            action = self._decoded_single_action(c)
            if action is not None:
                return action
        return None

    def _decoded_single_action(self, c: Candidate) -> Optional[Action]:
        """Fully-decoded single-candidate delete-or-replace: the accept path
        both the batched screen and the sequential screen feed into."""
        problem, result, survivors = self.simulate(
            [c], allow_new=True, max_total_price=c.price)
        if result.unschedulable or len(result.nodes) > 1:
            return None
        if not result.nodes:   # pure delete — survivors absorb everything
            return Action(kind="delete", reason="consolidation",
                          candidates=[c], simulation=result,
                          problem=problem, surviving_nodes=survivors)
        if result.total_price >= c.price:
            return None
        # spot→spot replacement needs flexibility (the reference's ≥15
        # cheaper-offerings floor): count only SPOT alternatives strictly
        # cheaper than the replaced node, clamped to how many cheaper spot
        # types the pool's catalog has at all
        chosen = result.nodes[0]
        if (c.node.capacity_type == wk.CAPACITY_TYPE_SPOT
                and chosen.option.capacity_type == wk.CAPACITY_TYPE_SPOT):
            # distinct cheaper spot TYPES, matching spot_alts' dedup
            pool_spot_cheaper = len({
                o.instance_type for o in problem.options
                if o.capacity_type == wk.CAPACITY_TYPE_SPOT
                and o.pool == chosen.option.pool and o.price < c.price})
            floor = min(self.spot_min_flexibility, pool_spot_cheaper)
            spot_alts = {a.instance_type for a in chosen.alternatives
                         if a.capacity_type == wk.CAPACITY_TYPE_SPOT
                         and a.price < c.price}
            spot_alts.add(chosen.option.instance_type)
            if len(spot_alts) < floor:
                return None
        return Action(kind="replace", reason="consolidation",
                      candidates=[c], simulation=result, problem=problem,
                      surviving_nodes=survivors)

    def _decoded_delete_action(self, subset: List[Candidate]) -> Optional[Action]:
        """Fully-decoded delete feasibility (incl. the batch-topology audit)
        for one candidate prefix; None if the subset can't be deleted."""
        union = [p for c in subset for p in c.reschedulable]
        if not self.cluster.evictable(union):
            return None
        problem, result, survivors = self.simulate(subset, allow_new=False)
        if result.unschedulable or result.nodes:
            return None
        return Action(kind="delete", reason="consolidation", candidates=subset,
                      simulation=result, problem=problem,
                      surviving_nodes=survivors)

    def _consolidatable(self, c: Candidate) -> bool:
        now = self.clock()
        after = c.pool.disruption.consolidate_after_s
        if after is not None and now - c.node.created_at < after:
            return False
        return True

    # ------------------------------------------------------------------
    # execution: taint → launch the replacements → rebind → terminate
    # ------------------------------------------------------------------
    def execute(self, action: Action) -> DisruptionResult:
        # cost-ledger attribution: every launch/terminate inside this
        # actuation funnel is tagged with the disruption reason (free
        # when the SLOEngine gate is off — the context is a thread-local
        # set/clear and the hooks behind it check LEDGER.enabled first)
        from ..obs.ledger import DECISION_SOURCES, LEDGER
        src = action.reason if action.reason in DECISION_SOURCES \
            else "consolidation"
        with tracing.span("disruption.execute", kind=action.kind,
                          reason=action.reason) as sp, LEDGER.decision(src):
            out = self._execute(action)
            sp.annotate(deleted=len(out.deleted), launched=len(out.launched))
            return out

    def _execute(self, action: Action) -> DisruptionResult:
        out = DisruptionResult(action=action)
        # taint first so nothing new schedules onto doomed nodes
        # (website/.../concepts/disruption.md:9-14)
        for c in action.candidates:
            c.node.marked_for_deletion = True
            if DISRUPTION_TAINT not in c.node.taints:
                c.node.taints.append(DISRUPTION_TAINT)
            self.cluster.touch_node(c.node)

        new_nodes: List[Node] = []
        catalog_by_name = {it.name: it
                           for it in self.provider.get_instance_types()}
        if action.simulation is not None and action.simulation.nodes:
            from .provisioning import claim_from_decision
            for decision in action.simulation.nodes:
                t_launch = time.perf_counter()
                dpods = [self._orig(action.problem.pods[i])
                         for i in decision.pod_indices]
                claim = claim_from_decision(decision, dpods, self.nodepools)
                try:
                    claim = self.provider.create(claim)
                except InsufficientCapacityError as e:
                    # rollback: untaint, unmark, abandon the action
                    # (website/.../concepts/disruption.md:12-14)
                    metrics.disruption_replacement_failures().inc(
                        {"method": action.reason})
                    self.recorder.publish(Event(
                        "Node", action.candidates[0].name, "DisruptionFailed",
                        f"replacement launch failed: {e}", type="Warning"))
                    log.warning("disruption rollback, launch failed: %s", e)
                    self._rollback(action, new_nodes, out)
                    out.error = str(e)
                    return out
                it = catalog_by_name.get(claim.instance_type)
                if it is not None:
                    ncs = getattr(self.provider, "node_classes", None) or {}
                    it = effective_instance_type(
                        it, self.nodepools.get(claim.nodepool),
                        ncs.get(claim.node_class_ref))
                node = self.cluster.register_nodeclaim(
                    claim, it.allocatable if it else claim.requests,
                    it.capacity if it else None)
                node._decision = decision
                new_nodes.append(node)
                out.launched.append(claim)
                # the replacement goes live at registration in this
                # substrate: create call → registered is its initialization
                metrics.disruption_replacement_initialized().observe(
                    time.perf_counter() - t_launch)

        # rebind the evicted pods — the cluster's originals, never the
        # lowered copies — per the simulation's placement
        if action.simulation is not None:
            sim = action.simulation
            for pod_i, slot in sim.existing_assignments.items():
                self.cluster.bind_pod(self._orig(action.problem.pods[pod_i]),
                                      action.surviving_nodes[slot].name)
            for node in new_nodes:
                for pod_i in node._decision.pod_indices:
                    self.cluster.bind_pod(
                        self._orig(action.problem.pods[pod_i]), node.name)

        # terminate the candidates — through the finalizer drain when a
        # terminator is wired, else the inline state-level equivalent
        for c in action.candidates:
            if self.terminator is not None:
                tres = self.terminator.drain_sync(c.node, reason=action.reason)
                out.deleted.extend(tres.terminated)
                if tres.errors:
                    out.error = "; ".join(tres.errors)
                else:
                    # count only actual disruptions — a failed drain retries
                    # next tick and must not double-count
                    metrics.nodeclaims_disrupted().inc(
                        {"type": action.reason,
                         "nodepool": c.node.nodepool or ""})
                continue
            # daemonset pods die with their node — they must NOT be requeued
            # as pending (a fresh node would be provisioned just for them)
            for p in list(c.node.pods):
                if p.is_daemon:
                    self.cluster.delete_pod(p)
            try:
                if c.claim is not None:
                    self.provider.delete(c.claim)
                    self.cluster.nodeclaims.pop(c.claim.name, None)
            except Exception as e:  # noqa: BLE001 — the cloud call's failure
                already_gone = isinstance(e, CloudError) and is_not_found(e)
                if not already_gone:
                    # transient cloud failure: untaint so the next reconcile
                    # retries this (now empty) node instead of stranding a
                    # billed zombie behind marked_for_deletion
                    c.node.marked_for_deletion = False
                    c.node.taints = [t for t in c.node.taints
                                     if t.key != DISRUPTION_TAINT.key]
                    self.cluster.touch_node(c.node)
                    out.error = str(e)
                    continue
                self.cluster.nodeclaims.pop(c.claim.name, None)
            self.cluster.remove_node(c.name)
            out.deleted.append(c.name)
            metrics.nodeclaims_disrupted().inc(
                {"type": action.reason, "nodepool": c.node.nodepool or ""})
            self.recorder.publish(Event(
                "Node", c.name, "DisruptionTerminating",
                f"{action.kind} via {action.reason}"))
        log.info("disruption %s: deleted %s, launched %s", action.name,
                 out.deleted, [c.name for c in out.launched])
        return out

    def _rollback(self, action: Action, new_nodes: List[Node],
                  out: DisruptionResult):
        """Undo a partly carried-out action: untaint and unmark the
        candidates, delete the replacements already launched.  The ICE
        cache keeps what the failed launch taught it."""
        for c in action.candidates:
            c.node.marked_for_deletion = False
            c.node.taints = [t for t in c.node.taints
                             if t.key != DISRUPTION_TAINT.key]
            self.cluster.touch_node(c.node)
        for node in new_nodes:
            claim = self.cluster.claim_for_provider_id(node.provider_id)
            if claim is not None:
                self.provider.delete(claim)
                self.cluster.nodeclaims.pop(claim.name, None)
            self.cluster.remove_node(node.name)
        out.launched.clear()
