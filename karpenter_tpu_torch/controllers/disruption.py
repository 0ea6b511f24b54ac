"""The consolidation decision: candidates → SimulationArena → batched sweep
→ decoded accept.

A copy of the decision half of the JAX package's `controllers/disruption.py`
(karpenter-core's disruption engine, karpenter:designs/consolidation.md and
karpenter:designs/deprovisioning.md):

  * candidate discovery with blockers — do-not-disrupt pods, PDB budgets,
    ownerless pods, recently-created nodes, in-flight nominations, live
    headroom placeholders;
  * consolidation's two actions: node *deletion* (pods fit on the remaining
    nodes) and node *replacement* (pods fit on remaining nodes + one cheaper
    node), decided by simulated scheduling;
  * disruption-cost candidate ranking weighted by remaining node lifetime.

The simulation is the class-granular packing solve: a probe family is 1-2
calls of the K1 + K5 sweep kernels on a cached `SimulationArena`, and the
one accepted action is re-validated by a decoded K1 + K2 + K3 solve with
the survivors as pre-opened columns — through the partitioned mesh driver
(parallel/driver.py, shard-batched kernels) first when the ShardedSolve
gate (`sharded_solve`) is on and the batch is shardable.  Every solve runs
on `device` ("cuda" by default; "cpu" runs the kernels' plain versions and
only when asked).

The provider is read only through `get_instance_types()` and
`node_classes`, as the reference reads it on this path.  Not ported yet
(ROADMAP.md): `reconcile` / `execute` / rollback, drift, expiration,
emptiness and gang preemption (they need the cloud provider and the
terminator), the solver-health ladder and its watchdog, and the native
and greedy simulation rungs; the options that select them raise
NotImplementedError.  The reference's metric and span calls are left out.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..api import labels as wk
from ..api.objects import Node, NodeClaim, NodePool, Pod, pool_view
from ..catalog.instancetype import InstanceType
from ..forecast.headroom import headroom_expiry, is_headroom
from ..ops.classpack import resolve_device, solve_classpack
from ..ops.constraints import (LEVEL_REQUIRED_ONLY,
                               find_batch_topology_violations, lower_pods,
                               make_zone_feasibility)
from ..ops.ffd import PackingResult
from ..ops.tensorize import Problem, tensorize
from ..parallel.driver import maybe_solve_partitioned
from ..state.cluster import Cluster
from ..utils.events import Event

log = logging.getLogger("karpenter_tpu_torch.disruption")

# Tunables (karpenter:designs/consolidation.md:61-67,
# karpenter:designs/deprovisioning.md:27-33).
DEFAULT_STABILIZATION_S = 5 * 60.0   # min node lifetime before disruption
# spot→spot replacement keeps this many cheaper launch alternatives so the
# new node retains fleet flexibility (reference consolidation docs: ≥15
# cheaper offerings required for spot-to-spot consolidation)
SPOT_TO_SPOT_MIN_ALTERNATIVES = 15


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
    `replacements` first (named {delete,replace}{Consolidation,...} like the
    reference's action strings)."""
    kind: str                       # "delete" | "replace"
    reason: str                     # "consolidation" | ...
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
    """The consolidation decision over cluster state.

    The signature is the reference's plus `device` and `mesh` (the
    ShardedSolve gate's mesh; default `parallel.make_pod_mesh` on `device`).
    `health`, `watchdog_timeout_s > 0`, `gang_source` and `terminator`
    select parts that are not ported yet and raise NotImplementedError."""

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
        unported = [name for name, on in (
            ("health", health is not None),
            ("watchdog_timeout_s", watchdog_timeout_s > 0),
            ("gang_source", gang_source is not None),
            ("terminator", terminator is not None)) if on]
        if unported:
            raise NotImplementedError(
                f"DisruptionController({', '.join(unported)}) is not ported "
                f"yet — ROADMAP.md queue B ('disruption execution')")
        from ..utils.events import Recorder
        self.device = resolve_device(device)
        self.provider = provider
        self.cluster = cluster
        self.nodepools = pool_view(nodepools)
        self.clock = clock
        self.recorder = recorder or Recorder(log=False)
        self.stabilization_s = stabilization_s
        self.drift_enabled = drift_enabled
        self.max_candidates = max_candidates
        self.spot_min_flexibility = spot_min_flexibility
        self.lp_guide = lp_guide
        self.batched_sweep = batched_sweep
        self.sharded_solve = sharded_solve
        self.mesh = mesh
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
            # NOT sweep everything — say so
            dropped = len(out) - self.max_candidates
            log.info("candidate discovery truncated: %d of %d kept "
                     "(max_candidates=%d), %d dropped",
                     self.max_candidates, len(out), self.max_candidates,
                     dropped)
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
        instead of rebuilding its option tables every simulation."""
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
        memo[max_total_price] = out
        return out

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
        """Simulation solve: the sharded gate → classpack, the reference's
        healthy path.  The reference runs it under a degradation ladder
        when `health` is set; the port has no ladder here (`health`
        raises)."""
        requested = "sharded" if (decode and self.sharded_solve) else "jax"
        return self._simulate_rung(requested, problem, node_list, alloc,
                                   used, compat, decode)

    def _simulate_rung(self, rung: str, problem: Problem, node_list,
                       alloc, used, compat, decode: bool) -> PackingResult:
        """One simulation attempt on one rung.  "jax" is the reference's
        name for the class-granular classpack rung; a sharded refusal falls
        through to it inline (routing, not failure).  The native and greedy
        rungs are not ported."""
        if rung not in ("sharded", "jax"):
            raise NotImplementedError(
                f"simulation rung {rung!r} is not ported yet — ROADMAP.md")
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
        return solve_classpack(
            problem, decode=decode,
            # the LPGuide gate covers THIS path too: a fresh replacement
            # solve (all candidates excluded, no survivors) would otherwise
            # run the guide despite the escape hatch
            guide="lp" if self.lp_guide else None, device=self.device, **ekw)

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
        return self._consolidation_action_batched(cands)

    def _consolidation_action_batched(self,
                                      cands: List[Candidate]
                                      ) -> Optional[Action]:
        arena = self._arena_for(cands)
        # PDB composition over prefix unions, computed incrementally on the
        # host in ONE pass
        evict_ok = self._prefix_evictable(cands)
        # replay the sequential binary search exactly, but evaluate its
        # probes in batched rounds: each round solves EVERY prefix the
        # search could still reach in its next few levels (≤31 rows ⇒ ≤2
        # rounds at any N), then walks the real outcomes.  The search only
        # ever reads mids evaluated with the same oracle, so best_mid is
        # identical to the sequential result even when feasibility is
        # non-monotone in the prefix length
        feas: Dict[int, bool] = {}
        lo, hi, best_mid = 1, len(cands), 0
        while lo <= hi:
            mids = _search_frontier(lo, hi)
            need = [k for k in mids if k not in feas]
            if need:
                sweep = arena.sweep_prefix_subset(need)
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
        # the aggregate probe is optimistic about intra-batch topology
        # (spread/anti-affinity audits need assignments): decode the winner
        # — common case, ONE decoded solve total.  If the audit rejects it,
        # rerun the binary search with decoded probes over the remaining
        # range: the pre-probe algorithm, paid only when audits bite.
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

        # single-node pass: one batched screen over ALL candidates, then the
        # decoded accept path candidate-by-candidate in discovery order —
        # first acceptance wins, exactly like the sequential loop.
        screen = arena.sweep_singles()
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
            return cached[1]
        arena = SimulationArena(cands, self.cluster, catalog, pools,
                                node_classes=ncs, device=self.device)
        self._arena_cache = (key, arena)
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
