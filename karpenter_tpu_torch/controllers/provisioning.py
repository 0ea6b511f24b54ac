"""Provisioning controller: pending pods → solver → NodeClaims → launches.

The port of the JAX package's `controllers/provisioning.py`, the
provisioning loop the operator runs every batch window:

  solve      lower the batch's constraints, tensorize it against the
             catalog and the limit-filtered pools, gather the live nodes as
             pre-opened slots, and pack — relaxing soft constraints level by
             level while pods come back unschedulable;
  pack       down the degradation ladder (ops/health.py) when a SolverHealth
             is wired: rung "sharded" (the ShardedSolve gate) is the
             partitioned mesh driver (parallel/driver.py, shard-batched
             kernels), which refuses small or unshardable batches — they
             fall to "jax" inline; rung "jax" is the card (`_pick_solver`: the
             class-granular `solve_classpack` with the LP guide and the
             DeviceDecode slab when gated on, or the pod-granular
             `solve_ffd` for batches of at most NATIVE_CUTOVER_ROWS rows
             and under solver="ffd"), "greedy" the host NumPy FFD.  A
             fault of the card or a kernel (`KernelError`, a CUDA error,
             device memory) is raised, never demoted: the ladder answers
             watchdog trips and faults of the solve's own logic;
  launch     each NodeDecision becomes a NodeClaim with flexible
             instance-type / zone candidates, launched through the
             CloudProvider, registered as a Node and bound; ICE'd launches
             leave their pods pending and the round re-solves once against
             the ICE-masked catalog.

The signature is the reference's plus `device` ("cuda" by default; "cpu"
runs the kernels' plain versions and only when asked for) and `mesh` (the
ShardedSolve gate's mesh; default `parallel.make_pod_mesh` on `device`, one
shard per visible card, where the reference reads `jax.devices()`).  Not
ported yet (ROADMAP.md): `gang_scheduling` raises NotImplementedError; the
"native" rung raises as the reference's does on a host without its C++
library, so a failing "jax" solve lands on "greedy".
The cluster's persistent arena is absent, so the live nodes are always
gathered by `Cluster.tensorize_nodes` (the reference's bit-identical path).
The reference's metrics, spans and chaos seam are left out.
"""

from __future__ import annotations

import functools
import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..api import labels as wk
from ..api.objects import NodeClaim, NodePool, Pod, pool_view
from ..api.requirements import IN, Requirement, Requirements
from ..api.resources import PODS, ResourceList
from ..catalog.instancetype import effective_instance_type
from ..cloud.provider import (CloudProvider, InsufficientCapacityError,
                              NodeClassNotFoundError)
# DEVICE_FAULTS: faults of the card or of a kernel, raised past the ladder,
# since its greedy rung would answer them with work on the host
from ..ops.classpack import DEVICE_FAULTS, resolve_device, solve_classpack
from ..ops.constraints import (MAX_LEVEL, find_batch_topology_violations,
                               has_soft_constraints, lower_pods,
                               make_zone_feasibility)
from ..ops.ffd import NATIVE_CUTOVER_ROWS, NodeDecision, solve_ffd
from ..ops.tensorize import Problem, tensorize
from ..parallel.driver import maybe_solve_partitioned
from ..state.cluster import Cluster
from ..utils.events import Event
from ..utils.provenance import (CAPACITY, ProvenanceRecord,
                                explain_unschedulable)
from ..utils.watchdog import WatchdogTimeout, run_with_deadline

log = logging.getLogger("karpenter_tpu_torch.provisioning")


@dataclass
class ProvisioningResult:
    launched: List[NodeClaim] = field(default_factory=list)
    bound_existing: int = 0
    unschedulable: List[Pod] = field(default_factory=list)
    failed_launches: List[str] = field(default_factory=list)
    # carriers of batch-internal anti-affinity violations, deferred to a
    # follow-up solve (ops/constraints.py post-solve repair)
    stranded: List[Pod] = field(default_factory=list)
    solve_seconds: float = 0.0

    bound_new: int = 0

    @property
    def scheduled(self) -> int:
        return self.bound_existing + self.bound_new


def _pod_class_map(problem) -> np.ndarray:
    """pod index → class id, built once per Problem (cached on it)."""
    m = getattr(problem, "_pod_class_map", None)
    if m is None:
        m = np.empty(len(problem.pods), np.int64)
        for ci, arr in enumerate(problem.members_arrays()):
            m[arr] = ci
        problem._pod_class_map = m
    return m


def claim_requests_columnar(problem, pod_indices: Sequence[int]) -> ResourceList:
    """One claim's request total as a CLASS-block sum (the DeviceDecode
    columnar NodeClaim path): pods in a tensorize class share one request
    spec, so the total folds count × value per class instead of allocating
    a ResourceList per pod.  Equal to the sequential merge for integer
    canonical quantities, with its first-seen key order."""
    idx = np.asarray(pod_indices, np.int64)
    cseq = _pod_class_map(problem)[idx]
    _, first, cnt = np.unique(cseq, return_index=True, return_counts=True)
    requests = ResourceList()
    for j in np.argsort(first, kind="stable").tolist():
        rep = problem.pods[int(idx[first[j]])].requests
        n = int(cnt[j])
        for k, v in rep.items():
            requests[k] = requests.get(k, 0) + n * v
    requests[PODS] = requests.get(PODS, 0) + len(idx)
    return requests


def claim_from_decision(decision: NodeDecision, pods: Sequence[Pod],
                        pools: Dict[str, NodePool],
                        requests: Optional[ResourceList] = None) -> NodeClaim:
    """NodeDecision → NodeClaim with flexible candidates encoded as
    requirements (the shape CloudProvider.create consumes,
    karpenter:pkg/cloudprovider/cloudprovider.go:92-118).  `requests`
    short-circuits the per-pod merge when the caller already built the
    total columnar-wise (claim_requests_columnar)."""
    opt = decision.option
    pool = pools[opt.pool]
    alt_types = [a.instance_type for a in decision.alternatives] or [opt.instance_type]
    alt_zones = sorted({a.zone for a in decision.alternatives} | {opt.zone})
    if requests is None:
        requests = ResourceList()
        for p in pods:
            requests = requests + p.requests
        requests[PODS] = requests.get(PODS, 0) + len(pods)
    claim = NodeClaim(
        nodepool=opt.pool,
        # pool requirements ∩ the decision's flexible candidate lists — a
        # claim always satisfies its NodePool's constraints
        requirements=pool.requirements().union(Requirements.of(
            Requirement(wk.INSTANCE_TYPE, IN, alt_types),
            Requirement(wk.ZONE, IN, alt_zones),
            Requirement(wk.CAPACITY_TYPE, IN, [opt.capacity_type]),
            Requirement(wk.NODEPOOL, IN, [opt.pool]),
        )),
        requests=requests,
        taints=list(pool.template.taints) + list(pool.template.startup_taints),
        node_class_ref=pool.template.node_class_ref,
        labels=dict(pool.template.labels),
    )
    claim._decision_pods = list(pods)  # transient: bound after registration
    return claim


class Provisioner:
    """Batch scheduling loop (pod batching windows live in the controller
    runtime; this is the per-batch solve)."""

    def __init__(self, provider: CloudProvider, cluster: Cluster,
                 nodepools,
                 clock: Callable[[], float] = time.time,
                 max_nodes_per_round: int = 2048,
                 solver: str = "auto",
                 lp_guide: bool = True,
                 refinery=None,
                 recorder=None,
                 provenance=None,
                 sharded_solve: bool = False,
                 health=None,
                 watchdog_timeout_s: float = 0.0,
                 device_decode: bool = False,
                 decode_health=None,
                 device_lp: bool = False,
                 lp_health=None,
                 gang_scheduling: bool = False,
                 device="cuda",
                 mesh=None):
        if gang_scheduling:
            raise NotImplementedError(
                "gang_scheduling is not ported yet — ROADMAP.md queue B, "
                "'gang scheduling'")
        self.device = resolve_device(device)
        self.provider = provider
        self.cluster = cluster
        self.nodepools = pool_view(nodepools)
        self.clock = clock
        # decision provenance: Warning events through the recorder plus the
        # queryable store (utils/provenance.py)
        self.recorder = recorder
        self.provenance = provenance
        self.max_nodes_per_round = max_nodes_per_round
        self.solver = solver
        # ShardedSolve feature gate: partition fleet-scale batches over the
        # mesh's shards (parallel/driver.py); maybe_solve_partitioned
        # returns None for small/unshardable batches and the round falls
        # through to the single-device path
        self.sharded_solve = bool(sharded_solve)
        self.mesh = mesh
        # degradation ladder (ops/health.py): None keeps the direct path;
        # watchdog_timeout_s > 0 arms a hard deadline per pack call
        self.health = health
        self.watchdog_timeout_s = watchdog_timeout_s
        # the LPGuide feature gate: False routes classpack solves straight
        # to the greedy (guide=None) — the operational escape hatch.  With a
        # refinery, guide misses never block the tick.
        self.lp_guide = lp_guide
        self.refinery = refinery if lp_guide else None
        # DeviceLP feature gate: guide misses refine on the PDHG kernel with
        # lp_health as the device_lp→highs ladder
        self.device_lp = bool(device_lp) and lp_guide
        self.lp_health = lp_health if self.device_lp else None
        self._classpack = functools.partial(solve_classpack,
                                            device=self.device)
        if not lp_guide:
            self._classpack = functools.partial(self._classpack, guide=None)
        elif self.refinery is not None:
            self._classpack = functools.partial(self._classpack,
                                                refinery=self.refinery)
        if self.device_lp:
            self._classpack = functools.partial(
                self._classpack, device_lp=True, lp_health=self.lp_health)
        # DeviceDecode feature gate: the kernels emit the slot-sorted slab
        # and the host assembles plans and NodeClaims column-wise
        # (ops/decode.py), with the DecodeHealth breaker
        self.device_decode = bool(device_decode)
        self.decode_health = decode_health
        if self.device_decode:
            self._classpack = functools.partial(
                self._classpack, device_decode=True,
                decode_health=decode_health)
        self._ffd = functools.partial(solve_ffd, device=self.device)

    def _pick_solver(self, problem: Problem, n_existing: int = 0):
        """The class-granular solve is the provisioning hot path; tiny
        batches take the pod-granular solve (whose native backend, in the
        reference, finishes before a device launch would; here its "auto"
        backend is the K7 kernel)."""
        if self.solver == "classpack":
            return self._classpack
        if self.solver == "ffd":
            return self._ffd
        rows = int(problem.class_counts.sum()) + n_existing
        return self._ffd if rows <= NATIVE_CUTOVER_ROWS else self._classpack

    def _pack_supervised(self, problem: Problem, existing):
        """Run the pack step down the degradation ladder.  With a
        SolverHealth wired, a watchdog trip or exception falls to the next
        rung inside the SAME solve while the ladder books the failure for
        future ticks.  The greedy rung is never deadline-guarded and its
        exceptions propagate — there is nothing below it.  A device fault
        (DEVICE_FAULTS) propagates from any rung and is not booked: the
        ladder must not move the card's work to the host."""
        requested = "sharded" if self.sharded_solve else "jax"
        if self.health is None:
            return self._run_rung(requested, problem, existing)
        rung = self.health.active_rung(requested)
        while True:
            timeout = 0.0 if rung == "greedy" else self.watchdog_timeout_s
            try:
                result = run_with_deadline(
                    lambda: self._run_rung(rung, problem, existing),
                    timeout, "provision.solve")
                self.health.report_success(rung)
                return result
            except WatchdogTimeout:
                self.health.report_failure(rung, reason="timeout")
            except DEVICE_FAULTS:
                raise
            except Exception:
                log.exception("pack rung %s failed", rung)
                self.health.report_failure(rung, reason="error")
                if rung == "greedy":
                    raise
            rung = self.health.active_rung(
                self.health.next_rung(rung) or "greedy")

    def _run_rung(self, rung: str, problem: Problem, existing):
        """One pack attempt on one ladder rung.  A sharded refusal
        (maybe_solve_partitioned → None: batch too small/unshardable) is
        routing, not failure — it falls through to the jax rung inline."""
        kw: Dict[str, object] = {}
        n_existing = 0
        if existing is not None:
            node_list, alloc, used, compat = existing
            n_existing = len(node_list)
            kw = dict(existing_alloc=alloc, existing_used=used,
                      existing_compat=compat)
        if rung == "sharded":
            result = maybe_solve_partitioned(
                problem, path="provisioning",
                max_nodes=self.max_nodes_per_round,
                device_decode=self.device_decode,
                decode_health=self.decode_health, mesh=self.mesh,
                device=self.device,
                **(dict(kw, node_list=existing[0])
                   if existing is not None else {}))
            if result is not None:
                return result
            rung = "jax"
        if rung == "jax":
            solve = self._pick_solver(problem, n_existing=n_existing)
            return solve(problem, max_nodes=self.max_nodes_per_round, **kw)
        if rung == "native":
            raise RuntimeError("the native rung is not ported (ROADMAP.md)")
        return solve_ffd(problem, max_nodes=self.max_nodes_per_round,
                         backend="numpy", **kw)

    def _pools_within_limits(self) -> List[NodePool]:
        usage = self.cluster.nodepool_usage()
        out = []
        for pool in self.nodepools.values():
            if pool.within_limits(usage.get(pool.name, ResourceList())):
                out.append(pool)
            else:
                log.info("nodepool %s at limit, excluded from provisioning", pool.name)
        return out

    def solve(self, pods: Sequence[Pod],
              schedule_on_existing: bool = True,
              nodes: Optional[Sequence] = None,
              pools: Optional[List[NodePool]] = None) -> tuple:
        """Tensorize + pack one batch, relaxing soft constraints level by
        level (preferred affinity, ScheduleAnyway spreads) while pods come
        back unschedulable.  Returns (problem, PackingResult).  `nodes` /
        `pools` override the live cluster's node set and the limit-filtered
        pool list (a caller holding a point-in-time snapshot).  The solve
        does not change the cluster."""
        if pools is None:
            pools = self._pools_within_limits()  # weight precedence is encoded
        catalog = self.provider.get_instance_types()  # in LaunchOption.weight_rank
        node_view = (list(self.cluster.nodes.values()) if nodes is None
                     else list(nodes))
        zone_rank: Dict[str, float] = {}
        for it in catalog:
            for o in it.offerings:
                if o.available:
                    zone_rank[o.zone] = min(zone_rank.get(o.zone, float("inf")),
                                            o.price)
        # existing-node zones count as spread/affinity domains even when no
        # offering is currently available there
        zones = sorted(set(zone_rank) | {n.zone for n in node_view if n.zone})
        soft = has_soft_constraints(pods)
        zone_feasible = make_zone_feasibility(catalog, node_view)
        best = None
        for level in range(MAX_LEVEL + 1):
            lowered = lower_pods(pods, nodes=node_view, option_zones=zones,
                                 zone_rank=zone_rank, level=level,
                                 zone_feasible=zone_feasible)
            problem = tensorize(lowered, catalog, pools,
                                node_classes=getattr(self.provider,
                                                     "node_classes", None))
            existing = None
            if schedule_on_existing and node_view:
                existing = self.cluster.tensorize_nodes(
                    problem.class_reps, problem.axes, scales=problem.scales,
                    nodes=node_view)   # (node_list, alloc, used, compat)
            result = self._pack_supervised(problem, existing)
            result._existing_nodes = existing[0] if existing else []
            if best is None or result.scheduled_count > best[1].scheduled_count:
                best = (problem, result)
            if not result.unschedulable or not soft:
                break
            if level < MAX_LEVEL:
                log.info("relaxing soft constraints to level %d (%d unschedulable)",
                         level + 1, len(result.unschedulable))
        return best

    def provision(self, pods: Optional[Sequence[Pod]] = None,
                  max_retries: int = 1) -> ProvisioningResult:
        """One provisioning round: solve the batch, launch, register, bind.

        If launches fail on exhausted capacity, the round re-solves once
        against the now-ICE-masked catalog (the reference reaches the same
        fixpoint via its retry-on-next-reconcile plus the launch-path retry
        at karpenter:pkg/providers/instance/instance.go:96-100)."""
        out = self._provision_round(pods)
        retries = 0
        while out.failed_launches and out.unschedulable and retries < max_retries:
            retries += 1
            retry = self._provision_round([p for p in out.unschedulable
                                           if not p.node_name])
            out.launched.extend(retry.launched)
            out.bound_existing += retry.bound_existing
            out.bound_new += retry.bound_new
            out.unschedulable = retry.unschedulable
            out.failed_launches.extend(retry.failed_launches)
            out.stranded.extend(retry.stranded)
        # anti-affinity carriers stranded by the post-solve repair: their
        # targets are now bound, so one follow-up solve sees them as
        # existing pods and the NotIn lowering applies
        strand_rounds = 0
        while out.stranded and strand_rounds < 2:
            strand_rounds += 1
            retry = self._provision_round([p for p in out.stranded
                                           if not p.node_name])
            out.launched.extend(retry.launched)
            out.bound_existing += retry.bound_existing
            out.bound_new += retry.bound_new
            out.unschedulable.extend(retry.unschedulable)
            out.failed_launches.extend(retry.failed_launches)
            out.stranded = retry.stranded
        return out

    def _provision_round(self, pods: Optional[Sequence[Pod]] = None) -> ProvisioningResult:
        t0 = self.clock()
        out = ProvisioningResult()
        if pods is None:
            pods = self.cluster.pending_pods()
        if not pods:
            return out
        if not self.nodepools:
            out.unschedulable = list(pods)
            return out
        problem, packing = self.solve(pods)
        out.solve_seconds = self.clock() - t0

        catalog_by_name = {it.name: it
                           for it in self.provider.get_instance_types()}
        orig = self.cluster.original

        # batch-internal anti-affinity/spread the masks couldn't see: strand
        # the violating carriers; they re-solve against bound targets
        stranded = find_batch_topology_violations(
            problem, packing, packing._existing_nodes)
        out.stranded = [orig(problem.pods[i]) for i in stranded]

        # pods placed on existing nodes
        for pod_i, slot in packing.existing_assignments.items():
            if pod_i in stranded:
                continue
            node = packing._existing_nodes[slot]
            pod = orig(problem.pods[pod_i])
            self.cluster.bind_pod(pod, node.name)
            if self.provenance is not None:
                self.provenance.clear(pod.name)
            out.bound_existing += 1

        # new nodes
        for decision in packing.nodes:
            if stranded:
                decision.pod_indices = [i for i in decision.pod_indices
                                        if i not in stranded]
                if not decision.pod_indices:
                    continue
            dpods = [orig(problem.pods[i]) for i in decision.pod_indices]
            creq = (claim_requests_columnar(problem, decision.pod_indices)
                    if self.device_decode else None)
            claim = claim_from_decision(decision, dpods, self.nodepools,
                                        requests=creq)
            try:
                claim = self.provider.create(claim)
            except InsufficientCapacityError as e:
                # leave pods pending; the ICE cache was updated inside
                # create() so the next round solves against a corrected
                # catalog.  A missing nodeclass is a persistent config
                # error, not capacity.
                if isinstance(e, NodeClassNotFoundError):
                    log.error("launch blocked by configuration: %s", e)
                else:
                    log.warning("launch failed: %s", e)
                out.failed_launches.append(str(e))
                out.unschedulable.extend(dpods)
                self._record_provenance(
                    [ProvenanceRecord(pod=p.name, constraint=CAPACITY,
                                      message=f"launch failed: {e}")
                     for p in dpods])
                continue
            it = catalog_by_name.get(claim.instance_type)
            if it is not None:
                ncs = getattr(self.provider, "node_classes", None) or {}
                it = effective_instance_type(
                    it, self.nodepools.get(claim.nodepool),
                    ncs.get(claim.node_class_ref))
            allocatable = it.allocatable if it else claim.requests
            node = self.cluster.register_nodeclaim(claim, allocatable,
                                                   it.capacity if it else None)
            for p in dpods:
                self.cluster.bind_pod(p, node.name)
                if self.provenance is not None:
                    self.provenance.clear(p.name)
            out.bound_new += len(dpods)
            out.launched.append(claim)

        out.unschedulable.extend(orig(problem.pods[i])
                                 for i in packing.unschedulable)
        if packing.unschedulable and (self.provenance is not None
                                      or self.recorder is not None):
            self._record_provenance(
                [explain_unschedulable(problem, i)
                 for i in packing.unschedulable])
        return out

    def _record_provenance(self, records: Sequence[ProvenanceRecord]) -> None:
        """Land unschedulability records in the queryable store and mirror
        them as Warning events (the FailedScheduling surface)."""
        for rec in records:
            if self.provenance is not None:
                self.provenance.record(rec)
            if self.recorder is not None:
                self.recorder.publish(Event(
                    kind="Pod", name=rec.pod, reason="FailedScheduling",
                    message=(f"{rec.constraint}"
                             + (f"/{rec.dimension}" if rec.dimension else "")
                             + f": {rec.message}"),
                    type="Warning"))
