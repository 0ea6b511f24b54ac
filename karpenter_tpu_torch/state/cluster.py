"""In-memory cluster state.

A copy of the JAX package's `state/cluster.py` (the analog of
karpenter-core's `state.Cluster`): the nodes + pods + bindings snapshot that
the consolidation simulator replays.  `tensorize_nodes` lowers the live node
set to the dense arrays (allocatable/used E×R, per-class compat C×E) that the
packing kernels take as pre-opened slots, so "simulate without node X" is an
array mask, not an object-graph walk.

`attach_arena` attaches the persistent delta arena (ops/arena.py
ClusterArena; the operator's IncrementalArena gate): every mutator below
forwards its delta to `self.arena`, which the Provisioner and the
consolidation SimulationArena gather warm instead of re-running
`tensorize_nodes`.  `self.arena` may also be an `IngestBatcher`
(state/ingest.py) wrapping it.  `mutation_epoch` is bumped by exactly the
mutators that bump it in the reference: the simulation arena's staleness
guard and the disruption controller's fingerprint cache read it.

`observer` is the demand observer hook (forecast/series.py DemandSeries,
wired by the Forecast gate): the mutators call its `pod_added`,
`pod_removed` and `pod_bound` where the reference's do.

`snapshot_state` / `restore_state` are the object-graph half of the
warm-restart snapshot (state/snapshot.py).  The mutators feed the
reference's metric families (utils/metrics.py) where its mutators do.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api import labels as wk
from ..api.objects import Node, NodeClaim, Pod, PodDisruptionBudget
from ..api.requirements import Requirements
from ..api.resources import DEFAULT_AXES, DEFAULT_SCALES, PODS, ResourceList
from ..api.taints import tolerates_all
from ..ops.constraints import pod_is_soft
from ..ops.tensorize import _class_key
from ..utils import metrics

_names = itertools.count(1)

# How long a fresh node stays protected from disruption while its pods are
# still in flight (the reference's nomination window in state.Cluster).
NOMINATION_WINDOW_S = 20.0


class Cluster:
    def __init__(self, clock: Callable[[], float] = time.time):
        self.clock = clock
        # the cluster has no lock of its own: every mutation happens under
        # the Operator's state_lock, held by the manager's tick loop, the
        # /v1 apply surface, and the metrics collector (graftlint LK)
        self.nodes: Dict[str, Node] = {}  # guarded-by: caller(state_lock)
        self.nodeclaims: Dict[str, NodeClaim] = {}  # guarded-by: caller(state_lock)
        self.pods: Dict[str, Pod] = {}  # guarded-by: caller(state_lock)
        self.pdbs: Dict[str, PodDisruptionBudget] = {}  # guarded-by: caller(state_lock)
        # optional demand observer (forecast/series.py DemandSeries): gets
        # pod_added/pod_removed/pod_bound callbacks; None unless the
        # Forecast gate wires one
        self.observer = None
        # optional persistent delta arena (ops/arena.py ClusterArena): every
        # mutator below forwards its delta so consumers can gather warm
        # tensors instead of re-running tensorize_nodes; None unless
        # attach_arena (the IncrementalArena gate) attaches one
        self.arena = None  # guarded-by: caller(state_lock)
        # monotone mutation counter, bumped by EVERY mutator (arena attached
        # or not): cached tensorizations (SimulationArena faces, the
        # disruption fingerprint) compare it to detect staleness lazily
        self.mutation_epoch = 0  # guarded-by: caller(state_lock)

    def attach_arena(self, **kwargs):
        """Create and attach a ClusterArena seeded from current state; every
        subsequent mutation streams into it as a typed delta."""
        from ..ops.arena import ClusterArena
        self.arena = ClusterArena(self, **kwargs)
        self.arena.rebuild()
        return self.arena

    # ---- warm restart (state/snapshot.py) ----
    def snapshot_state(self) -> Dict:  # guarded-by: caller(state_lock)
        """The object-graph half of the WarmRestart snapshot: the four
        state dicts plus the epoch.  Not copied — the whole snapshot
        payload pickles in one pass under the state lock, and sharing the
        live dicts keeps node.pods entries identical to pods.values()
        entries in the pickled graph (identity the arena's `_node_at`
        rewiring and `gather()`'s `is` check depend on after restore)."""
        return {
            "nodes": self.nodes,
            "nodeclaims": self.nodeclaims,
            "pods": self.pods,
            "pdbs": self.pdbs,
            "mutation_epoch": self.mutation_epoch,
        }

    def restore_state(self, data: Dict) -> None:  # guarded-by: caller(state_lock)
        """Adopt unpickled state dicts wholesale.  The caller re-attaches
        (or restores) the arena and observer afterwards — this method
        leaves both wiring hooks untouched."""
        self.nodes = data["nodes"]
        self.nodeclaims = data["nodeclaims"]
        self.pods = data["pods"]
        self.pdbs = data["pdbs"]
        self.mutation_epoch = int(data["mutation_epoch"])

    # ---- pods ----
    def add_pod(self, pod: Pod) -> Pod:
        pod.created_at = self.clock()   # informer-arrival stamp
        self.pods[pod.uid] = pod
        # admission-time lowering: compute the pod's equivalence-class key
        # and softness flag here, so every later tensorize of this object
        # hits the caches
        _class_key(pod)
        pod_is_soft(pod)
        if self.observer is not None:
            self.observer.pod_added(pod)
        self.mutation_epoch += 1
        if self.arena is not None:
            self.arena.apply_pod_add(pod)
        return pod

    def add_pods(self, pods: Sequence[Pod]) -> List[Pod]:
        return [self.add_pod(p) for p in pods]

    def delete_pod(self, pod: Pod):
        existed = self.pods.pop(pod.uid, None) is not None
        bound_to = ""
        if pod.node_name and pod.node_name in self.nodes:
            node = self.nodes[pod.node_name]
            node.pods = [p for p in node.pods if p.uid != pod.uid]
            bound_to = node.name
        if existed and self.observer is not None:
            self.observer.pod_removed(pod)
        self.mutation_epoch += 1
        if self.arena is not None:
            self.arena.apply_pod_remove(pod, bound_to)

    def bind_pod(self, pod: Pod, node_name: str):
        old_node = pod.node_name
        rebind = bool(old_node)
        if pod.node_name and pod.node_name in self.nodes:
            old = self.nodes[pod.node_name]
            old.pods = [p for p in old.pods if p.uid != pod.uid]
        pod.node_name = node_name
        node = self.nodes[node_name]
        node.pods.append(pod)
        node.nominated_until = 0.0  # nomination fulfilled
        if not rebind:
            # first bind only: arrival → placement latency
            # (karpenter_pods_bound_duration_seconds)
            metrics.pods_bound_duration().observe(
                max(0.0, self.clock() - pod.created_at))
            # pod "startup": running on a READY node.  Bound to an
            # already-initialized node -> now; else the lifecycle
            # controller observes it when initialization completes.  Once
            # per pod lifetime (the flag survives requeue).
            if (node.labels.get(wk.NODE_INITIALIZED) == "true"
                    and not pod.__dict__.get("_startup_observed")):
                pod.__dict__["_startup_observed"] = True
                metrics.pods_startup_time().observe(
                    max(0.0, self.clock() - pod.created_at))
        if not rebind and self.observer is not None:
            self.observer.pod_bound(pod)   # first bind only
        self.mutation_epoch += 1
        if self.arena is not None:
            self.arena.apply_pod_bind(pod, node_name, old_node)

    def unbind_pod(self, pod: Pod):
        was_on = ""
        if pod.node_name and pod.node_name in self.nodes:
            node = self.nodes[pod.node_name]
            node.pods = [p for p in node.pods if p.uid != pod.uid]
            was_on = node.name
        pod.node_name = ""
        self.mutation_epoch += 1
        if self.arena is not None and was_on:
            self.arena.apply_pod_unbind(was_on)

    def pending_pods(self) -> List[Pod]:
        return [p for p in self.pods.values() if not p.node_name]

    def original(self, pod: Pod) -> Pod:
        """Map a constraint-lowered pod copy (ops/constraints.py) back to the
        cluster's original object.  Controllers must always bind the
        original, never a rewritten copy."""
        return self.pods.get(pod.uid, pod)

    # ---- nodes / claims ----
    def add_node(self, node: Node) -> Node:
        self.nodes[node.name] = node
        self.mutation_epoch += 1
        if self.arena is not None:
            self.arena.apply_node_add(node)
        return node

    def remove_node(self, name: str) -> Optional[Node]:
        node = self.nodes.pop(name, None)
        if node:
            metrics.nodes_terminated().inc({"nodepool": node.nodepool or ""})
            for p in node.pods:
                p.node_name = ""
                # evicted pods with owners get recreated as pending; ownerless
                # pods are gone for good (termination semantics)
                if not p.owner_kind:
                    self.pods.pop(p.uid, None)
                    if self.observer is not None:
                        self.observer.pod_removed(p)
            node.pods = []
            self.mutation_epoch += 1
            if self.arena is not None:
                self.arena.apply_node_remove(name)
        return node

    def touch_node(self, node: Node):
        """Callers that edit a node's labels/taints/allocatable IN PLACE
        must report it here so the arena re-derives the node's row and
        cached tensorizations notice the change."""
        self.mutation_epoch += 1
        if self.arena is not None:
            self.arena.touch_node(node)

    def register_nodeclaim(self, claim: NodeClaim, allocatable: ResourceList,
                           capacity: Optional[ResourceList] = None,
                           initialized: bool = True,
                           rehydrate: bool = False) -> Node:
        """NodeClaim → Node on (simulated) kubelet join.  The sync
        provisioning path registers+initializes in one step; an async
        lifecycle passes initialized=False.  ``rehydrate`` marks restart
        recovery: rebuilding state for an already-registered node is not a
        registration event, so the latency histograms stay clean."""
        claim.registered = True
        claim.registered_at = claim.registered_at or self.clock()
        claim.initialized = initialized
        if initialized and not claim.initialized_at:
            claim.initialized_at = self.clock()
        if not rehydrate:
            # registration/initialization latency families — the sync path
            # records its true (instant) joins, the async lifecycle path its
            # real delays (reference karpenter_nodeclaims_* durations)
            if claim.launched_at:
                metrics.nodeclaim_registration_duration().observe(
                    max(0.0, claim.registered_at - claim.launched_at))
            if initialized:
                metrics.nodeclaim_initialization_duration().observe(
                    max(0.0, claim.initialized_at - claim.registered_at))
                metrics.nodeclaims_initialized().inc(
                    {"nodepool": claim.nodepool})
            metrics.nodeclaims_registered().inc({"nodepool": claim.nodepool})
            metrics.nodes_created().inc({"nodepool": claim.nodepool})
        self.nodeclaims[claim.name] = claim
        node = Node(
            name=f"node-{next(_names):06d}",
            provider_id=claim.provider_id,
            labels=dict(claim.labels),
            taints=list(claim.taints),
            allocatable=allocatable,
            capacity=capacity or allocatable,
            nodepool=claim.nodepool,
            instance_type=claim.instance_type,
            zone=claim.zone,
            capacity_type=claim.capacity_type,
            price=claim.price,
            created_at=self.clock(),
            # protected from disruption until its pods bind (or the window
            # lapses) — the reference's in-flight nomination blocker
            nominated_until=self.clock() + NOMINATION_WINDOW_S,
        )
        node.labels.setdefault(wk.HOSTNAME, node.name)
        if initialized:
            node.labels[wk.NODE_INITIALIZED] = "true"
        return self.add_node(node)

    def node_for_provider_id(self, provider_id: str) -> Optional[Node]:
        for n in self.nodes.values():
            if n.provider_id == provider_id:
                return n
        return None

    def claim_for_provider_id(self, provider_id: str) -> Optional[NodeClaim]:
        for c in self.nodeclaims.values():
            if c.provider_id == provider_id:
                return c
        return None

    def nodepool_usage(self) -> Dict[str, ResourceList]:
        """Capacity in use per NodePool — feeds limits enforcement."""
        out: Dict[str, ResourceList] = {}
        for n in self.nodes.values():
            if n.nodepool:
                out[n.nodepool] = out.get(n.nodepool, ResourceList()) + n.capacity
        return out

    # ---- PDBs / eviction safety ----
    def add_pdb(self, pdb: PodDisruptionBudget) -> PodDisruptionBudget:
        self.pdbs[pdb.name] = pdb
        return pdb

    def remove_pdb(self, name: str):
        self.pdbs.pop(name, None)

    def pdb_budget(self, pdb: PodDisruptionBudget) -> int:
        """Remaining voluntary evictions the budget allows right now. Bound
        pods count as healthy; pending ones as unavailable."""
        matching = [p for p in self.pods.values() if pdb.matches(p)]
        healthy = sum(1 for p in matching if p.node_name)
        return pdb.allowed_disruptions(healthy, len(matching))

    def pdb_budgets(self) -> Dict[str, int]:
        """All budgets in one pass — candidates() precomputes this so the
        per-node evictable() checks don't rescan the pod set."""
        return {name: self.pdb_budget(pdb) for name, pdb in self.pdbs.items()}

    def evictable(self, pods: Sequence[Pod],
                  budgets: Optional[Dict[str, int]] = None) -> bool:
        """Would evicting ALL of `pods` at once violate any PDB? The blocker
        the consolidation candidate filter and the drain flow share
        (karpenter:designs/consolidation.md:44-52)."""
        if not self.pdbs:
            return True
        draw: Dict[str, int] = {}
        for p in pods:
            for pdb in self.pdbs.values():
                if pdb.matches(p):
                    draw[pdb.name] = draw.get(pdb.name, 0) + 1
        if budgets is None:
            budgets = self.pdb_budgets()
        return all(budgets[name] >= n for name, n in draw.items())

    # ---- tensorization of live capacity ----
    def snapshot_nodes(self) -> List[Node]:
        """Point-in-time node copies for lock-free solves: shallow node
        copies with their pods list, labels dict and taints list copied, so
        a concurrent bind/remove or label/taint edit cannot change them
        mid-solve.  Pod objects themselves are shared."""
        import copy
        out = []
        for n in self.nodes.values():
            c = copy.copy(n)
            c.pods = list(n.pods)
            c.labels = dict(n.labels)
            c.taints = list(n.taints)
            out.append(c)
        return out

    def tensorize_nodes(self, pod_classes: Sequence[Pod],
                        axes: Tuple[str, ...] = DEFAULT_AXES,
                        exclude: Sequence[str] = (),
                        nodes: Optional[Sequence[Node]] = None,
                        scales=None):
        """Lower live nodes to pre-opened packing slots.

        Returns (node_list, alloc E×R, used E×R, compat C×E) where compat is
        label/taint feasibility of each pod class rep on each node. `exclude`
        masks candidate nodes out — the consolidation simulator's "what if
        this node were gone"."""
        node_list = [n for n in (nodes if nodes is not None else self.nodes.values())
                     if n.name not in exclude and not n.marked_for_deletion]
        if scales is None:
            scales = DEFAULT_SCALES
        E, R, C = len(node_list), len(axes), len(pod_classes)
        alloc = np.zeros((E, R), np.float32)
        used = np.zeros((E, R), np.float32)
        compat = np.zeros((C, E), bool)
        for e, n in enumerate(node_list):
            alloc[e] = n.allocatable.to_vector(axes, scales)
            req = n.requested()
            req[PODS] = len(n.pods)
            used[e] = req.to_vector(axes, scales, round_up=True)
            node_labels = dict(n.labels)
            # hostname defaults to the node name so hostname-NotIn lowerings
            # (anti-affinity) bind even for externally-seeded nodes that never
            # got the label from register_nodeclaim
            node_labels.setdefault(wk.HOSTNAME, n.name)
            provided = Requirements.from_labels(node_labels)
            for ci, rep in enumerate(pod_classes):
                if not tolerates_all(rep.tolerations, n.taints):
                    continue
                if any(b.compatible(provided) for b in rep.scheduling_requirements()):
                    compat[ci, e] = True
        return node_list, alloc, used, compat
