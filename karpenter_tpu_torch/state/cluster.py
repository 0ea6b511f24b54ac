"""In-memory cluster state.

A copy of the JAX package's `state/cluster.py` (the analog of
karpenter-core's `state.Cluster`): the nodes + pods + bindings snapshot that
the consolidation simulator replays.  `tensorize_nodes` lowers the live node
set to the dense arrays (allocatable/used E×R, per-class compat C×E) that the
packing kernels take as pre-opened slots, so "simulate without node X" is an
array mask, not an object-graph walk.

Left out until their slices land (ROADMAP.md): the persistent delta arena
(`attach_arena`, ClusterArena), the warm-restart snapshot
(`snapshot_state` / `restore_state`), the demand observer hook and the
metric families the mutators feed.  `mutation_epoch` is bumped by exactly
the mutators that bump it in the reference: the simulation arena's
staleness guard and the disruption controller's fingerprint cache read it.
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

_names = itertools.count(1)

# How long a fresh node stays protected from disruption while its pods are
# still in flight (the reference's nomination window in state.Cluster).
NOMINATION_WINDOW_S = 20.0


class Cluster:
    def __init__(self, clock: Callable[[], float] = time.time):
        self.clock = clock
        self.nodes: Dict[str, Node] = {}
        self.nodeclaims: Dict[str, NodeClaim] = {}
        self.pods: Dict[str, Pod] = {}
        self.pdbs: Dict[str, PodDisruptionBudget] = {}
        # monotone mutation counter, bumped by EVERY mutator: cached
        # tensorizations (SimulationArena faces, the disruption
        # fingerprint) compare it to detect staleness lazily
        self.mutation_epoch = 0

    # ---- pods ----
    def add_pod(self, pod: Pod) -> Pod:
        pod.created_at = self.clock()   # informer-arrival stamp
        self.pods[pod.uid] = pod
        # admission-time lowering: compute the pod's equivalence-class key
        # and softness flag here, so every later tensorize of this object
        # hits the caches
        _class_key(pod)
        pod_is_soft(pod)
        self.mutation_epoch += 1
        return pod

    def add_pods(self, pods: Sequence[Pod]) -> List[Pod]:
        return [self.add_pod(p) for p in pods]

    def delete_pod(self, pod: Pod):
        self.pods.pop(pod.uid, None)
        if pod.node_name and pod.node_name in self.nodes:
            node = self.nodes[pod.node_name]
            node.pods = [p for p in node.pods if p.uid != pod.uid]
        self.mutation_epoch += 1

    def bind_pod(self, pod: Pod, node_name: str):
        if pod.node_name and pod.node_name in self.nodes:
            old = self.nodes[pod.node_name]
            old.pods = [p for p in old.pods if p.uid != pod.uid]
        pod.node_name = node_name
        node = self.nodes[node_name]
        node.pods.append(pod)
        node.nominated_until = 0.0  # nomination fulfilled
        self.mutation_epoch += 1

    def unbind_pod(self, pod: Pod):
        if pod.node_name and pod.node_name in self.nodes:
            node = self.nodes[pod.node_name]
            node.pods = [p for p in node.pods if p.uid != pod.uid]
        pod.node_name = ""
        self.mutation_epoch += 1

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
        return node

    def remove_node(self, name: str) -> Optional[Node]:
        node = self.nodes.pop(name, None)
        if node:
            for p in node.pods:
                p.node_name = ""
                # evicted pods with owners get recreated as pending; ownerless
                # pods are gone for good (termination semantics)
                if not p.owner_kind:
                    self.pods.pop(p.uid, None)
            node.pods = []
            self.mutation_epoch += 1
        return node

    def touch_node(self, node: Node):
        """Callers that edit a node's labels/taints/allocatable IN PLACE
        must report it here so cached tensorizations notice the change."""
        self.mutation_epoch += 1

    def register_nodeclaim(self, claim: NodeClaim, allocatable: ResourceList,
                           capacity: Optional[ResourceList] = None,
                           initialized: bool = True,
                           rehydrate: bool = False) -> Node:
        """NodeClaim → Node on (simulated) kubelet join.  The sync
        provisioning path registers+initializes in one step; an async
        lifecycle passes initialized=False.  ``rehydrate`` marks restart
        recovery, which in the reference keeps the latency histograms clean
        (the port records no metrics yet, so it changes nothing here)."""
        claim.registered = True
        claim.registered_at = claim.registered_at or self.clock()
        claim.initialized = initialized
        if initialized and not claim.initialized_at:
            claim.initialized_at = self.clock()
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
