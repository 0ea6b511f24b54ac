"""Termination controller: graceful node teardown.

A copy of the JAX package's `controllers/termination.py` (Karpenter's
termination flow: node finalizer → taint → evict through the Eviction API
respecting PDBs → delete the cloud instance → remove the finalizer,
karpenter:website/content/en/docs/concepts/disruption.md:27-35,
karpenter:designs/termination.md):

  * a termination *request* puts the node behind the finalizer analog
    (`Node.marked_for_deletion`) and taints it NoSchedule;
  * each reconcile drains as many pods as the PDB budgets allow — a pod
    whose eviction would break a budget stays and the node requeues (the
    Eviction API's retry loop);
  * daemonset pods are not evicted — they die with the node;
  * only once every reschedulable pod is gone is the cloud instance
    terminated and the node released.

Host-only: it takes no `device`.  A finished drain observes
karpenter_nodes_termination_duration_seconds from its request.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

from ..api import labels as wk
from ..api.objects import Node, Pod
from ..api.taints import NO_SCHEDULE, Taint
from ..cloud.errors import is_not_found
from ..cloud.fake import CloudError
from ..cloud.provider import CloudProvider
from ..state.cluster import Cluster
from ..utils import metrics

log = logging.getLogger("karpenter_tpu_torch.termination")

TERMINATION_TAINT = Taint(wk.DISRUPTION_TAINT_KEY, NO_SCHEDULE, "terminating")


@dataclass
class TerminationResult:
    evicted: List[str] = field(default_factory=list)    # pod uids
    terminated: List[str] = field(default_factory=list)  # node names
    requeued: List[str] = field(default_factory=list)   # nodes still draining
    errors: List[str] = field(default_factory=list)


class TerminationController:
    """Finalizer-style drain loop over termination requests."""

    def __init__(self, provider: CloudProvider, cluster: Cluster,
                 clock: Callable[[], float] = time.time):
        self.provider = provider
        self.cluster = cluster
        self.clock = clock
        self._queue: Dict[str, str] = {}   # node name → reason
        self._requested_at: Dict[str, float] = {}  # drain-start stamps

    def request(self, node: Node, reason: str = "") -> None:
        """Begin terminating `node`: finalizer + taint; the drain happens on
        later reconciles."""
        node.marked_for_deletion = True
        # replace any same-key taint (the disruption controller's
        # 'disrupting'): duplicate keys are invalid node state
        node.taints = [t for t in node.taints
                       if t.key != TERMINATION_TAINT.key] + [TERMINATION_TAINT]
        self.cluster.touch_node(node)
        self._queue.setdefault(node.name, reason)
        self._requested_at.setdefault(node.name, self.clock())

    @property
    def pending(self) -> List[str]:
        return sorted(self._queue)

    def reconcile(self) -> TerminationResult:
        """One drain pass over every termination in flight."""
        out = TerminationResult()
        for name in sorted(self._queue):
            node = self.cluster.nodes.get(name)
            if node is None:           # already gone — drop the finalizer
                del self._queue[name]
                self._requested_at.pop(name, None)
                continue
            self._drain_one(node, out)
        return out

    def drain_sync(self, node: Node, reason: str = "",
                   max_rounds: int = 100) -> TerminationResult:
        """Request + drain to completion, or until PDBs stall the drain:
        the synchronous entry the disruption and interruption flows use."""
        self.request(node, reason)
        out = TerminationResult()
        for _ in range(max_rounds):
            before = len(out.evicted)
            self._drain_one(node, out)
            if node.name not in self._queue:
                break
            if len(out.evicted) == before:
                break  # stalled on PDBs — the caller retries later
        return out

    def _drain_one(self, node: Node, out: TerminationResult) -> None:
        budgets = self.cluster.pdb_budgets()
        # evict pod by pod, debiting the budgets as it goes (the Eviction
        # API checks each eviction against the live budget)
        for pod in sorted([p for p in node.pods if not p.is_daemon],
                          key=lambda p: p.uid):
            draw = [name for name, pdb in self.cluster.pdbs.items()
                    if pdb.matches(pod)]
            if any(budgets[n] <= 0 for n in draw):
                continue  # blocked this round; the PDB may free up later
            for n in draw:
                budgets[n] -= 1
            self._evict(pod)
            out.evicted.append(pod.uid)

        if any(not p.is_daemon for p in node.pods):
            out.requeued.append(node.name)
            return

        # fully drained: daemon pods die with the node, the instance goes
        # away, the finalizer is removed
        claim = self.cluster.claim_for_provider_id(node.provider_id)
        if claim is not None:
            try:
                self.provider.delete(claim)
            except CloudError as e:
                if not is_not_found(e):  # already gone == success
                    out.errors.append(f"{node.name}: {e}")
                    out.requeued.append(node.name)
                    return
            except Exception as e:  # noqa: BLE001 — a cloud call's failure
                out.errors.append(f"{node.name}: {e}")
                out.requeued.append(node.name)
                return
            self.cluster.nodeclaims.pop(claim.name, None)
        for p in list(node.pods):
            self.cluster.delete_pod(p)
        self.cluster.remove_node(node.name)
        self._queue.pop(node.name, None)
        started = self._requested_at.pop(node.name, None)
        if started is not None:
            metrics.termination_duration().observe(
                max(0.0, self.clock() - started))
        out.terminated.append(node.name)
        log.info("terminated node %s", node.name)

    def _evict(self, pod: Pod) -> None:
        """Eviction: an owned pod is recreated pending by its controller; an
        ownerless pod is gone for good."""
        self.cluster.unbind_pod(pod)
        if not pod.owner_kind:
            if self.cluster.pods.pop(pod.uid, None) is not None and \
                    self.cluster.observer is not None:
                self.cluster.observer.pod_removed(pod)
        else:
            # the replacement pod is a fresh arrival
            pod.created_at = self.clock()
