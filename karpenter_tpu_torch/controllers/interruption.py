"""Interruption controller: queue events → offering blacklist + node recycle.

A copy of the JAX package's `controllers/interruption.py` (Karpenter's
interruption loop, karpenter:pkg/controllers/interruption/
controller.go:82-121): receive at most 10 messages, parse them through the
kind registry (parser.go:54-80), map instance id → node / claim, then

  * spot interruption → mark the offering unavailable (controller.go:
    194-200) AND cordon and drain the node through the terminator
    (handleNodeClaim, controller.go:181-205);
  * scheduled change / state change (stopping | terminated) → drain;
  * rebalance recommendation → no action (the reference's default);
  * noop / instances not ours → the message is just deleted.

A message is deleted only once it is handled, so a drain that PDBs stall
is retried on the next receive (SQS visibility, cloud/queue.py).  Host-only:
it takes no `device`; the provisioner re-places the evicted pods.  With
the Forecast gate, `build_controllers` points `on_spot_reclaim` at the
HeadroomController's spot-risk prior (`SpotRiskPrior.observe_reclaim`).
It feeds the reference's interruption families, and the terminations of
its recycle are attributed to "interruption" in the cost ledger
(obs/ledger.py).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..api import labels as wk
from ..api.objects import Node, NodeClaim
from ..cloud.provider import CloudProvider
from ..cloud.queue import (FakeQueue, NOOP, ParsedEvent,
                           REBALANCE_RECOMMENDATION, SPOT_INTERRUPTION,
                           STATE_CHANGE, parse_event)
from ..state.cluster import Cluster
from ..utils import metrics
from .termination import TerminationController

log = logging.getLogger("karpenter_tpu_torch.interruption")

# state-change states that mean the instance is going or gone
_DEAD_STATES = {"stopping", "stopped", "shutting-down", "terminated"}


@dataclass
class InterruptionResult:
    received: int = 0
    handled: Dict[str, int] = field(default_factory=dict)   # kind → count
    recycled: List[str] = field(default_factory=list)       # node names
    deleted_messages: int = 0

    def bump(self, kind: str):
        self.handled[kind] = self.handled.get(kind, 0) + 1


class InterruptionController:
    """Singleton poll loop over the interruption queue."""

    def __init__(self, queue: FakeQueue, provider: CloudProvider,
                 cluster: Cluster, terminator: TerminationController,
                 clock: Callable[[], float] = time.time):
        self.queue = queue
        self.provider = provider
        self.cluster = cluster
        self.terminator = terminator
        self.clock = clock
        # hook(node_or_claim) fired on each observed spot reclaim
        self.on_spot_reclaim: Optional[Callable] = None

    def reconcile(self, max_batches: int = 1) -> InterruptionResult:
        out = InterruptionResult()
        # visibility timeout: messages whose handling failed last tick are
        # redelivered, so stalled drains (PDBs) eventually complete
        self.queue.release_inflight()
        for _ in range(max_batches):
            messages = self.queue.receive()
            if not messages:
                break
            out.received += len(messages)
            now = self.clock()
            for msg in messages:
                # message-age latency histogram (interruption/metrics.go:53)
                metrics.interruption_message_latency().observe(
                    max(0.0, now - msg.sent_at))
            # instance id → (node, claim), built once per batch
            # (makeNodeClaimInstanceIDMap, controller.go:94-101)
            by_id = self._instance_map()
            for msg in messages:
                event = parse_event(msg.body)
                metrics.interruption_received().inc({"message_type": event.kind})
                if self._handle(event, by_id, out):
                    self.queue.delete(msg.receipt)
                    out.deleted_messages += 1
                    metrics.interruption_deleted().inc()
        return out

    def _instance_map(self) -> Dict[str, Tuple[Optional[Node],
                                               Optional[NodeClaim]]]:
        out: Dict[str, Tuple[Optional[Node], Optional[NodeClaim]]] = {}
        for claim in self.cluster.nodeclaims.values():
            if claim.provider_id:
                out[claim.provider_id] = (None, claim)
        for node in self.cluster.nodes.values():
            if node.provider_id:
                claim = out.get(node.provider_id, (None, None))[1]
                out[node.provider_id] = (node, claim)
        return out

    def _handle(self, event: ParsedEvent, by_id,
                out: InterruptionResult) -> bool:
        """True when the message is fully handled (safe to delete)."""
        out.bump(event.kind)
        if event.kind == NOOP:
            return True
        ok = True
        for iid in event.instance_ids:
            node, claim = by_id.get(iid, (None, None))
            if node is None and claim is None:
                continue  # not ours, or already gone
            if event.kind == SPOT_INTERRUPTION:
                self._mark_spot_unavailable(node, claim)
                src = node or claim
                if src is not None and self.on_spot_reclaim is not None:
                    self.on_spot_reclaim(src)
            if event.kind == REBALANCE_RECOMMENDATION:
                continue  # observability only (the reference's default)
            if event.kind == STATE_CHANGE and \
                    event.detail.get("state", "") not in _DEAD_STATES:
                continue
            done = self._recycle(node, claim, event.kind, out)
            ok = done and ok
            if done:
                # count completed actions only: a PDB-blocked drain leaves
                # the message for redelivery, and counting each retry would
                # inflate one interruption into thousands of "actions"
                metrics.interruption_actions().inc(
                    {"action": f"CordonAndDrain/{event.kind}"})
        return ok

    def _mark_spot_unavailable(self, node: Optional[Node],
                               claim: Optional[NodeClaim]) -> None:
        """An interrupted spot offering is exhausted capacity: blacklist it
        so the next solve does not relaunch into the same pool
        (controller.go:194-200)."""
        src = node or claim
        if src is None or src.capacity_type != wk.CAPACITY_TYPE_SPOT:
            return
        if src.instance_type and src.zone:
            self.provider.unavailable.mark_unavailable(
                "interruption", src.instance_type, src.zone, src.capacity_type)

    def _recycle(self, node: Optional[Node], claim: Optional[NodeClaim],
                 reason: str, out: InterruptionResult) -> bool:
        """Cordon and drain through the termination flow; the evicted pods
        go pending and the provisioner replaces the capacity."""
        # ledger attribution: terminations inside this funnel are spot
        # interruptions, not voluntary consolidation
        from ..obs.ledger import LEDGER
        with LEDGER.decision("interruption"):
            if node is not None:
                res = self.terminator.drain_sync(node, reason=reason)
                if node.name in res.terminated:
                    out.recycled.append(node.name)
                    return True
                return False  # drain stalled (PDBs): retried via redelivery
            # a claim without a node (never registered): delete it directly
            if claim is not None:
                try:
                    self.provider.delete(claim)
                except Exception:  # noqa: BLE001 — a vanished instance is success
                    pass
                self.cluster.nodeclaims.pop(claim.name, None)
            return True
