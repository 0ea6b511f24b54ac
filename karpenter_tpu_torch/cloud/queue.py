"""Interruption event queue — the SQS / EventBridge substrate.

A copy of the JAX package's `cloud/queue.py` (the analog of Karpenter's
queue provider and message model: pkg/providers/sqs/sqs.go:52-72 — a
long-poll receive capped at 10, explicit delete — and the message kinds of
pkg/controllers/interruption/messages/{spotinterruption,
rebalancerecommendation,scheduledchange,statechange}/model.go).  The fake
cloud publishes here when instances are interrupted or change state, so
the interruption controller reads what the EventBridge → SQS pipeline
would deliver.  Its lock is built through `analysis.lockorder.named_lock`
(role "queue"), as the reference's is.  `snapshot_state` /
`restore_state` are the queue's section of the warm-restart snapshot
(state/snapshot.py).
"""

from __future__ import annotations

import itertools
import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence

from ..analysis.lockorder import named_lock

# message kinds (the parser registry's output domain)
SPOT_INTERRUPTION = "spot_interruption"
REBALANCE_RECOMMENDATION = "rebalance_recommendation"
SCHEDULED_CHANGE = "scheduled_change"
STATE_CHANGE = "state_change"
NOOP = "noop"

MAX_RECEIVE = 10  # the long-poll batch cap (sqs.go:52-72)

_msg_ids = itertools.count(1)


@dataclass
class Message:
    """One queue message: an EventBridge-style JSON body and its receipt
    handle."""
    body: str
    id: str = field(default_factory=lambda: f"msg-{next(_msg_ids):08d}")
    receipt: str = ""
    sent_at: float = 0.0

    def __post_init__(self):
        if not self.receipt:
            self.receipt = f"rcpt-{self.id}"


@dataclass
class ParsedEvent:
    kind: str
    instance_ids: List[str]
    start_time: float = 0.0
    detail: Dict = field(default_factory=dict)


def make_event_body(kind: str, instance_ids: Sequence[str],
                    state: str = "", ts: float = 0.0) -> str:
    """An EventBridge-style body for `kind` (the shapes the per-kind models
    parse)."""
    source, detail_type, detail = "cloud.compute", "", {}
    ids = list(instance_ids)
    if kind == SPOT_INTERRUPTION:
        detail_type = "Spot Instance Interruption Warning"
        detail = {"instance-id": ids[0], "instance-action": "terminate"}
    elif kind == REBALANCE_RECOMMENDATION:
        detail_type = "Instance Rebalance Recommendation"
        detail = {"instance-id": ids[0]}
    elif kind == SCHEDULED_CHANGE:
        source = "cloud.health"
        detail_type = "Scheduled Change"
        detail = {"affected-entities": [{"entity-value": i} for i in ids]}
    elif kind == STATE_CHANGE:
        detail_type = "Instance State-change Notification"
        detail = {"instance-id": ids[0], "state": state or "terminated"}
    else:
        detail_type = "Unknown"
    return json.dumps({"source": source, "detail-type": detail_type,
                       "detail": detail, "time": ts})


def parse_event(body: str) -> ParsedEvent:
    """The parser registry: detail-type → kind → instance ids
    (pkg/controllers/interruption/parser.go:54-80; an unknown event is an
    explicit noop, not an error)."""
    try:
        doc = json.loads(body)
    except (ValueError, TypeError):
        return ParsedEvent(kind=NOOP, instance_ids=[])
    detail_type = doc.get("detail-type", "")
    detail = doc.get("detail", {}) or {}
    ts = doc.get("time", 0.0) or 0.0
    if detail_type == "Spot Instance Interruption Warning":
        return ParsedEvent(SPOT_INTERRUPTION, [detail.get("instance-id", "")],
                           ts, detail)
    if detail_type == "Instance Rebalance Recommendation":
        return ParsedEvent(REBALANCE_RECOMMENDATION,
                           [detail.get("instance-id", "")], ts, detail)
    if detail_type == "Scheduled Change":
        ids = [e.get("entity-value", "")
               for e in detail.get("affected-entities", [])]
        return ParsedEvent(SCHEDULED_CHANGE, [i for i in ids if i], ts, detail)
    if detail_type == "Instance State-change Notification":
        return ParsedEvent(STATE_CHANGE, [detail.get("instance-id", "")],
                           ts, detail)
    return ParsedEvent(NOOP, [], ts, detail)


class FakeQueue:
    """In-memory interruption queue with SQS visibility semantics: a
    received message stays in flight until deleted; an undeleted one
    reappears."""

    def __init__(self, clock: Callable[[], float] = time.time):
        self.clock = clock
        self._lock = named_lock("queue")
        self._messages: List[Message] = []  # guarded-by: _lock
        self._inflight: Dict[str, Message] = {}  # guarded-by: _lock
        self.sent_count = 0  # guarded-by: _lock

    def send(self, body: str) -> Message:
        msg = Message(body=body, sent_at=self.clock())
        with self._lock:
            self._messages.append(msg)
            self.sent_count += 1
        return msg

    def receive(self, max_messages: int = MAX_RECEIVE) -> List[Message]:
        with self._lock:
            batch = self._messages[:max_messages]
            self._messages = self._messages[len(batch):]
            for m in batch:
                self._inflight[m.receipt] = m
            return batch

    def delete(self, receipt: str) -> bool:
        with self._lock:
            return self._inflight.pop(receipt, None) is not None

    def release_inflight(self):
        """The visibility timeout lapses: undeleted messages can be received
        again."""
        with self._lock:
            self._messages = list(self._inflight.values()) + self._messages
            self._inflight.clear()

    def __len__(self):
        with self._lock:
            return len(self._messages)

    # ---- warm restart (state/snapshot.py) ----
    def snapshot_state(self) -> Dict:
        with self._lock:
            return {"messages": list(self._messages),
                    "inflight": dict(self._inflight),
                    "sent_count": self.sent_count}

    def restore_state(self, data: Dict) -> None:
        with self._lock:
            self._messages = list(data["messages"])
            self._inflight = dict(data["inflight"])
            self.sent_count = int(data["sent_count"])
