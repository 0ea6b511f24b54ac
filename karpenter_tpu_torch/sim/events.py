"""Typed simulation events (a copy of the JAX package's `sim/events.py`).

Events are inert data — `scenario.expand` produces them, the harness
delivers them.  Each carries a ``kind`` string (the event-log and metrics
label domain) and a ``to_log()`` projection kept deliberately small so the
append-only event log stays byte-stable across runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..api.objects import Pod

# kind strings (the event log's and the report's `events.by_kind` keys)
POD_ARRIVAL = "pod_arrival"
POD_DEPARTURE = "pod_departure"
SPOT_RECLAIM = "spot_reclaim"
ICE_OPEN = "ice_open"
ICE_CLOSE = "ice_close"
PRICE_DRIFT = "price_drift"
NODE_READY_LATENCY = "node_ready_latency"
API_THROTTLE = "api_throttle"
NODE_READY = "node_ready"          # harness-internal (ready-latency lapse)


@dataclass
class SimEvent:
    kind = "event"

    def to_log(self) -> Dict:
        return {"kind": self.kind}


@dataclass
class PodArrival(SimEvent):
    """A cohort of pods hits the cluster (one wave bucket)."""
    pods: List[Pod]
    wave: str = ""
    kind = POD_ARRIVAL

    def to_log(self) -> Dict:
        return {"kind": self.kind, "wave": self.wave, "pods": len(self.pods)}


@dataclass
class PodDeparture(SimEvent):
    """A cohort completes / scales down: its pods leave the cluster."""
    uids: List[str]
    wave: str = ""
    kind = POD_DEPARTURE

    def to_log(self) -> Dict:
        return {"kind": self.kind, "wave": self.wave, "pods": len(self.uids)}


@dataclass
class SpotReclaim(SimEvent):
    """Reclaim `count` running spot instances: the 2-minute warning is
    published immediately, capacity is pulled `warning_s` later unless the
    controllers drained it first (the honor-rate input)."""
    count: int = 1
    warning_s: float = 120.0
    fault: str = ""
    kind = SPOT_RECLAIM

    def to_log(self) -> Dict:
        return {"kind": self.kind, "fault": self.fault, "count": self.count,
                "warning_s": self.warning_s}


@dataclass
class IceOpen(SimEvent):
    """Capacity pools start answering InsufficientInstanceCapacity.  Pool
    triples are (capacity_type, instance_type, zone); "*" wildcards resolve
    against the live catalog at delivery, deterministically."""
    pools: List[Tuple[str, str, str]]
    fault: str = ""
    kind = ICE_OPEN

    def to_log(self) -> Dict:
        return {"kind": self.kind, "fault": self.fault,
                "pools": len(self.pools)}


@dataclass
class IceClose(SimEvent):
    pools: List[Tuple[str, str, str]]
    fault: str = ""
    kind = ICE_CLOSE

    def to_log(self) -> Dict:
        return {"kind": self.kind, "fault": self.fault,
                "pools": len(self.pools)}


@dataclass
class PriceDrift(SimEvent):
    """Multiply every spot price by `factor`, each entry additionally
    jittered by up to ±`jitter` (resolved at delivery from the run seed)."""
    factor: float = 1.0
    jitter: float = 0.0
    fault: str = ""
    kind = PRICE_DRIFT

    def to_log(self) -> Dict:
        return {"kind": self.kind, "fault": self.fault,
                "factor": round(self.factor, 6),
                "jitter": round(self.jitter, 6)}


@dataclass
class NodeReadyLatency(SimEvent):
    """From now on, freshly launched nodes take `latency_s` of virtual time
    to become Ready (kubelet join + startup-taint clearance)."""
    latency_s: float = 0.0
    fault: str = ""
    kind = NODE_READY_LATENCY

    def to_log(self) -> Dict:
        return {"kind": self.kind, "fault": self.fault,
                "latency_s": self.latency_s}


@dataclass
class ApiThrottle(SimEvent):
    """Every cloud API call fails with RequestLimitExceeded for the next
    `duration_s` of virtual time (an API throttle burst)."""
    duration_s: float = 60.0
    fault: str = ""
    kind = API_THROTTLE

    def to_log(self) -> Dict:
        return {"kind": self.kind, "fault": self.fault,
                "duration_s": self.duration_s}


@dataclass
class NodeReady(SimEvent):
    """Harness-internal: a booting node's ready latency lapsed — clear its
    boot condition so the lifecycle controller can initialize it."""
    node: str = ""
    kind = NODE_READY

    def to_log(self) -> Dict:
        return {"kind": self.kind, "node": self.node}
