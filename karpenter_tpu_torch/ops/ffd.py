"""Packing result types shared by the solvers.

A copy of the result half of the JAX package's `ops/ffd.py`: the constants
and dataclasses the class-granular solve and the batched consolidation
sweep return.  The pod-granular
`ffd_pack_kernel` is not ported yet (ROADMAP queue B).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from ..api.resources import ResourceList
from .tensorize import LaunchOption

NO_ASSIGNMENT = -1

# Cap on new-node scores (price × ceil(tail/m)): large-but-finite prices
# times a big tail overflow float32 to +inf, which an argmin over all-inf
# scores resolves to index 0 — possibly an incompatible option.  Clamping
# keeps overflowed candidates comparable (ties break to the lower,
# cheaper-sorted index) and matches the reference's clamp bit for bit
# (the CUDA scan uses the same float32 constant).
SCORE_CAP = 3.38e38  # just under float32 max (3.4028e38)


@dataclass
class NodeDecision:
    """One node to launch: the chosen option plus the pods packed onto it.
    The flexible `alternatives` list (instance types the packed pods are
    jointly compatible with, price-ordered) is what feeds CreateFleet-style
    flexible launches (karpenter:pkg/providers/instance/instance.go:88-105)."""
    option: LaunchOption
    pod_indices: List[int]
    used: "ResourceList" = None   # canonical units (bytes/millicores)
    alternatives: List[LaunchOption] = field(default_factory=list)


@dataclass
class PackingResult:
    nodes: List[NodeDecision]
    unschedulable: List[int]            # original pod indices
    existing_assignments: Dict[int, int]  # pod index -> pre-opened slot id
    total_price: float

    @property
    def scheduled_count(self) -> int:
        return (sum(len(n.pod_indices) for n in self.nodes)
                + len(self.existing_assignments))

    def strip_pods(self, pod_indices, pods=None) -> None:
        """Remove pods from the plan in place: they leave their node
        decisions / existing slots and land in `unschedulable`.  Decisions
        left empty are dropped (their node is never launched) and
        `total_price` re-sums over the survivors.  This is how gang
        enforcement (ops/gang.py) takes a rejected gang out of the plan
        wholesale — no partial bind ever reaches claim_requests.  `pods`
        (the Problem's pod list) lets per-decision `used` shrink with the
        departures so downstream claim sizing stays honest."""
        drop = {int(i) for i in pod_indices}
        if not drop:
            return
        kept = []
        for dec in self.nodes:
            removed = [i for i in dec.pod_indices if int(i) in drop]
            if removed:
                dec.pod_indices = [i for i in dec.pod_indices
                                   if int(i) not in drop]
                if dec.used is not None and pods is not None:
                    for i in removed:
                        dec.used = dec.used - pods[i].requests
                    dec.used = dec.used.clamp_nonnegative()
            if dec.pod_indices:
                kept.append(dec)
        self.nodes = kept
        for i in [i for i in self.existing_assignments if int(i) in drop]:
            del self.existing_assignments[i]
        self.unschedulable = sorted(
            {int(i) for i in self.unschedulable} | drop)
        self.total_price = float(sum(d.option.price for d in self.nodes))


@dataclass
class SweepResult:
    """Aggregate verdicts for B masked sub-problems solved in one (or a few
    bucket-padded) device calls — the batched consolidation sweep's output.
    Row b answers the b-th probe exactly as a decode=False PackingResult
    would: could the probe's pods land on the unmasked columns, how many
    NEW nodes would launch, and at what launch cost."""
    total_price: np.ndarray     # B float32 — price of newly-launched nodes
    new_nodes: np.ndarray       # B int32  — nodes launched (existing excluded)
    unschedulable: np.ndarray   # B int32  — pods left unplaced
    device_calls: int = 1       # padded kernel invocations this sweep took

    def feasible_delete(self, b: int) -> bool:
        """The delete-probe contract: every pod lands on survivors alone."""
        return (int(self.unschedulable[b]) == 0
                and int(self.new_nodes[b]) == 0)
