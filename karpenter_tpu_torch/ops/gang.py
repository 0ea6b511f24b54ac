"""Gang / topology-aware scheduling (the `GangScheduling` feature gate).

A copy of the JAX package's `ops/gang.py`: host arithmetic over the packing
the ported kernels return, which stay gang-oblivious (tensorize only orders
a gang's classes side by side).

The solver places every pod independently; the tightly-coupled workloads
this repo is named for (multi-chip TPU slices, MPI gangs) need the
opposite: a *gang* of pods is useful only when every member runs, and
only when the members land close enough to each other to talk (one zone,
or one host).  This module supplies the missing semantics as a post-solve
audit over the dense packing — the kernels stay gang-oblivious and fast,
and the all-or-nothing / topology invariants are enforced where the plan
becomes visible, before any bind or launch:

* `audit_gangs` inspects a `PackingResult` and classifies every gang in
  the batch as admitted or rejected (`incomplete` — fewer members arrived
  than `gang_size` declares; `partial` — the solver left members
  unplaced; `straddle` — members placed across more than one topology
  domain).
* `enforce_gangs` strips every member of a rejected gang from the plan
  (`PackingResult.strip_pods`), so partial gangs never reach
  `claim_requests` or `bind_pod`, and records per-pod rejection info on
  `problem.gang_rejections` for `utils/provenance.explain_unschedulable`.
* `plan_preemption` builds the priority cascade: when a rejected gang
  outranks bound pods (strictly lower `gang_tier`), it computes the
  cheapest victim prefix — tier ascending, then disruption cost — whose
  eviction frees enough capacity in ONE topology domain.  The plan is
  capacity arithmetic, not a packing probe: the DisruptionController
  executes it like consolidation reschedules (victims unbind to pending)
  and the *real* solver admits the gang on a later round, so a bad plan
  costs churn, never correctness.
* `GangRegistry` is the durable ledger of gang admission state, carried
  through `state/snapshot.py` so a restart can prove no gang was ever
  half-admitted.

Everything here iterates in sorted order and touches no wall clock
(graftlint DT003): identical solves produce identical audits, plans and
registry states.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api.resources import ResourceList
from .tensorize import GangInfo

# Rejection reasons — the bounded vocabulary used as the
# karpenter_gang_rejections_total label (graftlint OB003: never the gang
# name, which is user-controlled and unbounded).
INCOMPLETE = "incomplete"   # fewer members arrived than gang_size declares
PARTIAL = "partial"         # solver left some arrived members unplaced
STRADDLE = "straddle"       # all placed, but across >1 topology domain


@dataclass
class GangAudit:
    """One gang's verdict for one solve."""
    gang: GangInfo
    members: Tuple[int, ...]    # original pod indices in the batch, sorted
    placed: Tuple[int, ...]     # members the packing placed, sorted
    domains: Tuple[str, ...]    # distinct topology-domain tokens touched
    admitted: bool
    reason: str = ""            # INCOMPLETE / PARTIAL / STRADDLE when rejected
    message: str = ""           # human form, mirrored into FailedScheduling
    bound: int = 0              # members already bound outside this batch
    bound_domains: Tuple[str, ...] = ()  # domains those residents occupy


@dataclass
class PreemptionVictim:
    uid: str
    pod: str
    node: str
    tier: int
    cost: float


@dataclass
class PreemptionPlan:
    """Evict `victims` (in order) to free room for `gang` in `domain`."""
    gang: str
    tier: int
    topology: str
    domain: str
    victims: List[PreemptionVictim]
    total_cost: float


def gang_members(problem) -> Dict[int, List[int]]:
    """gang index → sorted original pod indices, from the class columns."""
    out: Dict[int, List[int]] = {}
    if problem.class_gang is None:
        return out
    for ci, g in enumerate(problem.class_gang.tolist()):
        if g < 0:
            continue
        out.setdefault(int(g), []).extend(
            int(i) for i in np.asarray(problem.class_members[ci], np.int64))
    for g in out:
        out[g].sort()
    return out


def _placements(result, existing_nodes, topology: str) -> Dict[int, str]:
    """pod index → topology-domain token for every pod the packing placed.

    zone granularity: new nodes take their launch option's zone, existing
    nodes their live zone — same zone == same domain either way.  hostname
    granularity: every node (new decision or existing slot) is its own
    domain, so a gang must fit on ONE machine."""
    dom: Dict[int, str] = {}
    for di, dec in enumerate(result.nodes):
        token = dec.option.zone if topology == "zone" else f"new:{di}"
        for i in dec.pod_indices:
            dom[int(i)] = token
    for i, slot in result.existing_assignments.items():
        node = existing_nodes[slot]
        dom[int(i)] = node.zone if topology == "zone" else f"node:{node.name}"
    return dom


def _residents(gang: GangInfo, cluster_nodes: Sequence) -> Dict[str, int]:
    """Domain token → count of the gang's already-bound members.

    A gang that lost part of itself after admission (spot reclaim killed
    a member's node) re-enters the batch with fewer pods than its size
    declares; the still-bound members count toward completeness and pin
    the topology domain the stragglers must rejoin."""
    out: Dict[str, int] = {}
    for n in sorted(cluster_nodes, key=lambda n: n.name):
        cnt = sum(1 for p in n.pods if p.gang_name == gang.name)
        if cnt:
            token = (n.zone if gang.topology == "zone" else n.name) or ""
            out[token] = out.get(token, 0) + cnt
    return out


def audit_gangs(problem, result, existing_nodes: Sequence,
                cluster_nodes: Sequence = ()) -> List[GangAudit]:
    """Classify every gang in the batch against one packing, gang order."""
    audits: List[GangAudit] = []
    by_gang = gang_members(problem)
    placements: Dict[str, Dict[int, str]] = {}
    for g in sorted(by_gang):
        gang = problem.gangs[g]
        members = by_gang[g]
        dom = placements.get(gang.topology)
        if dom is None:
            dom = placements[gang.topology] = _placements(
                result, existing_nodes, gang.topology)
        placed = tuple(i for i in members if i in dom)
        bound = _residents(gang, cluster_nodes)
        bound_n = sum(bound.values())
        bound_domains = tuple(sorted(bound))
        present = len(members) + bound_n
        domains = tuple(sorted({dom[i] for i in placed} | set(bound)))
        if present < gang.size:
            admitted, reason = False, INCOMPLETE
            message = (f"gang incomplete: {present}/{gang.size} "
                       "members present")
        elif len(placed) < len(members):
            admitted, reason = False, PARTIAL
            message = (f"gang partially placeable: "
                       f"{len(placed) + bound_n}/{present}")
        elif len(domains) > 1:
            admitted, reason = False, STRADDLE
            message = (f"gang straddles {len(domains)} {gang.topology} "
                       f"domains: {list(domains)[:4]}")
        else:
            admitted, reason, message = True, "", ""
        audits.append(GangAudit(gang=gang, members=tuple(members),
                                placed=placed, domains=domains,
                                admitted=admitted, reason=reason,
                                message=message, bound=bound_n,
                                bound_domains=bound_domains))
    return audits


def enforce_gangs(problem, result, existing_nodes: Sequence,
                  registry: Optional["GangRegistry"] = None,
                  cluster_nodes: Sequence = ()) -> List[GangAudit]:
    """All-or-nothing enforcement: audit, then strip every member of every
    rejected gang from `result` in place (they come back unschedulable) and
    record per-pod rejection info on `problem.gang_rejections` for the
    provenance walk.  Returns ALL audits; callers split admitted/rejected
    for metrics.  No partial gang bind can survive this call."""
    audits = audit_gangs(problem, result, existing_nodes,
                         cluster_nodes=cluster_nodes)
    rejected = [a for a in audits if not a.admitted]
    if rejected:
        rejections: Dict[int, Dict] = dict(
            getattr(problem, "gang_rejections", None) or {})
        strip: set = set()
        for a in rejected:
            placed_set = set(a.placed)
            unplaced = [i for i in a.members if i not in placed_set]
            # the "worst" member: first unplaced one — provenance replays
            # its catalog walk to name the first failing constraint
            worst = unplaced[0] if unplaced else -1
            info = {"gang": a.gang.name, "size": a.gang.size,
                    "tier": a.gang.tier, "topology": a.gang.topology,
                    "arrived": len(a.members) + a.bound,
                    "placed": len(a.placed),
                    "placed_members": list(a.placed),
                    "reason": a.reason, "message": a.message,
                    "worst": worst}
            for i in a.members:
                rejections[i] = info
            strip.update(a.members)
        result.strip_pods(strip, pods=problem.pods)
        problem.gang_rejections = rejections
    if registry is not None:
        for a in audits:
            registry.observe(a)
    return audits


def gang_demand(problem, members: Sequence[int]) -> ResourceList:
    """Summed resource requests of a gang's arrived members."""
    total = ResourceList()
    for i in members:
        total = total + problem.pods[i].requests
    return total


def victim_cost(pod) -> float:
    """Eviction cost for cascade ordering.  Mirrors
    `controllers/disruption.pod_disruption_cost` (ops must not import
    controllers); tests/test_gang.py pins the two formulas together."""
    return 1.0 + max(pod.priority, 0) / 1e4 + pod.deletion_cost / 1e3


def _first_fit(member_reqs: Sequence[ResourceList],
               free: Dict[str, ResourceList],
               order: Sequence[str]) -> bool:
    """Every member lands on SOME node at the current free capacities?
    First-fit over name-sorted nodes, members largest-first — the cheap
    stand-in for the real packing the solver will run next round."""
    avail = dict(free)
    for req in member_reqs:
        for name in order:
            if req.fits(avail[name]):
                avail[name] = avail[name] - req
                break
        else:
            return False
    return True


def plan_preemption(gang: GangInfo, member_requests: Sequence[ResourceList],
                    nodes: Sequence,
                    pin_domains: Sequence[str] = ()) -> Optional[PreemptionPlan]:
    """Pick the cheapest victim set whose eviction lets every gang member
    first-fit into ONE topology domain.

    Candidates are bound pods of strictly lower gang tier that are fair
    game for disruption (owned, not daemons, not do-not-disrupt), ordered
    by (tier asc, disruption cost asc, uid) — the priority cascade.  Per
    domain we take the minimal prefix of that order under which every
    member first-fits onto some node (per-node capacities, NOT an
    aggregate sum: a domain with plenty of total headroom but no single
    node large enough for a member must keep evicting, or the plan frees
    nothing the solver can use); the best domain is the one needing the
    fewest victims (ties: lower total cost, then domain name).  First-fit
    is a conservative stand-in for the real packing — the plan only frees
    capacity, the real solver re-admits the gang next round, and if
    fragmentation still blocks it the next plan evicts further down the
    cascade.  `pin_domains` restricts the search to the listed tokens —
    a gang with members still bound somewhere must free room in THAT
    domain, or the stragglers rejoin as a straddle."""
    reqs = sorted(member_requests,
                  key=lambda r: tuple(sorted(r.items())), reverse=True)
    domains: Dict[str, List] = {}
    pins = set(pin_domains)
    for n in nodes:
        if getattr(n, "marked_for_deletion", False):
            continue
        token = (n.zone if gang.topology == "zone" else n.name) or ""
        if pins and token not in pins:
            continue
        domains.setdefault(token, []).append(n)
    best: Optional[PreemptionPlan] = None
    best_key = None
    for token in sorted(domains):
        dnodes = sorted(domains[token], key=lambda n: n.name)
        order = [n.name for n in dnodes]
        free = {n.name: n.available() for n in dnodes}
        victims: List[Tuple[Tuple, PreemptionVictim, ResourceList]] = []
        for n in dnodes:
            for p in n.pods:
                if (p.gang_tier >= gang.tier or p.is_daemon
                        or p.do_not_disrupt or not p.owner_kind):
                    continue
                cost = victim_cost(p)
                victims.append(((p.gang_tier, cost, p.uid),
                                PreemptionVictim(uid=p.uid, pod=p.name,
                                                 node=n.name,
                                                 tier=p.gang_tier, cost=cost),
                                p.requests))
        victims.sort(key=lambda v: v[0])
        chosen: List[PreemptionVictim] = []
        feasible = _first_fit(reqs, free, order)
        for _, victim, req in victims:
            if feasible:
                break
            free[victim.node] = free[victim.node] + req
            chosen.append(victim)
            feasible = _first_fit(reqs, free, order)
        if not feasible or not chosen:
            # infeasible even with every victim gone, or feasible with
            # none — either way eviction buys this gang nothing here
            continue
        total_cost = sum(v.cost for v in chosen)
        key = (len(chosen), total_cost, token)
        if best_key is None or key < best_key:
            best_key = key
            best = PreemptionPlan(gang=gang.name, tier=gang.tier,
                                  topology=gang.topology, domain=token,
                                  victims=chosen, total_cost=total_cost)
    return best


@dataclass
class GangRecord:
    """Durable per-gang admission state (the registry's unit)."""
    name: str
    size: int = 0
    tier: int = 0
    topology: str = "zone"
    admitted: bool = False      # latest verdict: fully bound right now?
    admissions: int = 0
    rejections: int = 0
    last_reason: str = ""
    preempted: int = 0          # victims evicted on this gang's behalf

    def to_dict(self) -> Dict:
        return {"name": self.name, "size": self.size, "tier": self.tier,
                "topology": self.topology, "admitted": self.admitted,
                "admissions": self.admissions, "rejections": self.rejections,
                "last_reason": self.last_reason, "preempted": self.preempted}


class GangRegistry:
    """name → GangRecord: every gang the provisioner has ever audited.

    The snapshot section (`state/snapshot.py` "gang") serializes this, so
    a restarted operator knows which gangs were fully admitted at the
    checkpoint — the restart test proves a kill -9 can never surface a
    half-admitted gang, because admission itself is atomic (enforce_gangs
    strips rejected gangs before any bind)."""

    def __init__(self):
        self._gangs: Dict[str, GangRecord] = {}

    def __len__(self) -> int:
        return len(self._gangs)

    def get(self, name: str) -> Optional[GangRecord]:
        return self._gangs.get(name)

    def observe(self, audit: GangAudit) -> GangRecord:
        g = audit.gang
        rec = self._gangs.get(g.name)
        if rec is None:
            rec = self._gangs[g.name] = GangRecord(name=g.name)
        rec.size, rec.tier, rec.topology = g.size, g.tier, g.topology
        rec.admitted = audit.admitted
        if audit.admitted:
            rec.admissions += 1
            rec.last_reason = ""
        else:
            rec.rejections += 1
            rec.last_reason = audit.reason
        return rec

    def record_preemption(self, name: str, victims: int) -> None:
        rec = self._gangs.get(name)
        if rec is None:
            rec = self._gangs[name] = GangRecord(name=name)
        rec.preempted += victims

    def summary(self) -> Dict[str, Dict]:
        """Deterministic name-sorted view (debug endpoint + sim report)."""
        return {name: self._gangs[name].to_dict()
                for name in sorted(self._gangs)}

    # ---- snapshot section (state/snapshot.py "gang") ----
    def snapshot_state(self) -> Dict:
        return {"gangs": self.summary()}

    def restore_state(self, state: Dict) -> None:
        self._gangs.clear()
        for name in sorted(state.get("gangs", {})):
            d = state["gangs"][name]
            self._gangs[name] = GangRecord(
                name=name, size=int(d.get("size", 0)),
                tier=int(d.get("tier", 0)),
                topology=str(d.get("topology", "zone")),
                admitted=bool(d.get("admitted", False)),
                admissions=int(d.get("admissions", 0)),
                rejections=int(d.get("rejections", 0)),
                last_reason=str(d.get("last_reason", "")),
                preempted=int(d.get("preempted", 0)))
