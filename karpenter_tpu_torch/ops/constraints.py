"""Topology-constraint lowering: spread / pod-(anti-)affinity → dense solver inputs.

A copy of the JAX package's `ops/constraints.py` (host numpy, no device
code): the consolidation simulation lowers its pods with it before
tensorizing, and parity with the reference needs the same rewrites.

The reference enforces topology spread, pod affinity/anti-affinity and PV
topology inside its per-pod scheduling simulator (surface described in
karpenter:website/content/en/docs/concepts/scheduling.md sections
"topology spread" and "pod affinity/anti-affinity"; relaxation of preferred
terms is karpenter-core's scheduler behavior).  A batched one-shot solve
can't replay per-pod decisions, so constraints are *lowered* ahead of
tensorization:

  * **zone / capacity-type domains** (labels every launch option and live
    node already carries) are lowered by REWRITING PODS: each member of a
    spread or anti-affinity group gets a concrete domain assignment as an
    extra requirement branch.  Option-compat and existing-node-compat then
    pick the constraint up through the ordinary Requirements path — no new
    kernel inputs.  Domain shares are water-filled against existing matching
    pods, which per-increment satisfies the K8s skew rule
    ((count_d + 1) - global_min <= max_skew) for any max_skew >= 1.
  * **hostname-granular** constraints become a per-class node cap enforced
    inside the packing kernels (self anti-affinity -> cap 1, hostname spread
    -> cap max_skew; computed in tensorize._node_cap), plus `hostname NotIn`
    masks against existing nodes already carrying group pods.
  * **soft constraints** (preferred node affinity, ScheduleAnyway spreads)
    are applied as hard requirements first and relaxed level by level when
    pods come back unschedulable — the batched analog of karpenter-core's
    one-preference-at-a-time relaxation loop.

Known approximations (documented, tested):
  * hostname spread against existing nodes is conservative: a node already
    carrying any group pod is excluded instead of tracking remaining skew.
  * required pod affinity between pods of the same batch co-locates the
    group into one deterministic zone (cheapest eligible) instead of
    searching all zones.
  * hostname-level *affinity* (all pods on one node) is not lowered; such
    pods schedule as if the term were zone-scoped.
  * required anti-affinity *between different pods of the same batch*
    (carrier's selector matches other batch pods, not itself) cannot be
    expressed as a mask ahead of the solve; violations are detected
    post-solve (`find_batch_anti_affinity_violations`) and the carrier is
    stranded to the next round, where the targets are existing pods and the
    ordinary NotIn lowering applies.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Set, Tuple

from ..api import labels as wk
from ..api.objects import Node, Pod, PodAffinityTerm, TopologySpreadConstraint
from ..api.requirements import IN, NOT_IN, Requirement, Requirements

# Relaxation levels (strictest first). MAX_LEVEL must stay the last index.
LEVEL_ALL_SOFT = 0        # every preferred term + ScheduleAnyway spreads hard
LEVEL_TOP_PREFERRED = 1   # only the highest-weight preferred term hard
LEVEL_REQUIRED_ONLY = 2   # required constraints only
MAX_LEVEL = LEVEL_REQUIRED_ONLY


def selector_matches(selector: Mapping[str, str], namespace: str, pod: Pod) -> bool:
    """Label-selector match within one namespace (K8s semantics: empty
    selector matches everything in the namespace)."""
    return (pod.namespace == namespace
            and all(pod.labels.get(k) == v for k, v in selector.items()))


@dataclass
class BoundPod:
    """Projection of a pod already running on a node — the 'existing
    matching pods' side of every topology computation."""
    pod: Pod
    zone: str
    capacity_type: str
    hostname: str


def bound_pods(nodes: Iterable[Node], exclude: Sequence[str] = ()) -> List[BoundPod]:
    out = []
    skip = set(exclude)
    for n in nodes:
        if n.name in skip:
            continue
        host = n.labels.get(wk.HOSTNAME, n.name)
        for p in n.pods:
            out.append(BoundPod(p, n.zone, n.capacity_type, host))
    return out


def greedy_spread(members: Sequence[int],
                  eligible: Mapping[int, Sequence[str]],
                  existing: Mapping[str, int]) -> Dict[int, Optional[str]]:
    """Assign each member pod a domain: most-constrained pods first, each to
    its *eligible* domain with the lowest current count — the per-increment
    form of the K8s skew rule ((count_d + 1) - eligible_min <= max_skew
    holds for any max_skew >= 1 because every pod lands on its own current
    minimum).  Deterministic: ties break on sorted domain name / member
    index.  Members with no eligible domain map to None."""
    counts: Dict[str, int] = dict(existing)
    out: Dict[int, Optional[str]] = {}
    for i in sorted(members, key=lambda i: (len(eligible[i]), i)):
        doms = eligible[i]
        if not doms:
            out[i] = None
            continue
        d = min(doms, key=lambda d: (counts.get(d, 0), d))
        counts[d] = counts.get(d, 0) + 1
        out[i] = d
    return out


# ---------------------------------------------------------------------------
# group detection
# ---------------------------------------------------------------------------

@dataclass
class _SpreadGroup:
    constraint: TopologySpreadConstraint
    namespace: str
    members: List[int] = field(default_factory=list)


@dataclass
class _AffinityGroup:
    term: PodAffinityTerm
    namespace: str
    members: List[int] = field(default_factory=list)


def _spread_key(ns: str, c: TopologySpreadConstraint) -> tuple:
    return (ns, c.topology_key, c.max_skew, c.when_unsatisfiable,
            tuple(sorted(c.label_selector.items())))


def _affinity_key(ns: str, a: PodAffinityTerm) -> tuple:
    return (ns, a.topology_key, a.anti, a.required,
            tuple(sorted(a.label_selector.items())))


def _self_group(term_selector: Mapping[str, str], namespace: str,
                members: Sequence[int], pods: Sequence[Pod]) -> bool:
    """Does the term's selector target the group's own pods?"""
    return any(selector_matches(term_selector, namespace, pods[i]) for i in members)


# ---------------------------------------------------------------------------
# the lowering pass
# ---------------------------------------------------------------------------

class _Rewrites:
    """Accumulates per-pod extra requirements; materializes copies lazily so
    unconstrained pods pass through untouched (and keep object identity)."""

    def __init__(self, pods: Sequence[Pod]):
        self.pods = list(pods)
        self.extra: Dict[int, Requirements] = {}
        self.impossible: Set[int] = set()
        # stripped soft constraints are tracked per kind: preferred terms
        # relax one level before ScheduleAnyway spreads (level contract)
        self.strip_preferred: Set[int] = set()
        self.strip_spread: Set[int] = set()

    def add(self, i: int, *reqs: Requirement):
        cur = self.extra.setdefault(i, Requirements())
        cur.add(*reqs)

    def mark_impossible(self, i: int):
        self.impossible.add(i)

    def result(self) -> List[Pod]:
        out = []
        for i, pod in enumerate(self.pods):
            extra = self.extra.get(i)
            strip_pref = i in self.strip_preferred
            strip_spread = i in self.strip_spread
            if i in self.impossible:
                # an empty In set matches nothing -> the pod surfaces as
                # unschedulable from the solver, like DoNotSchedule demands
                extra = (extra or Requirements()).union(
                    Requirements.of(Requirement.raw(wk.ZONE, False, set())))
            if extra is None and not (strip_pref or strip_spread):
                out.append(pod)
                continue
            p = copy.copy(pod)
            # the copy's constraint fields diverge below — drop the
            # inherited spec caches (ops/tensorize._class_key, pod_is_soft)
            p.__dict__.pop("_ckey", None)
            p.__dict__.pop("_cid", None)
            p.__dict__.pop("_soft", None)
            if strip_spread:
                p.topology_spread = [c for c in pod.topology_spread
                                     if c.when_unsatisfiable != "ScheduleAnyway"]
            if strip_pref:
                p.preferred_affinity_terms = []
                p.pod_affinities = [a for a in pod.pod_affinities if a.required]
            if extra:
                branches = pod.required_affinity_terms or [Requirements()]
                p.required_affinity_terms = [b.union(extra) for b in branches]
            out.append(p)
        return out


def _eligible_domains(pod: Pod, key: str, domains: Sequence[str]) -> List[str]:
    """Domains (zones / capacity types / …) the pod's own required
    constraints allow for label `key`."""
    out = []
    branches = pod.scheduling_requirements()
    for d in domains:
        for b in branches:
            r = b.get(key)
            if r is None or r.has(d):
                out.append(d)
                break
    return out


def eligible_zones(pod: Pod, zones: Sequence[str]) -> List[str]:
    return _eligible_domains(pod, wk.ZONE, zones)


def make_zone_feasibility(catalog: Sequence = (), nodes: Iterable[Node] = (),
                          exclude_nodes: Sequence[str] = ()):
    """Build a pod → {zones it can actually land in} predicate: zones with an
    available offering on a compatible instance type, or a compatible live
    node.  Without this, spread assignment only consults the pod's own zone
    requirement and can pin a type-pinned pod into a zone its instance type
    is never offered in (a false unschedulable the reference's per-pod
    simulator cannot produce)."""
    from ..api.taints import tolerates_all
    excl = set(exclude_nodes)
    node_list = [n for n in nodes
                 if n.name not in excl and not n.marked_for_deletion and n.zone]
    type_zones = []
    for it in catalog:
        avail = {o.zone for o in it.offerings if o.available}
        if avail:
            type_zones.append((it, avail))

    def feasible(pod: Pod) -> Set[str]:
        zones: Set[str] = set()
        branches = pod.scheduling_requirements()
        for it, avail in type_zones:
            if avail <= zones:
                continue
            if not pod.requests.fits(it.allocatable):
                continue
            for b in branches:
                allow = [k for k in b if k not in it.requirements]
                if b.compatible(it.requirements, allow_undefined=allow):
                    zones |= avail
                    break
        for n in node_list:
            if n.zone in zones:
                continue
            if not tolerates_all(pod.tolerations, n.taints):
                continue
            labels = dict(n.labels)
            labels.setdefault(wk.HOSTNAME, n.name)
            provided = Requirements.from_labels(labels)
            if any(b.compatible(provided) for b in branches):
                zones.add(n.zone)
        return zones

    return feasible


def _eligible_captypes(pod: Pod, captypes: Sequence[str]) -> List[str]:
    return _eligible_domains(pod, wk.CAPACITY_TYPE, captypes)


def lower_pods(pods: Sequence[Pod],
               nodes: Iterable[Node] = (),
               option_zones: Sequence[str] = (),
               option_captypes: Sequence[str] = (wk.CAPACITY_TYPE_ON_DEMAND,
                                                 wk.CAPACITY_TYPE_SPOT),
               zone_rank: Optional[Mapping[str, float]] = None,
               exclude_nodes: Sequence[str] = (),
               level: int = LEVEL_ALL_SOFT,
               zone_feasible=None) -> List[Pod]:
    """Lower zone/capacity-type topology constraints into pod requirement
    rewrites (see module docstring).  Returns a pod list of the same length
    and order; constrained pods are shallow copies with extra requirement
    branches, the rest pass through by identity."""
    existing = bound_pods(nodes, exclude=exclude_nodes)
    rw = _Rewrites(pods)

    spreads: Dict[tuple, _SpreadGroup] = {}
    host_spreads: Dict[tuple, _SpreadGroup] = {}
    affinities: Dict[tuple, _AffinityGroup] = {}
    for i, pod in enumerate(pods):
        for c in pod.topology_spread:
            if c.when_unsatisfiable == "ScheduleAnyway" and level >= LEVEL_REQUIRED_ONLY:
                rw.strip_spread.add(i)
                continue
            if c.topology_key in (wk.ZONE, wk.CAPACITY_TYPE):
                spreads.setdefault(_spread_key(pod.namespace, c),
                                   _SpreadGroup(c, pod.namespace)).members.append(i)
            elif c.topology_key == wk.HOSTNAME:
                host_spreads.setdefault(_spread_key(pod.namespace, c),
                                        _SpreadGroup(c, pod.namespace)).members.append(i)
        for a in pod.pod_affinities:
            if not a.required and level >= LEVEL_TOP_PREFERRED:
                rw.strip_preferred.add(i)
                continue
            affinities.setdefault(_affinity_key(pod.namespace, a),
                                  _AffinityGroup(a, pod.namespace)).members.append(i)
        if pod.preferred_affinity_terms and level < LEVEL_REQUIRED_ONLY:
            terms = sorted(pod.preferred_affinity_terms,
                           key=lambda wt: -wt[0])
            if level == LEVEL_TOP_PREFERRED:
                terms = terms[:1]
            for _, reqs in terms:
                rw.add(i, *reqs.values())
        elif pod.preferred_affinity_terms:
            rw.strip_preferred.add(i)

    # ---- zone/capacity-type spread: per-increment greedy assignment,
    # honoring each member's own eligibility (node selectors can differ
    # between members of one group) ----
    for g in spreads.values():
        c, ns = g.constraint, g.namespace
        if c.topology_key == wk.ZONE:
            elig = {}
            for i in g.members:
                zs = eligible_zones(pods[i], option_zones)
                if zone_feasible is not None:
                    # restrict to zones the pod can actually land in; fall
                    # back to the unfiltered set when nothing intersects so
                    # the worst case stays the old (relaxable) behavior
                    feas = zone_feasible(pods[i])
                    inter = [z for z in zs if z in feas]
                    if inter:
                        zs = inter
                elig[i] = zs
            dom_of = lambda bp: bp.zone
            key = wk.ZONE
        else:
            elig = {i: _eligible_captypes(pods[i], option_captypes)
                    for i in g.members}
            dom_of = lambda bp: bp.capacity_type
            key = wk.CAPACITY_TYPE
        all_domains = {d for ds in elig.values() for d in ds}
        counts: Dict[str, int] = {}
        for bp in existing:
            if selector_matches(c.label_selector, ns, bp.pod):
                d = dom_of(bp)
                if d in all_domains:
                    counts[d] = counts.get(d, 0) + 1
        for i, d in greedy_spread(g.members, elig, counts).items():
            if d is None:
                rw.mark_impossible(i)
            else:
                rw.add(i, Requirement(key, IN, [d]))

    # ---- hostname spread: new-node skew is the kernel node cap
    # (tensorize._node_cap); existing nodes already carrying a group pod
    # are excluded (conservative — see module docstring) ----
    for g in host_spreads.values():
        c, ns = g.constraint, g.namespace
        hosts = sorted({bp.hostname for bp in existing
                        if selector_matches(c.label_selector, ns, bp.pod)})
        if hosts:
            for i in g.members:
                rw.add(i, Requirement(wk.HOSTNAME, NOT_IN, hosts))

    # ---- pod (anti-)affinity over zone/hostname domains ----
    for g in affinities.values():
        a, ns = g.term, g.namespace
        sel = a.label_selector
        match_existing = [bp for bp in existing
                          if selector_matches(sel, ns, bp.pod)]
        self_ref = _self_group(sel, ns, g.members, pods)

        if a.anti:
            if a.topology_key == wk.HOSTNAME:
                hosts = sorted({bp.hostname for bp in match_existing})
                if hosts:
                    for i in g.members:
                        rw.add(i, Requirement(wk.HOSTNAME, NOT_IN, hosts))
                # self-exclusion among new pods = per-class node cap
                # (tensorize._node_cap); nothing more to do here
            elif a.topology_key == wk.ZONE:
                taken = sorted({bp.zone for bp in match_existing})
                if self_ref:
                    # one group pod per zone: assign distinct free zones
                    rep = pods[g.members[0]]
                    free = [z for z in eligible_zones(rep, option_zones)
                            if z not in taken]
                    free.sort(key=lambda z: (zone_rank or {}).get(z, 0.0))
                    for n_assigned, i in enumerate(sorted(g.members)):
                        if n_assigned < len(free):
                            rw.add(i, Requirement(wk.ZONE, IN, [free[n_assigned]]))
                        else:
                            rw.mark_impossible(i)
                elif taken:
                    for i in g.members:
                        rw.add(i, Requirement(wk.ZONE, NOT_IN, taken))
        else:
            # affinity: restrict to domains already hosting matching pods;
            # for an intra-batch group, co-locate into one eligible zone
            if a.topology_key == wk.HOSTNAME and match_existing:
                hosts = sorted({bp.hostname for bp in match_existing})
                for i in g.members:
                    rw.add(i, Requirement(wk.HOSTNAME, IN, hosts))
            elif a.topology_key == wk.ZONE or (
                    a.topology_key == wk.HOSTNAME and not match_existing):
                zones_with = sorted({bp.zone for bp in match_existing})
                if zones_with:
                    for i in g.members:
                        rw.add(i, Requirement(wk.ZONE, IN, zones_with))
                elif self_ref:
                    rep = pods[g.members[0]]
                    cand = eligible_zones(rep, option_zones)
                    if not cand:
                        for i in g.members:
                            rw.mark_impossible(i)
                        continue
                    chosen = min(cand, key=lambda z: ((zone_rank or {}).get(z, 0.0), z))
                    for i in g.members:
                        rw.add(i, Requirement(wk.ZONE, IN, [chosen]))
                elif a.required:
                    for i in g.members:
                        rw.mark_impossible(i)

    return rw.result()


def find_batch_topology_violations(problem, packing,
                                   existing_nodes: Sequence[Node] = ()
                                   ) -> Set[int]:
    """Detect topology constraints broken *within one batch* — the cases no
    pre-solve mask can express (module docstring, last approximation):

      * required anti-affinity whose selector matches a *different* pod
        placed on the same node (hostname) or zone;
      * hostname DoNotSchedule spread groups that span multiple pod classes
        (the kernel node cap is per class, so two classes of one group can
        co-locate beyond max_skew).

    Returns indices into `problem.pods` of pods to strand.  Carriers are
    processed in index order and only violate against *non-stranded* pods,
    so a mutually anti-affine pair strands exactly one member — the other
    binds, and the stranded one re-solves next round against bound targets,
    where the ordinary NotIn lowering applies (guaranteed convergence)."""
    pods = problem.pods
    # placement: pod index -> (node key, zone)
    place: Dict[int, Tuple[object, str]] = {}
    for di, nd in enumerate(packing.nodes):
        for i in nd.pod_indices:
            place[i] = (("new", di), nd.option.zone)
    nodes = list(existing_nodes)
    for i, slot in packing.existing_assignments.items():
        zone = nodes[slot].zone if slot < len(nodes) else ""
        place[i] = (("existing", slot), zone)

    by_node: Dict[object, List[int]] = {}
    by_zone: Dict[str, List[int]] = {}
    for i, (nk, z) in place.items():
        by_node.setdefault(nk, []).append(i)
        if z:
            by_zone.setdefault(z, []).append(i)

    out: Set[int] = set()
    for i in sorted(place):
        nk, z = place[i]
        pod = pods[i]
        for a in pod.pod_affinities:
            if not (a.anti and a.required):
                continue
            if a.topology_key == wk.HOSTNAME:
                neighbors = by_node.get(nk, ())
            elif a.topology_key == wk.ZONE:
                neighbors = by_zone.get(z, ()) if z else ()
            else:
                continue
            if any(j != i and j not in out and pods[j].uid != pod.uid
                   and selector_matches(a.label_selector, pod.namespace, pods[j])
                   for j in neighbors):
                out.add(i)
                break

    # hostname spread across classes: per (group, node) the kept count may
    # not exceed max_skew; strand the excess (highest indices first so the
    # earliest pods keep their placement deterministically)
    group_node: Dict[tuple, Dict[object, List[int]]] = {}
    for i in sorted(place):
        if i in out:
            continue
        pod = pods[i]
        for c in pod.topology_spread:
            if c.topology_key != wk.HOSTNAME or c.when_unsatisfiable != "DoNotSchedule":
                continue
            key = _spread_key(pod.namespace, c)
            group_node.setdefault(key, {}).setdefault(place[i][0], []).append(i)
    for key, per_node in group_node.items():
        max_skew = key[2]
        for nk, members in per_node.items():
            if len(members) > max_skew:
                out.update(members[max_skew:])
    return out


def pod_is_soft(pod: Pod) -> bool:
    """Whether relaxation levels can change this pod's lowering. Spec-derived
    and cached (dropped alongside the class key when _Rewrites copies a pod),
    so 50k-pod batches pay the attribute walk once, at admission."""
    d = pod.__dict__
    s = d.get("_soft")
    if s is None:
        s = d["_soft"] = bool(
            pod.preferred_affinity_terms
            or any(c.when_unsatisfiable == "ScheduleAnyway"
                   for c in pod.topology_spread)
            or any(not a.required for a in pod.pod_affinities))
    return s


def has_soft_constraints(pods: Sequence[Pod]) -> bool:
    """Whether relaxing to a higher level could change the outcome."""
    return any(pod_is_soft(p) for p in pods)
