"""Tensorization: pods + catalog + nodepools → dense arrays.

A copy of the JAX package's `ops/tensorize.py`, with its consolidation
`SimulationArena` (the delta-streamed ClusterArena is not ported yet).  The
lowering is host-side numpy and must stay bit-identical to the reference's,
because every kernel parity check starts from these arrays:

  * pods are deduplicated into **equivalence classes** (identical requests +
    constraints), so the host does set algebra once per (class × launch
    option);
  * the catalog is flattened into **launch options** — one column per
    (nodepool × instance-type × zone × capacity-type) available offering;
  * the result is a `Problem` of dense arrays (requests C×R, compat C×O,
    allocatable O×R, price O) that the CUDA kernels in
    karpenter_tpu_torch.ops.classpack_kernels consume.

Shape discipline: `pad_to` buckets P and O up to fixed sizes, so the device
buffers and the kernels' launch shapes repeat across solves.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..api import labels as wk
from ..api.objects import Node, NodePool, Pod
from ..api.requirements import IN, Requirement, Requirements
from ..api.resources import DEFAULT_AXES, DEFAULT_SCALES, PODS, ResourceList
from ..api.taints import tolerates_all
from ..catalog.instancetype import InstanceType, Offering


@dataclass(frozen=True)
class LaunchOption:
    """One solver column: a concrete way to buy a node."""
    pool: str
    instance_type: str
    zone: str
    capacity_type: str
    price: float
    type_index: int       # into the catalog list
    pool_index: int
    weight_rank: int = 0  # 0 == highest-weight pool (pool precedence)


@dataclass(frozen=True)
class GangInfo:
    """One all-or-nothing gang observed in a batch (ops/gang.py): every
    member binds in one solve within one topology domain, or none do."""
    name: str
    size: int                 # declared member count (arrived may be less)
    tier: int                 # preemption tier (higher evicts lower)
    topology: str = "zone"    # domain granularity: "zone" | "hostname"


@dataclass
class Problem:
    """Dense scheduling problem. All arrays are numpy on the host; the solve
    moves them to the device once per solve (content-cached)."""
    axes: Tuple[str, ...]
    # per pod-class
    class_requests: np.ndarray      # C×R float32
    class_counts: np.ndarray        # C int32
    class_compat: np.ndarray        # C×O bool
    class_members: Sequence  # class -> original pod index vectors (int64
                             # ndarrays from tensorize; plain lists OK too)
    # per launch option (column)
    options: List[LaunchOption]
    option_alloc: np.ndarray        # O×R float32
    option_price: np.ndarray        # O float32
    option_rank: np.ndarray = None  # O int32 pool-weight rank (0 = preferred)
    # per-class max pods per node (hostname spread / anti-affinity lowering;
    # _CAP_BIG == unconstrained)
    class_node_cap: np.ndarray = None  # C int32
    option_zone: np.ndarray = None  # O int32 (index into zones)
    option_captype: np.ndarray = None  # O int32 (index into the sorted
    # capacity-type vocabulary; on-demand=0, spot=1 in the standard catalog)
    zones: List[str] = field(default_factory=list)
    pods: List[Pod] = field(default_factory=list)
    # gang columns (GangScheduling): class → index into `gangs` (-1 = not
    # in a gang).  Gang members may span several classes (heterogeneous
    # specs); `None` class_gang means "no gang pods in this batch" and
    # every consumer short-circuits.
    class_gang: np.ndarray = None   # C int32, -1 == non-gang
    gangs: List[GangInfo] = field(default_factory=list)
    # per-axis quantity scales the dense arrays were lowered with (byte axes
    # divide to MiB so int32 kernel math can't overflow); decode must invert
    # with THESE, not DEFAULT_SCALES — extra axes may carry their own scale
    scales: Mapping[str, float] = field(default_factory=lambda: DEFAULT_SCALES)

    @property
    def num_classes(self) -> int:
        return self.class_requests.shape[0]

    @property
    def class_reps(self) -> List[Pod]:
        """One representative pod per equivalence class."""
        return [self.pods[m[0]] for m in self.class_members]

    def class_order(self) -> np.ndarray:
        """FFD order over classes (largest first) under a scale-free size key:
        the class's BOTTLENECK dimension (max over axes of request /
        mean-allocatable) — the standard vector-packing size measure, which
        benches 1-2% cheaper than the sum-of-dims key on mixed shapes and
        ties on homogeneous ones. The single source of ordering truth for
        expand(), the class-granular solver, and the test oracles."""
        norm = (self.option_alloc.mean(axis=0) if self.num_options
                else np.ones(len(self.axes), np.float32))
        norm = np.where(norm > 0, norm, 1.0)
        size = (self.class_requests / norm).max(axis=1)
        order = np.argsort(-size, kind="stable")
        if self.class_gang is not None:
            # gang members pack adjacently (at the rank of the gang's
            # largest class) so one scan sees the whole gang together —
            # the no-gang path above is byte-identical to the pre-gang key
            gang_slot: Dict[int, int] = {}
            groups: List[List[int]] = []
            for ci in order.tolist():
                g = int(self.class_gang[ci])
                if g < 0:
                    groups.append([ci])
                elif g in gang_slot:
                    groups[gang_slot[g]].append(ci)
                else:
                    gang_slot[g] = len(groups)
                    groups.append([ci])
            order = np.asarray([ci for grp in groups for ci in grp],
                               order.dtype)
        return order

    @property
    def num_options(self) -> int:
        return self.option_alloc.shape[0]

    def members_arrays(self) -> List[np.ndarray]:
        """class_members as int64 arrays, converted once per Problem —
        decode concatenates them every solve."""
        arrs = self.__dict__.get("_members_arr")
        if arrs is None:
            arrs = self.__dict__["_members_arr"] = [
                np.asarray(m, np.int64) for m in self.class_members]
        return arrs

    # ---- per-pod expansion (for pod-granular kernels) ----
    def expand(self, sort_desc: bool = True, extra_compat: Optional[np.ndarray] = None):
        """Expand classes to per-pod rows, FFD-sorted (largest first, as the
        reference sorts pods by resources descending,
        karpenter:designs/bin-packing.md:16-20). Returns
        (requests P×R, compat P×(O[+E]), pod_index P, class_id P). The sort
        is stable on class rank, so rows of one class stay contiguous — the
        pod-granular kernel's per-class node-cap counter relies on that.
        `extra_compat` (C×E, e.g. per-existing-node feasibility) is expanded
        and appended as extra columns in the same row order."""
        class_ids = np.repeat(np.arange(self.num_classes), self.class_counts)
        requests = self.class_requests[class_ids]
        compat = self.class_compat[class_ids]
        if extra_compat is not None:
            compat = np.concatenate([compat, extra_compat[class_ids]], axis=1)
        pod_idx = np.concatenate([np.asarray(m, dtype=np.int32) for m in self.class_members]) \
            if self.class_members else np.zeros(0, np.int32)
        if sort_desc and len(requests):
            class_rank = np.empty(self.num_classes, np.int64)
            class_rank[self.class_order()] = np.arange(self.num_classes)
            order = np.argsort(class_rank[class_ids], kind="stable")
            requests, compat = requests[order], compat[order]
            pod_idx, class_ids = pod_idx[order], class_ids[order]
        return requests.astype(np.float32), compat, pod_idx, class_ids.astype(np.int32)


def _class_key(pod: Pod) -> tuple:
    """Equivalence-class key over the pod's scheduling-relevant spec.

    Cached on the pod (the spec is immutable once created — the one code
    path that derives modified pods, ops/constraints._Rewrites, copies and
    drops the cache), so re-solves over the same pending set — relaxation
    levels, consolidation simulations, successive rounds — skip the key
    build entirely. Empty constraint fields short-circuit to (): at 50k
    pods the per-pod cost is what bounds tensorize latency."""
    d = pod.__dict__
    k = d.get("_ckey")
    if k is not None:
        return k
    req = d["requests"]
    ns = d["node_selector"]
    rat = d["required_affinity_terms"]
    pat = d["preferred_affinity_terms"]
    vz = d["volume_zones"]
    tol = d["tolerations"]
    ts = d["topology_spread"]
    pa = d["pod_affinities"]
    lab = d["labels"]
    k = (
        tuple(sorted([i for i in req.items() if i[1]])) if req else (),
        tuple(sorted(ns.items())) if ns else (),
        tuple([repr(t) for t in rat]) if rat else (),
        tuple([(w, repr(t)) for w, t in pat]) if pat else (),
        tuple(sorted(vz)) if vz else (),
        tuple(sorted([(t.key, t.operator, t.value, t.effect)
                      for t in tol])) if tol else (),
        tuple([(c.topology_key, c.max_skew, c.when_unsatisfiable,
                tuple(sorted(c.label_selector.items())))
               for c in ts]) if ts else (),
        tuple([(a.topology_key, a.anti, a.required,
                tuple(sorted(a.label_selector.items())))
               for a in pa]) if pa else (),
        tuple(sorted(lab.items())) if lab else (),
        d["namespace"],
        # gang members must never merge into non-gang classes (and gangs
        # must not merge with each other): the gang spec is part of the
        # scheduling-relevant identity.  Non-gang pods keep () so every
        # pre-gang key is unchanged in content.
        ((d["gang_name"], d["gang_size"], d["gang_tier"],
          d["gang_topology"]) if d["gang_name"] else ()),
    )
    d["_ckey"] = k
    return k


# class keys interned to small ints so the 50k-pod grouping loop can run in
# numpy (np.unique over an int vector) instead of 50k Python dict round
# trips.  Pod labels are part of the key, so distinct keys are unbounded in
# a long-lived controller (per-pod-unique label values churn daily): the
# table resets when it exceeds _CLASS_IDS_MAX, and a generation token on
# the per-pod cache invalidates stale ids.  Resets happen ONLY between
# tensorize calls (see tensorize) — a mid-call reset would let two distinct
# keys share an id and silently merge classes.
_CLASS_IDS: Dict[tuple, int] = {}
_CLASS_GEN = [0]
_CLASS_IDS_MAX = 1 << 17


def _class_id(pod: Pod) -> int:
    d = pod.__dict__
    tok = d.get("_cid")
    if tok is not None and tok[0] == _CLASS_GEN[0]:
        return tok[1]
    k = _class_key(pod)
    cid = _CLASS_IDS.get(k)
    if cid is None:
        cid = _CLASS_IDS[k] = len(_CLASS_IDS)
    d["_cid"] = (_CLASS_GEN[0], cid)
    return cid


_CAP_BIG = 2**30


def _node_cap(pod: Pod) -> int:
    """Max pods of this class one node may hold — the kernel-enforced
    lowering of hostname-granular constraints (ops/constraints.py docstring):
    hostname topology spread -> max_skew; required self anti-affinity over
    hostname -> 1."""
    cap = _CAP_BIG
    for c in pod.topology_spread:
        if c.topology_key == wk.HOSTNAME:
            cap = min(cap, max(1, int(c.max_skew)))
    for a in pod.pod_affinities:
        if (a.anti and a.required and a.topology_key == wk.HOSTNAME
                and all(pod.labels.get(k) == v
                        for k, v in a.label_selector.items())):
            cap = 1
    return cap


def build_options(catalog: Sequence[InstanceType],
                  nodepools: Sequence[NodePool]) -> List[LaunchOption]:
    """Flatten (nodepool × type × zone × capacity-type) available offerings,
    dropping options the nodepool's own requirements exclude.  Higher-weight
    NodePools rank first (weight precedence, reference NodePool.spec.weight)."""
    ranks = {w: i for i, w in
             enumerate(sorted({p.weight for p in nodepools}, reverse=True))}
    out: List[LaunchOption] = []
    for pi, pool in enumerate(nodepools):
        pool_reqs = pool.requirements()
        for ti, it in enumerate(catalog):
            # keys the type doesn't define (nodepool, template labels) are
            # provided by the pool itself at node creation — only type-defined
            # keys can conflict (AllowUndefinedWellKnownLabels semantics)
            allow = [k for k in pool_reqs if k not in it.requirements]
            if not pool_reqs.compatible(it.requirements, allow_undefined=allow):
                continue
            zone_req = pool_reqs.get(wk.ZONE)
            cap_req = pool_reqs.get(wk.CAPACITY_TYPE)
            for o in it.offerings:
                if not o.available:
                    continue
                if zone_req is not None and not zone_req.has(o.zone):
                    continue
                if cap_req is not None and not cap_req.has(o.capacity_type):
                    continue
                out.append(LaunchOption(pool.name, it.name, o.zone,
                                        o.capacity_type, o.price, ti, pi,
                                        weight_rank=ranks[pool.weight]))
    # pool precedence first, then deterministic price ordering with name
    # tie-break (karpenter:pkg/providers/instance/instance.go:395-412)
    out.sort(key=lambda lo: (lo.weight_rank, lo.price, lo.instance_type,
                             lo.zone, lo.capacity_type, lo.pool))
    return out


class _CatalogSide:
    """Everything tensorize derives from (catalog × nodepools) alone, cached
    across solves (option labels are encoded as tables once per catalog
    seq; the catalog changes only on ICE/pricing seq bumps).

    The compat decomposition: an option's label surface is its (type × pool)
    *group* surface — type requirements ∪ pool labels ∪ the nodepool pin —
    plus two per-option pins (zone, capacity-type). Pod requirement branches
    are therefore evaluated once per GROUP with the zone/captype keys
    stripped, and the stripped keys are applied as integer-table lookups
    over all O options at once. Exact because build_options only emits
    offerings whose zone/captype survive the pool's own constraints, so the
    per-option effective zone/captype sets are the singletons {o.zone} /
    {o.capacity_type}."""

    __slots__ = ("scales", "catalog", "nodepools", "options", "option_alloc",
                 "option_price", "option_zone", "option_captype",
                 "option_rank", "option_pool", "option_group", "zones",
                 "captypes", "groups", "pool_taints", "rest_mask_memo",
                 "compat_memo", "axes")

    def __init__(self, catalog: Sequence[InstanceType],
                 nodepools: Sequence[NodePool], axes: Tuple[str, ...],
                 scales: Optional[Mapping[str, float]] = None,
                 node_classes: Optional[Mapping[str, object]] = None):
        # strong refs keep the fingerprint's id()s stable for the cache's life
        self.catalog = list(catalog)
        self.nodepools = list(nodepools)
        self.axes = axes
        self.scales = DEFAULT_SCALES if scales is None else scales
        node_classes = node_classes or {}
        options = build_options(catalog, nodepools)
        self.options = options
        O, R = len(options), len(axes)
        self.option_alloc = np.zeros((O, R), np.float32)
        self.option_price = np.zeros(O, np.float32)
        self.zones = sorted({o.zone for o in options})
        zone_ids = {z: i for i, z in enumerate(self.zones)}
        self.captypes = sorted({o.capacity_type for o in options})
        cap_ids = {c: i for i, c in enumerate(self.captypes)}
        self.option_zone = np.zeros(O, np.int32)
        self.option_captype = np.zeros(O, np.int32)
        self.option_rank = np.zeros(O, np.int32)
        self.option_pool = np.zeros(O, np.int32)
        self.option_group = np.zeros(O, np.int32)
        self.pool_taints = [p.template.taints for p in nodepools]
        group_ids: Dict[tuple, int] = {}
        self.groups: List[Requirements] = []
        # per-(type, pool-kubelet) allocatable: a NodePool's kubelet config
        # (maxPods, podsPerCore, reserved/eviction overrides) reshapes pod
        # density and overhead for ITS options only — the reference rebuilds
        # its InstanceType list per kubelet hash
        # (karpenter:pkg/providers/instancetype/instancetype.go:114-124)
        from ..catalog.instancetype import (apply_kubelet, apply_storage,
                                            root_volume_gib)
        kubelet_keys = [p.template.kubelet.key() for p in nodepools]
        ncs = node_classes or {}
        storage_gib = [root_volume_gib(ncs.get(p.template.node_class_ref))
                       for p in nodepools]
        alloc_by_type: Dict[tuple, list] = {}
        for j, opt in enumerate(options):
            it = catalog[opt.type_index]
            kk = kubelet_keys[opt.pool_index]
            sg = storage_gib[opt.pool_index]
            vec = alloc_by_type.get((opt.type_index, kk, sg))
            if vec is None:
                eff = apply_storage(it, sg)
                if kk is not None:
                    eff = apply_kubelet(
                        eff, nodepools[opt.pool_index].template.kubelet)
                vec = alloc_by_type[(opt.type_index, kk, sg)] = \
                    eff.allocatable.to_vector(axes, self.scales)
            self.option_alloc[j] = vec
            self.option_price[j] = opt.price
            self.option_zone[j] = zone_ids[opt.zone]
            self.option_captype[j] = cap_ids[opt.capacity_type]
            self.option_rank[j] = opt.weight_rank
            self.option_pool[j] = opt.pool_index
            gk = (opt.type_index, opt.pool_index)
            gi = group_ids.get(gk)
            if gi is None:
                gi = group_ids[gk] = len(self.groups)
                pool = nodepools[opt.pool_index]
                reqs = Requirements(it.requirements)
                reqs = reqs.union(Requirements.of(
                    Requirement(wk.NODEPOOL, IN, [opt.pool])))
                reqs = reqs.union(Requirements.from_labels(pool.template.labels))
                reqs.pop(wk.ZONE, None)          # vectorized per option
                reqs.pop(wk.CAPACITY_TYPE, None)
                self.groups.append(reqs)
            self.option_group[j] = gi
        # per-(branch-rest signature) group masks / per-(full constraint
        # signature) compat rows, shared by every batch against this catalog
        self.rest_mask_memo: Dict[tuple, np.ndarray] = {}
        self.compat_memo: Dict[tuple, np.ndarray] = {}

    # -- vectorized pod-constraint → option-mask lowering -----------------
    def compat_row(self, rep: Pod) -> np.ndarray:
        branches = rep.scheduling_requirements()
        sig = (tuple(tuple(sorted((k, repr(r)) for k, r in b.items()))
                     for b in branches),
               tuple(sorted((t.key, t.operator, t.value, t.effect)
                            for t in rep.tolerations)))
        row = self.compat_memo.get(sig)
        if row is not None:
            return row
        O = len(self.options)
        row = np.zeros(O, bool)
        for bi, branch in enumerate(branches):
            zone_req = branch.get(wk.ZONE)
            cap_req = branch.get(wk.CAPACITY_TYPE)
            rest_sig = sig[0][bi]
            gmask = self.rest_mask_memo.get(rest_sig)
            if gmask is None:
                rest = Requirements({k: r for k, r in branch.items()
                                     if k not in (wk.ZONE, wk.CAPACITY_TYPE)})
                # Fail closed on keys the group can't provide: a pod
                # requiring a user label schedules only if some NodePool
                # template carries it (reference scheduling.md label rules);
                # complemented ops (NotIn/DoesNotExist) tolerate absence via
                # Requirements.compatible.
                gmask = np.fromiter(
                    (rest.compatible(g) for g in self.groups),
                    bool, count=len(self.groups))
                self.rest_mask_memo[rest_sig] = gmask
            bmask = gmask[self.option_group]
            if zone_req is not None:
                zvec = np.fromiter((zone_req.has(z) for z in self.zones),
                                   bool, count=len(self.zones))
                bmask = bmask & zvec[self.option_zone]
            if cap_req is not None:
                cvec = np.fromiter((cap_req.has(c) for c in self.captypes),
                                   bool, count=len(self.captypes))
                bmask = bmask & cvec[self.option_captype]
            row |= bmask
        if rep.tolerations or any(self.pool_taints):
            tvec = np.fromiter(
                (tolerates_all(rep.tolerations, ts) for ts in self.pool_taints),
                bool, count=len(self.pool_taints))
            row = row & tvec[self.option_pool]
        self.compat_memo[sig] = row
        return row


# LRU of catalog sides. Keyed on instance-type identity PLUS the mutable
# content the tensorizer consumes (offering price/availability, allocatable
# resources, requirements, pool spec), so in-place mutations — ICE masking
# in tests, capacity/requirement edits, pool edits — can't serve stale
# tensors. The content hashes cost ~µs/type; repeated-solve hits come from
# upper layers memoizing their catalog lists.
_CATSIDE_CACHE: Dict[tuple, _CatalogSide] = {}
_CATSIDE_MAX = 8
import threading as _threading
_CATSIDE_LOCK = _threading.Lock()


def _catside_fingerprint(catalog: Sequence[InstanceType],
                         nodepools: Sequence[NodePool],
                         axes: Tuple[str, ...],
                         scales: Optional[Mapping[str, float]] = None,
                         node_classes: Optional[Mapping[str, object]] = None) -> tuple:
    # requirements are keyed by an int hash over EVERY Requirement field
    # (not Requirement.__hash__, which omits min_values) — full content
    # tuples would triple the cost of this hot-path fingerprint, and a
    # spurious miss from dict-order variation only costs a rebuild
    cat_sig = tuple((id(it),
                     tuple((o.zone, o.capacity_type, o.price, o.available)
                           for o in it.offerings),
                     tuple(sorted(it.allocatable.items())),
                     hash(tuple((k, r.complement, tuple(r.values),
                                 r.greater_than, r.less_than, r.min_values)
                                for k, r in it.requirements.items())))
                    for it in catalog)
    pool_sig = tuple(
        (p.name, p.weight,
         tuple(sorted(p.template.labels.items())),
         tuple(repr(t) for t in p.template.taints),
         tuple(sorted((k, repr(r)) for k, r in p.template.requirements.items())),
         p.template.kubelet.key())
        for p in nodepools)
    scale_sig = (None if scales is None else
                 tuple(sorted((k, float(v)) for k, v in scales.items())))
    # only the nodeclass content the columns consume: per-pool root volume
    from ..catalog.instancetype import root_volume_gib
    ncs = node_classes or {}
    storage_sig = tuple(root_volume_gib(ncs.get(p.template.node_class_ref))
                        for p in nodepools)
    return (cat_sig, pool_sig, axes, scale_sig, storage_sig)


def catalog_side(catalog: Sequence[InstanceType],
                 nodepools: Sequence[NodePool],
                 axes: Tuple[str, ...] = DEFAULT_AXES,
                 scales: Optional[Mapping[str, float]] = None,
                 node_classes: Optional[Mapping[str, object]] = None) -> _CatalogSide:
    key = _catside_fingerprint(catalog, nodepools, axes, scales, node_classes)
    side = _CATSIDE_CACHE.get(key)
    if side is None:
        side = _CatalogSide(catalog, nodepools, axes, scales, node_classes)
    with _CATSIDE_LOCK:
        # atomic size-capped LRU re-insert (concurrent misses would
        # otherwise overshoot the cap)
        _CATSIDE_CACHE.pop(key, None)
        while len(_CATSIDE_CACHE) >= _CATSIDE_MAX:
            _CATSIDE_CACHE.pop(next(iter(_CATSIDE_CACHE)), None)
        _CATSIDE_CACHE[key] = side
    return side


def tensorize(pods: Sequence[Pod], catalog: Sequence[InstanceType],
              nodepools: Sequence[NodePool],
              axes: Tuple[str, ...] = DEFAULT_AXES,
              node_classes: Optional[Mapping[str, object]] = None) -> Problem:
    """Lower a scheduling round to dense arrays."""
    # pod equivalence classes, grouped in numpy over interned class ids —
    # one attribute read per pod instead of a dict-build round trip; class
    # order stays first-appearance (the old dict semantics) so tie-breaks
    # and decode order are unchanged
    n = len(pods)
    if len(_CLASS_IDS) >= _CLASS_IDS_MAX:   # bound the intern table; never
        _CLASS_IDS.clear()                  # resets mid-call (id collisions
        _CLASS_GEN[0] += 1                  # would merge distinct classes)
    if n:
        ids = np.fromiter((_class_id(p) for p in pods), np.int64, count=n)
        uniq, first, inverse = np.unique(ids, return_index=True,
                                         return_inverse=True)
        appear = np.argsort(first, kind="stable")
        rank = np.empty(len(uniq), np.int64)
        rank[appear] = np.arange(len(uniq))
        ci_of_pod = rank[inverse]
        reps = [pods[first[o]] for o in appear]
        by_class = np.argsort(ci_of_pod, kind="stable")
        counts = np.bincount(ci_of_pod, minlength=len(uniq))
        members = np.split(by_class, np.cumsum(counts)[:-1])
    else:  # np.split of an empty vector would yield ONE empty group
        reps, members = [], []
        counts = np.zeros(0, np.int64)

    # requested resources outside the configured axes become extra axes, so
    # the packer accounts for them exactly instead of silently ignoring
    # them (the reference compares EVERY requested resource,
    # karpenter:pkg/cloudprovider/cloudprovider.go:264 resources.Fits
    # — a pod asking for example.com/fpga must land only on types
    # advertising it, or go unschedulable). Scanning class reps, not pods:
    # identical requests are part of the class key.
    extra = sorted({k for rep in reps for k, v in rep.requests.items()
                    if v and k not in axes})
    scales = DEFAULT_SCALES
    if extra:
        axes = tuple(axes) + tuple(extra)
        # extra axes with byte-sized magnitudes must scale down or they
        # overflow the kernels' int32 lowering (2^31 ≈ 2GiB): hugepages-*
        # are bytes by the k8s spec and get the MEMORY convention (MiB);
        # anything else scales by the SMALLEST power of two that brings its
        # max observed quantity under 2^30 — count-valued resources with
        # large node capacity keep (most of) their granularity instead of
        # being flattened 2^20x (request ceil(1/2^20)=1 would collapse a
        # node's capacity to alloc/2^20 and over-provision wildly)
        scales = dict(DEFAULT_SCALES)
        for k in extra:
            if k.startswith("hugepages-"):
                scales[k] = float(2**20)
                continue
            big = max((float(rep.requests.get(k, 0)) for rep in reps),
                      default=0.0)
            big = max(big, max((float(it.allocatable.get(k, 0))
                                for it in catalog), default=0.0))
            if big >= 2.0**30:
                scales[k] = 2.0 ** math.ceil(math.log2(big) - 30)

    side = catalog_side(catalog, nodepools, axes, scales, node_classes)
    O, R = len(side.options), len(axes)

    C = len(reps)
    class_requests = np.zeros((C, R), np.float32)
    class_compat = np.zeros((C, O), bool)
    for ci, rep in enumerate(reps):
        req = ResourceList(rep.requests)
        req[PODS] = req.get(PODS, 0) + 1  # every pod consumes one pod slot
        class_requests[ci] = req.to_vector(axes, scales, round_up=True)
        class_compat[ci] = side.compat_row(rep)

    # gang columns: class → gang index in first-appearance order (the same
    # deterministic order classes themselves use).  The gang spec rides on
    # the class key, so one gang's heterogeneous members land in distinct
    # classes that all point at one GangInfo row.
    class_gang = None
    gangs: List[GangInfo] = []
    if any(rep.gang_name for rep in reps):
        class_gang = np.full(C, -1, np.int32)
        gang_of: Dict[str, int] = {}
        for ci, rep in enumerate(reps):
            if not rep.gang_name:
                continue
            gi = gang_of.get(rep.gang_name)
            if gi is None:
                gi = gang_of[rep.gang_name] = len(gangs)
                gangs.append(GangInfo(name=rep.gang_name,
                                      size=int(rep.gang_size),
                                      tier=int(rep.gang_tier),
                                      topology=rep.gang_topology or "zone"))
            class_gang[ci] = gi

    return Problem(
        axes=axes,
        class_requests=class_requests,
        class_counts=counts.astype(np.int32),
        class_compat=class_compat,
        class_members=members,
        class_node_cap=np.asarray([_node_cap(rep) for rep in reps], np.int32),
        options=side.options,
        option_alloc=side.option_alloc,
        option_price=side.option_price,
        option_rank=side.option_rank,
        option_zone=side.option_zone,
        option_captype=side.option_captype,
        zones=side.zones,
        pods=list(pods),
        scales=scales,
        class_gang=class_gang,
        gangs=gangs,
    )


def arena_fingerprint(candidates: Sequence, nodes: Sequence[Node],
                      catalog_key: tuple) -> tuple:
    """Cluster-state fingerprint for `SimulationArena` reuse: everything the
    arena's tensors consume — candidate identity/order/price/pod multisets,
    every live node's column inputs (allocatable, labels, taints, zone,
    bound pods), and the catalog side's content key.  Pod identity is
    (id, name): pod specs are immutable once admitted (see `_class_key`'s
    cache), so object identity covers spec content, and the cluster holds
    strong refs for the pods' cluster lifetime so ids can't be recycled
    while they still matter.  PDBs are deliberately NOT part of the key:
    evictability is recomputed on the host every tick, never baked into
    the arena's arrays."""
    node_sig = tuple(
        (n.name, n.zone, float(n.price), n.marked_for_deletion,
         tuple(sorted(n.allocatable.items())),
         tuple(sorted(n.labels.items())),
         tuple(repr(t) for t in n.taints),
         tuple((id(p), p.name) for p in n.pods))
        for n in nodes)
    cand_sig = tuple((c.name, float(c.price),
                      tuple((id(p), p.name) for p in c.reschedulable))
                     for c in candidates)
    return (cand_sig, node_sig, catalog_key)


@dataclass
class _ArenaSide:
    """One tensorized face of the arena: the lowered+tensorized problem over
    the union of all candidate pods, every live node as a pre-opened column,
    and the per-candidate bookkeeping the sweeps mask with."""
    problem: Problem
    node_list: List[Node]
    alloc: np.ndarray           # E×R float32
    used: np.ndarray            # E×R float32
    compat: np.ndarray          # C×E bool
    cand_counts: np.ndarray     # N×C int32 — candidate i's pod class counts
    cand_cols: np.ndarray       # N int64 — candidate i's column index (-1: none)


class SimulationArena:
    """One tensorization of the cluster serving a WHOLE consolidation sweep.

    The sequential path re-runs `lower_pods` + `tensorize` +
    `tensorize_nodes` per probe (log₂N prefix probes + up to 2N single-node
    screens per tick).  The arena does that lowering ONCE over the union of
    all candidate pods and ALL live nodes, then expresses each probe as
    pure masking: a per-probe class-count vector (which candidates' pods to
    reschedule), a per-probe existing-column mask (which candidate nodes
    are gone), and a per-probe price cap (the strictly-cheaper replacement
    rule) — exactly the batch axes `solve_classpack_sweep` consumes, so a
    whole prefix family or single-node screen is 1-2 device calls of the
    K5 sweep kernel.

    Two faces, matching the sequential simulate's two catalog shapes:
    `delete` (empty catalog — pods must fit on survivors alone) and
    `replace` (full catalog, price-masked per candidate).  Both are built
    lazily: a tick that finds a multi-node delete never pays for the
    replace face.

    Exactness: delete-face verdicts match the sequential per-probe oracle
    bit-for-bit on topology-free pods — same class arrays (zero-count
    classes are exact scan no-ops), same survivor columns (sequential
    probes keep non-probed candidates as survivors, so columns cover ALL
    live nodes and probes mask their own), same FFD order (catalog-free
    norm).  Two documented approximations remain: (1) constraint lowering
    runs once with every candidate excluded, where the sequential path
    excludes only the probed subset — spread/affinity rewrites can differ;
    (2) the replace face FFD-orders classes under the FULL catalog's norm
    while the sequential screen tensorizes a price-filtered catalog.  Both
    are safe by construction: the sweep only *screens*, and every chosen
    action is re-validated by the sequential fully-decoded `simulate`
    (decode-audit included) before execution.

    `device` is where the sweeps solve ("cuda" by default; "cpu" runs the
    kernels' plain versions).  The cluster is read through its node and
    pod dicts and `tensorize_nodes`; without a ClusterArena that is the
    reference's own bit-identical fallback path."""

    def __init__(self, candidates: Sequence, cluster, catalog,
                 nodepools: Sequence[NodePool], node_classes=None,
                 device="cuda"):
        from .classpack import resolve_device
        self.device = resolve_device(device)
        self.candidates = list(candidates)
        self._cluster = cluster
        self._catalog = list(catalog)
        self._nodepools = list(nodepools)
        self._node_classes = node_classes
        self._names = [c.name for c in self.candidates]
        self.prices = np.asarray([c.price for c in self.candidates],
                                 np.float32)
        pods = []
        self._slices: List[Tuple[int, int]] = []
        for c in self.candidates:
            s = len(pods)
            pods.extend(c.reschedulable)
            self._slices.append((s, len(pods)))
        self._pods = pods
        self._delete: Optional[_ArenaSide] = None
        self._replace: Optional[_ArenaSide] = None
        # staleness guard (the lazy-face hazard): faces tensorized from an
        # earlier cluster state must never serve a sweep after ANY cluster
        # mutation — a bind between sweeps changes used rows, a taint edit
        # changes compat.  The cluster's mutation_epoch is bumped by every
        # mutator, so comparing it is an O(1) validity check.
        self._built_epoch = getattr(cluster, "mutation_epoch", None)

    def _check_stale(self):
        epoch = getattr(self._cluster, "mutation_epoch", None)
        if epoch != self._built_epoch:
            self._delete = None
            self._replace = None
            self._built_epoch = epoch

    # ---- face construction ------------------------------------------------
    def _build_side(self, catalog) -> _ArenaSide:
        from .constraints import (LEVEL_REQUIRED_ONLY, lower_pods,
                                  make_zone_feasibility)
        nodes = list(self._cluster.nodes.values())
        excl = self._names
        excl_set = set(excl)
        zones = sorted({o.zone for it in catalog for o in it.offerings
                        if o.available}
                       | {n.zone for n in nodes
                          if n.name not in excl_set and n.zone})
        lowered = lower_pods(self._pods, nodes=nodes, option_zones=zones,
                             exclude_nodes=excl, level=LEVEL_REQUIRED_ONLY,
                             zone_feasible=make_zone_feasibility(
                                 catalog, nodes, exclude_nodes=excl))
        problem = tensorize(lowered, catalog, self._nodepools,
                            node_classes=self._node_classes)
        # ALL live nodes as columns — each probe masks its own subset, the
        # rest act as survivors exactly as in the sequential per-probe
        # tensorize_nodes(exclude=subset)
        node_list, alloc, used, compat = self._cluster.tensorize_nodes(
            problem.class_reps, problem.axes, exclude=(),
            scales=problem.scales)
        col_of = {n.name: i for i, n in enumerate(node_list)}
        C = problem.num_classes
        cid = np.zeros(len(lowered), np.int64)
        for ci, m in enumerate(problem.class_members):
            cid[np.asarray(m, np.int64)] = ci
        counts = np.zeros((len(self.candidates), C), np.int32)
        for i, (s, e) in enumerate(self._slices):
            if e > s:
                counts[i] = np.bincount(cid[s:e], minlength=C)
        cols = np.asarray([col_of.get(name, -1) for name in self._names],
                          np.int64)
        return _ArenaSide(problem, node_list, alloc, used, compat,
                          counts, cols)

    @property
    def delete_side(self) -> _ArenaSide:
        self._check_stale()
        if self._delete is None:
            self._delete = self._build_side([])
        return self._delete

    @property
    def replace_side(self) -> _ArenaSide:
        self._check_stale()
        if self._replace is None:
            self._replace = self._build_side(self._catalog)
        return self._replace

    # ---- the two sweeps ---------------------------------------------------
    def _sweep(self, side: _ArenaSide, counts_b: np.ndarray,
               mask: Optional[np.ndarray], caps: Optional[np.ndarray],
               max_nodes: int = 8192):
        from .classpack import solve_classpack_sweep
        return solve_classpack_sweep(
            side.problem, counts_b, device=self.device,
            **self.sweep_inputs(side, mask, caps, max_nodes))

    @staticmethod
    def sweep_inputs(side: _ArenaSide, mask: Optional[np.ndarray],
                     caps: Optional[np.ndarray], max_nodes: int = 8192):
        """The keyword arguments `solve_classpack_sweep` (and
        `lower_sweep`) take for a probe family on `side`, besides the
        problem and the counts."""
        E = len(side.node_list)
        return dict(existing_alloc=side.alloc if E else None,
                    existing_used=side.used if E else None,
                    existing_compat=side.compat if E else None,
                    exist_mask_b=mask if E else None,
                    price_cap_b=caps, max_nodes=max_nodes)

    def sweep_prefixes(self):
        """All N candidate prefixes as one batched delete probe: row k-1
        answers `simulate(cands[:k], allow_new=False, decode=False)` —
        feasible ⇔ unschedulable == 0 and new_nodes == 0."""
        return self.sweep_prefix_subset(range(1, len(self.candidates) + 1))

    def sweep_prefix_subset(self, ks):
        """Delete probes for the given prefix lengths only (1-based): row r
        answers `simulate(cands[:ks[r]], allow_new=False, decode=False)`.
        The consolidation search asks this for the mids its binary search
        can actually reach (~log₂N prefixes per round) instead of all N."""
        return self._sweep(*self.prefix_probes(ks))

    def prefix_probes(self, ks):
        """(face, counts_b, exist_mask_b, price_cap_b, max_nodes) of the
        delete probes for prefix lengths `ks`."""
        side = self.delete_side
        ks = [int(k) for k in ks]
        C = side.problem.num_classes
        if ks:
            cum = np.cumsum(side.cand_counts, axis=0, dtype=np.int32)
            counts_b = np.stack([cum[k - 1] for k in ks])
        else:
            counts_b = np.zeros((0, C), np.int32)
        E = len(side.node_list)
        mask = np.ones((len(ks), E), bool)
        for r, k in enumerate(ks):
            for j in side.cand_cols[:k]:
                if j >= 0:
                    mask[r, j] = False      # prefix k loses its candidates
        # the delete face has NO launch options — no slot beyond the E
        # pre-opened columns can ever open, so the slot array stops at the
        # E bucket instead of the pods+nodes bucket
        return (side, counts_b, mask, None,
                pad_to(E + 1, (256, 512, 1024, 2048, 4096, 8192)))

    def sweep_singles(self):
        """All N single-candidate replacement screens in one batched call:
        row i answers `simulate([c_i], allow_new=True,
        max_total_price=c_i.price, decode=False)` with the price cap
        applied as an option mask instead of a catalog rebuild."""
        return self._sweep(*self.singles_probes())

    def singles_probes(self):
        """(face, counts_b, exist_mask_b, price_cap_b, max_nodes) of the
        single-candidate replacement screens."""
        side = self.replace_side
        N = len(self.candidates)
        E = len(side.node_list)
        mask = np.ones((N, E), bool)
        for i, j in enumerate(side.cand_cols):
            if j >= 0:
                mask[i, j] = False
        return side, side.cand_counts, mask, self.prices, 8192


def pad_to(n: int, buckets: Sequence[int] = (256, 1024, 4096, 16384, 32768,
                                             53248, 65536)) -> int:
    """Bucketed padding, the reference's buckets exactly: the padded shapes
    decide the kernels' launch shapes and the decode's result size (one
    int16 per padded pod row), and parity with the reference needs the
    same Cpad/Opad/K/Ppad."""
    for b in buckets:
        if n <= b:
            return b
    return int(2 ** math.ceil(math.log2(max(n, 1))))
