"""Carry a solve's inputs across from the JAX package: build the port's
`Problem`, existing-node state and `Cluster` from plain values.

The reference's objects (or any objects or dicts with the same field names)
are read as numpy arrays, plain values and attributes only — never as
JAX-package types — so the port and the reference can be held against each
other on exactly the same inputs:

    prob_t = problem_from_arrays(ref_problem)
    ea, eu, ec = slot_state_from_arrays(dict(alloc=..., used=..., compat=...))
    cluster_t = cluster_from_objects(ref_cluster)
    cluster_t = cluster_from_arrays(nodes, pods, bound, claims)
    catalog_t = catalog_from_objects(ref_provider.get_instance_types())
    lp_caches_from_arrays(ref_lpguide.snapshot_caches(),
                          ref_lpsolve.snapshot_caches())
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from .api.objects import (Node, NodeClaim, Pod, PodAffinityTerm,
                          PodDisruptionBudget, TopologySpreadConstraint)
from .api.requirements import Requirement, Requirements
from .api.resources import DEFAULT_SCALES, ResourceList
from .api.taints import Taint, Toleration
from .catalog.instancetype import InstanceType, InstanceTypeInfo, Offering
from .ops.tensorize import GangInfo, LaunchOption, Problem
from .state.cluster import Cluster


def _get(src: Any, name: str, default=None):
    if isinstance(src, Mapping):
        return src.get(name, default)
    return getattr(src, name, default)


def _arr(src: Any, name: str, dtype) -> Optional[np.ndarray]:
    v = _get(src, name)
    return None if v is None else np.array(v, dtype=dtype, copy=True)


def _option(o) -> LaunchOption:
    """A LaunchOption from a tuple in field order, a mapping, or any object
    with the same attribute names."""
    if isinstance(o, (tuple, list)):
        return LaunchOption(*o)
    names = ("pool", "instance_type", "zone", "capacity_type", "price",
             "type_index", "pool_index", "weight_rank")
    return LaunchOption(**{n: _get(o, n) for n in names})


def problem_from_arrays(src: Any) -> Problem:
    """The port's Problem from `src`'s fields: axes, scales,
    class_requests/counts/compat/node_cap/members, option_alloc/price/
    rank/zone/captype, zones, options (tuples in LaunchOption field order,
    or objects with those attributes), and optionally class_gang/gangs.
    Arrays are copied with the reference's dtypes."""
    options = [_option(o) for o in _get(src, "options")]
    gangs = [GangInfo(*g) if isinstance(g, (tuple, list)) else
             GangInfo(name=_get(g, "name"), size=_get(g, "size"),
                      tier=_get(g, "tier"), topology=_get(g, "topology"))
             for g in (_get(src, "gangs") or [])]
    return Problem(
        axes=tuple(_get(src, "axes")),
        class_requests=_arr(src, "class_requests", np.float32),
        class_counts=_arr(src, "class_counts", np.int32),
        class_compat=_arr(src, "class_compat", bool),
        class_members=[np.array(m, dtype=np.int64, copy=True)
                       for m in _get(src, "class_members")],
        options=options,
        option_alloc=_arr(src, "option_alloc", np.float32),
        option_price=_arr(src, "option_price", np.float32),
        option_rank=_arr(src, "option_rank", np.int32),
        class_node_cap=_arr(src, "class_node_cap", np.int32),
        option_zone=_arr(src, "option_zone", np.int32),
        option_captype=_arr(src, "option_captype", np.int32),
        zones=list(_get(src, "zones") or []),
        class_gang=_arr(src, "class_gang", np.int32),
        gangs=gangs,
        scales=dict(_get(src, "scales") or DEFAULT_SCALES),
    )


def slot_state_from_arrays(src: Any) -> Tuple[np.ndarray, np.ndarray,
                                               Optional[np.ndarray]]:
    """(existing_alloc E×R f32, existing_used E×R f32, existing_compat C×E
    bool or None) from `src`'s `alloc`, `used` and `compat` — the
    existing-node columns `solve_classpack` takes."""
    alloc = _arr(src, "alloc", np.float32)
    used = _arr(src, "used", np.float32)
    if used is None:
        used = np.zeros_like(alloc)
    return alloc, used, _arr(src, "compat", bool)


# ---------------------------------------------------------------------------
# cluster state
# ---------------------------------------------------------------------------

def _requirements(src) -> Requirements:
    """Requirements from a key → requirement mapping whose values carry
    key / complement / values / greater_than / less_than / min_values."""
    return Requirements({k: Requirement.raw(
        _get(r, "key"), _get(r, "complement"), set(_get(r, "values")),
        _get(r, "greater_than"), _get(r, "less_than"),
        _get(r, "min_values")) for k, r in src.items()})


def _node(src, pods) -> Node:
    node = _plain(
        Node, src, labels=dict, taints=lambda ts: [_plain(Taint, t)
                                                   for t in ts],
        allocatable=ResourceList, capacity=ResourceList,
        pods=lambda ps: [])
    node.pods = list(pods)
    return node


def _claim(src) -> NodeClaim:
    return _plain(
        NodeClaim, src, requirements=_requirements, requests=ResourceList,
        taints=lambda ts: [_plain(Taint, t) for t in ts], labels=dict)


def _plain(cls, src, **conv):
    """A `cls` dataclass from `src`'s same-named attributes (or keys, for a
    mapping); `conv` maps a field name to a converter for nested values.
    Underscored fields and fields `src` lacks keep their defaults."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name.startswith("_"):
            continue
        if isinstance(src, Mapping):
            if f.name not in src:
                continue
            v = src[f.name]
        elif hasattr(src, f.name):
            v = getattr(src, f.name)
        else:
            continue
        fn = conv.get(f.name)
        kw[f.name] = fn(v) if fn else v
    return cls(**kw)


def _pod(src) -> Pod:
    """A Pod from an object or a mapping with Pod's field names; nested
    requirements, tolerations and topology terms may be objects or
    mappings too."""
    return _plain(
        Pod, src,
        requests=ResourceList, limits=ResourceList, node_selector=dict,
        required_affinity_terms=lambda ts: [_requirements(t) for t in ts],
        preferred_affinity_terms=lambda ts: [(w, _requirements(t))
                                             for w, t in ts],
        tolerations=lambda ts: [_plain(Toleration, t) for t in ts],
        topology_spread=lambda cs: [_plain(TopologySpreadConstraint, c,
                                           label_selector=dict) for c in cs],
        pod_affinities=lambda ts: [_plain(PodAffinityTerm, a,
                                          label_selector=dict) for a in ts],
        volume_zones=list, labels=dict, annotations=dict)


def cluster_from_objects(src) -> Cluster:
    """The port's `Cluster` holding the same state as `src` (a JAX-package
    Cluster, read by attribute only): every pod (bound or pending), every
    node with its bound pods in order, the node claims, the PDBs and the
    mutation epoch.  Names, uids, labels, taints, prices and timestamps
    carry over unchanged, and a pod bound to a node is ONE object in both
    the pod dict and the node's list, as in the source.  The new cluster's
    clock is `src.clock`."""
    out = Cluster(clock=getattr(src, "clock", None) or (lambda: 0.0))
    pods: Dict[str, Pod] = {}

    def pod(p):
        hit = pods.get(p.uid)
        if hit is None:
            hit = pods[p.uid] = _pod(p)
        return hit

    for uid, p in src.pods.items():
        out.pods[uid] = pod(p)
    for name, n in src.nodes.items():
        out.nodes[name] = _node(n, [pod(p) for p in n.pods])
    for name, c in src.nodeclaims.items():
        out.nodeclaims[name] = _claim(c)
    for name, b in src.pdbs.items():
        out.pdbs[name] = _plain(PodDisruptionBudget, b, selector=dict)
    out.mutation_epoch = int(getattr(src, "mutation_epoch", 0))
    return out


def cluster_from_arrays(nodes: Sequence, pods: Sequence,
                        bound: Sequence[Sequence[int]],
                        claims: Sequence = (),
                        clock: Optional[Callable[[], float]] = None,
                        mutation_epoch: int = 0) -> Cluster:
    """The port's `Cluster` from a plain description of a live cluster, as
    the JAX side can emit it:

      pods    every pod (pending or bound) in batch order, as objects or
              mappings with Pod's field names;
      nodes   the nodes in launch order, with Node's field names (name,
              allocatable, capacity, labels, taints, zone, instance type,
              nodepool, price, …; a `pods` field is ignored);
      bound   for each node, the batch positions of its pods in bind order;
      claims  the node claims, with NodeClaim's field names.

    Identities are batch positions, never names: every pod, node and claim
    gets a fresh uid or name from the port's own counters (names minted by
    another process would collide with the ones the port gives new
    objects), and a node's hostname label follows its new name.  A pod
    bound to node j is ONE object in the pod dict and in node j's list,
    with node j's name as its `node_name`; a pod bound nowhere is pending,
    in batch order."""
    from .api.labels import HOSTNAME
    from .api.objects import _uid
    from .state.cluster import _names
    out = Cluster(clock=clock or (lambda: 0.0))
    port_pods = []
    for src in pods:
        p = _pod(src)
        uid = _uid("pod")
        if p.name == p.uid:
            p.name = uid
        p.uid, p.node_name = uid, ""
        port_pods.append(p)
    for n, rows in zip(nodes, bound):
        node = _node(n, [port_pods[i] for i in rows])
        old, node.name = node.name, f"node-{next(_names):06d}"
        if node.labels.get(HOSTNAME) == old:
            node.labels[HOSTNAME] = node.name
        for p in node.pods:
            p.node_name = node.name
        out.nodes[node.name] = node
    for p in port_pods:
        out.pods[p.uid] = p
    for c in claims:
        claim = _claim(c)
        claim.name = _uid("nodeclaim")
        out.nodeclaims[claim.name] = claim
    out.mutation_epoch = int(mutation_epoch)
    return out


def catalog_from_objects(src) -> list:
    """The port's instance types from `src`'s (a JAX-package catalog, read
    by attribute only): name, requirements, offerings, capacity, the three
    overhead lists and the catalog row."""
    out = []
    for it in src:
        out.append(InstanceType(
            name=it.name, requirements=_requirements(it.requirements),
            offerings=[_plain(Offering, o) for o in it.offerings],
            capacity=ResourceList(it.capacity),
            kube_reserved=ResourceList(it.kube_reserved),
            system_reserved=ResourceList(it.system_reserved),
            eviction_threshold=ResourceList(it.eviction_threshold),
            info=None if it.info is None else _plain(
                InstanceTypeInfo, it.info, os=tuple)))
    return out


# ---------------------------------------------------------------------------
# LP-guide state
# ---------------------------------------------------------------------------

def _copy_plain(v):
    """A deep copy of plain snapshot data: arrays, scalars, bytes, and
    lists, tuples and dicts of them."""
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, Mapping):
        return {k: _copy_plain(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_copy_plain(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_copy_plain(x) for x in v)
    if isinstance(v, np.generic):
        return v.item()
    return v


def lp_caches_from_arrays(mix_snapshot: Optional[Mapping] = None,
                          warm_snapshot: Optional[Mapping] = None) -> None:
    """Carry the guided solve's state across: `mix_snapshot` is a
    `lpguide.snapshot_caches()` dict (the mix, stale-mix and colgen-support
    caches, keyed by content digests) and `warm_snapshot` a
    `lpsolve.snapshot_caches()` dict (the PDHG warm starts), both of plain
    numpy values, as either package exports them.  They replace the port's
    caches (a None leaves that cache as it is)."""
    from .ops import lpguide, lpsolve
    if mix_snapshot is not None:
        lpguide.restore_caches(_copy_plain(dict(mix_snapshot)))
    if warm_snapshot is not None:
        lpsolve.restore_caches(_copy_plain(dict(warm_snapshot)))
