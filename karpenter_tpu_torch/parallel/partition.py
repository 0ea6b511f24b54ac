"""Compatibility-group partition planner for the fleet-scale sharded solve.

A copy of the JAX package's `parallel/partition.py` (NumPy only): the same
plans, bit for bit, for the port's Problem.

The pod-batch sharding in `sharded.py` splits every class round-robin, so
each shard still scans the FULL class list against the FULL slot budget —
correct, but the per-shard work only shrinks in the counts, not in the
array extents that dominate the scan kernel's cost (C class steps × K slot
columns).  Real fleets have structure the round-robin split ignores: a
pod pinned to zone-a can never share a bin with a zone-b node, so the
bin-packing problem decomposes EXACTLY along zone/nodepool-compatibility
groups ("Priority Matters" pod-packing structure, CvxCluster's
structure-exploiting decomposition).

This planner buckets classes, options, and existing nodes into merged
compatibility groups keyed by the option zone:

  * a class touching exactly one zone group belongs to it;
  * a class touching two groups merges them (union-find) — locally
    flexible pods stay exactly solvable on one shard;
  * a class touching three or more groups (or none) goes to the host
    reconciliation RESIDUAL — re-solved after the mesh pass against the
    leftovers (driver.py).  Keeping promiscuous classes out of the merge
    is what stops one free-floating pod from collapsing the whole fleet
    into a single group.

Merged groups are then balanced onto the mesh with LPT (longest
processing time ≈ pod count), and every option and existing node gets
exactly one owning shard — bins never span shards, which is the property
that makes the per-device sub-problems an exact decomposition rather
than a heuristic.

The planner is deliberately solver-agnostic: it returns a class→shard
map plus ownership masks and balance stats; the driver does the FFD
ordering and array lowering.  `plan_partition` returns None whenever the
structure is not worth exploiting (a single effective group, everything
residual) and the caller falls back to the single-device path — the
ShardedSolve gate must never make a solvable batch unsolvable.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..ops.tensorize import Problem

# below this the kernel launch overhead beats any decomposition win
MIN_PODS_DEFAULT = 512
# a residual this large means the structure we exploit is absent
MAX_RESIDUAL_FRAC_DEFAULT = 0.2


@dataclass
class PartitionPlan:
    """Ownership maps + balance stats for one partitioned solve."""
    n_shards: int
    class_shard: np.ndarray     # C int32: owning shard, -1 == residual
    option_shard: np.ndarray    # O int32: owning shard per option column
    existing_shard: np.ndarray  # E int32: owning shard per existing node
    residual_classes: np.ndarray  # int64 ids of straddling classes
    residual_pods: int
    total_pods: int
    n_groups: int               # effective merged compatibility groups
    imbalance: float            # max shard pods / mean shard pods
    shard_pods: np.ndarray      # n_shards int64 pod load per shard


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            # deterministic: smaller root wins (graftlint DT003 — shard
            # assignment must not depend on iteration accidents)
            if rb < ra:
                ra, rb = rb, ra
            self.parent[rb] = ra


def plan_partition(problem: Problem, n_shards: int,
                   existing_compat: Optional[np.ndarray] = None,
                   existing_zone: Optional[np.ndarray] = None,
                   max_residual_frac: float = MAX_RESIDUAL_FRAC_DEFAULT,
                   min_pods: int = MIN_PODS_DEFAULT
                   ) -> Optional[PartitionPlan]:
    """Bucket the problem into ≤ n_shards compatibility partitions.

    `existing_zone` maps each existing-node column to an index into
    `problem.zones` (-1 = unknown zone; such nodes form their own group
    so any class that can land on them merges with it).  Returns None
    when partitioning is not worthwhile: fewer than two effective groups,
    fewer than two loaded shards, a residual above `max_residual_frac`,
    or a batch below `min_pods`.
    """
    C = problem.num_classes
    O = problem.num_options
    Z = len(problem.zones)
    total_pods = int(problem.class_counts.sum())
    if (n_shards < 2 or C == 0 or O == 0 or Z < 2
            or problem.option_zone is None or total_pods < min_pods):
        return None
    E = 0 if existing_compat is None else existing_compat.shape[1]

    # group universe: one per zone, plus one for unknown-zone existing nodes
    G = Z + 1
    UNKNOWN = Z

    # class → touched-groups incidence, vectorized: one-hot the option
    # zones, then a bool matmul folds the C×O compat into C×G
    zone_1hot = np.zeros((O, G), np.int32)
    zone_1hot[np.arange(O), problem.option_zone] = 1
    touch = (problem.class_compat.astype(np.int32) @ zone_1hot) > 0
    if E:
        ez = (existing_zone if existing_zone is not None
              else np.full(E, -1, np.int64)).astype(np.int64)
        ez = np.where((ez >= 0) & (ez < Z), ez, UNKNOWN)
        ex_1hot = np.zeros((E, G), np.int32)
        ex_1hot[np.arange(E), ez] = 1
        touch |= (existing_compat.astype(np.int32) @ ex_1hot) > 0
    else:
        ez = np.zeros(0, np.int64)

    if problem.class_gang is not None:
        # gang classes share fate (ops/gang.py): OR-fold every member
        # class's touch row so the union-find below lands the whole gang
        # in one root — or the whole gang in the residual — and a gang
        # can never straddle shards.  Sorted gang ids: DT003.
        cg = np.asarray(problem.class_gang)
        for g in sorted(int(x) for x in np.unique(cg[cg >= 0])):
            rows = cg == g
            touch[rows] = touch[rows].any(axis=0)

    ntouch = touch.sum(axis=1)
    residual_mask = (ntouch == 0) | (ntouch > 2)

    # locally-flexible classes (exactly two groups) merge their groups;
    # np.nonzero row order is ascending class id — deterministic
    uf = _UnionFind(G)
    for c in np.nonzero(ntouch == 2)[0]:
        g = np.nonzero(touch[c])[0]
        uf.union(int(g[0]), int(g[1]))
    root = np.fromiter((uf.find(g) for g in range(G)), np.int64, count=G)

    # per-root pod load from non-residual classes (each touches groups of
    # a single root after the merge)
    first_group = touch.argmax(axis=1)
    class_root = np.where(residual_mask, -1, root[first_group])
    load = np.zeros(G, np.int64)
    np.add.at(load, class_root[class_root >= 0],
              problem.class_counts[class_root >= 0].astype(np.int64))

    # effective roots: own at least one option, node, or class
    live = np.zeros(G, bool)
    live[root[np.unique(problem.option_zone)]] = True
    if E:
        live[root[ez]] = True
    live[class_root[class_root >= 0]] = True
    roots = np.nonzero(live)[0]
    if len(roots) < 2:
        return None

    residual_pods = int(problem.class_counts[residual_mask].sum())
    if residual_pods > max_residual_frac * total_pods:
        return None

    # LPT balance: heaviest root first onto the least-loaded shard
    # (ties break on root id / shard id — fully deterministic)
    shard_of_root = np.full(G, -1, np.int64)
    shard_load = np.zeros(n_shards, np.int64)
    for r in sorted(roots, key=lambda r: (-int(load[r]), int(r))):
        s = int(np.argmin(shard_load))
        shard_of_root[r] = s
        shard_load[s] += load[r]
    if int((shard_load > 0).sum()) < 2:
        return None  # one shard would do all the work — no decomposition

    class_shard = np.where(class_root >= 0,
                           shard_of_root[np.maximum(class_root, 0)],
                           -1).astype(np.int32)
    option_shard = shard_of_root[root[problem.option_zone]].astype(np.int32)
    existing_shard = (shard_of_root[root[ez]].astype(np.int32) if E
                      else np.zeros(0, np.int32))

    mean = shard_load.sum() / n_shards
    return PartitionPlan(
        n_shards=n_shards,
        class_shard=class_shard,
        option_shard=option_shard,
        existing_shard=existing_shard,
        residual_classes=np.nonzero(residual_mask)[0].astype(np.int64),
        residual_pods=residual_pods,
        total_pods=total_pods,
        n_groups=len(roots),
        imbalance=float(shard_load.max() / mean) if mean > 0 else 1.0,
        shard_pods=shard_load,
    )
