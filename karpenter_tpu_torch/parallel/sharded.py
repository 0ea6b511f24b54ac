"""Pod-batch sharding of the assignment problem over a mesh of shards.

The port of the JAX package's `parallel/sharded.py`.  The decomposition is
the reference's:

  * **pod-batch ("data") sharding** — each shard packs a disjoint slice of
    every pod class (counts are split across the mesh), a valid bin-packing
    decomposition because bins never span pods from two shards;
  * **capacity accounting by a reduction** — per-option node counts, total
    cost and unscheduled counts are summed over the mesh (K8 `shard_psum`,
    innermost axis first, as the reference's hierarchical `psum`), giving
    the global launch plan;
  * the option axis (catalog) is shared by every shard.

Where the reference runs the shards as `shard_map` copies on the devices of
a `jax.sharding.Mesh`, the port runs them as one launch per kernel with the
shard as a grid axis (ops/classpack_kernels `*_sharded`): `_sharded_pack`
is K1 + K2 + K4 then K8, `_sharded_assign` K1 + K2 + K3, over all n shards
at once on `mesh.device`.  The host lowering and decode are copies of the
reference's.

The mesh (`Mesh`, `make_pod_mesh`, `make_host_mesh`) has the reference's
axis names, shapes and checks.  The reference counts `jax.devices()`; the
port counts the visible devices of the mesh's type (`torch.cuda.
device_count()`, or 1 for the CPU) times `shards_per_device` (default 1),
which is how n shards are laid on one card — the counterpart of XLA's
`--xla_force_host_platform_device_count`.  With the default, one card is a
1-shard mesh and the sharded gate skips, as on one TPU device.  Every shard
runs on `mesh.device`; placing a mesh's shards on several cards is not done
yet (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import classpack_kernels as ck
from ..ops.classpack import _upload, resolve_device
from ..ops.tensorize import Problem, pad_to

SHARD_AXIS = "pods"
# hybrid-mesh axis names: the host axis rides DCN, the per-host chip axis
# rides ICI — the reduction runs over ICI first so only one partial per
# host crosses the (slower) data-center network
DCN_AXIS = "hosts"
ICI_AXIS = "chips"


@dataclass(frozen=True)
class Mesh:
    """The port's counterpart of `jax.sharding.Mesh`: the mesh's shape and
    axis names, and the torch device its shards run on."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def hosts(self) -> int:
        """Partials the reduction sums last: the DCN axis of a hybrid mesh,
        1 for a 1-D mesh."""
        return self.shape[0] if len(self.shape) == 2 else 1


def visible_devices(device="cuda", shards_per_device: int = 1) -> int:
    """How many mesh devices there are: the visible devices of `device`'s
    type (CUDA cards, or 1 for the CPU) times `shards_per_device`."""
    dev = resolve_device(device)
    if shards_per_device <= 0:
        raise ValueError(f"shards_per_device must be positive, got "
                         f"{shards_per_device}")
    cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    return cards * int(shards_per_device)


def make_pod_mesh(n_devices: Optional[int] = None, device="cuda",
                  shards_per_device: int = 1) -> Mesh:
    n_dev = visible_devices(device, shards_per_device)
    n = n_devices or n_dev
    if n > n_dev:
        raise ValueError(f"requested {n}-device mesh but only {n_dev} "
                         f"devices are available")
    return Mesh((n,), (SHARD_AXIS,), resolve_device(device))


def make_host_mesh(n_hosts: int, chips_per_host: Optional[int] = None,
                   device="cuda", shards_per_device: int = 1) -> Mesh:
    """2-D (hosts × chips) mesh: the reference's shapes and checks, with
    device order as host order (its virtual-mesh reading)."""
    n_dev = visible_devices(device, shards_per_device)
    if n_hosts <= 0 or (chips_per_host is not None and chips_per_host <= 0):
        raise ValueError(f"mesh axes must be positive, got "
                         f"{n_hosts}x{chips_per_host}")
    if chips_per_host is None:
        if n_dev % n_hosts:
            # inferring chips must not silently drop devices (8 devices /
            # 3 hosts would strand 2)
            raise ValueError(
                f"{n_dev} devices do not divide over {n_hosts} hosts; "
                f"pass chips_per_host explicitly")
        chips = n_dev // n_hosts
    else:
        chips = chips_per_host
    if n_hosts * chips > n_dev:
        raise ValueError(f"requested {n_hosts}x{chips} mesh but only "
                         f"{n_dev} devices are available")
    return Mesh((n_hosts, chips), (DCN_AXIS, ICI_AXIS),
                resolve_device(device))


def split_counts(counts: np.ndarray, n_shards: int) -> np.ndarray:
    """Split per-class pod counts across shards: n_shards×C. Remainders
    rotate with the class index so no shard becomes a systematic straggler
    (the scan is lockstep — wall clock is the heaviest shard)."""
    C = len(counts)
    base = counts // n_shards
    rem = counts - base * n_shards
    out = np.tile(base, (n_shards, 1))
    # shard s takes one extra pod of class c iff (s - c) mod n < rem[c]
    rot = (np.arange(n_shards)[:, None] - np.arange(C)[None, :]) % n_shards
    out += (rot < rem[None, :]).astype(counts.dtype)
    return out


def _shared(t: torch.Tensor, n: int) -> torch.Tensor:
    """One copy of a replicated operand seen by n shards (stride 0)."""
    return t.unsqueeze(0).expand(n, *t.shape)


def _pack_program(requests_sh, counts_sh, packed_sh, node_cap_sh, alloc,
                  price, rank, max_nodes_per_shard: int, mesh: Mesh):
    """The aggregate program of every shard, then the mesh reduction: K1,
    K2 and K4, each one launch over the shards, then K8 sums the flat
    launch plans, the innermost axis first.  Returns device (cost, nodes
    per column, unsched)."""
    m_all, ok_all = ck.classpack_precompute_sharded(
        requests_sh, node_cap_sh, packed_sh, alloc, price, rank)
    slot_option, _, n_open, n_unsched, _ = ck.classpack_scan_sharded(
        requests_sh, counts_sh, packed_sh, node_cap_sh, alloc, price, m_all,
        ok_all, None, None, max_nodes_per_shard, False)
    flat = ck.shard_psum(ck.classpack_aggregate_sharded(
        slot_option, price, n_open, n_unsched), mesh.hosts)
    return flat[0], flat[3:].to(torch.int32), flat[2].to(torch.int32)


def _assign_program(requests_sh, counts_sh, packed_sh, node_cap_sh, alloc,
                    price, rank, init_opt_sh, init_used_sh,
                    max_nodes_per_shard: int, n_pods_shard: int):
    """The assign program of every shard: K1, K2 emitting takes and K3,
    each one launch over the shards.  Returns (assignment n×n_pods,
    slot_option n×K, n_unsched n)."""
    m_all, ok_all = ck.classpack_precompute_sharded(
        requests_sh, node_cap_sh, packed_sh, alloc, price, rank)
    slot_option, _, _, n_unsched, takes = ck.classpack_scan_sharded(
        requests_sh, counts_sh, packed_sh, node_cap_sh, alloc, price, m_all,
        ok_all, init_opt_sh, init_used_sh, max_nodes_per_shard, True)
    assignment = ck.classpack_assign_decode_sharded(takes, counts_sh,
                                                    n_pods_shard)
    return assignment, slot_option, n_unsched


def _sharded_pack(requests, counts_sharded, compat, node_cap, alloc, price,
                  rank, max_nodes_per_shard: int, mesh: Mesh):
    """Row 13: every shard packs its pod slice (`counts_sharded` n×Cpad,
    shard-major; the class arrays shared by the shards), then the launch
    plan is reduced over the mesh.  Returns device (cost,
    nodes_per_option, unsched)."""
    n = mesh.size
    return _pack_program(_shared(requests, n), counts_sharded,
                         _shared(ck.pack_bits(compat), n),
                         _shared(node_cap, n), alloc, price, rank,
                         max_nodes_per_shard, mesh)


def _sharded_assign(requests, counts_sharded, compat_packed_sharded,
                    node_cap, alloc, price, rank, init_option_sharded,
                    init_used_sharded, max_nodes_per_shard: int,
                    n_pods_shard: int, mesh: Mesh):
    """Row 14: every shard runs the assign program on its pod slice and
    returns per-pod slot ids.  Slots are per-shard local (each shard's
    bins are disjoint by construction), so the host decode offsets them by
    shard index × K.  Per-shard inputs (counts, compat column mask,
    pre-opened existing slots) carry a leading shard axis; the class
    requests and caps and the catalog are shared."""
    n = mesh.size
    return _assign_program(_shared(requests, n),
                           counts_sharded, compat_packed_sharded,
                           _shared(node_cap, n), alloc, price, rank,
                           init_option_sharded, init_used_sharded,
                           max_nodes_per_shard, n_pods_shard)


def _lower(problem: Problem, mesh: Mesh,
           existing_alloc=None, existing_compat=None):
    """Shared lowering: FFD-sorted padded arrays + per-shard count split.
    Existing-node columns are appended after the real options with
    price=+inf (never launchable, only fillable) and OWNED by exactly one
    shard via a per-shard column mask — bins stay disjoint across the
    mesh, which is what makes pod-batch sharding a valid bin-packing
    decomposition."""
    n = mesh.size
    order = problem.class_order()
    C = problem.num_classes
    Cpad = pad_to(C, (64, 256, 1024, 4096))
    R = len(problem.axes)
    O = problem.num_options
    E = 0 if existing_alloc is None else len(existing_alloc)
    Opad = pad_to(O + E, (512, 2048, 4096, 8192))

    requests = np.zeros((Cpad, R), np.int32)
    requests[:C] = problem.class_requests[order].astype(np.int32)
    compat = np.zeros((Cpad, Opad), bool)
    compat[:C, :O] = problem.class_compat[order]
    if E:
        ec = existing_compat if existing_compat is not None else \
            np.ones((problem.num_classes, E), bool)
        compat[:C, O:O + E] = ec[order]
    alloc = np.zeros((Opad, R), np.int32)
    alloc[:O] = problem.option_alloc.astype(np.int32)
    if E:
        alloc[O:O + E] = np.ceil(existing_alloc).astype(np.int32)
    price = np.full(Opad, np.inf, np.float32)
    price[:O] = problem.option_price
    rank = np.full(Opad, 2**30 - 1, np.int32)
    rank[:O] = problem.option_rank
    node_cap = np.full(Cpad, 2**30, np.int32)
    if problem.class_node_cap is not None:
        node_cap[:C] = problem.class_node_cap[order]

    counts_sharded = np.zeros((n, Cpad), np.int32)
    counts_sharded[:, :C] = split_counts(
        problem.class_counts[order].astype(np.int32), n)
    return (order, C, Cpad, R, O, E, Opad, requests, compat, alloc, price,
            rank, node_cap, counts_sharded)


def solve_sharded(problem: Problem, mesh: Optional[Mesh] = None,
                  max_nodes_per_shard: int = 4096,
                  decode: bool = False,
                  existing_alloc: Optional[np.ndarray] = None,
                  existing_used: Optional[np.ndarray] = None,
                  existing_compat: Optional[np.ndarray] = None):
    """Pack a Problem over a mesh — 1-D (pods) or hybrid 2-D (hosts ×
    chips) — on `mesh.device` (default: `make_pod_mesh()` on the card).

    decode=False returns (total_cost, nodes_per_option, unsched_count)
    via one reduction over the mesh — the feasibility-probe contract.

    decode=True returns a PackingResult with real per-pod assignments:
    each shard runs the assign program on its slice, slot ids are
    globalized by shard offset, and the host decode (node runs,
    alternatives memo, pod-hosting-only cost) matches the single-device
    path audit for audit.  Existing-node columns ride the mesh too: each
    existing node is owned by one shard (round-robin) and masked out of
    every other shard's compat."""
    mesh = mesh or make_pod_mesh()
    dev = mesh.device
    n = mesh.size
    (order, C, Cpad, R, O, E, Opad, requests, compat, alloc, price, rank,
     node_cap, counts_flat) = _lower(problem, mesh, existing_alloc,
                                     existing_compat)
    K = max_nodes_per_shard

    if not decode:
        assert E == 0, "existing columns require decode=True (the "\
            "aggregate reduction cannot attribute fills to owners)"
        cost, nodes_per_col, unsched = _sharded_pack(
            *(_upload(a, dev) for a in (requests, counts_flat, compat,
                                        node_cap, alloc, price, rank)),
            K, mesh)
        return (float(cost.cpu()), nodes_per_col.cpu().numpy()[:O],
                int(unsched.cpu()))

    # ---- per-shard inputs for the decode path ----
    own = [np.nonzero(np.arange(E) % n == s)[0] for s in range(n)]
    E_max = max((len(o) for o in own), default=0)
    assert K > E_max, "max_nodes_per_shard must exceed owned existing nodes"
    compat_sh = np.zeros((n, Cpad, Opad), bool)
    init_opt = np.full((n, K), -1, np.int32)
    init_used = np.zeros((n, K, R), np.int32)
    for s in range(n):
        cm = compat.copy()
        if E:
            mask = np.zeros(E, bool)
            mask[own[s]] = True
            cm[:, O:O + E] &= mask[None, :]
            init_opt[s, :len(own[s])] = O + own[s]
            if existing_used is not None:
                init_used[s, :len(own[s])] = np.ceil(
                    existing_used[own[s]]).astype(np.int32)
        compat_sh[s] = cm
    compat_packed = np.packbits(compat_sh, axis=2)

    P_shard = int(counts_flat.sum(axis=1).max()) if n else 0
    Ppad = pad_to(max(P_shard, 1))
    assignment, slot_option, _unsched = _sharded_assign(
        *(_upload(a, dev) for a in (requests, counts_flat, compat_packed,
                                    node_cap, alloc, price, rank, init_opt,
                                    init_used)),
        K, Ppad, mesh)
    assignment = assignment.cpu().numpy().reshape(n, Ppad).astype(np.int32)
    slot_option = slot_option.cpu().numpy().reshape(n, K)
    return _decode_sharded(problem, order, counts_flat, assignment,
                           slot_option, own, O, E, K, n)


def _decode_sharded(problem, order, counts_flat, assignment, slot_option,
                    own, O, E, K, n):
    """Host decode over all shards at once: pod ids per shard from the
    split member chunks, node runs from globally-offset slot ids, then
    the same alternatives/usage assembly as the single-device path."""
    from ..ops.ffd import PackingResult

    members_arr = problem.members_arrays()
    C = problem.num_classes
    # member consumption: class c's members split shard-major in the same
    # order split_counts dealt them
    csum = np.zeros(C, np.int64)
    pod_parts, cls_parts, slot_parts = [], [], []
    for s in range(n):
        cnt_s = counts_flat[s]
        P_s = int(cnt_s.sum())
        if P_s == 0:
            continue
        chunks = []
        cls_ids = []
        # counts_flat rows follow the FFD order already
        for pos, ci in enumerate(order):
            k = int(cnt_s[pos])
            if k == 0:
                continue
            mem = members_arr[ci]
            chunks.append(mem[csum[ci]:csum[ci] + k])
            cls_ids.append(np.full(k, ci, np.int64))
            csum[ci] += k
        pod_s = np.concatenate(chunks)
        a_s = assignment[s, :P_s]
        sched = a_s >= 0
        # globalize: local slot → shard-offset slot id
        slot_parts.append(np.where(sched, a_s.astype(np.int64) + s * K, -1))
        pod_parts.append(pod_s)
        cls_parts.append(np.concatenate(cls_ids))
    if not pod_parts:
        return PackingResult(nodes=[], unschedulable=[],
                             existing_assignments={}, total_price=0.0)
    pod_all = np.concatenate(pod_parts)
    cls_all = np.concatenate(cls_parts)
    slot_all = np.concatenate(slot_parts)
    result, _ = _assemble_plan(problem, pod_all, cls_all, slot_all,
                               slot_option, O, K)
    return result


def _assemble_plan(problem, pod_all, cls_all, slot_all, slot_option, O, K):
    """Shared host assembly for every mesh decode path: node runs from
    globally-offset slot ids, existing-vs-new column split, alternatives
    memo, pod-hosting-only cost.  Also returns the per-existing-node
    usage the fills added (float, problem scale) so the partitioned
    driver's residual reconciliation can solve against true leftovers."""
    from ..ops.classpack import resolve_alternatives
    from ..ops.ffd import NodeDecision, PackingResult

    unschedulable = pod_all[slot_all < 0].tolist()
    sched = slot_all >= 0
    pod_all, cls_all, slot_all = pod_all[sched], cls_all[sched], slot_all[sched]
    o = np.argsort(slot_all, kind="stable")
    pod_all, cls_all, slot_all = pod_all[o], cls_all[o], slot_all[o]
    starts = np.nonzero(np.diff(slot_all, prepend=np.int64(-1)))[0]
    ends = np.append(starts[1:], len(slot_all))
    node_slots = slot_all[starts]
    node_shard = (node_slots // K).astype(np.int64)
    node_local = (node_slots % K).astype(np.int64)
    node_col = slot_option[node_shard, node_local].astype(np.int64)

    # existing vs new: columns ≥ O are existing-node fills
    existing_assignments = {}
    existing_used_add = {}
    nodes = []
    new_idx = []
    jcb_list = []
    used_rows = []
    compat_bits = np.packbits(problem.class_compat, axis=1)
    reqs = problem.class_requests.astype(np.int64)
    reqs_f = problem.class_requests
    pods_l = pod_all.tolist()
    for i in range(len(node_slots)):
        s, e = starts[i], ends[i]
        col = node_col[i]
        if col >= O:
            eid = int(col - O)
            for p in pods_l[s:e]:
                existing_assignments[p] = eid
            add = reqs_f[cls_all[s:e]].sum(axis=0)
            existing_used_add[eid] = existing_used_add.get(eid, 0.0) + add
            continue
        cl = np.unique(cls_all[s:e])
        jcb_list.append(compat_bits[cl[0]] if len(cl) == 1 else
                        np.bitwise_and.reduce(compat_bits[cl], axis=0))
        used_rows.append(reqs[cls_all[s:e]].sum(axis=0))
        new_idx.append(i)
    oi_l = [int(node_col[i]) for i in new_idx]
    used_mat = (np.asarray(used_rows, np.int64) if used_rows else
                np.zeros((0, reqs.shape[1]), np.int64))
    resolved = resolve_alternatives(problem, oi_l, jcb_list, used_mat)
    total = 0.0
    for j, i in enumerate(new_idx):
        alts, used_rl = resolved[j]
        nodes.append(NodeDecision(
            option=problem.options[oi_l[j]],
            pod_indices=pods_l[starts[i]:ends[i]],
            used=used_rl, alternatives=alts))
        total += float(problem.option_price[oi_l[j]])
    return PackingResult(nodes=nodes, unschedulable=unschedulable,
                         existing_assignments=existing_assignments,
                         total_price=total), existing_used_add
