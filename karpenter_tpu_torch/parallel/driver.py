"""Partitioned mesh driver: the fleet-scale sharded solve.

The port of the JAX package's `parallel/driver.py`.  `sharded.py` proves
pod-batch sharding is a valid bin-packing decomposition; this driver feeds
the mesh `partition.py`'s compatibility groups instead of a round-robin
count split.  Each shard scans ONLY its own classes (compacted and
re-padded) against ONLY its own slot budget, so the per-shard kernel cost
drops from C_total × K_total to (C/n) × (K/n).

Flow per solve:

  1. `plan_partition` buckets classes/options/existing nodes into merged
     zone-compatibility groups and balances them over the mesh.  A None
     plan means "no structure" and the caller falls back to the
     single-device path.
  2. The compacted per-shard arrays run the classpack programs shard-batched
     — one launch per kernel with the shard as a grid axis
     (ops/classpack_kernels `*_sharded`): `_partitioned_pack` (row 15, K1 +
     K2 + K4, then K8 reduces the launch plan over the mesh, innermost axis
     first), `_partitioned_assign` (row 16, K1 + K2 + K3) and
     `_partitioned_assign_slab` (row 17, K1 + K2 + K3 + K6).
  3. Pods whose requirements straddle partitions (the plan's residual) are
     re-solved on the same device by the single-device `solve_classpack`
     (guide=None) against the true leftovers — real existing nodes'
     remaining free space after the mesh pass — and merged into the result.

Parity: on shardable inputs (no residual, slot budgets not binding) the
decoded plan is identical to the single-device `solve_classpack`
(guide=None) plan, as in the reference.  The reference's metrics and spans
are left out.  A fault of the card or a kernel (`DEVICE_FAULTS`) is never
turned into "fall back to the single device": it is raised.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np

from ..ops import classpack_kernels as ck
from ..ops import decode as decode_mod
from ..ops.classpack import DEVICE_FAULTS, _upload, solve_classpack
from ..ops.lpguide import _subproblem
from ..ops.tensorize import Problem, pad_to
from .partition import (MAX_RESIDUAL_FRAC_DEFAULT, MIN_PODS_DEFAULT,
                        PartitionPlan, plan_partition)
from .sharded import (Mesh, _assemble_plan, _assign_program, _pack_program,
                      make_pod_mesh)

log = logging.getLogger("karpenter_tpu_torch.parallel")

# pad buckets for the COMPACTED per-shard axes (smaller low end than the
# single-device buckets: compaction is the point)
_CPAD_BUCKETS = (64, 256, 1024, 4096)
_OPAD_BUCKETS = (512, 2048, 4096, 8192)


def _partitioned_pack(requests_sh, counts_sh, compat_sh, node_cap_sh,
                      alloc, price, rank, max_nodes_per_shard: int,
                      mesh: Mesh):
    """Row 15: the aggregate pack over compacted per-shard class arrays
    (n×Cpad…, one launch per kernel over the shards), then the launch plan
    reduced over the mesh by K8, innermost axis first, exactly like
    `sharded._sharded_pack`.  Returns device (cost, nodes per column
    Opad, unsched)."""
    packed = ck.pack_bits(compat_sh.reshape(-1, compat_sh.shape[-1])
                          ).reshape(*compat_sh.shape[:2], -1)
    return _pack_program(requests_sh, counts_sh, packed, node_cap_sh, alloc,
                         price, rank, max_nodes_per_shard, mesh)


def _partitioned_assign(requests_sh, counts_sh, compat_packed_sh,
                        node_cap_sh, alloc, price, rank, init_opt_sh,
                        init_used_sh, max_nodes_per_shard: int,
                        n_pods_shard: int, mesh: Mesh):
    """Row 16: the decode pack over compacted per-shard class arrays
    (K1 + K2 + K3, each one launch over the shards): per-pod slot ids per
    shard (n×Ppad), globalized by the host decode with shard × K offsets;
    slot_option n×K; n_unsched n."""
    return _assign_program(requests_sh, counts_sh, compat_packed_sh,
                           node_cap_sh, alloc, price, rank, init_opt_sh,
                           init_used_sh, max_nodes_per_shard, n_pods_shard)


def _partitioned_assign_slab(requests_sh, counts_sh, compat_packed_sh,
                             node_cap_sh, alloc, price, rank, init_opt_sh,
                             init_used_sh, max_nodes_per_shard: int,
                             n_pods_shard: int, mesh: Mesh):
    """Row 17, the DeviceDecode variant of `_partitioned_assign`: each
    shard ships the sorted SLAB (row order + per-slot run lengths, K6 over
    the shards) instead of a raw per-row assignment, so the host assembly
    is pure column ops (ops/decode).  Returns (order n×Ppad, slot_counts
    n×K, slot_option n×K, n_unsched n)."""
    assignment, slot_option, n_unsched = _assign_program(
        requests_sh, counts_sh, compat_packed_sh, node_cap_sh, alloc, price,
        rank, init_opt_sh, init_used_sh, max_nodes_per_shard, n_pods_shard)
    order, slot_counts = ck.classpack_slab_sharded(assignment,
                                                   max_nodes_per_shard)
    return order, slot_counts, slot_option, n_unsched


# The reference jits these twice, the second copy donating the per-solve
# init slabs (argument 7 and 8) off the CPU.  torch has no buffer donation:
# the slabs are fresh uploads the caller drops, so the `_donate` names are
# the same launches.
_partitioned_assign_donate = _partitioned_assign
_partitioned_assign_slab_donate = _partitioned_assign_slab


def solve_partitioned(problem: Problem, mesh: Optional[Mesh] = None,
                      max_nodes_per_shard: int = 4096,
                      decode: bool = True,
                      existing_alloc: Optional[np.ndarray] = None,
                      existing_used: Optional[np.ndarray] = None,
                      existing_compat: Optional[np.ndarray] = None,
                      existing_zone: Optional[np.ndarray] = None,
                      plan: Optional[PartitionPlan] = None,
                      max_residual_frac: float = MAX_RESIDUAL_FRAC_DEFAULT,
                      min_pods: int = MIN_PODS_DEFAULT,
                      device_decode: bool = False,
                      decode_health=None):
    """Partition-aware mesh solve on `mesh.device` (default:
    `make_pod_mesh()` on the card).  Returns None when the planner finds
    no exploitable structure (caller falls back to the single-device
    path); otherwise a PackingResult (decode=True) or the aggregate
    (total_cost, nodes_per_option, unsched) tuple (decode=False, E==0
    only — the reduction cannot attribute fills to existing owners).

    device_decode=True (the `DeviceDecode` gate) swaps the decode path's
    program for the slab variant: each shard sorts its pod rows by slot on
    the card and the host builds the plan with column operations
    (ops/decode.assemble_slab_sharded) instead of `_assemble_plan`'s
    per-pod walk — bit-identical plans.  A slab-assembly failure (not a
    device fault, which is raised) rebuilds the legacy per-row assignment
    from the already-fetched slab (no second launch), runs
    `_assemble_plan`, and reports to `decode_health`."""
    mesh = mesh or make_pod_mesh()
    dev = mesh.device
    n = mesh.size
    if n < 2:
        return None
    E = 0 if existing_alloc is None else len(existing_alloc)
    C = problem.num_classes
    ec = None
    if E:
        ec = (existing_compat if existing_compat is not None
              else np.ones((C, E), bool))

    if plan is None:
        plan = plan_partition(problem, n, existing_compat=ec,
                              existing_zone=existing_zone,
                              max_residual_frac=max_residual_frac,
                              min_pods=min_pods)
    if plan is None:
        return None

    # ---- compacted lowering: per-shard class axis in global FFD order ----
    order = problem.class_order()
    R = len(problem.axes)
    O = problem.num_options
    Opad = pad_to(O + E, _OPAD_BUCKETS)
    shard_cls = [order[plan.class_shard[order] == s] for s in range(n)]
    Cs = max((len(x) for x in shard_cls), default=0)
    Cpad = pad_to(max(Cs, 1), _CPAD_BUCKETS)
    K = max_nodes_per_shard

    own = [np.nonzero(plan.existing_shard == s)[0] for s in range(n)]
    E_max = max((len(o) for o in own), default=0)
    assert K > E_max, "max_nodes_per_shard must exceed owned existing nodes"

    requests_sh = np.zeros((n, Cpad, R), np.int32)
    counts_sh = np.zeros((n, Cpad), np.int32)
    node_cap_sh = np.full((n, Cpad), 2**30, np.int32)
    compat_sh = np.zeros((n, Cpad, Opad), bool)
    init_opt = np.full((n, K), -1, np.int32)
    init_used = np.zeros((n, K, R), np.int32)
    for s in range(n):
        cls = shard_cls[s]
        m = len(cls)
        if m:
            requests_sh[s, :m] = problem.class_requests[cls].astype(np.int32)
            counts_sh[s, :m] = problem.class_counts[cls].astype(np.int32)
            if problem.class_node_cap is not None:
                node_cap_sh[s, :m] = problem.class_node_cap[cls]
            cm = np.zeros((m, Opad), bool)
            cm[:, :O] = problem.class_compat[cls]
            if E and len(own[s]):
                # only the shard's OWN existing columns are visible —
                # bins never span shards
                cm[:, O + own[s]] = ec[cls][:, own[s]]
            compat_sh[s, :m] = cm
        if E and len(own[s]):
            # pre-open owned existing nodes in increasing global index
            # order (the single-device kernel's slot-scan order)
            init_opt[s, :len(own[s])] = (O + own[s]).astype(np.int32)
            if existing_used is not None:
                init_used[s, :len(own[s])] = np.ceil(
                    existing_used[own[s]]).astype(np.int32)

    alloc = np.zeros((Opad, R), np.int32)
    alloc[:O] = problem.option_alloc.astype(np.int32)
    if E:
        alloc[O:O + E] = np.ceil(existing_alloc).astype(np.int32)
    price = np.full(Opad, np.inf, np.float32)
    price[:O] = problem.option_price
    rank = np.full(Opad, 2**30 - 1, np.int32)
    rank[:O] = problem.option_rank

    if not decode:
        assert E == 0, "existing columns require decode=True (the "\
            "aggregate reduction cannot attribute fills to owners)"
        cost, nodes_per_col, unsched = _partitioned_pack(
            *(_upload(a, dev) for a in (requests_sh, counts_sh, compat_sh,
                                        node_cap_sh, alloc, price, rank)),
            K, mesh)
        cost = float(cost.cpu())
        nodes_per_option = nodes_per_col.cpu().numpy()[:O].astype(np.int64)
        unsched = int(unsched.cpu())
        if len(plan.residual_classes):
            sub = _subproblem(
                problem, plan.residual_classes,
                problem.class_counts[plan.residual_classes].astype(np.int64),
                np.zeros(C, np.int64))
            r = solve_classpack(sub, max_nodes=max_nodes_per_shard,
                                decode=False, guide=None, device=dev)
            cost += r.total_price
            oi = {id(o): j for j, o in enumerate(problem.options)}
            for nd in r.nodes:
                nodes_per_option[oi[id(nd.option)]] += 1
            unsched += len(r.unschedulable)
        return cost, nodes_per_option, unsched

    # ---- decode path ----
    use_slab = bool(device_decode)
    if use_slab and decode_health is not None and not decode_health.allow():
        use_slab = False
    compat_packed = np.packbits(compat_sh, axis=2)
    P_shard = int(counts_sh.sum(axis=(1,)).max()) if n else 0
    Ppad = pad_to(max(P_shard, 1))
    assign_fn = (_partitioned_assign_slab_donate if use_slab
                 else _partitioned_assign_donate)
    staged = tuple(_upload(a, dev) for a in (
        requests_sh, counts_sh, compat_packed, node_cap_sh, alloc, price,
        rank, init_opt, init_used))
    out = assign_fn(*staged, K, Ppad, mesh)
    if use_slab:
        order_sh, slot_counts_sh, slot_option, _uns = (t.cpu().numpy()
                                                       for t in out)
        assignment = None
    else:
        assignment, slot_option, _unsched = (t.cpu().numpy() for t in out)

    # host decode: per-shard pod ids from whole-class membership (a class
    # lives entirely on its shard), then the shared assembly
    from ..ops.ffd import PackingResult
    result = used_add = None
    if use_slab:
        # columnar assembly: stitch the per-shard slabs shard-major — each
        # shard's rows are already slot-sorted and shard s's global slots
        # [s*K, (s+1)*K) precede shard s+1's, so the concatenation IS the
        # global stable sort _assemble_plan would have computed
        order_sh = order_sh.reshape(n, Ppad).astype(np.int64)
        slot_counts_sh = slot_counts_sh.reshape(n, K).astype(np.int64)
        slot_option = slot_option.reshape(n, K)
        members_arr = problem.members_arrays()
        try:
            pods_p, cls_p, slots_p, run_p, uns_p = [], [], [], [], []
            for s in range(n):
                P_s = int(counts_sh[s].sum())
                if P_s == 0:
                    continue
                chunks, cls_ids = [], []
                for pos, ci in enumerate(shard_cls[s]):
                    k = int(counts_sh[s, pos])
                    if k == 0:
                        continue
                    chunks.append(members_arr[ci][:k])
                    cls_ids.append(np.full(k, ci, np.int64))
                pod_s = np.concatenate(chunks)
                cls_s = np.concatenate(cls_ids)
                ord_s, cnt_s = order_sh[s], slot_counts_sh[s]
                S_s = int(cnt_s.sum())
                take = ord_s[:S_s]
                pods_p.append(pod_s[take])
                cls_p.append(cls_s[take])
                # stable key-K sort keeps real unscheduled rows (< P_s)
                # ahead of padding, in row order
                uns_p.append(pod_s[ord_s[S_s:P_s]])
                occ = np.nonzero(cnt_s)[0]
                slots_p.append(occ + s * K)
                run_p.append(cnt_s[occ])

            def cat(parts):
                return (np.concatenate(parts) if parts
                        else np.zeros(0, np.int64))
            result, used_add = decode_mod.assemble_slab_sharded(
                problem, cat(pods_p), cat(cls_p), cat(slots_p),
                cat(run_p), cat(uns_p), slot_option, O, K)
            if decode_health is not None:
                decode_health.report_success()
        except DEVICE_FAULTS:
            raise
        except Exception:
            log.exception("sharded slab assembly failed; falling back "
                          "to host assembly")
            if decode_health is not None:
                decode_health.report_failure("error")
            # the mesh output is still good: rebuild the per-row
            # assignment from the slab, no second launch
            assignment = np.stack([
                decode_mod.slab_to_assignment(
                    order_sh[s], slot_counts_sh[s], Ppad, K)
                for s in range(n)])
            result = None
    if result is None:
        assignment = np.asarray(assignment).reshape(
            n, Ppad).astype(np.int32)
        slot_option = np.asarray(slot_option).reshape(n, K)
        members_arr = problem.members_arrays()
        pod_parts, cls_parts, slot_parts = [], [], []
        for s in range(n):
            P_s = int(counts_sh[s].sum())
            if P_s == 0:
                continue
            chunks, cls_ids = [], []
            for pos, ci in enumerate(shard_cls[s]):
                k = int(counts_sh[s, pos])
                if k == 0:
                    continue
                chunks.append(members_arr[ci][:k])
                cls_ids.append(np.full(k, ci, np.int64))
            pod_s = np.concatenate(chunks)
            a_s = assignment[s, :P_s]
            slot_parts.append(
                np.where(a_s >= 0, a_s.astype(np.int64) + s * K, -1))
            pod_parts.append(pod_s)
            cls_parts.append(np.concatenate(cls_ids))
        if pod_parts:
            result, used_add = _assemble_plan(
                problem, np.concatenate(pod_parts),
                np.concatenate(cls_parts),
                np.concatenate(slot_parts), slot_option, O, K)
        else:
            result, used_add = PackingResult(
                nodes=[], unschedulable=[], existing_assignments={},
                total_price=0.0), {}

    # ---- reconciliation of the straddling residual, on the same device ----
    if len(plan.residual_classes):
        sub = _subproblem(
            problem, plan.residual_classes,
            problem.class_counts[plan.residual_classes].astype(np.int64),
            np.zeros(C, np.int64))
        if E:
            # true leftovers: the mesh pass's fills are charged against
            # each node's free space before the residual sees it
            used2 = decode_mod.merge_residual_used(
                existing_used, used_add, E, R)
            r = solve_classpack(sub, max_nodes=max_nodes_per_shard,
                                existing_alloc=existing_alloc,
                                existing_used=used2,
                                existing_compat=ec[plan.residual_classes],
                                guide=None, device=dev)
        else:
            r = solve_classpack(sub, max_nodes=max_nodes_per_shard,
                                guide=None, device=dev)
        result.nodes.extend(r.nodes)
        result.existing_assignments.update(r.existing_assignments)
        result.unschedulable = sorted(
            set(result.unschedulable) | set(r.unschedulable))
        result.total_price += r.total_price
    return result


def maybe_solve_partitioned(problem: Problem, *, path: str,
                            max_nodes: int = 4096,
                            existing_alloc: Optional[np.ndarray] = None,
                            existing_used: Optional[np.ndarray] = None,
                            existing_compat: Optional[np.ndarray] = None,
                            node_list: Optional[Sequence] = None,
                            device_decode: bool = False,
                            decode_health=None,
                            mesh: Optional[Mesh] = None,
                            device="cuda"):
    """Controller entry: route a solve through the partitioned mesh when
    the ShardedSolve gate is on AND the batch/mesh justify it.  Returns
    None whenever the caller should run its normal single-device path —
    the gate must never change WHETHER a batch solves, only WHERE.  The
    signature is the reference's plus `mesh` (default: `make_pod_mesh` on
    `device`, one shard per visible card, where the reference reads
    `jax.devices()`).  A fault of the card or a kernel (`DEVICE_FAULTS`)
    is raised; any other failure of the partitioned solve is logged and
    answered by the single-device path, as in the reference.  `path`
    names the caller, whose outcome metric the reference books (left out
    here)."""
    del path
    total = int(problem.class_counts.sum())
    if mesh is None:
        mesh = make_pod_mesh(device=device)
    if total < MIN_PODS_DEFAULT or mesh.size < 2:
        return None
    existing_zone = None
    if node_list:
        zid = {z: i for i, z in enumerate(problem.zones)}
        existing_zone = np.asarray(
            [zid.get(getattr(nd, "zone", None), -1) for nd in node_list],
            np.int64)
    try:
        return solve_partitioned(problem, mesh=mesh,
                                 max_nodes_per_shard=max_nodes, decode=True,
                                 existing_alloc=existing_alloc,
                                 existing_used=existing_used,
                                 existing_compat=existing_compat,
                                 existing_zone=existing_zone,
                                 device_decode=device_decode,
                                 decode_health=decode_health)
    except DEVICE_FAULTS:
        raise
    except Exception:
        log.exception("partitioned solve failed; falling back to the "
                      "single-device path")
        return None
