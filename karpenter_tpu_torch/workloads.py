"""Seeded workloads, plan fingerprints and the headline goldens.

`build_pods` is a copy of the reference bench's pod-batch builder
(`bench.build_pods`): the same spec draws from the same numpy Generator, so
both packages can be handed the same batch.  `existing_nodes` draws E
pre-opened existing-node columns for a tensorized problem with numpy only.
`plan_fingerprint` is the bench's exact plan identity, and `plan_digest`
hashes it; `GOLDEN` holds the digests of the headline solves (50k pods ×
600 instance types), which the JAX package reproduces on the CPU
(tests/test_torch_slice.py) and `chip_smoke.py` checks on the card.

`consolidation_fleet` builds the consolidation cell — BASELINE.json config
4, 500 under-utilized nodes — from a numpy seed; `consolidation_digests`
fingerprints a consolidation decision and its sweep rows, and
`GOLDEN_CONSOLIDATION` holds the JAX package's digests of that fleet
(tests/test_torch_consolidation.py), which `chip_smoke.py` checks on the
card.

`PROVISION_CELLS` are the provisioning cells — `Provisioner.provision` on
a live cluster at full width — and `provision_env` / `provision_round` drive
either package through them; `provision_signature` identifies a round by
batch positions, and `GOLDEN_PROVISION` holds the JAX package's signatures
(tests/test_torch_provisioning.py), which `chip_smoke.py` checks on the
card.

The sharded paths (the ShardedSolve gate, parallel/): the zone-pinned
provisioning cell `provision-sharded-50k-20k` (in `PROVISION_CELLS`),
`megafleet_problem` (the reference bench's 1M-pod fleet) and the headline
over an 8-shard mesh; `GOLDEN_SHARDED` holds the JAX package's results on
them (tests/test_torch_partitioned.py), which `chip_smoke.py` checks on
the card.

`GOLDEN_GUIDED` is the digest of the headline's default, LP-guided solve
(HiGHS restricted masters), and `lp_instance` / `GOLDEN_LP` are the
refinery-shaped LP instances of the reference bench's LP A/B
(`bench._lp_instance`) with their HiGHS objectives and device-master plan
totals, all as the JAX package computes them on the CPU
(tests/test_torch_lpguide.py).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np

from .api import labels as wk
from .api.objects import NodeClaim, NodePool, Pod
from .api.requirements import IN, Requirement, Requirements
from .api.resources import CPU, GPU, MEMORY, PODS, ResourceList
from .api.taints import Toleration

# the headline: BASELINE.json's 50k-pod mixed burst over a 600-type catalog
HEADLINE = dict(spec_count=200, total=50_000, gpu_frac=0.05, zone_frac=0.2,
                taint_frac=0.1)
HEADLINE_TYPES = 600
HEADLINE_SEED = 0
HEADLINE_EXISTING = 512
EXISTING_SEED = 1


def build_pods(spec_count, total, rng: np.random.Generator, gpu_frac=0.0,
               zone_frac=0.0, taint_frac=0.0,
               selector_zones=("zone-a", "zone-b", "zone-c")):
    specs = []
    for i in range(spec_count):
        cpu = int(rng.integers(100, 8000))
        mem = int(rng.integers(128, 32768)) * 2**20
        req = ResourceList({CPU: cpu, MEMORY: mem})
        sel = {}
        tol = []
        if rng.random() < gpu_frac:
            req[GPU] = int(rng.choice([1, 2, 4, 8]))
        if rng.random() < zone_frac:
            sel[wk.ZONE] = str(rng.choice(list(selector_zones)))
        if rng.random() < taint_frac:
            tol = [Toleration("dedicated", "Exists")]
        specs.append((req, sel, tol))
    per = total // spec_count
    extra = total - per * spec_count
    pods = []
    for i, (req, sel, tol) in enumerate(specs):
        n = per + (1 if i < extra else 0)
        pods.extend(Pod(requests=ResourceList(req), node_selector=dict(sel),
                        tolerations=list(tol)) for _ in range(n))
    return pods


def existing_nodes(problem, n_nodes: int, rng: np.random.Generator
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """E existing-node columns for `problem` (read as numpy arrays only:
    option_alloc, num_classes): (alloc E×R f32, used E×R f32, compat C×E
    bool).  Allocatable is an option's shaved by up to 10% (fractional, so
    the int32 lowering truncates), usage a random share of it (fractional,
    so the lowering takes its ceiling), and one node in 32 is overcommitted
    on one axis, which drives its free space negative."""
    alloc_o = np.asarray(problem.option_alloc, np.float32)
    R = alloc_o.shape[1]
    pick = rng.integers(0, alloc_o.shape[0], size=n_nodes)
    alloc = (alloc_o[pick] * rng.uniform(0.9, 1.0, (n_nodes, 1))
             ).astype(np.float32)
    used = (alloc * rng.uniform(0.0, 0.9, (n_nodes, R))).astype(np.float32)
    over = rng.random(n_nodes) < 1 / 32
    axis = rng.integers(0, R, size=n_nodes)
    used[over, axis[over]] = alloc[over, axis[over]] + 1.5
    compat = rng.random((int(problem.num_classes), n_nodes)) < 0.8
    return alloc, used, compat


def plan_fingerprint(problem, res):
    """EXACT plan identity as comparable arrays: node option sequence,
    per-node pod runs (order included), existing fills in dict insertion
    order, unschedulable sequence, float total (the reference bench's
    `_plan_fingerprint`)."""
    oi = {id(o): j for j, o in enumerate(problem.options)}
    opts = np.asarray([oi[id(nd.option)] for nd in res.nodes], np.int64)
    sizes = np.asarray([len(nd.pod_indices) for nd in res.nodes], np.int64)
    pods = (np.concatenate([np.asarray(nd.pod_indices, np.int64)
                            for nd in res.nodes])
            if res.nodes else np.zeros(0, np.int64))
    ex = np.asarray(list(res.existing_assignments.items()),
                    np.int64).reshape(-1, 2)
    uns = np.asarray(res.unschedulable, np.int64)
    return opts, sizes, pods, ex, uns, res.total_price


def plan_digest(problem, res, decode: bool = True) -> Tuple[str, float]:
    """(sha256 of the plan's integer identity, total_price).  A decoded plan
    hashes every fingerprint array; an aggregate (decode=False) plan has
    no per-pod binding and hashes the option of every node (nodes per
    option) and the unschedulable count.  The total price stays out of the
    hash: the decoded total is a float32 host sum and the aggregate total a
    float32 device sum, so it is compared within a stated tolerance."""
    h = hashlib.sha256()
    if decode:
        opts, sizes, pods, ex, uns, total = plan_fingerprint(problem, res)
        for a in (opts, sizes, pods, ex, uns):
            h.update(np.ascontiguousarray(a, np.int64).tobytes())
            h.update(b"|")
    else:
        oi = {id(o): j for j, o in enumerate(problem.options)}
        opts = np.asarray([oi[id(nd.option)] for nd in res.nodes], np.int64)
        h.update(opts.tobytes())
        h.update(b"|")
        h.update(np.int64(len(res.unschedulable)).tobytes())
        total = res.total_price
    return h.hexdigest(), float(total)


# (n_existing, decode) -> (plan digest, total_price) of the headline solve
# with guide=None, as the JAX package computes it on the CPU.
GOLDEN = {
    (0, True): ("f31ad4e1e9787f315d1569327ec6ad7ec64cdda2d43120e0c1083e6e6aa86968",
                4967.345703125),
    (0, False): ("68d0cf97d5a41ec24c3bd3b1bf682194040b1f48e317332609e1f2c5d3dad45f",
                 4967.3447265625),
    (HEADLINE_EXISTING, True): (
        "46089627b084b549205d1e55d610af5f6dc06ada287b1fb1ac985146fbedace1",
        4810.14404296875),
    (HEADLINE_EXISTING, False): (
        "5ff7ea316c245e090ed9ced1d4e21d7617900a44f8f237eb1742a49766a68225",
        4810.14404296875),
}


# ---------------------------------------------------------------------------
# the consolidation cell: BASELINE.json config 4, 500 under-utilized nodes
# ---------------------------------------------------------------------------

CONSOLIDATION_NODES = 500
CONSOLIDATION_SEED = 3
CONSOLIDATION_TYPES = 200          # bench.run_consolidation_replay's n_types
CONSOLIDATION_VCPUS = (4, 8, 16)   # the fleet's node sizes
CONSOLIDATION_SCALE_DOWN = 0.72    # share of pods deleted after the fill
CONSOLIDATION_NOW = 10_000.0       # the controller's clock; nodes are born at 0
CONSOLIDATION_SHAPES = (100, 500)  # max_candidates: the reference's limit, all
LAUNCH_PROBE_ROWS = 64             # launch_probes: rows, one call at B = 64
LAUNCH_PROBE_SEED = 11


class CatalogProvider:
    """A cloud provider as the consolidation decision reads one: a fixed
    catalog from `get_instance_types()` and `node_classes` (None: every
    pool's nodes boot the catalog's own 20 GiB root volume)."""

    def __init__(self, catalog, node_classes=None):
        self.catalog = list(catalog)
        self.node_classes = node_classes

    def get_instance_types(self):
        return self.catalog


@dataclass
class Fleet:
    provider: CatalogProvider
    cluster: object            # state.cluster.Cluster
    pools: List[NodePool]
    clock: Callable[[], float]


def consolidation_fleet(n_nodes: int = CONSOLIDATION_NODES,
                        seed: int = CONSOLIDATION_SEED,
                        n_types: int = CONSOLIDATION_TYPES) -> Fleet:
    """A dense fleet scaled down to ~28% utilization, as
    `bench.run_consolidation_replay` and the reference's deprovisioning
    scale suite (karpenter:test/suites/scale/deprovisioning_test.go:325-428)
    build it, but directly from the seed instead of through a provisioner.

    Node i (`node-0000`…) draws an instance type among the catalog's 4-,
    8- and 16-vCPU types and one of its available offerings, and registers
    through `Cluster.register_nodeclaim` with the labels, provider id and
    allocatable a launch of that offering gets.  Pods (`pod-00000`…, owner
    ReplicaSet) draw bench's requests — cpu 1500-2599m, memory 2-4 GiB —
    and fill each node first-fit; the first pod that does not fit starts
    the next node, and the pod that does not fit the last node is not
    created.  Then each pod is deleted with probability 0.72 (bench's
    scale-down).  Nodes are created at t=0; `clock` reads 10 000 s, well
    past the 300 s stabilization window."""
    from .catalog.generate import generate_catalog
    from .catalog.instancetype import effective_instance_type
    from .state.cluster import Cluster
    rng = np.random.default_rng(seed)
    catalog = generate_catalog(n_types)
    pool = NodePool()
    cluster = Cluster(clock=lambda: 0.0)
    sizes = [it for it in catalog
             if it.info is not None
             and it.info.cpu_m in tuple(v * 1000 for v in CONSOLIDATION_VCPUS)
             and it.available_offerings()]

    def start(i: int):
        it = sizes[int(rng.integers(len(sizes)))]
        offs = it.available_offerings()
        o = offs[int(rng.integers(len(offs)))]
        labels = dict(pool.template.labels)
        labels.update({wk.INSTANCE_TYPE: it.name, wk.ZONE: o.zone,
                       wk.CAPACITY_TYPE: o.capacity_type,
                       wk.NODEPOOL: pool.name})
        labels.update({k: v for k, v in it.requirements.labels().items()
                       if k not in (wk.ZONE, wk.CAPACITY_TYPE)})
        name = f"node-{i:04d}"
        claim = NodeClaim(
            nodepool=pool.name, name=f"{name}-claim",
            requirements=pool.requirements().union(Requirements.of(
                Requirement(wk.INSTANCE_TYPE, IN, [it.name]),
                Requirement(wk.ZONE, IN, [o.zone]),
                Requirement(wk.CAPACITY_TYPE, IN, [o.capacity_type]))),
            taints=list(pool.template.taints), labels=labels,
            provider_id=f"fleet:///{o.zone}/i-{i:017x}",
            instance_type=it.name, zone=o.zone,
            capacity_type=o.capacity_type, price=o.price)
        eff = effective_instance_type(it, pool)
        node = cluster.register_nodeclaim(claim, eff.allocatable,
                                          eff.capacity)
        # the registry names nodes from a process-wide counter; the cell
        # needs names that depend on the seed alone
        del cluster.nodes[node.name]
        node.name = node.labels[wk.HOSTNAME] = name
        cluster.nodes[name] = node
        return node

    pods: List[Pod] = []
    node, i_node, used = start(0), 0, ResourceList()
    while True:
        req = ResourceList({CPU: int(rng.integers(1500, 2600)),
                            MEMORY: int(rng.integers(2, 5)) * 2**30})
        with_pod = used + req
        with_pod[PODS] = with_pod.get(PODS, 0) + 1
        if not with_pod.fits(node.allocatable):
            if i_node + 1 == n_nodes:
                break
            i_node += 1
            node, used = start(i_node), ResourceList()
            with_pod = ResourceList(req)
            with_pod[PODS] = 1
            assert with_pod.fits(node.allocatable), node.instance_type
        name = f"pod-{len(pods):05d}"
        pod = cluster.add_pod(Pod(name=name, uid=name, requests=req,
                                  owner_kind="ReplicaSet"))
        cluster.bind_pod(pod, node.name)
        pods.append(pod)
        used = with_pod
    for p in pods:
        if rng.random() < CONSOLIDATION_SCALE_DOWN:
            cluster.delete_pod(p)
    return Fleet(CatalogProvider(catalog), cluster, [pool],
                 lambda: CONSOLIDATION_NOW)


def action_signature(action):
    """What 'the same action' means: kind + candidate nodes + what gets
    launched (instance types, sorted) — tests/test_consolidation_sweep.py's
    identity of a consolidation decision."""
    if action is None:
        return None
    launched = []
    if action.simulation is not None:
        launched = sorted(d.option.instance_type
                          for d in action.simulation.nodes)
    return (action.kind, [c.name for c in action.candidates], launched)


def sweep_digest(sweep) -> Tuple[str, float]:
    """(sha256 of a SweepResult's integer rows — new nodes and
    unschedulable pods — and the float32 sum of its per-row launch
    costs, compared within a stated tolerance)."""
    h = hashlib.sha256()
    for a in (sweep.new_nodes, sweep.unschedulable):
        h.update(np.ascontiguousarray(a, np.int64).tobytes())
        h.update(b"|")
    return h.hexdigest(), float(np.asarray(sweep.total_price,
                                           np.float64).sum())


def consolidation_digests(action, prefixes, singles) -> Dict[str, object]:
    """The fingerprint of one consolidation run: the action signature's
    sha256, and `sweep_digest` of `arena.sweep_prefixes()` and
    `arena.sweep_singles()`."""
    sig = json.dumps(action_signature(action)).encode()
    return dict(action=hashlib.sha256(sig).hexdigest(),
                prefixes=sweep_digest(prefixes),
                singles=sweep_digest(singles))


def launch_probes(arena, n_rows: int = LAUNCH_PROBE_ROWS,
                  seed: int = LAUNCH_PROBE_SEED):
    """Seeded replace-face probes that must launch new nodes, over an
    arena of either package (read by attribute only): row r reschedules
    the pods of 1 + r % 10 candidates that hold pods, keeps no live node
    (even r) or about 1% of them (odd r) as survivors, and caps launches strictly below the sum of
    those candidates' prices (r % 3 == 1), half of it (r % 3 == 2), or not
    at all (r % 3 == 0).  Returns (problem, counts_b, keyword arguments of
    `solve_classpack_sweep`)."""
    side = arena.replace_side
    rng = np.random.default_rng(seed)
    N, C = side.cand_counts.shape
    E = len(side.node_list)
    busy = np.nonzero(side.cand_counts.sum(1) > 0)[0]
    counts = np.zeros((n_rows, C), np.int32)
    mask = np.ones((n_rows, E), bool)
    caps = np.full(n_rows, np.inf, np.float32)
    for r in range(n_rows):
        pick = rng.choice(busy, size=min(1 + r % 10, len(busy)),
                          replace=False)
        counts[r] = side.cand_counts[pick].sum(0)
        mask[r] = rng.random(E) < (0.01 if r % 2 else 0.0)
        price = np.float32(np.asarray(arena.prices, np.float64)[pick].sum())
        if r % 3:
            caps[r] = price if r % 3 == 1 else price / np.float32(2)
    return side.problem, counts, dict(
        existing_alloc=side.alloc, existing_used=side.used,
        existing_compat=side.compat, exist_mask_b=mask, price_cap_b=caps,
        max_nodes=8192)


# sweep_digest of `launch_probes` over the 500-candidate arena of
# `consolidation_fleet()`, through the JAX package's solve_classpack_sweep on
# the CPU: 64 rows, every one of them schedulable, 294 launches in all
GOLDEN_LAUNCH_SWEEP: Tuple[str, float] = (
    "5b5435f05bce702b2ccc7e697f9d3b87f144cdc6a63f7f287678a73335689d5f",
    12.727600233629346)

# max_candidates -> consolidation_digests of `consolidation_fleet()` as the
# JAX package's DisruptionController computes them on the CPU
GOLDEN_CONSOLIDATION: Dict[int, Dict[str, object]] = {
    100: dict(
        action="74a6007d525547274adb174612a3f6939e4271407653399c3724c7f5484b2a26",
        prefixes=("67d96f527361a32781f1592b76adcf54bd9dd9170ec49c4191f31e85750b002c",
                  0.0),
        singles=("67d96f527361a32781f1592b76adcf54bd9dd9170ec49c4191f31e85750b002c",
                 0.0)),
    500: dict(
        action="d56049a8cbe62c5b959cb519dbb932e9cac8c10fdf2253c7ffb14dc917f664c8",
        prefixes=("8e513b1565c6230f14046f4b6b2729af9208c9c22d3e982e1b431b2839648c12",
                  0.0),
        singles=("361d05da05356c37141fbb922418ec453b148ac414ea9d47b46162bf65ecb784",
                 0.0)),
}


# ---------------------------------------------------------------------------
# the guided solve: the headline's default plan and the LP A/B instances
# ---------------------------------------------------------------------------

# plan_digest of the headline's default solve_classpack(prob) (guide="lp",
# HiGHS masters) as the JAX package computes it on the CPU.  The plan rests
# on HiGHS's vertex, so the scipy version that made it is part of it.
GOLDEN_GUIDED: Dict[str, object] = dict(
    digest="c381f73ec3e77e1a32d9292379733341bf4867445881cdd3c8ab596e1c00d24e",
    total=4653.490084409714,
    nodes=1463,
    z_lp=4474.6324297541905,
    scipy="1.17.0",
)

LP_SEED = 42            # bench.run_lp_ab's generator seed
LP_TYPES = 40           # bench.run_lp_ab's n_types
LP_SIZES = (100, 250)   # class counts whose device masters converge


def lp_problem(n_classes: int, n_types: int, rng: np.random.Generator):
    """The tensorized problem behind `lp_instance`: blended pods (20 per
    class, 20% zone selectors) against `generate_catalog(n_types)`."""
    from .catalog.generate import generate_catalog
    from .ops.tensorize import tensorize
    pods = build_pods(n_classes, n_classes * 20, rng, zone_frac=0.2)
    return tensorize(pods, generate_catalog(n_types), [NodePool()])


def lp_operands(prob):
    """(req, cnt, compat, alloc, price) of `prob` deduped to
    LP-distinguishable options: the operands `solve_guided` hands to the
    column generation."""
    from .ops import lpguide
    ok = lpguide._feasible_mask(prob)
    alloc, price, compat, _ = lpguide._dedup_with_inverse(
        prob.option_alloc.astype(np.float64),
        prob.option_price.astype(np.float64), ok)
    req = prob.class_requests.astype(np.float64)
    cnt = prob.class_counts.astype(np.float64)
    return req, cnt, compat, alloc, price


def lp_instance(n_classes: int, n_types: int, rng: np.random.Generator):
    """A copy of `bench._lp_instance` on the port's types: (req, cnt,
    compat, alloc, price) of one refinery-shaped LP workload."""
    return lp_operands(lp_problem(n_classes, n_types, rng))


def lp_problems() -> Dict[int, object]:
    """{class count: problem} of LP_SIZES, each drawn from a fresh
    `default_rng(LP_SEED)`."""
    return {C: lp_problem(C, LP_TYPES, np.random.default_rng(LP_SEED))
            for C in LP_SIZES}


# class count -> the JAX package's numbers on the CPU for `lp_problems()`:
# z of the HiGHS column generation (exact_lp_mix on lp_operands, 2 pricing
# rounds at both sizes), and the total and node count of the guided plan
# with device_lp=True (both masters of each size converge)
GOLDEN_LP: Dict[int, Dict[str, float]] = {
    100: dict(z=237.65520285588352, device_total=245.7881063297391,
              device_nodes=473),
    250: dict(z=589.5349812292611, device_total=610.202819917351,
              device_nodes=1082),
}


def ffd_scan_inputs(rng: np.random.Generator, P: int = 4096, C: int = 48,
                    O: int = 600, R: int = 4, E: int = 0, K: int = 1024):
    """A seeded input of the pod-granular scan (`ffd_kernels.ffd_scan`'s
    arguments as numpy arrays, and K): class-contiguous rows, zero request
    axes, fractional usage, +inf / NaN / near-max prices, two pool ranks,
    hostname caps on a tenth of the classes, E pre-opened existing slots
    and 64 padded rows."""
    from .ops.ffd import rem_in_class
    f32 = np.float32
    sizes = rng.multinomial(P - 64, np.ones(C) / C)
    class_ids = np.repeat(np.arange(C, dtype=np.int32), sizes)
    n = len(class_ids)
    creq = rng.integers(100, 4000, (C, R)).astype(f32)
    creq[:, 2:][rng.random((C, R - 2)) < 0.3] = 0.0
    ccap = np.full(C, 2**30, np.int32)
    capped = rng.random(C) < 0.1
    ccap[capped] = rng.integers(1, 4, capped.sum())
    cols = O + E
    alloc = rng.integers(2000, 64000, (cols, R)).astype(f32)
    price = rng.uniform(0.05, 5.0, cols).astype(f32)
    u = rng.random(O)
    price[:O][u < 0.05] = np.inf
    price[:O][(u >= 0.05) & (u < 0.07)] = np.nan
    price[:O][(u >= 0.07) & (u < 0.09)] = f32(3e38)
    price[O:] = np.inf
    rank = rng.integers(0, 2, cols).astype(np.int32)
    ccomp = rng.random((C, cols)) < 0.7
    init_option = np.full(K, -1, np.int32)
    init_used = np.zeros((K, R), f32)
    init_option[:E] = np.arange(O, O + E, dtype=np.int32)
    init_used[:E] = (alloc[O:] * rng.uniform(0.0, 0.9, (E, R))).astype(f32)
    Ppad = P
    req = np.zeros((Ppad, R), f32)
    req[:n] = creq[class_ids]
    crow = np.zeros(Ppad, np.int32)
    crow[:n] = class_ids
    cid = np.full(Ppad, -2, np.int32)
    cid[:n] = class_ids
    valid = np.zeros(Ppad, bool)
    valid[:n] = True
    cap = np.full(Ppad, 2**30, np.int32)
    cap[:n] = ccap[class_ids]
    rem = np.zeros(Ppad, np.int32)
    rem[:n] = rem_in_class(class_ids)
    return (req, np.packbits(ccomp, axis=1), crow, cid, valid, cap, rem,
            alloc, price, rank, init_option, init_used), K


# seeded K7 inputs whose rows of one class are not all identical, so that
# the scan kernel's first-fit cursor must reset inside a class
FFD_CURSOR_CASES = ("request", "compat row", "node cap", "invalid rows",
                    "exhaustion", "all, existing slots")


def ffd_cursor_case(name: str, rng: np.random.Generator, P: int = 1024):
    """One of FFD_CURSOR_CASES as `ffd_scan_inputs` does it (arrays, K):
    rows of a class alternate, in blocks of 1-8, between their class's
    request and another (some of them a zero axis's -0.0), their class's
    compat row and the next class's, or their class's node cap and 1-3;
    rows inside a class are invalid, some of them with another class's id
    (a class boundary no valid row shows); a few large classes exhaust 16
    slots; or all of these at once with 32 existing slots."""
    f32 = np.float32
    if name == "exhaustion":
        return ffd_scan_inputs(rng, P=P, C=6, O=64, R=3, K=16)
    every = name == "all, existing slots"
    arrays, K = ffd_scan_inputs(rng, P=P, C=16, O=128, R=4,
                                E=32 if every else 0, K=256)
    req, packed, crow, cid, valid, cap, rem = (a.copy() for a in arrays[:7])
    n = int(valid.sum())

    def blocks():
        """A mask of the valid rows in alternating blocks of 1-8 rows."""
        mask = np.zeros(len(valid), bool)
        at, on = 0, False
        while at < n:
            step = int(rng.integers(1, 9))
            mask[at:min(at + step, n)] = on
            at, on = at + step, not on
        return mask
    if name in ("request", "all, existing slots"):
        flip = blocks()
        req[flip] = np.floor(req[flip] * f32(0.75))
        zero = (req == 0.0) & blocks()[:, None]
        req[zero] = -0.0
    if name in ("compat row", "all, existing slots"):
        flip = blocks()
        crow[flip] = (crow[flip] + 1) % packed.shape[0]
    if name in ("node cap", "all, existing slots"):
        flip = blocks()
        cap[flip] = rng.integers(1, 4, int(flip.sum()))
    if name in ("invalid rows", "all, existing slots"):
        drop = blocks() & (rng.random(len(valid)) < 0.3)
        valid[drop] = False
        away = drop & (rng.random(len(valid)) < 0.3)
        cid[away] = cid[away] + 1000
    return (req, packed, crow, cid, valid, cap, rem) + arrays[7:], K


def _takes_within(counts: np.ndarray, K: int, rng: np.random.Generator,
                  share: float = 0.8) -> np.ndarray:
    """C × K int32 takes that K2 could emit: each class schedules at most
    its count (about `share` of it), spread over a random set of slots."""
    C = counts.shape[0]
    takes = np.zeros((C, K), np.int32)
    for c in range(C):
        m = int(counts[c])
        t = int(rng.binomial(m, share)) if m else 0
        if t == 0:
            continue
        used = rng.choice(K, size=min(K, 1 + t // 8), replace=False)
        takes[c, used] = rng.multinomial(t, np.ones(len(used)) / len(used))
    return takes


def assign_decode_edges(C: int, K: int, n_pods: int,
                        rng: np.random.Generator
                        ) -> Dict[str, Tuple[np.ndarray, np.ndarray, int]]:
    """Edge inputs of K3 `classpack_assign_decode`, name → (takes C × K,
    counts C, n_pods), every one within what K2 guarantees (takes ≥ 0, a
    class's row total ≤ its count): every pod in one class (fully
    scheduled), two thirds of the classes empty (the first and the last
    among them), all takes zero, half the rows padding past the last pod,
    counts summing past n_pods (the repeat truncates), and a seeded
    general case."""
    out = {}
    counts = np.zeros(C, np.int32)
    counts[C // 3] = n_pods
    takes = _takes_within(counts, K, rng, share=1.0)
    out["every pod in one class"] = (takes, counts, n_pods)
    counts = rng.multinomial(n_pods, np.ones(C) / C).astype(np.int32)
    counts[rng.random(C) < 2 / 3] = 0
    counts[0] = counts[-1] = 0
    out["empty classes"] = (_takes_within(counts, K, rng), counts, n_pods)
    counts = rng.multinomial(n_pods, np.ones(C) / C).astype(np.int32)
    out["all takes zero"] = (np.zeros((C, K), np.int32), counts, n_pods)
    counts = rng.multinomial(n_pods // 2, np.ones(C) / C).astype(np.int32)
    counts[-1] = max(int(counts[-1]), 1)
    out["padding rows"] = (_takes_within(counts, K, rng, share=1.0), counts,
                           n_pods)
    counts = rng.multinomial(n_pods + n_pods // 4 + 1,
                             np.ones(C) / C).astype(np.int32)
    out["truncated repeat"] = (_takes_within(counts, K, rng), counts, n_pods)
    counts = rng.multinomial(n_pods - n_pods // 8,
                             np.ones(C) / C).astype(np.int32)
    out["seeded"] = (_takes_within(counts, K, rng), counts, n_pods)
    return out


# ---------------------------------------------------------------------------
# the provisioning cells: Provisioner.provision on a live cluster
# ---------------------------------------------------------------------------

PROVISION_TYPES = 600                     # full width: 600 types, 3600 options
# the second burst of provision-live: the headline's fractions, 20k pods
PROVISION_ROUND2 = dict(spec_count=200, total=20_000, gpu_frac=0.05,
                        zone_frac=0.2, taint_frac=0.1)
PROVISION_ROUND2_SEED = 5
PROVISION_SMALL = dict(spec_count=16, total=64)   # three bursts, rng(7 + r)
PROVISION_SMALL_SEED = 7
# the sharded cell's bursts: the live cell's, every spec pinned to a zone
ZONE_PINNED = dict(HEADLINE, zone_frac=1.0)
ZONE_PINNED_ROUND2 = dict(PROVISION_ROUND2, zone_frac=1.0)
SHARDED_CELL = "provision-sharded-50k-20k"
MESH_SHARDS = 8                           # every sharded path: 8 shards

# cell -> (Provisioner options, rounds as (build_pods kwargs, seed))
PROVISION_CELLS: Dict[str, Tuple[Dict, List[Tuple[Dict, int]]]] = {
    # the default Provisioner + DeviceDecode: a guided round 1 on an empty
    # cluster, then a burst against the 1463-node live cluster (E > 0
    # skips the guide, so it takes the slab programs, row 7)
    "provision-live-50k-20k": (
        dict(device_decode=True),
        [(HEADLINE, HEADLINE_SEED),
         (PROVISION_ROUND2, PROVISION_ROUND2_SEED)]),
    # the LPGuide escape hatch + DeviceDecode: row 8 at P = 50 000
    "provision-noguide-50k": (
        dict(lp_guide=False, device_decode=True),
        [(HEADLINE, HEADLINE_SEED)]),
    # three 64-pod bursts into one cluster: every solve is a small batch,
    # which `_pick_solver` sends to solve_ffd (row 11)
    "provision-small-3x64": (
        {},
        [(PROVISION_SMALL, PROVISION_SMALL_SEED + r) for r in range(3)]),
    # solver="ffd": row 11 at P = 50 000, K = 2048
    "provision-ffd-50k": (
        dict(solver="ffd"),
        [(HEADLINE, HEADLINE_SEED)]),
    # the ShardedSolve gate + DeviceDecode over an 8-shard mesh: a
    # zone-pinned 50k burst on an empty cluster (row 17, three loaded
    # shards), then 20k more against the live cluster (row 17 with each
    # shard owning its zone's nodes).  4096 slots per shard: at the
    # default 2048 round 1 fills zone-b's shard to exactly 2048 nodes, and
    # round 2 then fails the driver's K > owned-nodes check and falls back
    # to the single device.  The port's Provisioner takes the mesh as
    # `mesh=` (the reference reads its 8 devices); the cell's golden is in
    # GOLDEN_SHARDED
    SHARDED_CELL: (
        dict(sharded_solve=True, device_decode=True,
             max_nodes_per_round=4096),
        [(ZONE_PINNED, HEADLINE_SEED),
         (ZONE_PINNED_ROUND2, PROVISION_ROUND2_SEED)]),
}


@dataclass
class ProvisionEnv:
    """The objects of one provisioning cell.  Built by `provision_env` from
    the classes it is given, so the same code runs either package."""
    cloud: object
    provider: object
    cluster: object
    provisioner: object


def provision_env(cell: str, FakeCloud, CloudProvider, Cluster, Provisioner,
                  NodePool, catalog, **extra) -> ProvisionEnv:
    """FakeCloud → CloudProvider(catalog) → Cluster → Provisioner with the
    cell's options (plus `extra`, e.g. the port's `device` or a
    SolverHealth), one default NodePool."""
    opts, _ = PROVISION_CELLS[cell]
    cloud = FakeCloud()
    provider = CloudProvider(cloud, catalog)
    cluster = Cluster()
    prov = Provisioner(provider, cluster, [NodePool()], **opts, **extra)
    return ProvisionEnv(cloud, provider, cluster, prov)


def provision_round(env: ProvisionEnv, pods) -> Tuple[Dict, object]:
    """Add `pods` to the cluster and run one `provision()`; returns (the
    round's signature, the ProvisioningResult)."""
    env.cluster.add_pods(pods)
    return provision_pending(env)


def provision_pending(env: ProvisionEnv) -> Tuple[Dict, object]:
    """One `provision()` of the cluster's pending pods; returns (the round's
    signature, the ProvisioningResult).  Batch positions index the pending
    pods as `provision()` reads them."""
    batch = env.cluster.pending_pods()
    before = list(env.cluster.nodes)
    res = env.provisioner.provision()
    return provision_signature(batch, before, env.cluster, res), res


def provision_signature(batch, nodes_before, cluster, res) -> Dict:
    """A provisioning round's identity by batch position, never by name
    (pod and claim names come from a process-wide counter): the launched
    claims in launch order (instance type, zone, capacity type, nodepool,
    request totals, the batch positions of their pods); the pods bound to
    nodes that existed before the round, as (batch position, node launch
    index); the unschedulable batch positions; the total launch price."""
    pos = {id(p): i for i, p in enumerate(batch)}
    launch_index = {name: i for i, name in enumerate(cluster.nodes)}
    old = set(nodes_before)
    claims = [[c.instance_type, c.zone, c.capacity_type, c.nodepool,
               [[k, int(v)] for k, v in c.requests.items()],
               [pos[id(p)] for p in c._decision_pods]]
              for c in res.launched]
    existing = [[i, launch_index[p.node_name]] for i, p in enumerate(batch)
                if p.node_name in old]
    unsched = [pos[id(p)] for p in res.unschedulable]
    total = 0.0
    for c in res.launched:
        total += c.price
    digest = hashlib.sha256(json.dumps([claims, existing, unsched]).encode())
    return dict(digest=digest.hexdigest(), launched=len(claims),
                bound_new=res.bound_new, bound_existing=len(existing),
                unschedulable=len(unsched), total_price=total)

# cell -> per round, the JAX package's `provision_signature` on the CPU
# (tests/test_torch_provisioning.py proves it for provision-live and
# provision-small; `python tests/test_torch_provisioning.py` prints all four)
GOLDEN_PROVISION: Dict[str, List[Dict]] = {
    'provision-live-50k-20k': [
        dict(digest='4b393cd16d0177a0627c09879252a9fc'
             '1416388a9ad1f47938991f0ab2819369',
             launched=1463, bound_new=50000, bound_existing=0,
             unschedulable=0, total_price=4651.988099999959),
        dict(digest='6c4f1c8ac5426614754afd04b6c50e71'
             'd3fa6c4cc0a73d42dcadf8096ec70046',
             launched=585, bound_new=11519, bound_existing=718,
             unschedulable=7763, total_price=2029.3209999999995),
    ],
    'provision-noguide-50k': [
        dict(digest='fc726a6116a81a0c4875534a6a5fb425'
             '5e00d408422657f30742d0f6c9ea5850',
             launched=2048, bound_new=23079, bound_existing=0,
             unschedulable=26921, total_price=3556.043599999961),
    ],
    'provision-small-3x64': [
        dict(digest='d1fd5ded5f872973059d9f0372074e2f'
             'c42f25c43b4eeda0c49d9dfe745a0fe5',
             launched=39, bound_new=64, bound_existing=0,
             unschedulable=0, total_price=4.9997),
        dict(digest='ce6db94f3febb69ba2e1cb453bad56dd'
             '94724f15097482bb39de681b37dc860d',
             launched=26, bound_new=51, bound_existing=13,
             unschedulable=0, total_price=3.4571),
        dict(digest='714805e67ecc6e4aedc03b970ef691e6'
             'dff24eb06bff6db4e81d6e688ffd92c1',
             launched=29, bound_new=54, bound_existing=10,
             unschedulable=0, total_price=4.3059),
    ],
    'provision-ffd-50k': [
        dict(digest='a046f5502f5d0c78aee6f011c9b527a3'
             'deb8229cad90444cfc8234ee35e44a07',
             launched=2048, bound_new=23261, bound_existing=0,
             unschedulable=26739, total_price=3571.827199999971),
    ],
}


# ---------------------------------------------------------------------------
# the sharded paths: the megafleet and the headline over a mesh
# ---------------------------------------------------------------------------

MEGAFLEET_UNITS = 8                 # bench.py's `make bench-megafleet` n
MEGAFLEET_UNIT_PODS = 125_000       # pods per unit: 8 units = 1 000 000
MEGAFLEET_K = 4096                  # max_nodes_per_shard
HEADLINE_SHARDED_K = 4096


def megafleet_problem(n_units: int, pods_per_unit: int = MEGAFLEET_UNIT_PODS,
                      free_frac: float = 0.005):
    """A copy of the reference bench's `_megafleet_problem`, building the
    port's Problem from the same arrays: n_units compat-disjoint zone
    groups (2 zones × 2 types = 4 launch options and 64 pod classes each),
    `pods_per_unit` pods per unit.  63 classes per unit are unit-pinned;
    one class per unit (`free_frac` of its pods) is zone-free — compatible
    with every option fleet-wide — the straddling residual the partitioned
    driver reconciles.  Built directly as dense arrays (no pod objects)."""
    from .ops.tensorize import LaunchOption, Problem
    free = int(round(pods_per_unit * free_frac))
    pinned = pods_per_unit - free
    zones, options, alloc_rows, price_rows, zone_rows = [], [], [], [], []
    req_rows, count_rows, class_unit = [], [], []
    for u in range(n_units):
        za, zb = f"z{u}a", f"z{u}b"
        zones += [za, zb]
        for zi, z in ((2 * u, za), (2 * u + 1, zb)):
            for ti, (cpu, mem, price) in enumerate(
                    ((128, 512, 1.0), (256, 1024, 1.9))):
                options.append(LaunchOption(
                    pool=f"pool-{u}", instance_type=f"mf-{ti}", zone=z,
                    capacity_type="on-demand", price=price,
                    type_index=ti, pool_index=u))
                alloc_rows.append((cpu, mem))
                price_rows.append(price)
                zone_rows.append(zi)
        for c in range(63):
            cpu = (1, 2, 4)[c % 3]
            req_rows.append((cpu, 4 * cpu))
            count_rows.append(pinned // 63 + (1 if c < pinned % 63 else 0))
            class_unit.append(u)
        if free:
            req_rows.append((2, 8))
            count_rows.append(free)
            class_unit.append(-1)  # fleet-wide compat → residual
    O = len(options)
    counts = np.asarray(count_rows, np.int32)
    C = len(counts)
    compat = np.zeros((C, O), bool)
    for ci, u in enumerate(class_unit):
        if u < 0:
            compat[ci, :] = True
        else:
            compat[ci, 4 * u:4 * u + 4] = True
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    members = [np.arange(s, s + k, dtype=np.int64)
               for s, k in zip(starts, counts)]
    return Problem(
        axes=("cpu", "memory"),
        class_requests=np.asarray(req_rows, np.float32),
        class_counts=counts, class_compat=compat, class_members=members,
        options=options,
        option_alloc=np.asarray(alloc_rows, np.float32),
        option_price=np.asarray(price_rows, np.float32),
        option_rank=np.zeros(O, np.int32),
        class_node_cap=np.full(C, 2**30, np.int32),
        option_zone=np.asarray(zone_rows, np.int32),
        option_captype=np.zeros(O, np.int32),
        zones=zones, pods=[], scales={"cpu": 1.0, "memory": 1.0})


def aggregate_digest(nodes_per_option, unsched) -> str:
    """sha256 of an aggregate (decode=False) mesh answer's integer part:
    the nodes per option and the unschedulable count."""
    h = hashlib.sha256(np.ascontiguousarray(nodes_per_option,
                                            np.int64).tobytes())
    h.update(b"|")
    h.update(np.int64(unsched).tobytes())
    return h.hexdigest()


# The JAX package's answers on the sharded paths, on the CPU with 8 virtual
# devices (tests/test_torch_partitioned.py and tests/test_torch_sharded.py
# prove them; `python tests/test_torch_partitioned.py` prints them):
#   SHARDED_CELL: per round, `provision_signature`;
#   "megafleet-8x125k": solve_partitioned(megafleet_problem(8), 8 shards,
#     max_nodes_per_shard=MEGAFLEET_K) per mode — "aggregate" (decode=False:
#     aggregate_digest and the float32 psum'd cost), "decode" and "slab"
#     (device_decode=True): plan_digest and total_price;
#   "headline-sharded": solve_sharded(the headline problem, K =
#     HEADLINE_SHARDED_K) on make_pod_mesh(8) ("pods") and make_host_mesh(2,
#     4) ("hosts"), decode=False (aggregate_digest, cost) and decode=True
#     with the HEADLINE_EXISTING existing nodes (plan_digest, total_price).
# Integers are compared exactly; a float32 psum'd cost within relative 1e-6
# (the mesh sums in another order), every other total by ==.
GOLDEN_SHARDED: Dict[str, object] = {
    SHARDED_CELL: [
        dict(digest='4ece150e8a410748ea30b3bc8045081e'
             'ad60c0d24256f235e25ed8553525c54b',
             launched=4460, bound_new=50000, bound_existing=0,
             unschedulable=0, total_price=5538.2941999998175),
        dict(digest='2561a34104f2509280cefe1a74b69bec'
             'ab58793477e73a94de9d79062f099e0b',
             launched=2162, bound_new=18860, bound_existing=1140,
             unschedulable=0, total_price=2177.512199999971),
    ],
    "megafleet-8x125k": {
        "aggregate": ("b9e1e2a36fa9fe61f24273dcf37b575d"
                      "4394ccc1c168d6ae026d07cf38e089aa", 17384.310546875),
        "decode": ("7ab6eaacd642da454cec79f863fe0ef7"
                   "865486df8ea3979330af5bbd39461ddf", 17384.299800872803),
        "slab": ("7ab6eaacd642da454cec79f863fe0ef7"
                 "865486df8ea3979330af5bbd39461ddf", 17384.299800872803),
    },
    "headline-sharded": {
        ("pods", False): ("470ed7d3b4c924be19334623de11c08c"
                          "3957383fc8b394ef00a543a498018f9e",
                          4964.74462890625),
        ("pods", True): ("c5ab003a4503f8fc670010ca3400c1fb"
                         "ebb1aaa10971f8acdf7a9c7f572398b4",
                         4838.299500770867),
        ("hosts", False): ("470ed7d3b4c924be19334623de11c08c"
                           "3957383fc8b394ef00a543a498018f9e",
                           4964.74462890625),
        ("hosts", True): ("c5ab003a4503f8fc670010ca3400c1fb"
                          "ebb1aaa10971f8acdf7a9c7f572398b4",
                          4838.299500770867),
    },
}
MEGAFLEET_MODES = {"aggregate": dict(decode=False), "decode": {},
                   "slab": dict(device_decode=True)}
PSUM_RTOL = 1e-6


def sharded_answer(problem, res) -> Tuple[str, float]:
    """(digest, total) of a mesh solve's answer: `aggregate_digest` and the
    cost of an aggregate (cost, nodes_per_option, unsched) tuple, or
    `plan_digest` of a decoded PackingResult."""
    if isinstance(res, tuple):
        return aggregate_digest(res[1], res[2]), float(res[0])
    return plan_digest(problem, res)
