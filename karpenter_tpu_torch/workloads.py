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

`disruption_env` / `disruption_replay` build and drive the disruption
cell `disruption-replay-500` — BASELINE config 4 built through
`Provisioner.provision`, then carried out tick by tick (consolidation and
emptiness, drift with a rolled-back tick, expiration, spot interruption,
garbage collection) — from a namespace of either package's classes;
`disruption_tick` signs a tick by launch and batch positions, and
`GOLDEN_DISRUPTION` holds the JAX package's ticks
(tests/test_torch_disruption.py), which `chip_smoke.py` checks on the
card.

`GOLDEN_GUIDED` is the digest of the headline's default, LP-guided solve
(HiGHS restricted masters), and `lp_instance` / `GOLDEN_LP` are the
refinery-shaped LP instances of the reference bench's LP A/B
(`bench._lp_instance`) with their HiGHS objectives and device-master plan
totals, all as the JAX package computes them on the CPU
(tests/test_torch_lpguide.py).

The operator loop: `SIM_SOAK` is the cell `sim-long-soak-480`, the
long-soak scenario's firehose replayed by the simulator for 480 virtual
seconds, and `GOLDEN_SIM_SOAK` the JAX package's report of it
(`sim_digest`; tests/test_torch_sim_soak_golden.py); `SIM_DRIP` and
`GOLDEN_SIM_DRIP` are the same for `sim-steady-state-drip-480`
(tests/test_torch_sim_drip_golden.py).  `start_loop` runs a manager's
loop on a thread that keeps the exception it ends with.  `v1_solve_payload`
turns a pod batch into the Pod manifests of a `/v1/solve` request,
`V1_MANIFESTS` are the NodePool and NodeClass applied over `/v1/apply`
before it, and `GOLDEN_V1_SOLVE` is the JAX package's `/v1/solve` answer on
the headline (`v1_solve_digest`; tests/test_torch_v1_solve_golden.py).
`chip_smoke.py` checks both on the card.

The flight recorder and the SLO engine: `OBS_REPLAYS` are the gated sim
replays (chaos-storm and failover-drill with the FlightRecorder gate,
spot-reclaim-storm with the SLOEngine gate, then with both), `obs_replay`
runs one from a reset metric registry, and `obs_digest` fingerprints its
report.  The `tick_duration` SLI reads wall-clock reconcile time, so
`slo_wall_free` records its `bad`, `budget_remaining`, `burn.*`, `alerts`
and `alerting` by their comparisons' outcomes before the SLO reports are
hashed;
`without_obs` strips a gated report back to the ungated one.
`GOLDEN_INCIDENTS` and `GOLDEN_SLO` hold the JAX package's digests
(tests/test_torch_obs.py), which `chip_smoke.py` checks on the card.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

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


SWEEP_SIZES = (100, 250, 500)   # bench.run_lp_ab's class counts


def lp_duals(req, cnt, compat, alloc, price) -> Tuple[float, np.ndarray]:
    """(z, duals) of the class LP over `lp_operands`, by HiGHS: x over the
    compatible (class, option) pairs and n over the options,
    Σ_c req[c]·x[c,j] ≤ alloc[j]·n_j, Σ_j x[c,j] = cnt_c, min price·n.
    `duals` are the demand rows' marginals (scipy's eqlin), the duals
    ggbound's column generation prices its options under."""
    from scipy import sparse
    from scipy.optimize import linprog
    C, R = req.shape
    O = alloc.shape[0]
    pc, pj = np.nonzero(compat)
    P = len(pc)
    rows = np.concatenate([pj.repeat(R) * R + np.tile(np.arange(R), P),
                           np.arange(O * R)])
    cols = np.concatenate([np.arange(P).repeat(R), P + np.arange(O).repeat(R)])
    vals = np.concatenate([req[pc].ravel(), -alloc.ravel()])
    A_ub = sparse.csr_matrix((vals, (rows, cols)), shape=(O * R, P + O))
    A_eq = sparse.csr_matrix((np.ones(P), (pc, np.arange(P))),
                             shape=(C, P + O))
    res = linprog(np.concatenate([np.zeros(P), price]), A_ub=A_ub,
                  b_ub=np.zeros(O * R), A_eq=A_eq, b_eq=cnt,
                  bounds=(0, None), method="highs")
    if res.status != 0:
        raise RuntimeError(f"class LP: {res.message}")
    return float(res.fun), np.asarray(res.eqlin.marginals, np.float64)


def lp_pricing_jobs(req, compat, alloc, duals):
    """A copy of `bench._lp_pricing_jobs`: ggbound's pricing sweep for one
    dual vector, [(option j, classes idx, per-class caps ub)] — per
    candidate option, max Σ duals·z s.t. req·z ≤ alloc_j, 0 ≤ z ≤ ub."""
    jobs = []
    for j in range(alloc.shape[0]):
        idx = np.nonzero(compat[:, j] & (duals > 1e-9))[0]
        if len(idx) == 0:
            continue
        reqpos = req[idx] > 0
        safe = np.where(reqpos, req[idx], 1.0)
        ubj = np.where(reqpos, alloc[j][None, :] // safe, np.inf).min(axis=1)
        jobs.append((j, idx, ubj))
    return jobs


# tools/certify.py's default instance: 10 000 pods in 100 shapes (30% zone
# selectors) against generate_catalog(200), from default_rng(42)
CERTIFY_PODS = 10_000
CERTIFY_TYPES = 200
CERTIFY_SPECS = 100
CERTIFY_SEED = 42
CERTIFY_ZONE_FRAC = 0.3
CERTIFY_GG_ITERS = 1    # the column-generation rounds the card runs


def certify_problem():
    """The tensorized problem of tools/certify.py's defaults."""
    from .catalog.generate import generate_catalog
    from .ops.tensorize import tensorize
    pods = build_pods(CERTIFY_SPECS, CERTIFY_PODS,
                      np.random.default_rng(CERTIFY_SEED),
                      zone_frac=CERTIFY_ZONE_FRAC)
    return tensorize(pods, generate_catalog(CERTIFY_TYPES), [NodePool()])


# The JAX package's numbers on the CPU for `certify_problem()`: the
# default solve_classpack plan, class_lp_bound, and gg_bound after
# CERTIFY_GG_ITERS rounds warm-started from the plan (its HiGHS screen):
# `own` is the column generation's own value (gg_bound with no class LP
# under it: one round's Farley value, master / worst pricing ratio, below
# the class LP), `columns` its column pool, and `gg` the bound, the max of
# the class LP and `own`.  The plan rests on HiGHS's vertex, so the scipy
# version that made it is part of it.
GOLDEN_CERTIFY: Dict[str, object] = dict(
    plan_cost=679.8250003457069,
    nodes=1046,
    unschedulable=0,
    class_lp=639.4551721142284,
    own=252.7144361398449,
    gg=639.4551721142284,
    gg_iters=1,
    columns=714,
    scipy="1.17.0",
)


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


def ffd_native_args(arrays, K: int) -> dict:
    """`native.ffd_pack_native`'s arguments for one input of the scan K7
    (`ffd_kernels.ffd_scan`'s arguments as numpy arrays, as
    `ops/ffd.lower_ffd` or `ffd_scan_inputs` make them): the valid rows
    unpadded, the per-row compat of the O options and E pre-opened slots,
    and the scan's K, so both packers fill the same slots.  The valid rows
    must be a prefix (the native packer has no invalid rows)."""
    (req, packed, crow, cid, valid, cap, rem, alloc, price, rank, iopt,
     iused) = arrays
    P = int(valid.sum())
    if not valid[:P].all():
        raise ValueError("the scan input's valid rows are not a prefix")
    E = int((iopt >= 0).sum())
    O = int(iopt[0]) if E else alloc.shape[0]
    compat = np.unpackbits(packed, axis=1, count=alloc.shape[0]).astype(
        bool)[crow[:P], :O + E]
    return dict(requests=req[:P], compat=compat, class_ids=cid[:P],
                caps=cap[:P], alloc=alloc[:O + E], price=price[:O + E],
                rank=rank[:O + E], existing_used=iused[:E] if E else None,
                O=O, E=E, K=K)


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
                  NodePool, catalog, arena: bool = False,
                  **extra) -> ProvisionEnv:
    """FakeCloud → CloudProvider(catalog) → Cluster → Provisioner with the
    cell's options (plus `extra`, e.g. the port's `device` or a
    SolverHealth), one default NodePool.  With `arena` the cluster gets its
    persistent delta arena (`Cluster.attach_arena`, the operator's
    IncrementalArena gate) before any pod arrives."""
    opts, _ = PROVISION_CELLS[cell]
    cloud = FakeCloud()
    provider = CloudProvider(cloud, catalog)
    cluster = Cluster()
    if arena:
        cluster.attach_arena()
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


# ---------------------------------------------------------------------------
# the disruption cell: BASELINE config 4 carried out, tick by tick
# ---------------------------------------------------------------------------

DISRUPTION_CELL = "disruption-replay-500"
DISRUPTION_PODS = 2590             # bench.run_consolidation_replay's n_pods
DISRUPTION_SEED = 3                # ... its generator seed
DISRUPTION_TYPES = 200             # ... its n_types
DISRUPTION_LAUNCH_T = 1000.0       # the clock while the fleet is built
DISRUPTION_START_T = DISRUPTION_LAUNCH_T + 10_000.0   # the first tick
DISRUPTION_TICK_S = 30.0           # the clock's step after every tick
CONSOLIDATION_TICKS = 12           # phase (a): until a tick takes no action
DRIFT_TICKS = 3                    # phase (b): the middle one is ICE'd
EXPIRATION_TICKS = 2               # phase (c)
EXPIRE_AFTER_S = 3600.0            # phase (c): the pool's expire_after_s
INTERRUPTED_SPOT = 8               # phase (d): spot instances reclaimed
GC_STEP_S = 60.0                   # phase (e): past the 30 s grace period
DRIFT_USER_DATA = "drift-v2"       # phase (b): the NodeClass's new spec

class SteppedClock:
    """A fake clock the cell steps by hand."""

    def __init__(self, t: float):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def step(self, dt: float) -> None:
        self.t += dt


def port_kit():
    """The port's classes for `disruption_env`."""
    from types import SimpleNamespace
    from .cloud import (CloudProvider, FakeCloud, FakeQueue, FleetOverride,
                        UnavailableOfferings)
    from .controllers import (DisruptionController,
                              GarbageCollectionController,
                              InterruptionController, Provisioner,
                              TerminationController)
    from .state.cluster import Cluster
    return SimpleNamespace(
        FakeQueue=FakeQueue, FakeCloud=FakeCloud, FleetOverride=FleetOverride,
        CloudProvider=CloudProvider,
        UnavailableOfferings=UnavailableOfferings, Cluster=Cluster,
        Provisioner=Provisioner, TerminationController=TerminationController,
        DisruptionController=DisruptionController,
        InterruptionController=InterruptionController,
        GarbageCollectionController=GarbageCollectionController,
        NodePool=NodePool, Pod=Pod, ResourceList=ResourceList)


@dataclass
class DisruptionEnv:
    """The objects of the disruption cell, built by `disruption_env`.
    `pods` is the batch in creation order (a pod's position is its
    identity); `launch_index` numbers every node the cell has seen in
    launch order (`index_nodes`)."""
    clock: SteppedClock
    queue: object
    cloud: object
    provider: object
    cluster: object
    provisioner: object
    terminator: object
    disruption: object
    interruption: object
    gc: object
    pool: object
    pods: List
    kit: object
    launch_index: Dict[str, int]


def index_nodes(env: DisruptionEnv) -> None:
    """Give every node not seen yet the next launch position (the cluster's
    dict keeps registration order)."""
    for name in env.cluster.nodes:
        if name not in env.launch_index:
            env.launch_index[name] = len(env.launch_index)


def disruption_env(kit, catalog, n_pods: int = DISRUPTION_PODS,
                   seed: int = DISRUPTION_SEED, arena: bool = False,
                   **extra) -> DisruptionEnv:
    """The disruption cell's fleet from `kit`, a namespace of one
    package's classes (FakeQueue, FakeCloud, FleetOverride, CloudProvider,
    UnavailableOfferings, Cluster, Provisioner, TerminationController,
    DisruptionController, InterruptionController,
    GarbageCollectionController, NodePool, Pod, ResourceList: `port_kit()`
    gives the port's), built as `bench.run_consolidation_replay`
    builds BASELINE config 4 (after karpenter's deprovisioning scale suite,
    test/suites/scale/deprovisioning_test.go:325-428): `n_pods` pods of cpu
    1500-2599m and memory 2-4 GiB drawn from rng(`seed`), provisioned by
    `Provisioner.provision()` on a FakeCloud (every node a running
    instance), then each pod deleted with probability 0.72.  The clock is
    a `SteppedClock` at `DISRUPTION_LAUNCH_T` during the build and 10 000 s
    later after it; the ICE cache runs on it too.  A TerminationController
    is wired into the DisruptionController and the InterruptionController
    (whose queue the cloud publishes to), beside a
    GarbageCollectionController.  With `arena` the cluster gets its
    persistent delta arena before the fleet is built, so every gather of
    the build and of the ticks may be served from its slab.  `extra` goes
    to the Provisioner and the DisruptionController (the port's
    `device`)."""
    clock = SteppedClock(DISRUPTION_LAUNCH_T)
    queue = kit.FakeQueue(clock)
    cloud = kit.FakeCloud(clock, queue=queue)
    provider = kit.CloudProvider(
        cloud, catalog, unavailable=kit.UnavailableOfferings(clock=clock),
        clock=clock)
    cluster = kit.Cluster(clock)
    if arena:
        cluster.attach_arena()
    pool = kit.NodePool()
    prov = kit.Provisioner(provider, cluster, [pool], clock=clock, **extra)
    rng = np.random.default_rng(seed)
    pods = [kit.Pod(name=f"pod-{i:05d}", uid=f"pod-{i:05d}",
                    requests=kit.ResourceList(
                        {CPU: int(rng.integers(1500, 2600)),
                         MEMORY: int(rng.integers(2, 5)) * 2**30}))
            for i in range(n_pods)]
    cluster.add_pods(pods)
    prov.provision()
    for p in pods:
        if rng.random() < CONSOLIDATION_SCALE_DOWN:
            cluster.delete_pod(p)
    clock.t = DISRUPTION_START_T
    term = kit.TerminationController(provider, cluster, clock=clock)
    ctrl = kit.DisruptionController(provider, cluster, [pool], clock=clock,
                                    terminator=term, **extra)
    intr = kit.InterruptionController(queue, provider, cluster, term,
                                      clock=clock)
    gc = kit.GarbageCollectionController(provider, cluster, clock=clock)
    env = DisruptionEnv(clock, queue, cloud, provider, cluster, prov, term,
                        ctrl, intr, gc, pool, pods, kit, {})
    index_nodes(env)
    return env


def _running(env: DisruptionEnv) -> Tuple[int, float]:
    """(running instances, their $/h summed in launch order)."""
    total = 0.0
    insts = env.cloud.running()
    for inst in insts:
        total += inst.price
    return len(insts), total


def fleet_state(env: DisruptionEnv):
    """What a rolled-back tick must leave as it found it: every node with
    its deletion mark, taints and pods, and the running instances."""
    nodes = [(n.name, n.marked_for_deletion,
              [(t.key, t.effect, t.value) for t in n.taints],
              [p.uid for p in n.pods]) for n in env.cluster.nodes.values()]
    return nodes, [i.id for i in env.cloud.running()]


def _moves(env: DisruptionEnv, before: List[str], nodes_before) -> Dict:
    """Counts and digest of the batch pods whose node changed: rebound to
    a node that existed before (a survivor), bound to a new node, or
    unbound; each move as (batch position, node launch position or -1)."""
    moves, survivors, new = [], 0, 0
    for i, p in enumerate(env.pods):
        if p.node_name == before[i]:
            continue
        if p.node_name:
            if p.node_name in nodes_before:
                survivors += 1
            else:
                new += 1
        moves.append([i, env.launch_index.get(p.node_name, -1)])
    digest = hashlib.sha256(json.dumps(moves).encode()).hexdigest()
    return dict(rebound=survivors, bound_new=new, moved=digest)


def disruption_tick(env: DisruptionEnv, phase: str,
                    step: float = DISRUPTION_TICK_S) -> Tuple[Dict, object]:
    """One `DisruptionController.reconcile()`, then the clock's `step`.
    Returns (the tick's signature, the DisruptionResult).  The signature
    names nodes by launch position and pods by batch position: the
    action's kind and reason, its candidates, the launched claims (type,
    zone, capacity type) in launch order, the counts deleted / rebound to
    survivors / bound to new nodes / pending, the moves' digest, the
    running instances and their $/h summed in launch order, and whether
    the tick returned an error."""
    index_nodes(env)
    before = [p.node_name for p in env.pods]
    nodes_before = set(env.cluster.nodes)
    res = env.disruption.reconcile()
    index_nodes(env)
    action = res.action
    running, price = _running(env)
    sig = dict(
        phase=phase,
        action=None if action is None else [action.kind, action.reason],
        candidates=[] if action is None else
        [env.launch_index[c.name] for c in action.candidates],
        launched=[[c.instance_type, c.zone, c.capacity_type]
                  for c in res.launched],
        deleted=len(res.deleted),
        pending=len(env.cluster.pending_pods()),
        running=running, price=price, error=bool(res.error))
    sig.update(_moves(env, before, nodes_before))
    env.clock.step(step)
    return sig, res


def _ice_everything(env: DisruptionEnv) -> None:
    for it in env.provider.instance_types.base_catalog:
        for o in it.offerings:
            env.cloud.insufficient_capacity_pools.add(
                (o.capacity_type, it.name, o.zone))


def disruption_replay(env: DisruptionEnv,
                      tick: Callable = disruption_tick) -> List[Dict]:
    """The cell's five phases; returns one signature per tick (`tick`
    runs a tick, `disruption_tick` by default, so a caller can time it):

      (a) consolidation and emptiness: reconcile until a tick takes no
          action, at most CONSOLIDATION_TICKS ticks;
      (b) drift: the default NodeClass's spec changes (its static hash with
          it), then DRIFT_TICKS ticks; before the middle one every
          (type, zone, capacity type) pool of the cloud is ICE'd, so a
          replacement launch fails and rolls back (`kept`: the fleet is as
          before the tick), and the marks are cleared after it;
      (c) expiration: the pool's expire_after_s, EXPIRATION_TICKS ticks;
      (d) spot interruption: the first INTERRUPTED_SPOT spot instances in
          launch order are interrupted, `InterruptionController.reconcile()`
          drains them, and `provision()` re-places the evicted pods (its
          `provision_signature` is part of the tick);
      (e) garbage collection: one tagged instance launched straight through
          `create_fleet`, the clock stepped past the grace period, GC."""
    sigs: List[Dict] = []
    for _ in range(CONSOLIDATION_TICKS):
        sig, _ = tick(env, "consolidation")
        sigs.append(sig)
        if sig["action"] is None:
            break

    nc = env.provider.node_classes["default"]
    nc.user_data = DRIFT_USER_DATA
    nc.hash_annotation = ""
    for t in range(DRIFT_TICKS):
        iced = t == DRIFT_TICKS // 2
        if iced:
            _ice_everything(env)
            state = fleet_state(env)
        sig, _ = tick(env, "drift")
        if iced:
            sig["kept"] = fleet_state(env) == state
            env.cloud.insufficient_capacity_pools.clear()
        sigs.append(sig)

    env.pool.disruption.expire_after_s = EXPIRE_AFTER_S
    for _ in range(EXPIRATION_TICKS):
        sig, _ = tick(env, "expiration")
        sigs.append(sig)

    spot = [i for i in env.cloud.running()
            if i.capacity_type == wk.CAPACITY_TYPE_SPOT][:INTERRUPTED_SPOT]
    by_pid = {n.provider_id: n.name for n in env.cluster.nodes.values()}
    for inst in spot:
        env.cloud.interrupt(inst.id)
    ires = env.interruption.reconcile()
    prov_sig, _ = provision_pending(env)
    index_nodes(env)
    running, price = _running(env)
    sigs.append(dict(
        phase="interruption",
        interrupted=[env.launch_index[by_pid[i.id]] for i in spot],
        received=ires.received, handled=dict(sorted(ires.handled.items())),
        recycled=[env.launch_index[n] for n in ires.recycled],
        deleted_messages=ires.deleted_messages, provision=prov_sig,
        pending=len(env.cluster.pending_pods()), running=running,
        price=price))
    env.clock.step(DISRUPTION_TICK_S)

    it = env.provider.instance_types.base_catalog[0]
    o = it.offerings[0]
    env.cloud.create_fleet(
        [env.kit.FleetOverride(it.name, o.zone, o.capacity_type, o.price)],
        tags={"karpenter.sh/cluster": env.provider.cluster_name})
    early = env.gc.reconcile()
    env.clock.step(GC_STEP_S)
    gres = env.gc.reconcile()
    running, price = _running(env)
    sigs.append(dict(
        phase="gc", early=len(early.leaked_instances),
        leaked=len(gres.leaked_instances),
        orphaned=len(gres.orphaned_nodes), running=running, price=price))
    return sigs


def disruption_digests(sigs: List[Dict]) -> List[Dict]:
    """The cell's ticks as `GOLDEN_DISRUPTION` holds them: per tick the
    phase, the action, the launch and delete counts, the running instances
    and their $/h (compared with ==), and the sha256 of the whole
    signature."""
    out = []
    for sig in sigs:
        out.append(dict(
            phase=sig["phase"], action=sig.get("action"),
            launched=len(sig.get("launched", ())),
            deleted=sig.get("deleted", 0), running=sig["running"],
            price=sig["price"],
            digest=hashlib.sha256(json.dumps(
                sig, sort_keys=True).encode()).hexdigest()))
    return out

# `disruption_digests` of `disruption_replay(disruption_env(...))` on the
# JAX package, on the CPU: thirteen ticks (phase (a) stops at its sixth,
# the first without an action; phase (b)'s middle tick rolls back)
GOLDEN_DISRUPTION: List[Dict] = [
    dict(phase='consolidation', action=['delete', 'emptiness'], launched=0,
         deleted=100, running=404, price=65.36120000000017,
         digest='92334b885f7705128aea84dfcaec052b'
                'd4dfe8d3eaf79759025eeace91dae939'),
    dict(phase='consolidation', action=['delete', 'emptiness'], launched=0,
         deleted=100, running=304, price=63.88120000000005,
         digest='9e1f2264685a2645a4df5ecb4db933d8'
                'c5f09278917cb2e7b76e70939d3f842e'),
    dict(phase='consolidation', action=['delete', 'emptiness'], launched=0,
         deleted=90, running=214, price=62.1238000000001,
         digest='da1dbd3c5650d16a084d2f2c6f1fb780'
                'e1f03274111b2723dc9c13c424f57b82'),
    dict(phase='consolidation', action=['delete', 'consolidation'], launched=0,
         deleted=100, running=114, price=60.58560000000009,
         digest='06204de1997905570e755149b8c75b18'
                '58da9ff7ce052afc2929486a749a96c9'),
    dict(phase='consolidation', action=['delete', 'consolidation'], launched=0,
         deleted=81, running=33, price=20.232299999999988,
         digest='44dbce9388ea5f3eb27ea9f1b0e8c52a'
                '046890c3673f66ddc789d4bdcdcb5419'),
    dict(phase='consolidation', action=None, launched=0,
         deleted=0, running=33, price=20.232299999999988,
         digest='c198b8eb4d1b0270bd4a50fb3c6b71df'
                '53274f3c1f77030c30e01fa6a1099cb9'),
    dict(phase='drift', action=['replace', 'drift'], launched=14,
         deleted=1, running=46, price=20.356500000000004,
         digest='848736295767c6a68d449e1b27ccb21d'
                '56985666109e9e3e5037e4fca7b837c3'),
    dict(phase='drift', action=['replace', 'drift'], launched=0,
         deleted=0, running=46, price=20.356500000000004,
         digest='e7da033925f4e1e8f6ad4e2729f32e79'
                '5bf49abd7e8c2ec316099c1e2e9f5d44'),
    dict(phase='drift', action=['replace', 'drift'], launched=15,
         deleted=1, running=60, price=21.49639999999999,
         digest='c554b2591ddabba6f03659054174cfff'
                'c89b44bf5c59eaf76aa035f022480888'),
    dict(phase='expiration', action=['replace', 'expiration'], launched=22,
         deleted=1, running=81, price=21.585700000000006,
         digest='d239958894a004eb6ed530ecf5e2f538'
                '328d1debb227c18632cb0b0b2f1d4597'),
    dict(phase='expiration', action=['replace', 'expiration'], launched=20,
         deleted=1, running=100, price=21.961000000000013,
         digest='121aa85c36e809777b51f886eefa4dbe'
                '8be7f33b1b506d7ae6b1f2ab12d6399d'),
    dict(phase='interruption', action=None, launched=0,
         deleted=0, running=224, price=28.14839999999995,
         digest='acac283da2c5843e9065dabfde1834eb'
                '5f75112d9c22e6d9ce900dcbc99d97e9'),
    dict(phase='gc', action=None, launched=0,
         deleted=0, running=224, price=28.14839999999995,
         digest='5672d1d3abde39b23ed5a6129b320495'
                '3d565aab22b529d96754f601a109dd6a'),
]


# ---------------------------------------------------------------------------
# the operator cell: the default Operator, its controllers, the live bursts
# ---------------------------------------------------------------------------

OPERATOR_CELL = "operator-live-50k-20k"
OPERATOR_LAUNCH_T = 1000.0          # the stepped clock through both rounds
OPERATOR_TICK_AFTER_S = 10_000.0    # the disruption tick: this long after
# the live cell's two bursts, in order
OPERATOR_ROUNDS = [(HEADLINE, HEADLINE_SEED),
                   (PROVISION_ROUND2, PROVISION_ROUND2_SEED)]
OPERATOR_IP_COUNT = 8187            # free IPs of a /19 subnet
OPERATOR_K8S_VERSION = "1.28"       # FakeControlPlane's default version


@dataclass
class OperatorEnv:
    """The operator cell's objects: the stepped clock, the Operator and
    its controllers (`build_controllers`)."""
    clock: SteppedClock
    op: object
    controllers: Dict[str, object]

    def provision_env(self) -> ProvisionEnv:
        return ProvisionEnv(self.op.cloud, self.op.cloud_provider,
                            self.op.cluster,
                            self.controllers["provisioning"])


def seed_operator_cloud(op, SubnetInfo, SecurityGroupInfo, ImageInfo,
                        zones=("zone-a", "zone-b", "zone-c")) -> None:
    """The inventory a fresh fake cloud lacks for an operator to launch
    into: one /19 subnet a zone of the catalog, a node security group, and
    an image a CPU architecture published under the standard family's
    parameter path for the control plane's version (the launch path
    resolves images through it and keeps only the types an image
    covers)."""
    cluster = op.options.cluster_name
    op.cloud.subnets = [SubnetInfo(f"subnet-{z}", z, OPERATOR_IP_COUNT,
                                   {"karpenter.sh/discovery": cluster})
                        for z in zones]
    op.cloud.security_groups = [SecurityGroupInfo(
        "sg-nodes", "nodes", {"karpenter.sh/discovery": cluster})]
    op.cloud.images = [ImageInfo(f"img-standard-{arch}", f"standard-{arch}",
                                 arch, 1.0) for arch in ("amd64", "arm64")]
    op.params.parameters = {
        f"/karpenter-tpu/images/standard/{OPERATOR_K8S_VERSION}/{arch}/"
        f"latest": f"img-standard-{arch}" for arch in ("amd64", "arm64")}


def operator_env(kit, catalog=None, **extra) -> OperatorEnv:
    """The operator cell from `kit`, a namespace of one package's Operator,
    Options, build_controllers, SubnetInfo, SecurityGroupInfo and
    ImageInfo: `Operator(Options(), clock=<stepped clock>, **extra)` with
    its default `generate_catalog(600)` (full width), its fake cloud
    seeded by `seed_operator_cloud`, `build_controllers(op)`, and one
    NodeClassController reconcile of the default NodeClass (its resolved
    status and static hash, as the operator's first tick writes them).
    `catalog` replaces the default catalog (a test's smaller one); `extra`
    is the port's `device`."""
    clock = SteppedClock(OPERATOR_LAUNCH_T)
    if catalog is not None:
        extra["catalog"] = catalog
    op = kit.Operator(kit.Options(), clock=clock, **extra)
    seed_operator_cloud(op, kit.SubnetInfo, kit.SecurityGroupInfo,
                        kit.ImageInfo)
    ctrls = kit.build_controllers(op)
    ctrls["nodeclass"].reconcile(op.node_classes["default"])
    return OperatorEnv(clock, op, ctrls)


def operator_tick_signature(nodes_before, res) -> Dict:
    """A disruption reconcile of the operator cell by launch position: the
    action's kind and reason, its candidates, the launched claims' types
    (sorted), the deleted count and whether the tick returned an error."""
    launch_index = {name: i for i, name in enumerate(nodes_before)}
    action = res.action
    return dict(
        action=None if action is None else [action.kind, action.reason],
        candidates=[] if action is None else
        [launch_index[c.name] for c in action.candidates],
        launched=sorted(c.instance_type for c in res.launched),
        deleted=len(res.deleted), error=bool(res.error))


def operator_replay(env: OperatorEnv, build_pods: Callable,
                    provision: Callable = provision_pending,
                    tick: Optional[Callable] = None,
                    rounds=OPERATOR_ROUNDS) -> Dict:
    """The operator cell: each of `rounds`' bursts (OPERATOR_ROUNDS; built by
    `build_pods`, the bench's or this module's) added to the operator's
    cluster and provisioned by its Provisioner (`provision`, by default
    `provision_pending`, so a caller can time it), then one reconcile of
    its DisruptionController `OPERATOR_TICK_AFTER_S` after the launches
    (`tick()` runs it, by default `reconcile()`).  Returns the provisioning
    signatures by round and the tick's signature."""
    penv = env.provision_env()
    sigs = []
    for kw, seed in rounds:
        env.op.cluster.add_pods(build_pods(rng=np.random.default_rng(seed),
                                           **kw))
        sig, _ = provision(penv)
        sigs.append(sig)
    env.clock.t = OPERATOR_LAUNCH_T + OPERATOR_TICK_AFTER_S
    before = list(env.op.cluster.nodes)
    res = (tick or env.controllers["disruption"].reconcile)()
    return dict(rounds=sigs, tick=operator_tick_signature(before, res))

# `operator_replay(operator_env(...))` on the JAX package, on the CPU
# (tests/test_torch_operator_golden.py): the live cell's two rounds (the
# same signatures as GOLDEN_PROVISION's, the operator's DeviceDecode gate
# being off) and a disruption tick that takes no action
GOLDEN_OPERATOR: Dict[str, object] = dict(
    rounds=[
        dict(digest='4b393cd16d0177a0627c09879252a9fc'
             '1416388a9ad1f47938991f0ab2819369',
             launched=1463, bound_new=50000, bound_existing=0,
             unschedulable=0, total_price=4651.988099999959),
        dict(digest='6c4f1c8ac5426614754afd04b6c50e71'
             'd3fa6c4cc0a73d42dcadf8096ec70046',
             launched=585, bound_new=11519, bound_existing=718,
             unschedulable=7763, total_price=2029.3209999999995),
    ],
    tick=dict(action=None, candidates=[], launched=[], deleted=0,
              error=False),
)

# the operator cell at a tenth of its depth (full width): both bursts'
# totals divided by OPERATOR_SMALL_SCALE (5000 + 2000 pods).  The full
# cell's 2048 launches each wait out the CreateFleet batcher's 35 ms idle
# window in turn; `chip_smoke.py` phases 14(c) and 18(b) replay this copy
OPERATOR_SMALL_SCALE = 10
OPERATOR_SMALL_ROUNDS = [(dict(kw, total=kw["total"] // OPERATOR_SMALL_SCALE),
                          seed) for kw, seed in OPERATOR_ROUNDS]

# `operator_replay(operator_env(...), rounds=OPERATOR_SMALL_ROUNDS)` on the
# JAX package, on the CPU (tests/test_torch_operator_small.py): its tick
# deletes one node for consolidation
GOLDEN_OPERATOR_SMALL: Dict[str, object] = dict(
    rounds=[
        dict(digest='d5c6d44114e0085b539d6c83168c1ca0'
             '3b572b443415dd26c78be36b8813556a',
             launched=200, bound_new=5000, bound_existing=0,
             unschedulable=0, total_price=480.88880000000097),
        dict(digest='ab66be728306440bd0812ec145ed2a04'
             'bc95683882c65b3a4b8c4c91199d25f8',
             launched=180, bound_new=1866, bound_existing=134,
             unschedulable=0, total_price=276.43789999999996),
    ],
    tick=dict(action=['delete', 'consolidation'], candidates=[355],
              launched=[], deleted=1, error=False),
)


# ---------------------------------------------------------------------------
# The operator loop: the simulator's soak cell and the /v1 surface
# ---------------------------------------------------------------------------

# the cell sim-long-soak-480: scenarios/long-soak.yaml at seed 0 for 480
# virtual seconds (the golden of tests/golden/ pins its first 120)
SIM_SOAK = dict(scenario="long-soak.yaml", seed=0, duration_s=480.0)
# the cell sim-steady-state-drip-480: scenarios/steady-state-drip.yaml at
# seed 0 for 480 virtual seconds (the golden of tests/golden/ pins its
# first 300, in which no consolidation sweep runs)
SIM_DRIP = dict(scenario="steady-state-drip.yaml", seed=0, duration_s=480.0)


def sim_digest(report: Dict) -> Dict[str, object]:
    """A simulator report (either package's) as the goldens hold it: the
    sha256 of its canonical JSON (`sim.report_to_json`) and the counts a
    reader checks first."""
    from .sim.report import report_to_json
    doc = report_to_json(report)
    return dict(sha256=hashlib.sha256(doc.encode()).hexdigest(),
                pods_arrived=report["workload"]["pods_arrived"],
                pods_bound=report["workload"]["pods_bound"],
                nodes_launched=report["churn"]["nodes_launched"],
                nodes_running_at_end=report["churn"]["nodes_running_at_end"],
                events=report["events"]["total"],
                tick_exceptions=report["errors"]["tick_exceptions"])


# the NodePool and the NodeClass a /v1 client applies before it solves:
# the defaults, relabelled and retagged, so the read-back shows them
V1_MANIFESTS = [
    {"apiVersion": "karpenter.tpu/v1beta1", "kind": "NodePool",
     "metadata": {"name": "default"},
     "spec": {"template": {"metadata": {"labels": {"team": "v1"}},
                           "spec": {"nodeClassRef": {"name": "default"}}},
              "disruption": {"consolidationPolicy": "WhenUnderutilized",
                             "expireAfter": "Never"},
              "weight": 0}},
    {"apiVersion": "karpenter.tpu/v1beta1", "kind": "NodeClass",
     "metadata": {"name": "default"},
     "spec": {"imageFamily": "standard", "tags": {"team": "v1"}}},
]


# the command line of the /v1 cell's operators: the endpoints on a free port
V1_ARGV = ["--metrics-port", "0"]
# the burst the first operator launches before the restart (build_pods'
# arguments, seed): its nodes are what the restarted operator hydrates
V1_FLEET = (dict(HEADLINE, spec_count=30, total=600), 7)


def v1_manager(kit, build_pods: Callable, **extra):
    """The /v1 cell's manager from `kit`, a namespace of one package's
    Operator, Options, build_controllers, ControllerManager, SubnetInfo,
    SecurityGroupInfo and ImageInfo.  A first default operator,
    `Operator(Options.from_args(V1_ARGV), **extra)` (its full-width
    `generate_catalog(600)` unless `extra` names a catalog; the port's
    `device`) over a seeded cloud (`seed_operator_cloud`), provisions the
    V1_FLEET burst (built by `build_pods`, the bench's or this module's);
    then a second one over the same cloud — a restart — hydrates that
    fleet, and its `ControllerManager` walks `startup()`, whose parity
    probe gathers the hydrated nodes from the arena."""
    first = kit.Operator(kit.Options.from_args(V1_ARGV), **extra)
    seed_operator_cloud(first, kit.SubnetInfo, kit.SecurityGroupInfo,
                        kit.ImageInfo)
    ctrls = kit.build_controllers(first)
    ctrls["nodeclass"].reconcile(first.node_classes["default"])
    kw, seed = V1_FLEET
    first.cluster.add_pods(build_pods(rng=np.random.default_rng(seed), **kw))
    ctrls["provisioning"].provision()
    extra["catalog"] = first.catalog
    op = kit.Operator(kit.Options.from_args(V1_ARGV), cloud=first.cloud,
                      params=first.params, **extra)
    mgr = kit.ControllerManager(op, kit.build_controllers(op))
    mgr.startup()
    return mgr


def start_loop(mgr, tick_seconds: float = 0.05):
    """`mgr.run(tick_seconds)` on a thread of its own.  Returns (the
    thread, a list that receives the exception the loop ends with, a lock
    that holds the loop between ticks while it is held).  A tick that
    raises ends `run` (a `DEVICE_FAULTS` fault is never booked on a
    supervisor), so a caller checks the list after `join`; holding the lock
    keeps the loop's ticks out of what the caller runs meanwhile."""
    import threading
    errors: List[BaseException] = []
    pause, tick = threading.Lock(), mgr.tick

    def paused_tick():
        with pause:
            return tick()
    mgr.tick = paused_tick

    def loop():
        try:
            mgr.run(tick_seconds=tick_seconds)
        except BaseException as e:  # kept for the caller, never swallowed
            errors.append(e)
    thread = threading.Thread(target=loop, name="manager-loop", daemon=True)
    thread.start()
    return thread, errors, pause


def http_json(port: int, path: str, payload=None, timeout: float = 600.0):
    """GET (no payload) or POST (JSON payload) `path` on 127.0.0.1:`port`:
    (status, decoded JSON body)."""
    import urllib.error
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def pod_manifest(pod, name: str) -> Dict:
    """A Pod manifest of `pod` (either package's Pod, as `build_pods` makes
    them: requests, a node selector, tolerations) named `name`."""
    requests = {k: (f"{v}m" if k == CPU else str(v))
                for k, v in sorted(pod.requests.items())}
    spec: Dict = {"containers": [{"name": "app",
                                  "resources": {"requests": requests}}]}
    if pod.node_selector:
        spec["nodeSelector"] = dict(pod.node_selector)
    if pod.tolerations:
        spec["tolerations"] = [
            {k: v for k, v in (("key", t.key), ("operator", t.operator),
                               ("value", t.value), ("effect", t.effect))
             if v} for t in pod.tolerations]
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "default"},
            "spec": spec}


def v1_solve_payload(pods) -> Dict:
    """A /v1/solve request for `pods`: their manifests, named by position,
    for new capacity only (`scheduleOnExisting` false): the restarted
    operator's hydrated nodes are empty (pods live in the cluster API, not
    in the cloud), and its running loop may consolidate them at any tick,
    so packing onto them would make the answer depend on when it came."""
    return {"pods": [pod_manifest(p, f"pod-{i:05d}")
                     for i, p in enumerate(pods)],
            "scheduleOnExisting": False}


def v1_solve_digest(resp: Dict) -> Dict[str, object]:
    """A /v1/solve answer as the goldens hold it: the node count, the
    price, the counts of its other lists, and the sha256 of the whole
    answer in canonical JSON (its pod names are positions already)."""
    doc = json.dumps(resp, sort_keys=True, separators=(",", ":"))
    return dict(nodes=len(resp["nodes"]),
                total_price=resp["totalPricePerHour"],
                bound_existing=len(resp["boundToExisting"]),
                unschedulable=len(resp["unschedulable"]),
                deferred=len(resp["deferred"]),
                sha256=hashlib.sha256(doc.encode()).hexdigest())

# `sim_digest` of the JAX package's SimHarness on SIM_SOAK, on the CPU
# (tests/test_torch_sim_soak_golden.py)
GOLDEN_SIM_SOAK: Dict[str, object] = dict(
    sha256='b20bb194a3a87f50153eaa9d2339c8c4'
           'cc1facff58f1be40ce833a18d635f6ae',
    pods_arrived=3408, pods_bound=3408, nodes_launched=287,
    nodes_running_at_end=143, events=797, tick_exceptions=0)

# `sim_digest` of the JAX package's SimHarness on SIM_DRIP, on the CPU
# (tests/test_torch_sim_drip_golden.py)
GOLDEN_SIM_DRIP: Dict[str, object] = dict(
    sha256='ccd5a5ba3f09c9f45b87ebc973e115de'
           '0c48393070c141218eb5d1e47a1c451c',
    pods_arrived=43, pods_bound=43, nodes_launched=32,
    nodes_running_at_end=32, events=7, tick_exceptions=0)

# `v1_solve_digest` of the JAX package's /v1/solve on the headline (HEADLINE
# pods at seed 0 as `v1_solve_payload`), after V1_MANIFESTS were applied to
# its restarted operator (`v1_manager`), on the CPU
# (tests/test_torch_v1_solve_golden.py)
GOLDEN_V1_SOLVE: Dict[str, object] = dict(
    nodes=1463, total_price=4653.4901, bound_existing=0, unschedulable=0,
    deferred=0,
    sha256='6f6af742d2386c63e50542812acd01d0'
           '93e384bde892ecfced2340d3e2dc3fe1')


# ---------------------------------------------------------------------------
# The gang cell: Provisioner(gang_scheduling=True) at full width
# ---------------------------------------------------------------------------

GANG_CELL = "provision-gang-50k"
GANG_SEED = 14                     # the draw of the gang members
GANG_LAUNCH_T = 1000.0             # the stepped clock through the rounds
GANG_TICK_AFTER_S = 600.0          # the disruption tick: this long after
# slots a round: a gang's members are classes of their own, so the guided
# round 1 opens more nodes than the live cell's 1463 (with the default
# 2048 it runs out of slots and leaves half the burst pending)
GANG_MAX_NODES = 8192
# round 1: of the headline's 50 000 pods, 1024 gangs of 4 (tier 1, zone
# topology), and 64 gangs that declare 4 members and bring 3
GANG_R1 = dict(gangs=1024, size=4, tier=1, topology="zone", short=64)
# beside them, GANG_R1_SPLIT more gangs of 4 (tier 1, zone topology) pin
# members 0-1 and 2-3 to two zones (a zone straddle, which eviction cannot
# mend), and GANG_R1_HUGE gangs of 4 at tier 0 carry one member no
# instance type holds (a partial placement; tier 0 outranks nobody)
GANG_R1_SPLIT = dict(gangs=4, size=4, tier=1, topology="zone", short=0)
GANG_R1_HUGE = dict(gangs=4, size=4, tier=0, topology="zone", short=0)
GANG_HUGE_CPU_M = 10_000_000
# round 2: of PROVISION_ROUND2's 20 000 pods, 256 gangs of 8 (tier 2,
# hostname topology) whose members each request GANG_R2_MEMBER: a gang of
# 48 vCPU fits one node, yet a third of them land on two (a straddle, with
# a preemption plan)
GANG_R2 = dict(gangs=256, size=8, tier=2, topology="hostname", short=0)
GANG_R2_MEMBER = dict(cpu_m=6000, mem_gib=12)
# the CPU tests' copy: bursts and gang counts divided by this (5000 + 2000
# pods, 102 + 25 gangs, 6 short ones)
GANG_SMALL_SCALE = 10


def _form_gangs(pods, pick: List[int], prefix: str, gangs: int, size: int,
                tier: int, topology: str, short: int) -> List[list]:
    """Turn `gangs` runs of `size` of the pod positions `pick` and then
    `short` runs of `size - 1` into gangs named `<prefix>-g<i>`, in place;
    returns the gangs' members."""
    runs = [pick[i * size:(i + 1) * size] for i in range(gangs)]
    at = gangs * size
    runs += [pick[at + i * (size - 1):at + (i + 1) * (size - 1)]
             for i in range(short)]
    out = []
    for gi, members in enumerate(runs):
        for i in members:
            p = pods[i]
            p.gang_name = f"{prefix}-g{gi:04d}"
            p.gang_size = size
            p.gang_tier = tier
            p.gang_topology = topology
        out.append([pods[i] for i in members])
    return out


def _members(spec: Dict) -> int:
    return spec["gangs"] * spec["size"] + spec["short"] * (spec["size"] - 1)


def gang_rounds(build_pods: Callable, scale: int = 1) -> List[list]:
    """The cell's two bursts, built by `build_pods` (the bench's or this
    module's, so either package's pods), the gang members drawn by one
    seeded numpy stream (positions sorted, so most of a gang shares one
    spec): the headline with GANG_R1's, GANG_R1_SPLIT's and GANG_R1_HUGE's
    gangs, then PROVISION_ROUND2 with GANG_R2's.  `scale` divides the
    bursts and GANG_R1's and GANG_R2's gang counts (GANG_SMALL_SCALE is the
    CPU tests' copy); the split and huge gangs stay four each."""
    def cut(spec: Dict) -> Dict:
        return dict(spec, gangs=spec["gangs"] // scale,
                    short=spec["short"] // scale)
    rng = np.random.default_rng(GANG_SEED)
    r1 = build_pods(rng=np.random.default_rng(HEADLINE_SEED),
                    **dict(HEADLINE, total=HEADLINE["total"] // scale))
    specs = [("r1", cut(GANG_R1)), ("r1s", GANG_R1_SPLIT),
             ("r1h", GANG_R1_HUGE)]
    pick = rng.choice(len(r1), size=sum(_members(s) for _, s in specs),
                      replace=False)
    at, formed = 0, {}
    for prefix, spec in specs:
        n = _members(spec)
        formed[prefix] = _form_gangs(r1, np.sort(pick[at:at + n]).tolist(),
                                     prefix, **spec)
        at += n
    for members in formed["r1s"]:
        for j, p in enumerate(members):
            p.node_selector = {wk.ZONE: ("zone-a", "zone-b")[j // 2]}
    for members in formed["r1h"]:
        p = members[0]
        p.requests = type(p.requests)({CPU: GANG_HUGE_CPU_M, MEMORY: 2**30})
    r2 = build_pods(rng=np.random.default_rng(PROVISION_ROUND2_SEED),
                    **dict(PROVISION_ROUND2,
                           total=PROVISION_ROUND2["total"] // scale))
    spec = cut(GANG_R2)
    pick = np.sort(rng.choice(len(r2), size=_members(spec),
                              replace=False)).tolist()
    for members in _form_gangs(r2, pick, "r2", **spec):
        for p in members:
            p.requests = type(p.requests)(
                {CPU: GANG_R2_MEMBER["cpu_m"],
                 MEMORY: GANG_R2_MEMBER["mem_gib"] * 2**30})
    return [r1, r2]


@dataclass
class GangEnv:
    """The gang cell's objects: the stepped clock, the provisioning env
    (`Provisioner(gang_scheduling=True)`) and the DisruptionController fed
    by its `take_preemption_plan`."""
    clock: SteppedClock
    penv: ProvisionEnv
    disruption: object


def gang_env(kit, catalog, **extra) -> GangEnv:
    """The gang cell from `kit` (a namespace of one package's FakeCloud,
    CloudProvider, Cluster, Provisioner, DisruptionController and
    NodePool) over `catalog`: one default NodePool on a stepped clock, the
    default guided Provisioner with the GangScheduling gate, and a
    DisruptionController whose `gang_source` is the Provisioner's plan
    queue.  `extra` is the port's `device`."""
    clock = SteppedClock(GANG_LAUNCH_T)
    cloud = kit.FakeCloud(clock)
    provider = kit.CloudProvider(cloud, catalog, clock=clock)
    cluster = kit.Cluster(clock)
    pools = [kit.NodePool()]
    prov = kit.Provisioner(provider, cluster, pools, clock=clock,
                           gang_scheduling=True,
                           max_nodes_per_round=GANG_MAX_NODES, **extra)
    disruption = kit.DisruptionController(
        provider, cluster, pools, clock=clock,
        gang_source=prov.take_preemption_plan, **extra)
    return GangEnv(clock, ProvisionEnv(cloud, provider, cluster, prov),
                   disruption)


def _gang_audits(before: Dict, after: Dict) -> Dict:
    """One round's audits from the registry's summaries around it: the
    gangs admitted by tier, and rejected by reason and tier."""
    admitted: Dict[str, int] = {}
    rejected: Dict[str, Dict[str, int]] = {}
    for name, rec in after.items():
        old = before.get(name, {"admissions": 0, "rejections": 0})
        tier = str(rec["tier"])
        if rec["admissions"] > old["admissions"]:
            admitted[tier] = admitted.get(tier, 0) + 1
        if rec["rejections"] > old["rejections"]:
            by_tier = rejected.setdefault(rec["last_reason"], {})
            by_tier[tier] = by_tier.get(tier, 0) + 1
    return dict(admitted=dict(sorted(admitted.items())),
                rejected={r: dict(sorted(t.items()))
                          for r, t in sorted(rejected.items())})


def _plan_signature(plan, pod_pos: Dict[str, int],
                    node_pos: Dict[str, int]) -> List:
    """A preemption plan by positions: the gang, its tier and topology,
    the domain (a zone, or a node's launch position), and the victims in
    order as (pod admission position, node launch position, tier, cost)."""
    domain = (plan.domain if plan.topology == "zone"
              else node_pos.get(plan.domain, -1))
    return [plan.gang, plan.tier, plan.topology, domain,
            [[pod_pos[v.uid], node_pos[v.node], v.tier, v.cost]
             for v in plan.victims], plan.total_cost]


def _digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()


def gang_replay(env: GangEnv, build_pods: Callable,
                provision: Callable = provision_pending,
                tick: Optional[Callable] = None, scale: int = 1) -> Dict:
    """The gang cell: each of `gang_rounds(build_pods, scale)`' bursts
    added to the cluster and provisioned (`provision`, by default
    `provision_pending`, so a caller can time it), then one
    DisruptionController reconcile GANG_TICK_AFTER_S later (`tick()` runs
    it), which executes the first queued preemption plan.  Returns per
    round its provisioning signature, its audits and its queued plans
    (their count, digest and first plan), the tick's action and evicted
    pods, and the registry's final state (digest and totals)."""
    penv, cluster, prov = env.penv, env.penv.cluster, env.penv.provisioner
    rounds = []
    for pods in gang_rounds(build_pods, scale):
        cluster.add_pods(pods)
        before = prov.gang_registry.summary()
        sig, _ = provision(penv)
        after = prov.gang_registry.summary()
        pod_pos = {uid: i for i, uid in enumerate(cluster.pods)}
        node_pos = {name: i for i, name in enumerate(cluster.nodes)}
        plans = [_plan_signature(p, pod_pos, node_pos)
                 for p in prov.gang_preemption_plans.values()]
        rounds.append(dict(
            signature=sig, audits=_gang_audits(before, after),
            plans=len(plans), plans_digest=_digest(plans),
            first_plan=plans[0] if plans else None))
    env.clock.t = GANG_LAUNCH_T + GANG_TICK_AFTER_S
    pod_pos = {uid: i for i, uid in enumerate(cluster.pods)}
    bound = {uid for uid, p in cluster.pods.items() if p.node_name}
    res = (tick or env.disruption.reconcile)()
    action = res.action
    evicted = sorted(pod_pos[uid] for uid in bound
                     if not cluster.pods[uid].node_name)
    summary = prov.gang_registry.summary()
    return dict(
        rounds=rounds,
        tick=dict(action=None if action is None
                  else [action.kind, action.reason],
                  evicted=evicted, plans_left=len(prov.gang_preemption_plans)),
        registry=dict(
            gangs=len(summary),
            admitted=sum(1 for g in summary.values() if g["admitted"]),
            admissions=sum(g["admissions"] for g in summary.values()),
            rejections=sum(g["rejections"] for g in summary.values()),
            preempted=sum(g["preempted"] for g in summary.values()),
            digest=_digest(summary)))

# `gang_replay(gang_env(...))` on the JAX package, on the CPU
# (tests/test_torch_gang_golden.py): provision-gang-50k in full, and its
# 5000-pod copy (scale GANG_SMALL_SCALE), which the port reproduces on the
# CPU (tests/test_torch_gang_cell.py)
GOLDEN_GANG: Dict[str, object] = {'rounds': [{'signature': {'digest': 'e1b724f0e4516feee74e97b5853187f4d98d2fbbaae1cafbb858facf51d6933d',
                           'launched': 5852,
                           'bound_new': 49596,
                           'bound_existing': 0,
                           'unschedulable': 404,
                           'total_price': 4986.60800000016},
             'audits': {'admitted': {'1': 979},
                        'rejected': {'incomplete': {'1': 64},
                                     'partial': {'0': 4},
                                     'straddle': {'1': 49}}},
             'plans': 0,
             'plans_digest': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
             'first_plan': None},
            {'signature': {'digest': '241abd3b9ddd5ba8dbd251dd613bba68b8930ec5be1c866a3d3313d8bfc3de97',
                           'launched': 1719,
                           'bound_new': 18045,
                           'bound_existing': 1287,
                           'unschedulable': 1072,
                           'total_price': 2672.663399999987},
             'audits': {'admitted': {'1': 3, '2': 171},
                        'rejected': {'incomplete': {'1': 64},
                                     'partial': {'0': 4},
                                     'straddle': {'1': 46, '2': 85}}},
             'plans': 85,
             'plans_digest': 'cc5e8cc01cedc5a32854b0e7795bb29288586be48fa59451ccd1e05640dae1b9',
             'first_plan': ['r2-g0000',
                            2,
                            'hostname',
                            310,
                            [[6552, 310, 0, 1.0],
                             [7750, 310, 0, 1.0],
                             [23750, 310, 0, 1.0]],
                            3.0]}],
 'tick': {'action': ['preempt', 'gang'],
          'evicted': [6552, 7750, 23750],
          'plans_left': 84},
 'registry': {'gangs': 1352,
              'admitted': 1153,
              'admissions': 1153,
              'rejections': 316,
              'preempted': 3,
              'digest': 'b903499595ee7217d05a8100a5b7924959100cbba6d9d3c02f6f1fb47565546b'}}

GOLDEN_GANG_SMALL: Dict[str, object] = {'rounds': [{'signature': {'digest': '134123ab78ac51030f639c1b99738bf40eb375bcdb7abb0d508b2656f206d6bd',
                           'launched': 949,
                           'bound_new': 4798,
                           'bound_existing': 0,
                           'unschedulable': 202,
                           'total_price': 497.1440999999967},
             'audits': {'admitted': {'1': 64},
                        'rejected': {'incomplete': {'1': 6},
                                     'partial': {'0': 4},
                                     'straddle': {'1': 42}}},
             'plans': 0,
             'plans_digest': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
             'first_plan': None},
            {'signature': {'digest': 'cab3a116e7bc86765ceb83e25e0363c0c188290d6904343fe1859335103f5d18',
                           'launched': 308,
                           'bound_new': 1641,
                           'bound_existing': 263,
                           'unschedulable': 298,
                           'total_price': 257.3681000000008},
             'audits': {'admitted': {'1': 6, '2': 10},
                        'rejected': {'incomplete': {'1': 6},
                                     'partial': {'0': 4},
                                     'straddle': {'1': 36, '2': 15}}},
             'plans': 19,
             'plans_digest': '1337a8562e066b13d9e74bf5e9ca842dbf0f39f94260d3e9f398a0a20c6e8a06',
             'first_plan': ['r1-g0002',
                            1,
                            'zone',
                            'zone-b',
                            [[175, 279, 0, 1.0], [176, 280, 0, 1.0]],
                            2.0]}],
 'tick': {'action': ['preempt', 'gang'],
          'evicted': [175, 176],
          'plans_left': 18},
 'registry': {'gangs': 141,
              'admitted': 80,
              'admissions': 80,
              'rejections': 113,
              'preempted': 2,
              'digest': '3cf63e720f738abc823a6006b30d8b5bbfa0aae96562cd4b833e7d1751cb0a54'}}


# ---------------------------------------------------------------------------
# slice 17: the flight recorder, the SLO engine and the cost ledger
# ---------------------------------------------------------------------------

# name → (scenario file, virtual seconds, the harness's gate overrides)
OBS_REPLAYS: Dict[str, Tuple[str, float, Dict[str, bool]]] = {
    "chaos-storm": ("chaos-storm.yaml", 5400.0, {"flight_recorder": True}),
    "failover-drill": ("failover-drill.yaml", 5400.0,
                       {"flight_recorder": True}),
    "spot-reclaim-storm": ("spot-reclaim-storm.yaml", 7200.0,
                           {"slo": True}),
    "spot-reclaim-storm+fr": ("spot-reclaim-storm.yaml", 7200.0,
                              {"slo": True, "flight_recorder": True}),
}

# the SLI over controller_runtime_reconcile_time_seconds: wall time, so its
# budget depends on how long each reconcile took on the machine
WALL_SLI = "tick_duration"


def obs_replay(sim, metrics, scenarios_dir: str, name: str, **extra):
    """One gated replay of either package (`sim`, `metrics`: its modules)
    from an empty metric registry: the SLO engine counts the registry's
    whole history, as the reference's does.  Returns the SimRun."""
    fname, duration_s, gates = OBS_REPLAYS[name]
    metrics.REGISTRY.reset()
    sc = sim.load_scenario(f"{scenarios_dir}/{fname}")
    return sim.SimHarness(sc, seed=0, duration_s=duration_s, **gates,
                          **extra).run()


def slo_wall_free(report: Dict) -> Dict:
    """A report with `slo.budgets.slos.tick_duration`'s wall-clock fields
    recorded by their comparisons' outcomes: `0 <= bad <= total`,
    `budget_remaining <= 1`, each `burn.<window> >= 0`, `alerts >= 0` and
    `alerting` a bool (a host slow enough to take more than 1 s over many
    reconciles fires the SLI's burn alert).  A report without SLO budgets
    comes back as it is."""
    slos = report.get("slo", {}).get("budgets", {}).get("slos")
    if not slos or WALL_SLI not in slos:
        return report
    out = json.loads(json.dumps(report))
    sli = out["slo"]["budgets"]["slos"][WALL_SLI]
    sli["bad"] = 0.0 <= sli["bad"] <= sli["total"]
    sli["budget_remaining"] = sli["budget_remaining"] <= 1.0
    sli["burn"] = {w: b >= 0.0 for w, b in sli["burn"].items()}
    sli["alerts"] = sli["alerts"] >= 0
    sli["alerting"] = isinstance(sli["alerting"], bool)
    return out


def without_obs(report: Dict) -> Dict:
    """A gated report without what the FlightRecorder and SLOEngine gates
    add (`incidents`, `slo.budgets`, `ledger`, `cost.by_nodepool`,
    `cost.by_decision_source`): the ungated report of the same run, which
    the gates must leave as it was."""
    out = json.loads(json.dumps(report))
    out.pop("incidents", None)
    out.pop("ledger", None)
    out.get("slo", {}).pop("budgets", None)
    for key in ("by_nodepool", "by_decision_source"):
        out.get("cost", {}).pop(key, None)
    return out


def obs_digest(report: Dict) -> Dict[str, object]:
    """A gated report (either package's) as the goldens hold it: the sha256
    of the canonical JSON of `slo_wall_free(report)`, its length, and the
    incident and ledger counts a reader checks first."""
    from .sim.report import report_to_json
    doc = report_to_json(slo_wall_free(report))
    out: Dict[str, object] = dict(
        sha256=hashlib.sha256(doc.encode()).hexdigest(), bytes=len(doc))
    if "incidents" in report:
        out["by_kind"] = dict(sorted(report["incidents"]["by_kind"].items()))
    if "ledger" in report:
        out["ledger_entries"] = report["ledger"]["entries_opened"]
    return out


# the JAX package's digests of the FlightRecorder replays, byte for byte
# (`obs_digest`; tests/test_torch_obs.py)
GOLDEN_INCIDENTS: Dict[str, Dict[str, object]] = {
    "chaos-storm": {
        "by_kind": {"circuit_open": 2, "solver_demotion": 2},
        "bytes": 2846,
        "sha256": "a618d26ebddc3e517a5a05e8f87397e546be4530ef0a2c01733031f089711283"},
    "failover-drill": {
        "by_kind": {"leader_loss": 2},
        "bytes": 2358,
        "sha256": "465d872d5018262ffdd884d6647c15f4af8477082ca7ed6cd1ad79875012a9e4"},
}

# the JAX package's digests of the SLOEngine replays, `tick_duration`'s
# wall-clock fields by outcome (`obs_digest`; tests/test_torch_obs.py)
GOLDEN_SLO: Dict[str, Dict[str, object]] = {
    "spot-reclaim-storm": {
        "bytes": 4250,
        "ledger_entries": 53,
        "sha256": "cd94a1d7d650a84864adf05ecad4dfa8522cf582262362c4cc3e1cbe926bbe33"},
    "spot-reclaim-storm+fr": {
        "by_kind": {},
        "bytes": 4465,
        "ledger_entries": 53,
        "sha256": "758754b812dbf71900f8d6b9f1fbf2eb763d2f6c561a71177fe19094951ce2d0"},
}
