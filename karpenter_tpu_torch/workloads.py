"""Seeded workloads, plan fingerprints and the headline goldens.

`build_pods` is a copy of the reference bench's pod-batch builder
(`bench.build_pods`): the same spec draws from the same numpy Generator, so
both packages can be handed the same batch.  `existing_nodes` draws E
pre-opened existing-node columns for a tensorized problem with numpy only.
`plan_fingerprint` is the bench's exact plan identity, and `plan_digest`
hashes it; `GOLDEN` holds the digests of the headline solves (50k pods ×
600 instance types), which the JAX package reproduces on the CPU
(tests/test_torch_slice.py) and `chip_smoke.py` checks on the card.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np

from .api import labels as wk
from .api.objects import Pod
from .api.resources import CPU, GPU, MEMORY, ResourceList
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
