"""Seeded kernel inputs for the port's kernel tests, shared by the CPU
parity tests (tests/test_torch_classpack.py) and the card tests
(tests/test_torch_cuda.py).  numpy and torch only: the card's machine runs
the latter without JAX."""

import numpy as np
import pytest
import torch

BIG = 2**30


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the CPU plain versions on one thread: the suite runs them beside
    timing-sensitive tests in other worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_lp(rng, n, me, mi):
    """tests/test_lpsolve.py's LP generator: feasible by construction
    (b = A x*, h = G x* + slack), c > 0 and finite upper bounds, so HiGHS
    returns an exact optimum.  Returns (c, A, b, G, h, u)."""
    x_star = rng.uniform(0.0, 2.0, n)
    A = rng.uniform(-1.0, 1.0, (me, n))
    b = A @ x_star
    G = rng.uniform(-1.0, 1.0, (mi, n))
    h = G @ x_star + rng.uniform(0.1, 1.0, mi)
    c = rng.uniform(0.1, 1.0, n)
    u = np.full(n, 4.0)
    return c, A, b, G, h, u


def make_case(seed, C=20, Cpad=64, O=40, Opad=512, R=5, E=0, K=256,
              trap=None):
    """Padded kernel inputs as the solve lowers them (numpy)."""
    rng = np.random.default_rng(seed)
    cols = O + E
    req = np.zeros((Cpad, R), np.int32)
    req[:C, 0] = rng.integers(100, 4000, C)
    req[:C, 1] = rng.integers(64, 8000, C)
    req[:C, 2] = 1                                     # the pods axis
    if R > 3:
        req[:C, 3] = np.where(rng.random(C) < 0.2, rng.integers(1, 3, C), 0)
    cnt = np.zeros(Cpad, np.int32)
    cnt[:C] = rng.integers(1, 40, C)
    cap = np.full(Cpad, BIG, np.int32)
    comp = np.zeros((Cpad, Opad), bool)
    comp[:C, :cols] = rng.random((C, cols)) < 0.7
    alloc = np.zeros((Opad, R), np.int32)
    alloc[:O, 0] = rng.choice([2000, 4000, 8000, 16000, 32000], O)
    alloc[:O, 1] = alloc[:O, 0] * rng.choice([2, 4, 8], O)
    alloc[:O, 2] = 110
    if R > 3:
        alloc[:O, 3] = np.where(rng.random(O) < 0.3, 4, 0)
    price = np.full(Opad, np.inf, np.float32)
    price[:O] = np.sort(rng.uniform(0.05, 5.0, O)).astype(np.float32)
    rank = np.full(Opad, BIG - 1, np.int32)
    rank[:cols] = 0
    iopt = iused = None
    if E:
        alloc[O:cols] = alloc[rng.integers(0, O, E)]
        iopt = np.full(K, -1, np.int32)
        iopt[:E] = np.arange(O, cols, dtype=np.int32)
        iused = np.zeros((K, R), np.int32)
        iused[:E] = (alloc[O:cols] * rng.uniform(0, 0.9, (E, R))).astype(np.int32)
        # overcommitted existing nodes: free < 0 needs floor division
        iused[:E:3, 0] = alloc[O:cols:3, 0] + rng.integers(1, 500, len(range(0, E, 3)))
    if trap == "overflow":
        # price × ceil(rem/m) overflows float32: scores clamp at SCORE_CAP
        # and tie, so the lowest (cheapest-sorted) index must win
        price[:O] = np.float32(3e38)
        price[0] = np.float32(1e38)
        req[:C, 0] = rng.integers(3000, 9000, C)
    elif trap == "nonfinite":
        price[rng.random(Opad) < 0.3] = np.inf
        price[:O][rng.random(O) < 0.1] = np.nan
    elif trap == "caps_ranks":
        cap[:C] = np.where(rng.random(C) < 0.5, rng.integers(1, 4, C), BIG)
        rank[:O] = np.where(rng.random(O) < 0.4, 1, 0)
        comp[:C, :O] &= (rng.random((C, O)) < 0.9)
    return dict(req=req, cnt=cnt, comp=comp, cap=cap, alloc=alloc,
                price=price, rank=rank, iopt=iopt, iused=iused, K=K,
                Ppad=int(cnt.sum()) + 37)


# few distinct shapes on purpose: each (K, R) pair costs the JAX side one
# compile of every program
CASES = {
    "plain": dict(),
    "existing": dict(E=12),
    "overflow": dict(trap="overflow"),
    "nonfinite_many_axes": dict(trap="nonfinite", E=6, R=9, O=100),
    "caps_ranks": dict(trap="caps_ranks"),
    "exhaustion": dict(K=16),
    "exhaustion_existing": dict(K=16, E=12),
    # C == Cpad, more pods than slots: the padded pod rows repeat a class
    # that has pods
    "full_classes": dict(C=64, Cpad=64),
}


def _fields(cls, src, **conv):
    """A `cls` dataclass from `src`'s same-named attributes (underscored
    and missing fields keep their defaults); `conv` converts nested
    values by field name."""
    import dataclasses
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name.startswith("_") or not hasattr(src, f.name):
            continue
        v = getattr(src, f.name)
        kw[f.name] = conv[f.name](v) if f.name in conv else v
    return cls(**kw)


def fleet_to_reference(fleet):
    """The port's `workloads.consolidation_fleet()` as JAX-package objects:
    (provider, cluster, pools, clock) for the JAX package's
    DisruptionController.  The provider serves the JAX package's own
    `generate_catalog` of the same size (the same catalog, built by the
    same generator) with no nodeclasses, as the port's CatalogProvider
    does.  Imports the JAX package inside: the card's tests never call it."""
    from types import SimpleNamespace

    from karpenter_tpu.api import objects as jo
    from karpenter_tpu.api.requirements import Requirement, Requirements
    from karpenter_tpu.api.resources import ResourceList
    from karpenter_tpu.api.taints import Taint
    from karpenter_tpu.catalog.generate import generate_catalog
    from karpenter_tpu.state import Cluster

    def reqs(src):
        return Requirements({k: Requirement.raw(
            r.key, r.complement, set(r.values), r.greater_than, r.less_than,
            r.min_values) for k, r in src.items()})

    src = fleet.cluster
    cluster = Cluster(clock=src.clock)
    pods = {uid: _fields(jo.Pod, p, requests=ResourceList,
                         limits=ResourceList, labels=dict, annotations=dict)
            for uid, p in src.pods.items()}
    cluster.pods.update(pods)
    for name, n in src.nodes.items():
        cluster.nodes[name] = _fields(
            jo.Node, n, labels=dict, allocatable=ResourceList,
            capacity=ResourceList,
            taints=lambda ts: [_fields(Taint, t) for t in ts],
            pods=lambda ps: [pods[p.uid] for p in ps])
    for name, c in src.nodeclaims.items():
        cluster.nodeclaims[name] = _fields(
            jo.NodeClaim, c, requirements=reqs, requests=ResourceList,
            labels=dict, taints=lambda ts: [_fields(Taint, t) for t in ts])
    cluster.mutation_epoch = src.mutation_epoch
    catalog = generate_catalog(len(fleet.provider.get_instance_types()))
    provider = SimpleNamespace(get_instance_types=lambda: catalog,
                               node_classes=None)
    return provider, cluster, [jo.NodePool()], fleet.clock


def make_sweep_case(seed, B=8, **case):
    """Seeded sweep inputs over `make_case(seed, **case)`: B rows of class
    counts, column masks and price caps, with the init state always given
    (all slots closed when the case has no existing nodes).  Rows 0-5 are
    fixed probes: everything with no cap, zero counts, every column masked,
    a cap below every price, a cap between prices, and a mask that removes
    the best pool rank (rank 0 options; the existing columns stay); the
    rest draw random counts, masks and caps."""
    c = make_case(seed, **case)
    rng = np.random.default_rng(seed + 1000)
    Cpad, Opad = c["comp"].shape
    K, R = c["K"], c["req"].shape[1]
    price, rank = c["price"], c["rank"]
    fin = price[np.isfinite(price)].astype(np.float64)
    counts = np.where(rng.random((B, Cpad)) < 0.6, c["cnt"][None], 0)
    counts = counts.astype(np.int32)
    mask = rng.random((B, Opad)) < 0.7
    caps = np.where(rng.random(B) < 0.3, np.inf,
                    rng.choice(fin, B) * rng.uniform(0.5, 1.5, B))
    counts[0], mask[0], caps[0] = c["cnt"], True, np.inf
    counts[1] = 0
    mask[2] = False
    caps[3] = fin.min() * 0.5
    caps[4] = np.median(fin)
    mask[5], caps[5] = rank != 0, np.inf
    if c["iopt"] is not None:
        ecols = c["iopt"][c["iopt"] >= 0]
        mask[5, ecols] = True
    iopt = c["iopt"] if c["iopt"] is not None else np.full(K, -1, np.int32)
    iused = c["iused"] if c["iused"] is not None else \
        np.zeros((K, R), np.int32)
    return dict(req=c["req"], counts=counts,
                packed=np.packbits(c["comp"], axis=1), cap=c["cap"],
                alloc=c["alloc"], price=price, rank=rank, mask=mask,
                caps=np.minimum(caps, np.finfo(np.float32).max).astype(
                    np.float32), iopt=iopt, iused=iused, K=K)


# the sweep program's parity cases (each (K, R, B) shape costs the JAX side
# one compile)
SWEEP_CASES = {
    "plain": dict(),
    "existing_overcommitted": dict(E=12),
    "exhaustion_existing": dict(K=16, E=12),
    "pool_ranks_existing": dict(trap="caps_ranks", E=12),
    "nonfinite_many_axes": dict(trap="nonfinite", E=6, R=9, O=100),
    "overflow": dict(trap="overflow"),
}


def sweep_args(s):
    """The sweep program's positional arguments, in its order."""
    return (s["req"], s["counts"], s["packed"], s["cap"], s["alloc"],
            s["price"], s["rank"], s["mask"], s["caps"], s["iopt"],
            s["iused"])


def stack_shards(c, n, rng, dev):
    """n shards of one kernel case (`make_case`) on `dev`, as the
    shard-batched kernels take them: per-shard counts drawn from the case's
    (shard 1 empty), the class arrays and the pre-opened slots one copy
    shared by every shard (an `expand`ed view, stride 0) — except the init
    slabs, stacked — and the catalog shared."""
    def t(a):
        return torch.tensor(a, device=dev)
    cnt = np.stack([np.where(rng.random(c["cnt"].shape) < 0.7, c["cnt"], 0)
                    for _ in range(n)]).astype(np.int32)
    cnt[1] = 0
    packed = np.packbits(c["comp"], axis=1)
    return dict(req=t(c["req"]).expand(n, *c["req"].shape),
                cnt=t(cnt),
                packed=t(packed).expand(n, *packed.shape),
                cap=t(c["cap"]).expand(n, *c["cap"].shape),
                alloc=t(c["alloc"]), price=t(c["price"]), rank=t(c["rank"]),
                iopt=None if c["iopt"] is None else
                t(c["iopt"]).expand(n, *c["iopt"].shape).contiguous(),
                iused=None if c["iused"] is None else
                t(c["iused"]).expand(n, *c["iused"].shape).contiguous())


# ---- K1 (classpack_precompute) and K4 (classpack_aggregate) inputs ----

# (n, C, O, R) of K1 on each main path: the headline, the live cell's round
# 2, the consolidation-500 tick and the megafleet's row 17
PRECOMPUTE_PATH_SHAPES = {
    "headline": (1, 256, 4096, 7),
    "live-round-2": (1, 256, 8192, 7),
    "consolidation-500": (1, 1024, 512, 7),
    "megafleet-row-17": (8, 64, 512, 2),
}
# edge shapes: one class, one / seven options (a ragged row), one past a
# bucket, the widest bucket, 32 axes, 8 shards
PRECOMPUTE_EDGE_SHAPES = {
    "C1": (1, 1, 512, 7),
    "O1": (1, 20, 1, 7),
    "O7": (1, 20, 7, 7),
    "O4097": (1, 20, 4097, 7),
    "O32768": (1, 8, 32_768, 7),
    "R32": (1, 20, 512, 32),
    "n8": (8, 20, 600, 7),
}


def make_precompute_case(seed, n=1, C=20, O=512, R=7, trap=None):
    """Seeded K1 inputs (numpy; requests n×C×R, node_cap n×C, compat
    n×C×O bool, alloc O×R, price O, rank O) with its parity traps: axes a
    class does not request (0) and negative requests (masked), requests of
    1 and near 2^30, node caps of 0 and 1, negative allocations (existing
    columns over-committed) and the int32 extremes, +inf and NaN prices,
    classes with no compatible option, pool ranks.  `trap="all_inf"` prices
    every option +inf (no class has a launchable option)."""
    rng = np.random.default_rng(seed)
    req = rng.integers(1, 9000, (n, C, R)).astype(np.int32)
    req[rng.random((n, C, R)) < 0.25] = 0
    neg = rng.random((n, C, R)) < 0.05
    req[neg] = -rng.integers(1, 50, neg.sum())
    if R:
        req[..., :1][rng.random((n, C, 1)) < 0.15] = 1
    near = rng.random((n, C, R)) < 0.05
    req[near] = 2**30 - rng.integers(-1, 3, near.sum())
    cap = np.full((n, C), BIG, np.int32)
    capped = rng.random((n, C)) < 0.3
    cap[capped] = rng.integers(0, 3, capped.sum())
    comp = rng.random((n, C, O)) < 0.6
    comp[:, ::7] = False
    alloc = rng.integers(0, 64_000, (O, R)).astype(np.int32)
    wide = rng.random((O, R)) < 0.05
    alloc[wide] = rng.integers(-2**31, 2**31 - 1, wide.sum(), dtype=np.int64)
    alloc[rng.random((O, R)) < 0.1] *= -1
    if R:
        alloc.flat[rng.integers(0, O * R, 2)] = [-2**31, 2**31 - 1]
    price = rng.uniform(0.05, 5.0, O).astype(np.float32)
    price[rng.random(O) < 0.2] = np.inf
    price[rng.random(O) < 0.02] = np.nan
    if trap == "all_inf":
        price[:] = np.inf
    rank = rng.integers(0, 3, O).astype(np.int32)
    rank[rng.random(O) < 0.05] = BIG - 1
    return dict(req=req, cap=cap, comp=comp, alloc=alloc, price=price,
                rank=rank)


def precompute_args(c, dev="cpu", shard=None):
    """A `make_precompute_case` as torch tensors on `dev`, in K1's argument
    order (compat packed): the n-shard stack, or shard `shard` alone."""
    pick = (lambda a: a) if shard is None else (lambda a: a[shard])
    packed = np.packbits(c["comp"], axis=-1)
    return [torch.tensor(np.ascontiguousarray(a), device=dev) for a in (
        pick(c["req"]), pick(c["cap"]), pick(packed), c["alloc"], c["price"],
        c["rank"])]


def make_slot_case(seed, n=1, K=8192, O=4096, kind="runs"):
    """Seeded K4 inputs (numpy): slot_option n×K, price O, n_open and
    n_unsched n.  `kind`: "runs" (open slots a prefix, each class's new
    slots one run of one option, prices over six decades, some +inf),
    "hot" (every slot one option), "closed" (no slot open) or "all_inf"
    (every price +inf)."""
    rng = np.random.default_rng(seed)
    price = (10.0 ** rng.uniform(-3, 3, O)).astype(np.float32)
    price[rng.random(O) < 0.1] = np.inf
    so = np.full((n, K), -1, np.int32)
    for s in range(n):
        n_open = int(rng.integers(0, K + 1))
        k = 0
        while k < n_open:
            run = int(min(n_open - k, rng.geometric(0.05)))
            so[s, k:k + run] = rng.integers(0, O)
            k += run
    if kind == "hot":
        so[:] = rng.integers(0, O)
        price[so[0, 0]] = np.float32(1.5)
    elif kind == "closed":
        so[:] = -1
    elif kind == "all_inf":
        price[:] = np.inf
    n_open = (so >= 0).sum(1).astype(np.int32)
    n_unsched = rng.integers(0, 1000, n).astype(np.int32)
    return dict(slot_option=so, price=price, n_open=n_open,
                n_unsched=n_unsched)
