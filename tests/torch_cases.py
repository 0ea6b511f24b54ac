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
