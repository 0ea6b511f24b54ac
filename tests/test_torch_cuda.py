"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here is marked `cuda` and skips without a card: a CUDA kernel
has no CPU mode.  The file imports neither JAX nor the JAX package, so it
runs on the card's machine as it is:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Integer outputs must be equal; the aggregate's float32 total_cost may differ
by relative 1e-5 (the kernel sums the launched prices in another order)."""

import dataclasses

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import workloads
from karpenter_tpu_torch._build import KernelError
from karpenter_tpu_torch.api.objects import NodePool
from karpenter_tpu_torch.catalog.generate import generate_catalog
from karpenter_tpu_torch.ops import classpack as cp
from karpenter_tpu_torch.ops import classpack_kernels as ck
from karpenter_tpu_torch.ops.tensorize import tensorize
from torch_cases import (CASES, PRECOMPUTE_EDGE_SHAPES,
                         PRECOMPUTE_PATH_SHAPES, SWEEP_CASES, clear_lp_caches,
                         make_case, make_precompute_case, make_slot_case,
                         make_sweep_case, precompute_args, random_lp,
                         stack_shards, sweep_args)

REL_TOL = 1e-5


def _close(a, b):
    a, b = float(a), float(b)
    return a == b or abs(a - b) <= REL_TOL * max(abs(a), 1e-30)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _on(c, dev):
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    args = [t(a) for a in (c["req"], c["cnt"], np.packbits(c["comp"], axis=1),
                           c["cap"], c["alloc"], c["price"], c["rank"])]
    init = (None, None) if c["iopt"] is None else (t(c["iopt"]), t(c["iused"]))
    return args, init


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernels_match_plain(cuda_device, name):
    c = make_case(4, **CASES[name])
    (req, cnt, packed, cap, alloc, price, rank), (iopt, iused) = \
        _on(c, cuda_device)
    K = c["K"]
    ck.reset_launches()
    m, ok = ck.classpack_precompute(req, cap, packed, alloc, price, rank)
    m0, ok0 = ck.classpack_precompute_plain(req, cap, packed, alloc, price,
                                            rank)
    assert torch.equal(m, m0) and torch.equal(ok, ok0)
    for emit in (False, True):
        got = ck.classpack_scan(req, cnt, packed, cap, alloc, price, m, ok,
                                iopt, iused, K, emit)
        want = ck.classpack_scan_plain(req, cnt, packed, cap, alloc, price,
                                       m0, ok0, iopt, iused, K, emit)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    slot_option, _, n_open, n_unsched, takes = got
    a = ck.classpack_assign_decode(takes, cnt, c["Ppad"])
    assert torch.equal(a, ck.classpack_assign_decode_plain(takes, cnt,
                                                           c["Ppad"]))
    g = ck.classpack_aggregate(slot_option, price, n_open, n_unsched)
    w = ck.classpack_aggregate_plain(slot_option, price, n_open, n_unsched)
    assert torch.equal(g[1:], w[1:])
    assert _close(g[0], w[0])
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {**{k: 0 for k in ck.KERNELS},
                           "classpack_precompute": 1, "classpack_scan": 2,
                           "classpack_assign_decode": 1,
                           "classpack_aggregate": 1}


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_inputs(cuda_device):
    (req, cnt, packed, cap, alloc, price, rank), _ = \
        _on(make_case(0, **CASES["plain"]), cuda_device)
    with pytest.raises(TypeError):
        ck.classpack_precompute(req.to(torch.int64), cap, packed, alloc,
                                price, rank)
    with pytest.raises(ValueError):
        ck.classpack_precompute(req, cap, packed[:, :-1].contiguous(), alloc,
                                price, rank)
    with pytest.raises(ValueError):
        ck.classpack_precompute(req.t().contiguous().t(), cap, packed, alloc,
                                price, rank)
    with pytest.raises(ValueError):
        ck.classpack_precompute(req, cap.cpu(), packed, alloc, price, rank)


@pytest.mark.cuda
def test_cuda_solve_matches_cpu_and_the_goldens(cuda_device):
    """The headline solves on the card reproduce the golden digests (which
    the JAX package computes on the CPU, tests/test_torch_slice.py), and a
    small batch solves identically on the card and on the CPU."""
    pods = workloads.build_pods(
        rng=np.random.default_rng(workloads.HEADLINE_SEED),
        **workloads.HEADLINE)
    prob = tensorize(pods, generate_catalog(workloads.HEADLINE_TYPES),
                     [NodePool()])
    a, u, cm = workloads.existing_nodes(
        prob, workloads.HEADLINE_EXISTING,
        np.random.default_rng(workloads.EXISTING_SEED))
    ex = dict(existing_alloc=a, existing_used=u, existing_compat=cm)
    for n_existing, kw in ((0, {}), (workloads.HEADLINE_EXISTING, ex)):
        for decode in (True, False):
            got = cp.solve_classpack(prob, guide=None, decode=decode, **kw)
            gold, gold_total = workloads.GOLDEN[(n_existing, decode)]
            digest, total = workloads.plan_digest(prob, got, decode)
            assert digest == gold
            assert _close(total, gold_total)
    small = tensorize(workloads.build_pods(20, 700, np.random.default_rng(9),
                                           gpu_frac=0.1, zone_frac=0.3),
                      generate_catalog(60), [NodePool()])
    for decode in (True, False):
        on_card = cp.solve_classpack(small, guide=None, decode=decode)
        on_cpu = cp.solve_classpack(small, guide=None, decode=decode,
                                    device="cpu")
        assert workloads.plan_digest(small, on_card, decode)[0] == \
            workloads.plan_digest(small, on_cpu, decode)[0]


def _sweep_on(s, dev):
    t = [torch.tensor(a, device=dev) for a in sweep_args(s)]
    t[7] = torch.tensor(np.packbits(s["mask"], axis=1), device=dev)
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SWEEP_CASES))
def test_cuda_sweep_matches_plain(cuda_device, name):
    """K5 against its plain version on the seeded sweep rows (caps of inf,
    below every price and between prices, an all-masked row, zero-count
    rows, a mask that removes the best pool rank, slot exhaustion); B = 8
    and the same rows tiled to B = 40 (more blocks than rows of one wave
    would need)."""
    s = make_sweep_case(3, **SWEEP_CASES[name])
    req, counts, packed, cap, alloc, price, rank, mpacked, caps, iopt, iused \
        = _sweep_on(s, cuda_device)
    m_all, _ = ck.classpack_precompute(req, cap, packed, alloc, price, rank)
    for reps in (1, 5):
        cb = counts.repeat(reps, 1).contiguous()
        mb = mpacked.repeat(reps, 1).contiguous()
        pb = caps.repeat(reps).contiguous()
        ck.reset_launches()
        got = ck.classpack_sweep(req, cb, packed, cap, alloc, price, rank, mb,
                                 pb, iopt, iused, m_all, s["K"])
        want = ck.classpack_sweep_plain(req, cb, packed, cap, alloc, price,
                                        rank, mb, pb, iopt, iused, m_all,
                                        s["K"])
        torch.cuda.synchronize()
        assert ck.LAUNCHES["classpack_sweep"] == 1
        assert torch.equal(got[:, 1:], want[:, 1:])
        for a, b in zip(got[:, 0].tolist(), want[:, 0].tolist()):
            assert _close(a, b)


@pytest.mark.cuda
def test_cuda_sweep_large_slot_state_spills_to_global(cuda_device):
    """K = 8192 at R = 7 (256 KB a row) exceeds the shared memory a block
    can opt into, so the rows' slot state runs from a global slice (the
    budget is the opt-in maximum since the redesign; 48 KB rows, which
    spilled under the old 40 KB budget, stay in shared memory)."""
    s = make_sweep_case(6, E=12, K=8192, R=7)
    t = _sweep_on(s, cuda_device)
    req, counts, packed, cap, alloc, price, rank, mpacked, caps, iopt, iused \
        = t
    plan = ck.sweep_plan_for(cuda_device, s["K"], req.shape[1],
                             price.shape[0], counts.shape[0])
    assert not plan.state_smem
    assert ck.sweep_plan_for(cuda_device, 2048, 5, 512, 8).state_smem
    m_all, _ = ck.classpack_precompute(req, cap, packed, alloc, price, rank)
    args = (req, counts, packed, cap, alloc, price, rank, mpacked, caps,
            iopt, iused, m_all, s["K"])
    got = ck.classpack_sweep(*args)
    want = ck.classpack_sweep_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 1:], want[:, 1:])
    assert all(_close(a, b) for a, b in zip(got[:, 0].tolist(),
                                            want[:, 0].tolist()))


@pytest.mark.cuda
def test_cuda_sweep_refuses_instead_of_falling_back(cuda_device):
    s = make_sweep_case(3, E=12)
    req, counts, packed, cap, alloc, price, rank, mpacked, caps, iopt, iused \
        = _sweep_on(s, cuda_device)
    m_all, _ = ck.classpack_precompute(req, cap, packed, alloc, price, rank)
    ok = [req, counts, packed, cap, alloc, price, rank, mpacked, caps, iopt,
          iused, m_all]
    ck.reset_launches()
    bad = list(ok)
    bad[1] = counts.to(torch.int64)                     # counts dtype
    with pytest.raises(TypeError):
        ck.classpack_sweep(*bad, s["K"])
    bad = list(ok)
    bad[7] = mpacked[:, :-1].contiguous()               # mask width
    with pytest.raises(ValueError):
        ck.classpack_sweep(*bad, s["K"])
    bad = list(ok)
    bad[8] = caps.cpu()                                 # mixed devices
    with pytest.raises(ValueError):
        ck.classpack_sweep(*bad, s["K"])
    with pytest.raises(ValueError):                     # K past the kernel
        ck.classpack_sweep(*ok[:9], torch.full((2**14,), -1, dtype=torch.int32,
                                               device=cuda_device),
                           torch.zeros((2**14, req.shape[1]),
                                       dtype=torch.int32, device=cuda_device),
                           m_all, 2**14)
    assert ck.LAUNCHES["classpack_sweep"] == 0


@pytest.mark.cuda
def test_cuda_consolidation_matches_the_goldens(cuda_device):
    """The consolidation decision on the card over the 500-node fleet
    reproduces the goldens the JAX package computes on the CPU
    (tests/test_torch_consolidation.py), through K5 and K1-K3."""
    from karpenter_tpu_torch.controllers.disruption import \
        DisruptionController
    for n_cands in workloads.CONSOLIDATION_SHAPES:
        f = workloads.consolidation_fleet()
        ck.reset_launches()
        ctrl = DisruptionController(f.provider, f.cluster, f.pools,
                                    clock=f.clock, max_candidates=n_cands)
        cands = ctrl.candidates()
        action = ctrl.consolidation_action(cands)
        # the tick alone launched them; the full sweeps below are not a tick
        for name in ("classpack_precompute", "classpack_scan",
                     "classpack_assign_decode", "classpack_sweep"):
            assert ck.LAUNCHES[name] > 0, name
        arena = ctrl._arena_for(cands)
        got = workloads.consolidation_digests(
            action, arena.sweep_prefixes(), arena.sweep_singles())
        gold = workloads.GOLDEN_CONSOLIDATION[n_cands]
        assert got["action"] == gold["action"]
        for face in ("prefixes", "singles"):
            assert got[face][0] == gold[face][0]
            assert _close(got[face][1], gold[face][1])


@pytest.mark.cuda
def test_cuda_launch_sweep_matches_the_golden(cuda_device):
    """Replace-face rows that launch new nodes (`workloads.launch_probes`)
    reproduce the JAX package's GOLDEN_LAUNCH_SWEEP through K1 + K5."""
    from karpenter_tpu_torch.controllers.disruption import \
        DisruptionController
    from karpenter_tpu_torch.ops.classpack import solve_classpack_sweep
    f = workloads.consolidation_fleet()
    ctrl = DisruptionController(f.provider, f.cluster, f.pools,
                                clock=f.clock, max_candidates=500)
    problem, counts, kw = workloads.launch_probes(
        ctrl._arena_for(ctrl.candidates()))
    ck.reset_launches()
    res = solve_classpack_sweep(problem, counts, **kw)
    assert ck.LAUNCHES["classpack_sweep"] == res.device_calls == 1
    digest, total = workloads.sweep_digest(res)
    assert digest == workloads.GOLDEN_LAUNCH_SWEEP[0]
    assert _close(total, workloads.GOLDEN_LAUNCH_SWEEP[1])


def _small_replay(device):
    """Three ticks of a 300-pod disruption fleet (`workloads.disruption_env`
    cut to 300 pods): two consolidation ticks, then a drift tick after the
    default NodeClass's spec changes.  Returns their signatures."""
    from karpenter_tpu_torch.ops import lpguide, lpsolve
    with lpguide._MIX_LOCK:
        lpguide._MIX_CACHE.clear()
        lpguide._STALE_CACHE.clear()
        lpguide._SUPPORT_CACHE.clear()
    lpsolve.reset_caches()
    env = workloads.disruption_env(
        workloads.port_kit(), generate_catalog(workloads.DISRUPTION_TYPES),
        n_pods=300, device=device)
    sigs = [workloads.disruption_tick(env, "consolidation")[0]
            for _ in range(2)]
    env.provider.node_classes["default"].user_data = workloads.DRIFT_USER_DATA
    env.provider.node_classes["default"].hash_annotation = ""
    sigs.append(workloads.disruption_tick(env, "drift")[0])
    return sigs


@pytest.mark.cuda
def test_cuda_disruption_ticks_equal_the_cpu_ticks(cuda_device):
    """Three ticks of a small fleet carried out on the card equal the same
    ticks on the CPU, through the sweep (K1 + K5) and the decoded solves
    (K1 + K2 + K3)."""
    want = _small_replay("cpu")
    ck.reset_launches()
    got = _small_replay("cuda")
    assert got == want
    assert want[2]["action"][1] == "drift"
    for name in ("classpack_precompute", "classpack_scan",
                 "classpack_assign_decode", "classpack_sweep"):
        assert ck.LAUNCHES[name] > 0, name


# ---- the PDHG LP kernel (csrc/lpsolve.cu) ----

def _pdhg_both(insts, dev, iters_cap=20000):
    from karpenter_tpu_torch.ops import lpsolve as lp
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    torch.backends.cuda.matmul.allow_tf32 = False
    bt = lp.pad_batch(insts)
    ops = [torch.from_numpy(a).to(dev) for a in bt.operands()]
    got = lk.pdhg(*ops, lp.DEFAULT_EPS, iters_cap, lp.DEFAULT_CHECK_EVERY)
    want = lk.pdhg_plain(*ops, lp.DEFAULT_EPS, iters_cap,
                         lp.DEFAULT_CHECK_EVERY)
    torch.cuda.synchronize()
    return [g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want], bt


@pytest.mark.cuda
@pytest.mark.parametrize("n,me,mi,inf_u", [(20, 5, 8, False),
                                           (80, 20, 30, True),
                                           (1500, 40, 60, False)])
def test_cuda_pdhg_matches_plain(cuda_device, n, me, mi, inf_u):
    """The kernel against its plain version: same status, objective within
    relative 1e-3, x within 2e-2, iterations within a factor 1.5 (float32
    sums run in another order)."""
    from karpenter_tpu_torch.ops import lpsolve as lp
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    c, A, b, G, h, u = random_lp(np.random.default_rng(n), n, me, mi)
    if inf_u:
        u[::3] = np.inf
    lk.reset_launches()
    got, want, bt = _pdhg_both([lp.LPInstance(
        c=np.asarray(c, np.float32), A_eq=A, b_eq=b, A_ub=G, b_ub=h,
        upper=u)], cuda_device)
    assert lk.LAUNCHES["pdhg"] == 1
    assert bool(got[3][0]) and bool(want[3][0])
    og = float(bt.c[0].astype(np.float64) @ got[0][0])
    ow = float(bt.c[0].astype(np.float64) @ want[0][0])
    assert og == pytest.approx(ow, rel=1e-3, abs=1e-3)
    np.testing.assert_allclose(got[0][0], want[0][0], atol=2e-2)
    assert got[4][0] <= 1.5 * want[4][0] and want[4][0] <= 1.5 * got[4][0]


@pytest.mark.cuda
def test_cuda_pdhg_batch_matches_singles_and_caps(cuda_device):
    """A B = 3 batch reproduces each member's solo launch (the done
    freeze), and a 64-iteration cap exits with status cap."""
    from karpenter_tpu_torch.ops import lpsolve as lp
    rng = np.random.default_rng(3)
    insts = []
    for n, me, mi in [(20, 5, 8), (28, 7, 12), (16, 4, 6)]:
        c, A, b, G, h, u = random_lp(rng, n, me, mi)
        insts.append(lp.LPInstance(c=np.asarray(c, np.float32), A_eq=A,
                                   b_eq=b, A_ub=G, b_ub=h, upper=u))
    batch = lp.solve_lp_batch(insts, buckets=(32,))
    for inst, b_sol in zip(insts, batch):
        solo = lp.solve_lp_batch([inst], buckets=(32,))[0]
        assert b_sol.status == solo.status == lp.STATUS_CONVERGED
        assert b_sol.iterations == solo.iterations
        np.testing.assert_allclose(b_sol.x, solo.x, atol=1e-4)
    got, want, _ = _pdhg_both(insts[:1], cuda_device, iters_cap=64)
    assert not bool(got[3][0]) and not bool(want[3][0])
    assert int(got[4][0]) == int(want[4][0]) == 64


def _pairing_trap():
    """tests/test_lpguide.py's pairing trap on the port's types: the
    specialist types are per-pod cheapest for each class alone, the
    balanced type hosts a 2+2 blend cheaper; only the LP sees the blend."""
    from karpenter_tpu_torch.api.objects import Pod
    from karpenter_tpu_torch.api.resources import CPU, MEMORY, ResourceList
    from karpenter_tpu_torch.catalog.instancetype import (
        GiB, InstanceTypeInfo, Offering, new_instance_type)

    def make_type(name, cpu, mem_gib, price):
        return new_instance_type(
            InstanceTypeInfo(name=name, cpu_m=cpu * 1000,
                             memory_bytes=mem_gib * GiB, arch="amd64"),
            [Offering("zone-a", "on-demand", price)])
    catalog = [make_type("pair", 10, 10, 1.00),
               make_type("cpu-special", 10, 2, 0.75),
               make_type("mem-special", 2, 10, 0.75)]
    pods = ([Pod(requests=ResourceList({CPU: 4200, MEMORY: 300 * 2**20}))
             for _ in range(100)]
            + [Pod(requests=ResourceList({CPU: 300, MEMORY: 3584 * 2**20}))
               for _ in range(100)])
    return tensorize(pods, catalog, [NodePool()])


@pytest.mark.cuda
def test_cuda_guided_device_lp_on_the_pairing_trap(cuda_device):
    """solve_classpack's default guide with device_lp=True on the card: the
    PDHG kernel solves the masters, the ladder stays healthy, and the plan
    binds every pod on nodes within their allocatable, below 0.8x greedy."""
    from karpenter_tpu_torch.ops import lpguide
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    from karpenter_tpu_torch.ops.health import lp_ladder
    prob = _pairing_trap()
    with lpguide._MIX_LOCK:
        lpguide._MIX_CACHE.clear()
        lpguide._STALE_CACHE.clear()
        lpguide._SUPPORT_CACHE.clear()
    h = lp_ladder(clock=lambda: 0.0)
    lk.reset_launches()
    res = cp.solve_classpack(prob, device_lp=True, lp_health=h)
    assert lk.LAUNCHES["pdhg"] >= 1
    assert h.active_rung("device_lp") == "device_lp"
    assert h._state["device_lp"].failures == 0
    assert sorted(p for nd in res.nodes for p in nd.pod_indices) == \
        list(range(200)) and not res.unschedulable
    cls = np.empty(200, np.int64)
    for c, m in enumerate(prob.class_members):
        cls[np.asarray(m, np.int64)] = c
    oi = {id(o): j for j, o in enumerate(prob.options)}
    for nd in res.nodes:
        used = prob.class_requests[cls[np.asarray(nd.pod_indices)]].sum(0)
        assert (used <= prob.option_alloc[oi[id(nd.option)]]).all()
    greedy = cp.solve_classpack(prob, guide=None)
    assert res.total_price < 0.8 * greedy.total_price


# ---- K6 classpack_slab and K7 ffd_scan (slice 4) ----

@pytest.mark.cuda
@pytest.mark.parametrize("K,n,dtype", [
    (256, 1061, np.int16), (2048, 32768, np.int16), (2048, 53248, np.int32),
    (8192, 300_000, np.int16)])   # the last above the (K+1)·n < 2^31 guard
def test_cuda_slab_matches_plain(cuda_device, K, n, dtype):
    a = torch.tensor(np.random.default_rng(K + n).integers(
        -1, K, size=n).astype(dtype), device=cuda_device)
    ck.reset_launches()
    order, counts = ck.classpack_slab(a, K)
    order0, counts0 = ck.classpack_slab_plain(a, K)
    torch.cuda.synchronize()
    assert torch.equal(order, order0) and torch.equal(counts, counts0)
    assert ck.LAUNCHES["classpack_slab"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("seed,kw", [
    (0, dict(P=2048, C=24, O=300)),
    (1, dict(P=2048, C=24, O=300, E=32)),
    (2, dict(P=1024, C=16, O=200, K=64)),            # slot exhaustion
    (3, dict(P=1024, C=16, O=200, R=12, K=4096))])   # state in global memory
def test_cuda_ffd_scan_matches_plain(cuda_device, seed, kw):
    from karpenter_tpu_torch.ops import ffd_kernels as fk
    arrays, K = workloads.ffd_scan_inputs(np.random.default_rng(seed), **kw)
    args = [torch.tensor(a, device=cuda_device) for a in arrays]
    fk.reset_launches()
    got = fk.ffd_scan(*args, K)
    want = fk.ffd_scan_plain(*args, K)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert fk.LAUNCHES["ffd_scan"] == 1


@pytest.mark.cuda
def test_cuda_ffd_scan_refuses_without_fallback(cuda_device):
    from karpenter_tpu_torch.ops import ffd_kernels as fk
    arrays, K = workloads.ffd_scan_inputs(np.random.default_rng(4), P=128,
                                          C=4, O=32)
    args = [torch.tensor(a, device=cuda_device) for a in arrays]
    fk.reset_launches()
    bad = list(args)
    bad[0] = bad[0].double()
    with pytest.raises(TypeError):
        fk.ffd_scan(*bad, K)
    bad = list(args)
    bad[0] = bad[0].cpu()
    with pytest.raises(ValueError, match="devices"):
        fk.ffd_scan(*bad, K)
    assert fk.LAUNCHES["ffd_scan"] == 0


@pytest.mark.cuda
def test_cuda_provision_small_cell_matches_the_golden(cuda_device):
    """Three 64-pod bursts through Provisioner.provision on the card: every
    solve takes solve_ffd (K7), and each round reproduces the JAX
    package's signature."""
    from karpenter_tpu_torch.cloud import CloudProvider, FakeCloud
    from karpenter_tpu_torch.controllers.provisioning import Provisioner
    from karpenter_tpu_torch.ops import ffd_kernels as fk
    from karpenter_tpu_torch.state import Cluster
    cell = "provision-small-3x64"
    env = workloads.provision_env(
        cell, FakeCloud, CloudProvider, Cluster, Provisioner, NodePool,
        generate_catalog(workloads.PROVISION_TYPES))
    for r, (kw, seed) in enumerate(workloads.PROVISION_CELLS[cell][1]):
        fk.reset_launches()
        sig, _ = workloads.provision_round(env, workloads.build_pods(
            rng=np.random.default_rng(seed), **kw))
        assert sig == workloads.GOLDEN_PROVISION[cell][r]
        assert fk.LAUNCHES["ffd_scan"] >= 1


# ---- the shard-batched kernels and the sharded paths (rows 13-17) ----

def _sharded_all(s, K, Ppad, plain):
    """K1-K4 and K6 shard-batched on the stacked shards `s`, through the
    wrappers or (`plain`) their plain versions."""
    sfx = "_plain" if plain else ""
    f = {k: getattr(ck, k + sfx) for k in (
        "classpack_precompute_sharded", "classpack_scan_sharded",
        "classpack_assign_decode_sharded", "classpack_aggregate_sharded",
        "classpack_slab_sharded")}
    m, ok = f["classpack_precompute_sharded"](
        s["req"], s["cap"], s["packed"], s["alloc"], s["price"], s["rank"])
    scan = f["classpack_scan_sharded"](
        s["req"], s["cnt"], s["packed"], s["cap"], s["alloc"], s["price"], m,
        ok, s["iopt"], s["iused"], K, True)
    a = f["classpack_assign_decode_sharded"](scan[4], s["cnt"], Ppad)
    agg = f["classpack_aggregate_sharded"](scan[0], s["price"], scan[2],
                                           scan[3])
    slab = f["classpack_slab_sharded"](a, K)
    return (m, ok, *scan, a, agg, *slab)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["plain", "existing", "exhaustion_existing",
                                  "caps_ranks", "full_classes"])
def test_cuda_sharded_kernels_match_plain(cuda_device, name):
    """K1-K4 and K6 over 4 shards (one empty, the class arrays shared)
    equal their plain versions and, shard for shard, the single-device
    kernels (K4 bit for bit); K8 equals its plain version bit for bit on a
    flat and a 2 x 2 mesh."""
    c = make_case(6, **CASES[name])
    K, Ppad, n = c["K"], c["Ppad"], 4
    s = stack_shards(c, n, np.random.default_rng(2), cuda_device)
    ck.reset_launches()
    got = _sharded_all(s, K, Ppad, plain=False)
    torch.cuda.synchronize()
    assert all(ck.LAUNCHES[k] == 1 for k in ck.KERNELS
               if k.endswith("_sharded"))
    want = _sharded_all(s, K, Ppad, plain=True)
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 8:                      # K4: the float32 cost within 1e-5
            assert torch.equal(g[:, 1:], w[:, 1:])
            assert all(_close(a, b) for a, b in zip(g[:, 0], w[:, 0]))
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), i
    for sh in range(n):
        m1, ok1 = ck.classpack_precompute(s["req"][sh], s["cap"][sh],
                                          s["packed"][sh], s["alloc"],
                                          s["price"], s["rank"])
        one = ck.classpack_scan(
            s["req"][sh], s["cnt"][sh].contiguous(), s["packed"][sh],
            s["cap"][sh], s["alloc"], s["price"], m1, ok1,
            None if s["iopt"] is None else s["iopt"][sh],
            None if s["iused"] is None else s["iused"][sh], K, True)
        a1 = ck.classpack_assign_decode(one[4], s["cnt"][sh].contiguous(),
                                        Ppad)
        g1 = ck.classpack_aggregate(one[0], s["price"], one[2], one[3])
        for g, w in zip((got[0][sh], got[1][sh], got[2][sh], got[3][sh],
                         got[6][sh], got[7][sh], got[8][sh]),
                        (m1, ok1, one[0], one[1], one[4], a1, g1)):
            assert torch.equal(g, w)
    flat = got[8]
    for hosts in (1, 2):
        k8 = ck.shard_psum(flat, hosts)
        assert torch.equal(k8, ck.shard_psum_plain(flat, hosts))
    assert ck.LAUNCHES["shard_psum"] == 2


@pytest.mark.cuda
def test_cuda_sharded_wrappers_refuse_bad_inputs(cuda_device):
    c = make_case(3)
    s = stack_shards(c, 2, np.random.default_rng(0), cuda_device)
    ck.reset_launches()
    # contract faults of the port's lowering: ShardLayoutError, a
    # KernelError that is also the TypeError / ValueError it replaces
    with pytest.raises(ck.ShardLayoutError) as got:
        ck.classpack_precompute_sharded(s["req"].float(), s["cap"],
                                        s["packed"], s["alloc"], s["price"],
                                        s["rank"])
    assert isinstance(got.value, TypeError)
    with pytest.raises(ck.ShardLayoutError) as got:
        ck.classpack_precompute_sharded(s["req"], s["cap"].cpu(),
                                        s["packed"], s["alloc"], s["price"],
                                        s["rank"])
    assert isinstance(got.value, ValueError)
    with pytest.raises(ck.ShardLayoutError):
        ck.shard_psum(torch.zeros((3, 5), device=cuda_device), 2)
    assert all(v == 0 for v in ck.LAUNCHES.values())


def _sharded_launches_moved():
    return all(ck.LAUNCHES[k] >= 1 for k in (
        "classpack_precompute_sharded", "classpack_scan_sharded"))


@pytest.mark.cuda
def test_cuda_sharded_paths_match_the_goldens(cuda_device):
    """The megafleet (three modes) and the headline over a flat and a
    2 x 4 mesh, 8 shards on the card, reproduce GOLDEN_SHARDED (the JAX
    package's, on the CPU); the shard-batched kernels launched, and the
    single-device scan only for the megafleet's residual reconcile."""
    from karpenter_tpu_torch.parallel import (make_host_mesh, make_pod_mesh,
                                              solve_partitioned,
                                              solve_sharded)
    n = workloads.MESH_SHARDS
    gold = workloads.GOLDEN_SHARDED
    prob = workloads.megafleet_problem(workloads.MEGAFLEET_UNITS)
    mesh = make_pod_mesh(n, shards_per_device=n)
    for mode, kw in workloads.MEGAFLEET_MODES.items():
        ck.reset_launches()
        res = solve_partitioned(prob, mesh=mesh,
                                max_nodes_per_shard=workloads.MEGAFLEET_K,
                                **kw)
        digest, total = workloads.sharded_answer(prob, res)
        assert digest == gold["megafleet-8x125k"][mode][0]
        assert total == pytest.approx(gold["megafleet-8x125k"][mode][1],
                                      rel=workloads.PSUM_RTOL, abs=0)
        assert _sharded_launches_moved()
        assert ck.LAUNCHES["classpack_scan"] == 1
    pods = workloads.build_pods(
        rng=np.random.default_rng(workloads.HEADLINE_SEED),
        **workloads.HEADLINE)
    hp = tensorize(pods, generate_catalog(workloads.HEADLINE_TYPES),
                   [NodePool()])
    a, u, cm = workloads.existing_nodes(
        hp, workloads.HEADLINE_EXISTING,
        np.random.default_rng(workloads.EXISTING_SEED))
    for name, m in (("pods", make_pod_mesh(n, shards_per_device=n)),
                    ("hosts", make_host_mesh(2, 4, shards_per_device=n))):
        for decode in (False, True):
            kw = dict(existing_alloc=a, existing_used=u,
                      existing_compat=cm) if decode else {}
            ck.reset_launches()
            res = solve_sharded(hp, m,
                                max_nodes_per_shard=workloads.HEADLINE_SHARDED_K,
                                decode=decode, **kw)
            digest, total = workloads.sharded_answer(hp, res)
            assert digest == gold["headline-sharded"][(name, decode)][0]
            assert total == pytest.approx(
                gold["headline-sharded"][(name, decode)][1],
                rel=workloads.PSUM_RTOL, abs=0)
            assert _sharded_launches_moved()
            assert ck.LAUNCHES["classpack_scan"] == 0


@pytest.mark.cuda
def test_cuda_sharded_cell_matches_the_golden(cuda_device):
    """provision-sharded-50k-20k through Provisioner.provision with an
    8-shard mesh on the card: both rounds answered by the sharded rung
    (row 17: the slab program shard-batched), each reproducing the JAX
    package's signature."""
    from karpenter_tpu_torch.cloud import CloudProvider, FakeCloud
    from karpenter_tpu_torch.controllers.provisioning import Provisioner
    from karpenter_tpu_torch.parallel import make_pod_mesh
    from karpenter_tpu_torch.state import Cluster
    cell = workloads.SHARDED_CELL
    n = workloads.MESH_SHARDS
    env = workloads.provision_env(
        cell, FakeCloud, CloudProvider, Cluster, Provisioner, NodePool,
        generate_catalog(workloads.PROVISION_TYPES),
        mesh=make_pod_mesh(n, shards_per_device=n))
    for r, (kw, seed) in enumerate(workloads.PROVISION_CELLS[cell][1]):
        ck.reset_launches()
        sig, _ = workloads.provision_round(env, workloads.build_pods(
            rng=np.random.default_rng(seed), **kw))
        assert sig == workloads.GOLDEN_SHARDED[cell][r]
        assert ck.LAUNCHES["classpack_slab_sharded"] == 1
        assert ck.LAUNCHES["classpack_scan"] == 0


# ---- K3, one launch per call: a class's row scanned in shared memory ----

K3_EDGES = ("every pod in one class", "empty classes", "all takes zero",
            "padding rows", "truncated repeat", "seeded")


@pytest.mark.cuda
@pytest.mark.parametrize("C,K,n_pods", [(40, 512, 3000), (16, 2**15, 4000)])
@pytest.mark.parametrize("name", K3_EDGES)
def test_cuda_assign_decode_edges_match_plain(cuda_device, name, C, K,
                                              n_pods):
    """K3 and K3s on edge inputs K2 could emit: one launch each, equal to
    their plain versions (int16 below K = 2^15, int32 at it).  The shard
    stack holds the case, the case with its classes reversed, and the case
    with no takes; then two shards sharing one counts row (stride 0)."""
    takes, counts, _ = workloads.assign_decode_edges(
        C, K, n_pods, np.random.default_rng(K))[name]
    t = torch.tensor(takes, device=cuda_device)
    c = torch.tensor(counts, device=cuda_device)
    ck.reset_launches()
    got = ck.classpack_assign_decode(t, c, n_pods)
    want = ck.classpack_assign_decode_plain(t, c, n_pods)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["classpack_assign_decode"] == 1
    assert got.dtype == want.dtype == (torch.int16 if K < 2**15
                                       else torch.int32)
    assert torch.equal(got, want)
    ts = torch.stack([t, t.flip(0), torch.zeros_like(t)])
    cs = torch.stack([c, c.flip(0), c])
    got = ck.classpack_assign_decode_sharded(ts, cs, n_pods)
    want = ck.classpack_assign_decode_sharded_plain(ts, cs, n_pods)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    shared = c.expand(2, C)
    got = ck.classpack_assign_decode_sharded(ts[::2].contiguous(), shared,
                                             n_pods)
    want = ck.classpack_assign_decode_sharded_plain(ts[::2], shared, n_pods)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ck.LAUNCHES["classpack_assign_decode_sharded"] == 2


@pytest.mark.cuda
def test_cuda_assign_decode_refuses_past_its_slots(cuda_device):
    t = torch.zeros((2, 2**15 + 4), dtype=torch.int32, device=cuda_device)
    c = torch.ones(2, dtype=torch.int32, device=cuda_device)
    ck.reset_launches()
    with pytest.raises(KernelError):
        ck.classpack_assign_decode(t, c, 4)
    assert ck.LAUNCHES["classpack_assign_decode"] == 0


# ---- pdhg: the resident kernel (operator in shared memory) and the
# streaming one, chosen by shape ----

def _lp_ops(insts, dev):
    from karpenter_tpu_torch.ops import lpsolve as lp
    torch.backends.cuda.matmul.allow_tf32 = False
    bt = lp.pad_batch(insts)
    return [torch.from_numpy(a).to(dev) for a in bt.operands()], bt


def _lp_insts(seed, shapes, inf_u=False):
    from karpenter_tpu_torch.ops import lpsolve as lp
    rng = np.random.default_rng(seed)
    out = []
    for n, me, mi in shapes:
        c, A, b, G, h, u = random_lp(rng, n, me, mi)
        if inf_u:
            u[::3] = np.inf
        out.append(lp.LPInstance(c=np.asarray(c, np.float32), A_eq=A,
                                 b_eq=b, A_ub=G, b_ub=h, upper=u))
    return out


def _agree(got, want, c, what):
    """Same status, objective within relative 1e-3, x within 2e-2,
    iterations within a factor 1.5 (float32 sums in another order)."""
    for i in range(c.shape[0]):
        assert bool(got[3][i]) == bool(want[3][i]), what
        og = float(c[i].astype(np.float64) @ got[0][i])
        ow = float(c[i].astype(np.float64) @ want[0][i])
        assert og == pytest.approx(ow, rel=1e-3, abs=1e-3), what
        np.testing.assert_allclose(got[0][i], want[0][i], atol=2e-2,
                                   err_msg=what)
        assert got[4][i] <= 1.5 * want[4][i] and \
            want[4][i] <= 1.5 * got[4][i], what


@pytest.mark.cuda
@pytest.mark.parametrize("shapes,inf_u", [
    ([(20, 5, 8)], False), ([(80, 20, 30)], True), ([(1500, 40, 60)], False),
    ([(1800, 100, 200)], False), ([(20, 5, 8), (28, 7, 12), (16, 4, 6)],
                                  False)])
def test_cuda_pdhg_resident_matches_plain_and_streaming(
        cuda_device, monkeypatch, shapes, inf_u):
    """These masters fit the SMs' shared memory, so the launch takes the
    resident kernel; it agrees with the plain version and with the
    streaming kernel (forced by a plan of None) on the same operands."""
    from karpenter_tpu_torch.ops import lpsolve as lp
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    ops, bt = _lp_ops(_lp_insts(len(shapes) + shapes[0][0], shapes, inf_u),
                      cuda_device)
    args = (*ops, lp.DEFAULT_EPS, 20000, lp.DEFAULT_CHECK_EVERY)
    lk.reset_launches()
    res = [g.cpu().numpy() for g in lk.pdhg(*args)]
    assert lk.LAUNCHES == {"pdhg": 1, "pdhg_resident": 1}
    monkeypatch.setattr(lk, "resident_plan", lambda *a: None)
    stream = [g.cpu().numpy() for g in lk.pdhg(*args)]
    assert lk.LAUNCHES == {"pdhg": 2, "pdhg_resident": 1}
    want = [w.cpu().numpy() for w in lk.pdhg_plain(*args)]
    assert all(bool(d) for d in res[3])
    _agree(res, want, bt.c, "resident vs plain")
    _agree(res, stream, bt.c, "resident vs streaming")


@pytest.mark.cuda
def test_cuda_pdhg_resident_is_deterministic(cuda_device):
    """Two resident launches of the same operands give the same bits (the
    band partials are summed in a fixed order), on a master cut into many
    tiles and on a batch."""
    from karpenter_tpu_torch.ops import lpsolve as lp
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    for shapes in ([(2000, 128, 256)], [(20, 5, 8), (28, 7, 12)]):
        ops, _ = _lp_ops(_lp_insts(5, shapes), cuda_device)
        args = (*ops, lp.DEFAULT_EPS, 4000, lp.DEFAULT_CHECK_EVERY)
        plan = lk.device_plan(ops[0].shape[0], ops[0].shape[1]
                              + ops[2].shape[1], ops[0].shape[2],
                              cuda_device)
        assert plan is not None
        lk.reset_launches()
        one, two = lk.pdhg(*args), lk.pdhg(*args)
        torch.cuda.synchronize()
        assert lk.LAUNCHES["pdhg_resident"] == 2
        for a, b in zip(one, two):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_pdhg_plan_fits_the_card(cuda_device):
    """The plan's shared memory is the kernel's own count, and the
    headline master (B=1, 768 × 8192) is resident on this card while a
    B=2 batch of it is not."""
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    sms, optin, smem = lk.device_smem(cuda_device)
    assert 0 < smem < optin
    for h, w in ((1, 4), (13, 64), (128, 376)):
        assert lk._lib().lp_resident_smem(h, w) == lk.resident_smem_bytes(h, w)
    if sms >= 132 and optin >= 232_448:
        assert lk.device_plan(1, 768, 8192, cuda_device) is not None
        assert lk.device_plan(2, 768, 8192, cuda_device) is None


@pytest.mark.cuda
def test_cuda_pdhg_resident_launch_error_raises(cuda_device, monkeypatch):
    """A resident launch the card refuses (a tile past the shared memory a
    block can hold) raises KernelError and is not retried on the streaming
    kernel."""
    from karpenter_tpu_torch.ops import lpsolve as lp
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    ops, _ = _lp_ops(_lp_insts(9, [(80, 20, 30)]), cuda_device)
    B, mt, n = ops[0].shape[0], ops[0].shape[1] + ops[2].shape[1], \
        ops[0].shape[2]
    monkeypatch.setattr(lk, "resident_plan", lambda *a: lk.ResidentPlan(
        B=B, mt=mt, n=n, row_bands=1, col_bands=1, band_rows=mt,
        band_cols=1 << 16))
    lk.reset_launches()
    with pytest.raises(KernelError):
        lk.pdhg(*ops, lp.DEFAULT_EPS, 64, lp.DEFAULT_CHECK_EVERY)
    assert lk.LAUNCHES == {"pdhg": 0, "pdhg_resident": 0}


@pytest.mark.cuda
def test_cuda_pdhg_launches_after_a_refused_launch(cuda_device, monkeypatch):
    """A refused resident launch leaves no error behind it: the next
    streaming launch in the same thread runs and equals plain."""
    from karpenter_tpu_torch.ops import lpsolve as lp
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    ops, _ = _lp_ops(_lp_insts(9, [(80, 20, 30)]), cuda_device)
    B, mt, n = ops[0].shape[0], ops[0].shape[1] + ops[2].shape[1], \
        ops[0].shape[2]
    with monkeypatch.context() as m:
        m.setattr(lk, "resident_plan", lambda *a: lk.ResidentPlan(
            B=B, mt=mt, n=n, row_bands=1, col_bands=1, band_rows=mt,
            band_cols=1 << 16))
        with pytest.raises(KernelError):
            lk.pdhg(*ops, lp.DEFAULT_EPS, 64, lp.DEFAULT_CHECK_EVERY)
    monkeypatch.setattr(lk, "resident_plan", lambda *a: None)
    lk.reset_launches()
    got = lk.pdhg(*ops, lp.DEFAULT_EPS, 64, lp.DEFAULT_CHECK_EVERY)
    want = lk.pdhg_plain(*ops, lp.DEFAULT_EPS, 64, lp.DEFAULT_CHECK_EVERY)
    assert lk.LAUNCHES == {"pdhg": 1, "pdhg_resident": 0}
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    assert float((got[0] - want[0]).abs().max()) <= 2e-2


# ---- K6 / K6s and K7 redesigned for Hopper (slice 7) ----

def _k3_slots(rng, n, K, classes=64, unplaced=0.05):
    """n K3-shaped slots: each class's pods in rising slots, then its
    unplaced rows (-1); the padding at the end unplaced."""
    live = n - n // 32
    rows = []
    for size in rng.multinomial(live, np.ones(classes) / classes):
        slots = np.sort(rng.integers(0, K, size=int(size)))
        cut = int(size * (1 - unplaced))
        rows.append(np.concatenate([slots[:cut],
                                    np.full(int(size) - cut, -1)]))
    rows.append(np.full(n - live, -1))
    return np.concatenate(rows)


def _slab_twice(a, K, sharded):
    """The kernel twice on the same slots (the second launch must give the
    same bits) and its plain version."""
    f = ck.classpack_slab_sharded if sharded else ck.classpack_slab
    plain = (ck.classpack_slab_sharded_plain if sharded
             else ck.classpack_slab_plain)
    ck.reset_launches()
    got, again, want = f(a, K), f(a, K), plain(a, K)
    torch.cuda.synchronize()
    for g, h, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(g, h)
    assert ck.LAUNCHES["classpack_slab_sharded" if sharded
                       else "classpack_slab"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_cuda_slab_sharded_megafleet_shape_matches_plain(cuda_device, dtype):
    """8 shards x 131 072 rows, K = 4096 (the megafleet's row 17): K3-shaped
    slots, shard 5 all unplaced, shard 6 random."""
    rng = np.random.default_rng(71)
    K, n = 4096, 131_072
    a = np.stack([_k3_slots(rng, n, K) for _ in range(8)])
    a[5] = -1
    a[6] = rng.integers(-1, K, size=n)
    _slab_twice(torch.tensor(a.astype(dtype), device=cuda_device), K, True)


@pytest.mark.cuda
@pytest.mark.parametrize("n_sh,K,n", [
    (1, 4096, 131_072),      # n = 1: the single-device launch's shape
    (1, 8192, 300_000),      # above the (K+1)·n < 2^31 guard
    (2, 8192, 300_000),
    (3, 32_768, 5000),       # one warp table per scatter block
    (8, 4096, 100)])         # fewer rows than keys
def test_cuda_slab_sharded_edges_match_plain(cuda_device, n_sh, K, n):
    rng = np.random.default_rng(K + n + n_sh)
    a = np.stack([_k3_slots(rng, n, K) for _ in range(n_sh)])
    t = torch.tensor(a.astype(np.int16 if K < 2**15 else np.int32),
                     device=cuda_device)
    _slab_twice(t, K, True)
    _slab_twice(t[0].contiguous(), K, False)


@pytest.mark.cuda
@pytest.mark.parametrize("name", workloads.FFD_CURSOR_CASES)
def test_cuda_ffd_scan_cursor_cases_match_plain(cuda_device, name):
    """K7 on the inputs that break its first-fit cursor's runs: every
    output equal to the plain version's, slot usage bit for bit, and a
    second launch equal to the first."""
    from karpenter_tpu_torch.ops import ffd_kernels as fk
    arrays, K = workloads.ffd_cursor_case(name, np.random.default_rng(7),
                                          P=2048)
    args = [torch.tensor(a, device=cuda_device) for a in arrays]
    fk.reset_launches()
    got, again = fk.ffd_scan(*args, K), fk.ffd_scan(*args, K)
    want = fk.ffd_scan_plain(*args, K)
    torch.cuda.synchronize()
    for g, h, w in zip(got, again, want):
        assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g, h)
    assert fk.LAUNCHES["ffd_scan"] == 2


@pytest.mark.cuda
def test_cuda_ffd_scan_at_the_ffd_cell_shape(cuda_device):
    """A seeded P = 8192 scan at the provision-ffd-50k cell's widths
    (R = 7, 3600 options, K = 2048), with existing slots."""
    from karpenter_tpu_torch.ops import ffd_kernels as fk
    arrays, K = workloads.ffd_scan_inputs(np.random.default_rng(50), P=8192,
                                          C=160, O=3600, R=7, E=64, K=2048)
    args = [torch.tensor(a, device=cuda_device) for a in arrays]
    got, again = fk.ffd_scan(*args, K), fk.ffd_scan(*args, K)
    want = fk.ffd_scan_plain(*args, K)
    torch.cuda.synchronize()
    for g, h, w in zip(got, again, want):
        assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,scratch", [
    # 8192 options at the ffd cell's K and R: the slot state in shared
    # memory, the candidate list (12 bytes an option) in global scratch
    (dict(P=4096, C=64, O=8192, R=7, K=2048), 8192 * 12),
    # both in global scratch: the state's allocatable and class counts
    # (the outputs hold the rest), then the candidates
    (dict(P=2048, C=48, O=20000, R=12, K=4096),
     4096 * 12 * 4 + 4096 * 4 + 20000 * 12)])
def test_cuda_ffd_scan_candidates_in_global_scratch(cuda_device, kw,
                                                    scratch):
    """K7 where the new-node candidate list does not fit shared memory:
    equal to the plain version, slot usage bit for bit, and a second
    launch equal to the first."""
    from karpenter_tpu_torch.ops import ffd_kernels as fk
    arrays, K = workloads.ffd_scan_inputs(np.random.default_rng(kw["O"]),
                                          E=32, **kw)
    args = [torch.tensor(a, device=cuda_device) for a in arrays]
    T = args[1].shape[0]
    assert fk._lib().ffd_scratch_bytes(kw["O"] + 32, kw["R"], K, T) == \
        scratch + 32 * 12
    got, again = fk.ffd_scan(*args, K), fk.ffd_scan(*args, K)
    want = fk.ffd_scan_plain(*args, K)
    torch.cuda.synchronize()
    assert int(got[3]) > 32
    for g, h, w in zip(got, again, want):
        assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1000, 97])
def test_cuda_ffd_scan_ragged_last_chunk(cuda_device, P):
    """A row count that is no multiple of the walking warp's 32: the last
    chunk's missing rows join no run of identical rows and no padding run."""
    from karpenter_tpu_torch.ops import ffd_kernels as fk
    arrays, K = workloads.ffd_cursor_case("all, existing slots",
                                          np.random.default_rng(P), P=P)
    args = [torch.tensor(a, device=cuda_device) for a in arrays]
    got = fk.ffd_scan(*args, K)
    want = fk.ffd_scan_plain(*args, K)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ---- K2 / K2s (one cluster per shard) and K5 (a row's short class step) ----

def _headline_case(seed, K=8192, R=7, E=0):
    """A case at the headline's shapes (Cpad 256, Opad 4096, R = 7) with
    zero-count classes between non-empty ones and one negative count."""
    c = make_case(seed, C=200, Cpad=256, O=3600, Opad=4096, R=R, K=K, E=E)
    c["cnt"][:200:5] = 0
    c["cnt"][3] = -2
    return c


def _scan_twice(args, K, emit):
    got = ck.classpack_scan(*args, K, emit)
    again = ck.classpack_scan(*args, K, emit)
    want = ck.classpack_scan_plain(*args, K, emit)
    torch.cuda.synchronize()
    for g, h, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(g, h)
    return got


def _scan_args(c, dev):
    (req, cnt, packed, cap, alloc, price, rank), (iopt, iused) = _on(c, dev)
    m, ok = ck.classpack_precompute(req, cap, packed, alloc, price, rank)
    return (req, cnt, packed, cap, alloc, price, m, ok, iopt, iused)


@pytest.mark.cuda
@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
def test_cuda_scan_each_cluster_size_matches_plain(cuda_device, cs, emit):
    """K2 at the headline's shapes at a slot count whose plan takes
    clusters of `cs` CTAs (K = 64, 256, 512, 1024, 2048; slots run out),
    twice, bit-equal to the plain version."""
    K = {1: 64, 2: 256, 4: 512, 8: 1024, 16: 2048}[cs]
    args = _scan_args(_headline_case(1, K=K, E=40), cuda_device)
    plan = ck.scan_plan_for(cuda_device, K, 7, 4096, 1)
    assert (plan.cluster, plan.state_smem, plan.stage) == (cs, True, True)
    ck.reset_launches()
    _scan_twice(args, K, emit)
    assert ck.LAUNCHES["classpack_scan"] == 2


def _misaligned(t):
    """A contiguous copy of `t` 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() * t.element_size() + 16, dtype=torch.uint8,
                      device=t.device)
    u = buf[4:4 + t.numel() * t.element_size()].view(t.dtype).view(t.shape)
    u.copy_(t)
    return u


# (K, R, Opad, aligned) -> (state in shared memory, staged): the layouts
# that read the class rows in place
UNSTAGED_SCANS = {
    "opad32768": (1000, 7, 32_768, True, (True, False)),
    "opad32768-state-global": (32_768, 32, 32_768, True, (False, False)),
    "o3600": (8192, 7, 3600, True, (True, False)),
    "o3600-state-global": (32_768, 32, 3600, True, (False, False)),
    "misaligned-m": (8192, 7, 4096, False, (True, False)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("name", sorted(UNSTAGED_SCANS))
def test_cuda_scan_unstaged_layouts_match_plain(cuda_device, name, emit):
    """K2 in the layouts that read the class rows in place: the widest
    option bucket (Opad 32 768, whose staging fits no CTA), options not a
    multiple of 128 and an m_all 4 bytes off a 16-byte boundary; with the
    slot state in shared memory and in a global slice.  Twice, bit-equal
    to the plain version."""
    K, R, O, aligned, want = UNSTAGED_SCANS[name]
    c = make_case(7, C=48, Cpad=64, O=O - 64, Opad=O, R=R, K=K, E=40)
    c["cnt"][:48:5] = 0
    args = list(_scan_args(c, cuda_device))
    if not aligned:
        args[6] = _misaligned(args[6])
        assert args[6].data_ptr() % 16 == 4
    plan = ck.scan_plan_for(cuda_device, K, R, O, 1, aligned=aligned)
    assert (plan.state_smem, plan.stage) == want
    got = _scan_twice(tuple(args), K, emit)
    assert int(got[2]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("K,R,E", [(1, 7, 0), (37, 7, 12), (1000, 5, 12),
                                   (32_768, 7, 40), (32_768, 32, 0)])
def test_cuda_scan_slot_edges_match_plain(cuda_device, K, R, E, emit):
    """K2 at one slot, at a K no cluster size divides, at slot exhaustion,
    at K3's widest 32 768 slots (in shared memory at R = 7, in the global
    layout at R = 32), twice each, bit-equal to the plain version."""
    c = _headline_case(2, K=K, R=R, E=E)
    args = _scan_args(c, cuda_device)
    plan = ck.scan_plan_for(cuda_device, K, R, 4096, 1)
    assert plan.state_smem == (R != 32)
    got = _scan_twice(args, K, emit)
    if K < 1000:
        assert int(got[3]) > 0          # slots ran out: pods unscheduled


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8])
def test_cuda_scan_sharded_matches_plain_and_serial(cuda_device, n):
    """K2s at the headline's shapes over n shards (one cluster each), twice,
    bit-equal to its plain version and to n single-device launches."""
    c = _headline_case(3, E=40)
    s = stack_shards(c, max(n, 2), np.random.default_rng(8), cuda_device)
    if n == 1:
        s = {k: (v[:1].contiguous() if k in ("req", "cnt", "packed", "cap",
                                             "iopt", "iused")
                 and v is not None else v) for k, v in s.items()}
    m, ok = ck.classpack_precompute_sharded(s["req"], s["cap"], s["packed"],
                                            s["alloc"], s["price"], s["rank"])
    for emit in (False, True):
        args = (s["req"], s["cnt"], s["packed"], s["cap"], s["alloc"],
                s["price"], m, ok, s["iopt"], s["iused"], c["K"], emit)
        got = ck.classpack_scan_sharded(*args)
        again = ck.classpack_scan_sharded(*args)
        want = ck.classpack_scan_sharded_plain(*args)
        torch.cuda.synchronize()
        for g, h, w in zip(got, again, want):
            assert torch.equal(g, w) and torch.equal(g, h)
        for i in range(n):
            one = ck.classpack_scan(
                s["req"][i], s["cnt"][i].contiguous(), s["packed"][i],
                s["cap"][i], s["alloc"], s["price"], m[i], ok[i],
                None if s["iopt"] is None else s["iopt"][i],
                None if s["iused"] is None else s["iused"][i], c["K"], emit)
            for g, w in zip(got, one):
                assert torch.equal(g[i], w)


@pytest.mark.cuda
def test_cuda_scan_refuses_instead_of_falling_back(cuda_device, monkeypatch):
    """A launch the kernel refuses (a plan that does not match its carve, a
    cluster the card does not schedule) raises KernelError; nothing runs
    the plain version on a CUDA tensor."""
    args = _scan_args(_headline_case(4), cuda_device)
    plan = ck.scan_plan_for(cuda_device, 8192, 7, 4096, 1)
    ck.reset_launches()
    bad = dataclasses.replace(plan, smem=plan.smem + 16)
    monkeypatch.setattr(ck, "scan_plan_for", lambda *a, **k: bad)
    with pytest.raises(KernelError):
        ck.classpack_scan(*args, 8192, True)
    # the carve of one CTA holding all 8192 slots and the staging: more
    # shared memory than a block may opt into, refused by the launch
    one = dataclasses.replace(
        plan, cluster=1, threads=512, slots_per_thread=16, per_cta=8192,
        state_smem=True, stage=True,
        smem=ck.scan_smem_bytes(1, 512, 16, 7, 4096, True, True))
    monkeypatch.setattr(ck, "scan_plan_for", lambda *a, **k: one)
    with pytest.raises(KernelError):
        ck.classpack_scan(*args, 8192, True)
    monkeypatch.setattr(ck, "scan_plan_for", lambda *a, **k: (_ for _ in ()
                        ).throw(ck.KernelLimitError("no layout")))
    with pytest.raises(KernelError):
        ck.classpack_scan(*args, 8192, True)
    assert ck.LAUNCHES["classpack_scan"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 40, 512])
def test_cuda_sweep_rows_match_plain(cuda_device, B):
    """K5 at one row, at 40 and at 512 rows, twice, against its plain
    version."""
    s = make_sweep_case(5, B=max(B, 8), E=12)
    req, counts, packed, cap, alloc, price, rank, mpacked, caps, iopt, iused \
        = _sweep_on(s, cuda_device)
    reps = -(-B // counts.shape[0])
    cb = counts.repeat(reps, 1)[:B].contiguous()
    mb = mpacked.repeat(reps, 1)[:B].contiguous()
    pb = caps.repeat(reps)[:B].contiguous()
    m_all, _ = ck.classpack_precompute(req, cap, packed, alloc, price, rank)
    args = (req, cb, packed, cap, alloc, price, rank, mb, pb, iopt, iused,
            m_all, s["K"])
    got = ck.classpack_sweep(*args)
    again = ck.classpack_sweep(*args)
    want = ck.classpack_sweep_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got[:, 1:], want[:, 1:])
    assert all(_close(a, b) for a, b in zip(got[:, 0].tolist(),
                                            want[:, 0].tolist()))


# (K, Opad, aligned) -> (state, invariants in shared memory, staged)
UNSTAGED_SWEEPS = {
    "opad32768": (512, 32_768, True, (True, False, False)),
    "opad32768-state-global": (8192, 32_768, True, (False, False, False)),
    "o3600": (512, 3600, True, (True, True, False)),
    "o3600-state-global": (8192, 3600, True, (False, True, False)),
    "misaligned-m": (512, 4096, False, (True, True, False)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(UNSTAGED_SWEEPS))
def test_cuda_sweep_unstaged_layouts_match_plain(cuda_device, name):
    """K5 in the layouts that read the class rows in place: Opad 32 768
    (the row's invariants too wide for shared memory), options not a
    multiple of 128 and an m_all 4 bytes off a 16-byte boundary; the slot
    state in shared memory and in a global slice.  Twice, bit-equal, and
    equal to the plain version."""
    K, O, aligned, want = UNSTAGED_SWEEPS[name]
    s = make_sweep_case(9, B=8, C=48, Cpad=64, O=O - 64, Opad=O, R=7, K=K,
                        E=12)
    req, counts, packed, cap, alloc, price, rank, mpacked, caps, iopt, iused \
        = _sweep_on(s, cuda_device)
    m_all, _ = ck.classpack_precompute(req, cap, packed, alloc, price, rank)
    if not aligned:
        m_all = _misaligned(m_all)
    plan = ck.sweep_plan_for(cuda_device, K, 7, O, 8, aligned=aligned)
    assert (plan.state_smem, plan.inv_smem, plan.stage) == want
    args = (req, counts, packed, cap, alloc, price, rank, mpacked, caps,
            iopt, iused, m_all, K)
    got = ck.classpack_sweep(*args)
    again = ck.classpack_sweep(*args)
    want_out = ck.classpack_sweep_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got[:, 1:], want_out[:, 1:])
    assert all(_close(a, b) for a, b in zip(got[:, 0].tolist(),
                                            want_out[:, 0].tolist()))


@pytest.mark.cuda
def test_cuda_step_probe_measures_a_positive_step(cuda_device):
    """The least class step (a chain of dependent exchanges, with and
    without a block reduction) for the bounds: positive cycles, the
    reduction adding to the exchange."""
    for cs, T in ((1, 128), (1, 1024), (8, 1024), (16, 512)):
        bare = ck.step_cycles(cs, T, False)
        full = ck.step_cycles(cs, T, True)
        assert 0 < bare < full


# ---- K1 / K1s (tiles of classes x options, clusters along the options) and
# K4 / K4s (a cluster of CTAs a shard) ----

K1_SHAPES = {**PRECOMPUTE_PATH_SHAPES, **PRECOMPUTE_EDGE_SHAPES}


@pytest.mark.cuda
@pytest.mark.parametrize("trap", [None, "all_inf"])
@pytest.mark.parametrize("name", sorted(K1_SHAPES))
def test_cuda_precompute_matches_plain_at_every_shape(cuda_device, name,
                                                      trap):
    """K1 (n = 1) and K1s (n > 1) at the main paths' shapes and the edges,
    on inputs with K1's parity traps: bit-equal to plain and to the tile
    model, twice over, and with_ok=False giving the same m and no ok.  K1s
    also equals n single-device launches, and with every per-shard operand
    shared it computes one shard."""
    n, C, O, R = K1_SHAPES[name]
    c = make_precompute_case(sum(map(ord, name)), n=n, C=C, O=O, R=R,
                             trap=trap)
    ck.reset_launches()
    if n == 1:
        args = precompute_args(c, cuda_device, shard=0)
        got, again = ck.classpack_precompute(*args), \
            ck.classpack_precompute(*args)
        want = ck.classpack_precompute_plain(*args)
        m_only, none = ck.classpack_precompute(*args, with_ok=False)
        torch.cuda.synchronize()
        assert none is None and torch.equal(m_only, want[0])
        plan = ck.precompute_plan_for(cuda_device, C, O, R, 1)
        if C * O <= 2**20:
            mm, mok = ck.precompute_tile_model(
                *[a.cpu().numpy() for a in args], plan)
            assert np.array_equal(mm, got[0].cpu().numpy())
            assert np.array_equal(mok, got[1].cpu().numpy())
        assert ck.LAUNCHES["classpack_precompute"] == 3
    else:
        args = precompute_args(c, cuda_device)
        got = ck.classpack_precompute_sharded(*args)
        again = ck.classpack_precompute_sharded(*args)
        want = ck.classpack_precompute_sharded_plain(*args)
        torch.cuda.synchronize()
        for i in range(n):
            one = ck.classpack_precompute(
                *precompute_args(c, cuda_device, shard=i))
            assert torch.equal(got[0][i], one[0])
            assert torch.equal(got[1][i], one[1])
        shared = [a[:1].expand(n, *a.shape[1:]) for a in args[:3]]
        m1, ok1 = ck.classpack_precompute_sharded(*shared, *args[3:])
        assert m1.stride(0) == 0 and torch.equal(m1[n - 1], want[0][0])
        assert torch.equal(ok1[n - 1], want[1][0])
        assert ck.LAUNCHES["classpack_precompute_sharded"] == 3
    for g, h, w in zip(got, again, want):
        assert g.dtype == w.dtype and torch.equal(g, h) and torch.equal(g, w)


K4_SHAPES = [(1, 1), (1, 8192), (37, 512), (8192, 4096), (32_768, 1),
             (32_768, 8192)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["runs", "hot", "closed", "all_inf"])
@pytest.mark.parametrize("K,O", K4_SHAPES)
def test_cuda_aggregate_edges_match_plain(cuda_device, K, O, kind):
    """K4 at one slot and at K3's widest 32 768, at one option and at 8192,
    with every slot one option (the hot bin), every slot closed and every
    price +inf: counts exact, the cost within REL_TOL of the plain
    version's and equal, bit for bit, to `aggregate_sum_model` (the
    kernel's order), and two launches bit-equal."""
    s = make_slot_case(K + O, n=1, K=K, O=O, kind=kind)
    t = lambda a: torch.tensor(a, device=cuda_device)  # noqa: E731
    so, price = t(s["slot_option"][0]), t(s["price"])
    n_open, n_unsched = t(s["n_open"][0]), t(s["n_unsched"][0])
    ck.reset_launches()
    got = ck.classpack_aggregate(so, price, n_open, n_unsched)
    again = ck.classpack_aggregate(so, price, n_open, n_unsched)
    want = ck.classpack_aggregate_plain(so, price, n_open, n_unsched)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got[1:], want[1:])
    assert _close(got[0], want[0])
    plan = ck.aggregate_plan_for(cuda_device, K, O, 1)
    cost, counts = ck.aggregate_sum_model(s["slot_option"][0], s["price"],
                                          plan)
    assert np.float32(got[0].item()).tobytes() == cost.tobytes()
    assert np.array_equal(counts.astype(np.float32), got[3:].cpu().numpy())
    assert ck.LAUNCHES["classpack_aggregate"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["runs", "hot", "closed"])
@pytest.mark.parametrize("K,O", [(4096, 512), (32_768, 8192), (1, 1)])
def test_cuda_aggregate_sharded_strided_matches_plain(cuda_device, K, O,
                                                      kind):
    """K4s over 8 shards with n_open and n_unsched read as strided columns
    of one n x 2 tensor (as K2s leaves its scalars): equal to plain and to
    8 single-device launches, bit-equal launch to launch."""
    n = 8
    s = make_slot_case(K * 3 + O, n=n, K=K, O=O, kind=kind)
    t = lambda a: torch.tensor(a, device=cuda_device)  # noqa: E731
    so, price = t(s["slot_option"]), t(s["price"])
    scalars = t(np.stack([s["n_open"], s["n_unsched"]], 1))
    n_open, n_unsched = scalars[:, 0], scalars[:, 1]
    got = ck.classpack_aggregate_sharded(so, price, n_open, n_unsched)
    again = ck.classpack_aggregate_sharded(so, price, n_open, n_unsched)
    want = ck.classpack_aggregate_sharded_plain(so, price, n_open, n_unsched)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got[:, 1:], want[:, 1:])
    assert all(_close(a, b) for a, b in zip(got[:, 0].tolist(),
                                            want[:, 0].tolist()))
    for i in range(n):
        one = ck.classpack_aggregate(so[i], price, n_open[i], n_unsched[i])
        assert torch.equal(got[i, 1:], one[1:])


@pytest.mark.cuda
def test_cuda_precompute_and_aggregate_refuse_without_fallback(cuda_device,
                                                               monkeypatch):
    """A shape K1's plan refuses (more options than 16 CTAs cover) raises
    KernelLimitError, and a plan the kernels refuse (a carve that does not
    match) raises KernelError; neither launches, and nothing runs the plain
    version on a CUDA tensor."""
    def no_plain(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")
    monkeypatch.setattr(ck, "classpack_precompute_plain", no_plain)
    monkeypatch.setattr(ck, "classpack_aggregate_plain", no_plain)
    ck.reset_launches()
    c = make_precompute_case(2, C=4, O=16 * 4 * 8 * 1024 + 1, R=2)
    with pytest.raises(ck.KernelLimitError):
        ck.classpack_precompute(*precompute_args(c, cuda_device, shard=0))
    c = make_precompute_case(2, C=16, O=512, R=7)
    args = precompute_args(c, cuda_device, shard=0)
    plan = ck.precompute_plan_for(cuda_device, 16, 512, 7, 1)
    bad = dataclasses.replace(plan, smem=plan.smem + 16)
    monkeypatch.setattr(ck, "precompute_plan_for", lambda *a, **k: bad)
    with pytest.raises(KernelError):
        ck.classpack_precompute(*args)
    s = make_slot_case(5, n=1, K=8192, O=4096)
    t = lambda a: torch.tensor(a, device=cuda_device)  # noqa: E731
    aplan = ck.aggregate_plan_for(cuda_device, 8192, 4096, 1)
    monkeypatch.setattr(ck, "aggregate_plan_for", lambda *a, **k:
                        dataclasses.replace(aplan, per_cta=aplan.per_cta - 1))
    with pytest.raises(KernelError):
        ck.classpack_aggregate(t(s["slot_option"][0]), t(s["price"]),
                               t(s["n_open"][0]), t(s["n_unsched"][0]))
    torch.cuda.synchronize()
    assert ck.LAUNCHES["classpack_precompute"] == 0
    assert ck.LAUNCHES["classpack_aggregate"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cs", [2, 4, 8, 16])
def test_cuda_precompute_cluster_exchange_matches_plain(cuda_device, cs,
                                                        monkeypatch):
    """K1 and K1s with a class's options over a cluster of cs CTAs, whose
    minima meet in distributed shared memory: the plan takes a cluster past
    32 768 options, so the headline's 4096 are cut over cs CTAs here by a
    forced plan (and 40 000 options take the plan's own).  Twice, bit-equal
    to plain."""
    C, O, R = 40, 4096, 7
    T = O // (4 * cs)
    plan = ck.PrecomputePlan(classes=4, options=4 * T, cluster=cs, threads=T,
                             groups=1, stage=True,
                             smem=ck.precompute_smem_bytes(R, 4 * T, True, 4,
                                                           T))
    c = make_precompute_case(cs, n=3, C=C, O=O, R=R)
    real = ck.precompute_plan_for
    monkeypatch.setattr(ck, "precompute_plan_for", lambda *a, **k: plan)
    one = precompute_args(c, cuda_device, shard=0)
    stack = precompute_args(c, cuda_device)
    for fn, plain, args in ((ck.classpack_precompute,
                             ck.classpack_precompute_plain, one),
                            (ck.classpack_precompute_sharded,
                             ck.classpack_precompute_sharded_plain, stack)):
        got, again, want = fn(*args), fn(*args), plain(*args)
        torch.cuda.synchronize()
        for g, h, w in zip(got, again, want):
            assert torch.equal(g, h) and torch.equal(g, w)
    monkeypatch.setattr(ck, "precompute_plan_for", real)
    c = make_precompute_case(7, n=1, C=6, O=40_000, R=7)
    args = precompute_args(c, cuda_device, shard=0)
    assert ck.precompute_plan_for(cuda_device, 6, 40_000, 7, 1).cluster > 1
    got, want = ck.classpack_precompute(*args), \
        ck.classpack_precompute_plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
def test_cuda_aggregate_each_cluster_size(cuda_device, cs, monkeypatch):
    """K4 and K4s at each cluster size (forced; the plan's own is one CTA
    up to 8192 slots and a cluster past them): counts exact, the cost
    bit-equal to `aggregate_sum_model` under that plan, twice."""
    K, O = 8192, 4096
    plan = ck.AggregatePlan(cluster=cs, threads=ck.AGG_THREADS,
                            per_cta=-(-K // cs), smem=4 * O)
    monkeypatch.setattr(ck, "aggregate_plan_for", lambda *a, **k: plan)
    s = make_slot_case(cs, n=3, K=K, O=O)
    t = lambda a: torch.tensor(a, device=cuda_device)  # noqa: E731
    so, price = t(s["slot_option"]), t(s["price"])
    n_open, n_unsched = t(s["n_open"]), t(s["n_unsched"])
    got = ck.classpack_aggregate_sharded(so, price, n_open, n_unsched)
    again = ck.classpack_aggregate_sharded(so, price, n_open, n_unsched)
    one = ck.classpack_aggregate(so[0], price, n_open[0], n_unsched[0])
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got[0], one)
    for i in range(3):
        cost, counts = ck.aggregate_sum_model(s["slot_option"][i],
                                              s["price"], plan)
        assert np.float32(got[i, 0].item()).tobytes() == cost.tobytes()
        assert np.array_equal(counts.astype(np.float32),
                              got[i, 3:].cpu().numpy())
        assert got[i, 1].item() == s["n_open"][i]
        assert got[i, 2].item() == s["n_unsched"][i]


# ---- the arena and the operator (slice 11) ----

SMALL_LIVE = [(dict(workloads.HEADLINE, spec_count=40, total=2000), 0),
              (dict(workloads.PROVISION_ROUND2, spec_count=40, total=800), 5)]


def _small_live(device, arena):
    from karpenter_tpu_torch.cloud import CloudProvider, FakeCloud
    from karpenter_tpu_torch.controllers.provisioning import Provisioner
    from karpenter_tpu_torch.state import Cluster
    clear_lp_caches()
    env = workloads.provision_env(
        "provision-live-50k-20k", FakeCloud, CloudProvider, Cluster,
        Provisioner, NodePool, generate_catalog(workloads.PROVISION_TYPES),
        arena=arena, device=device)
    sigs = [workloads.provision_round(env, workloads.build_pods(
        rng=np.random.default_rng(seed), **kw))[0] for kw, seed in SMALL_LIVE]
    return sigs, getattr(env.cluster.arena, "gathers", None)


@pytest.mark.cuda
def test_cuda_arena_fed_solve_equals_scratch_fed_solve(cuda_device):
    """The live cell's bursts at 2000 and 800 pods (DeviceDecode on): round
    2's existing-node columns gathered from the arena's slab give the same
    provisioning on the card as `tensorize_nodes`' (and as the CPU)."""
    want, _ = _small_live("cuda", arena=False)
    ck.reset_launches()
    got, gathers = _small_live("cuda", arena=True)
    assert got == want == _small_live("cpu", arena=True)[0]
    assert want[1]["bound_existing"] > 0
    assert gathers["warm"] >= 1 and gathers["fallback"] == 0
    assert ck.LAUNCHES["classpack_slab"] > 0


@pytest.mark.cuda
def test_cuda_operator_builds_and_provisions_a_small_burst(cuda_device):
    """`Operator()` with its default device (the card) and
    `build_controllers` provision two small bursts and tick the
    DisruptionController as the same operator does on the CPU."""
    from types import SimpleNamespace
    from karpenter_tpu_torch.cloud.fake import (ImageInfo, SecurityGroupInfo,
                                                SubnetInfo)
    from karpenter_tpu_torch.operator import (Operator, Options,
                                              build_controllers)
    kit = SimpleNamespace(Operator=Operator, Options=Options,
                          build_controllers=build_controllers,
                          SubnetInfo=SubnetInfo,
                          SecurityGroupInfo=SecurityGroupInfo,
                          ImageInfo=ImageInfo)
    rounds = [(dict(workloads.HEADLINE, spec_count=30, total=600), 0),
              (dict(workloads.PROVISION_ROUND2, spec_count=30, total=300), 5)]
    out = {}
    for device in ("cpu", None):
        clear_lp_caches()
        extra = {} if device is None else {"device": device}
        env = workloads.operator_env(kit, catalog=generate_catalog(40),
                                     **extra)
        ck.reset_launches()
        out[device] = workloads.operator_replay(env, workloads.build_pods,
                                                rounds=rounds)
        if device is None:
            assert env.op.device.type == "cuda"
            assert env.controllers["provisioning"].device.type == "cuda"
            assert env.op.cluster.arena.gathers["warm"] >= 2
            assert ck.LAUNCHES["classpack_scan"] > 0
    assert out[None] == out["cpu"]
    assert out[None]["rounds"][0]["launched"] > 0


@pytest.mark.cuda
def test_cuda_sim_replay_equals_its_golden(cuda_device):
    """A short SimHarness replay on the card (the default device): the
    ice-starvation scenario's canned golden at its 5400 s horizon, byte for
    byte, with the provisioning, sweep and first-fit kernels launched."""
    import os
    from karpenter_tpu_torch.ops import ffd_kernels as fk
    from karpenter_tpu_torch.sim import (SimHarness, load_scenario,
                                         report_to_json)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    clear_lp_caches()
    ck.reset_launches()
    fk.reset_launches()
    sc = load_scenario(os.path.join(repo, "scenarios", "ice-starvation.yaml"))
    h = SimHarness(sc, seed=0, duration_s=5400.0)
    run = h.run()
    assert h.op.device.type == "cuda"
    with open(os.path.join(repo, "tests", "golden",
                           "sim-ice-starvation.json")) as fh:
        assert report_to_json(run.report) == fh.read()
    for name in ("classpack_precompute", "classpack_scan",
                 "classpack_assign_decode", "classpack_sweep"):
        assert ck.LAUNCHES[name] > 0, name
    assert fk.LAUNCHES["ffd_scan"] > 0


@pytest.mark.cuda
def test_cuda_v1_solve_of_a_small_batch_equals_the_cpu(cuda_device):
    """/v1/solve over HTTP on the card's manager and on the CPU's (each
    restarted over the same launched fleet) give the same answer for a
    small batch."""
    from types import SimpleNamespace
    from karpenter_tpu_torch.cloud.fake import (ImageInfo, SecurityGroupInfo,
                                                SubnetInfo)
    from karpenter_tpu_torch.operator import (ControllerManager, Operator,
                                              Options, build_controllers)
    kit = SimpleNamespace(Operator=Operator, Options=Options,
                          build_controllers=build_controllers,
                          ControllerManager=ControllerManager,
                          SubnetInfo=SubnetInfo,
                          SecurityGroupInfo=SecurityGroupInfo,
                          ImageInfo=ImageInfo)
    pods = workloads.build_pods(rng=np.random.default_rng(0), **dict(
        workloads.HEADLINE, spec_count=30, total=600))
    out = {}
    for device in ("cpu", None):
        clear_lp_caches()
        extra = {} if device is None else {"device": device}
        mgr = workloads.v1_manager(kit, workloads.build_pods,
                                   catalog=generate_catalog(40), **extra)
        port = mgr.serve_endpoints(metrics_port=0)
        try:
            ck.reset_launches()
            code, resp = workloads.http_json(
                port, "/v1/solve", workloads.v1_solve_payload(pods))
            assert code == 200, resp
            if device is None:
                assert ck.LAUNCHES["classpack_scan"] > 0
        finally:
            mgr.stop()
        out[device] = workloads.v1_solve_digest(resp)
    assert out[None] == out["cpu"]
    assert out[None]["nodes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed,kw", [
    (0, dict(P=256, C=12, O=96, R=4)),
    (1, dict(P=256, C=12, O=96, R=4, E=16, K=256)),
    (2, dict(P=512, C=8, O=64, R=3, K=32)),
])
def test_cuda_native_packer_equals_k7(cuda_device, seed, kw):
    """The native C++ packer on the host and K7 on the card, on seeded scan
    inputs (+inf / NaN / near-max prices, caps, existing slots, slot
    exhaustion): the same slots, slot usage bit for bit."""
    from karpenter_tpu_torch import native
    from karpenter_tpu_torch.ops import ffd_kernels as fk
    arrays, K = workloads.ffd_scan_inputs(np.random.default_rng(seed), **kw)
    got = [t.cpu().numpy() for t in fk.ffd_scan(
        *(torch.tensor(a, device=cuda_device) for a in arrays), K)]
    a, so, su, n = native.ffd_pack_native(**workloads.ffd_native_args(
        arrays, K))
    P = len(a)
    assert np.array_equal(got[0][:P], a) and (got[0][P:] == -1).all()
    assert np.array_equal(got[1], so) and int(got[3]) == n
    assert np.array_equal(got[2].view(np.int32), su.view(np.int32))


@pytest.mark.cuda
def test_cuda_chaos_storm_equals_its_golden(cuda_device):
    """scenarios/chaos-storm.yaml on the card: its ladder demotions (the
    native packer answering), quarantines and paced cloud retries give the
    canned golden byte for byte, and the injector is disarmed after."""
    import os
    from karpenter_tpu_torch.sim import (SimHarness, load_scenario,
                                         report_to_json)
    from karpenter_tpu_torch.utils.chaos import CHAOS
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    clear_lp_caches()
    try:
        sc = load_scenario(os.path.join(repo, "scenarios", "chaos-storm.yaml"))
        run = SimHarness(sc, seed=0, duration_s=5400.0).run()
    finally:
        CHAOS.reset()
    with open(os.path.join(repo, "tests", "golden",
                           "sim-chaos-storm.json")) as fh:
        assert report_to_json(run.report) == fh.read()
    assert run.report["chaos"]["solver_transitions"] == {
        "jax>jax:recovered": 1, "jax>native:error": 2}


@pytest.mark.cuda
def test_cuda_kernel_fault_under_chaos_is_raised_not_demoted(cuda_device,
                                                            monkeypatch):
    """With chaos armed and a SolverHealth wired, a KernelError from K7 on
    the card leaves provision() as itself: no rung answers for the card
    and the ladder books nothing."""
    from karpenter_tpu_torch.cloud import CloudProvider, FakeCloud
    from karpenter_tpu_torch.controllers.provisioning import Provisioner
    from karpenter_tpu_torch.ops import ffd_kernels as fk
    from karpenter_tpu_torch.ops.health import SolverHealth
    from karpenter_tpu_torch.state import Cluster
    from karpenter_tpu_torch.utils.chaos import CHAOS, ChaosRule
    from karpenter_tpu_torch.api.objects import Pod
    from karpenter_tpu_torch.api.resources import CPU, MEMORY, ResourceList

    def broken(*a, **k):
        raise KernelError("ffd_scan: injected launch fault")
    monkeypatch.setattr(fk, "ffd_scan", broken)
    health = SolverHealth()
    cluster = Cluster()
    prov = Provisioner(CloudProvider(FakeCloud(), generate_catalog(10)),
                       cluster, [NodePool()], health=health,
                       watchdog_timeout_s=30.0)
    cluster.add_pods([Pod(requests=ResourceList({CPU: 500,
                                                 MEMORY: 512 * 2**20}))
                      for _ in range(5)])
    CHAOS.configure([ChaosRule("solver.pack", key="native")], seed=0)
    try:
        with pytest.raises(KernelError, match="ffd_scan"):
            prov.provision()
    finally:
        CHAOS.reset()
    assert health.transitions == {}
    assert all(r["total_failures"] == 0
               for r in health.snapshot()["rungs"].values())
    assert len(cluster.pending_pods()) == 5 and not cluster.nodes


# ---- the certified bounds: ggbound's pricing screen ----

@pytest.mark.cuda
def test_cuda_gg_screen_matches_plain(cuda_device):
    """`ggbound._device_screen` on the card against the same screen on
    `pdhg`'s plain version, on bench.run_lp_ab's lp-100 pricing sweep under
    the class LP's duals: one pdhg launch, each certified bound within
    relative 1e-3 (the LP tolerance) of the plain one's, and at least the
    HiGHS optimum of its pricing LP."""
    from scipy.optimize import linprog
    from karpenter_tpu_torch.ops import ggbound, lpsolve
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    req, cnt, compat, alloc, price = workloads.lp_instance(
        100, workloads.LP_TYPES, np.random.default_rng(workloads.LP_SEED))
    _, duals = workloads.lp_duals(req, cnt, compat, alloc, price)
    jobs = workloads.lp_pricing_jobs(req, compat, alloc, duals)
    lpsolve.reset_caches()
    lk.reset_launches()
    got = ggbound._device_screen(jobs, duals, req, alloc, "cuda")
    assert lk.LAUNCHES["pdhg"] == 1
    lpsolve.reset_caches()
    want = ggbound._device_screen(jobs, duals, req, alloc, "cpu")
    lpsolve.reset_caches()
    assert sorted(got) == sorted(want) == [j for j, _, _ in jobs]
    for j, idx, ub in jobs:
        res = linprog(-duals[idx], A_ub=req[idx].T, b_ub=alloc[j],
                      bounds=[(0, u) for u in ub], method="highs")
        assert got[j] >= -res.fun - 1e-6
        assert abs(got[j] - want[j]) <= 1e-3 * max(1.0, abs(want[j]))


@pytest.mark.cuda
def test_cuda_device_dual_bound_matches_plain(cuda_device, monkeypatch):
    """`lpbound.device_dual_bound` on the card at the LP instance lp-100
    (one pdhg launch over its dense class LP) against the same function
    with `pdhg_plain` on the card in the kernel's place, from the same
    iteration cap: within relative 1e-3 (the LP tolerance) of the class LP
    of each other, and both a certified bound, at most the class LP."""
    from karpenter_tpu_torch.ops import lpbound, lpsolve
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    prob = workloads.lp_problems()[100]
    lp = lpbound.class_lp_bound(prob)
    lpsolve.reset_caches()
    lk.reset_launches()
    got = lpbound.device_dual_bound(prob, iters_cap=2000)
    assert lk.LAUNCHES["pdhg"] == 1
    monkeypatch.setattr(lpsolve, "_pdhg_kernel", lambda *a, **kw:
                        lk.pdhg_plain(*a[:10], kw["iters_cap"],
                                      kw["check_every"]))
    lpsolve.reset_caches()
    want = lpbound.device_dual_bound(prob, iters_cap=2000)
    lpsolve.reset_caches()
    assert abs(got - want) <= 1e-3 * lp
    assert 0.0 < got <= lp * (1 + 1e-6)
    assert 0.0 < want <= lp * (1 + 1e-6)
