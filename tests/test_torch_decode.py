"""The port's device decode (the DeviceDecode gate, rows 7-8) against the
JAX package's, on the CPU: the single-device cases of tests/test_decode.py.

The slab path is a bit-exact rewrite of the legacy decode, so plans are
compared verbatim — node order, pod order within a node, each node's
`used` and alternatives, the existing-fill dict in insertion order, the
unschedulable list, and `total_price` by ==.  The slab programs
(`class_pack_assign_slab_kernel[_fresh]`, K1-K3 then K6's plain version
here) are held output for output against the JAX programs on the same
lowered arrays, and `classpack_slab_plain` against a stable argsort on both
sides of the reference's (K+1)·n < 2^31 guard."""

import numpy as np
import pytest
import torch

from helpers import cpu_pod
from karpenter_tpu.api.objects import NodePool
from karpenter_tpu.api.resources import PODS, ResourceList
from karpenter_tpu.ops import classpack as ref_cp
from karpenter_tpu.ops import decode as ref_dec
from karpenter_tpu.ops import solve_classpack as ref_solve
from karpenter_tpu.ops import tensorize
from karpenter_tpu_torch import convert
from karpenter_tpu_torch.ops import classpack as port_cp
from karpenter_tpu_torch.ops import classpack_kernels as ck
from karpenter_tpu_torch.ops import decode as port_dec
from test_decode import FakeClock, exact, existing_capacity
from test_partitioned import random_pinned_pods, zoned_catalog
from torch_cases import one_torch_thread  # noqa: F401


def _port_existing(ex_alloc, ex_used, ec):
    a, u, c = convert.slot_state_from_arrays(dict(alloc=ex_alloc,
                                                  used=ex_used, compat=ec))
    return dict(existing_alloc=a, existing_used=u, existing_compat=c)


def _port_solve(prob, **kw):
    return port_cp.solve_classpack(prob, guide=None, device="cpu", **kw)


class _Calls:
    """Count the calls of a module function (the call runs unchanged)."""

    def __init__(self, monkeypatch, module, name):
        self.n = 0
        orig = getattr(module, name)

        def wrapped(*a, **k):
            self.n += 1
            return orig(*a, **k)
        monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_single_device_parity_fresh(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    prob = tensorize(random_pinned_pods(rng), zoned_catalog(), [NodePool()])
    want = ref_solve(prob, guide=None, device_decode=True)
    tprob = convert.problem_from_arrays(prob)
    host = _port_solve(tprob)
    slab = _Calls(monkeypatch, port_cp, "classpack_slab")
    dev = _port_solve(tprob, device_decode=True)
    assert slab.n == 1
    assert exact(tprob, dev) == exact(prob, want) == exact(tprob, host)


def test_single_device_parity_existing():
    rng = np.random.default_rng(4)
    prob = tensorize(random_pinned_pods(rng, total=560), zoned_catalog(),
                     [NodePool()])
    ex_alloc, ex_used, ec, _ = existing_capacity(prob)
    want = ref_solve(prob, guide=None, existing_alloc=ex_alloc,
                     existing_used=ex_used, existing_compat=ec,
                     device_decode=True)
    tprob = convert.problem_from_arrays(prob)
    kw = _port_existing(ex_alloc, ex_used, ec)
    dev = _port_solve(tprob, device_decode=True, **kw)
    host = _port_solve(tprob, **kw)
    assert len(dev.existing_assignments) > 0, "existing columns unused"
    assert exact(tprob, dev) == exact(prob, want) == exact(tprob, host)


def test_single_device_floor_skips_slab(monkeypatch):
    """Batches under DEVICE_DECODE_FLOOR stay on the legacy decode — no K6
    — and still produce the identical plan."""
    assert port_dec.DEVICE_DECODE_FLOOR == ref_dec.DEVICE_DECODE_FLOOR == 512
    prob = tensorize([cpu_pod() for _ in range(64)], zoned_catalog(),
                     [NodePool()])
    want = ref_solve(prob, guide=None, device_decode=True)
    tprob = convert.problem_from_arrays(prob)
    slab = _Calls(monkeypatch, port_cp, "classpack_slab")
    dev = _port_solve(tprob, device_decode=True)
    assert slab.n == 0
    assert exact(tprob, dev) == exact(prob, want)


def test_fallback_single_device_and_breaker_cycle(monkeypatch):
    """Injected slab-assembly failure: identical plan off the same kernel
    output (no second launch), demotion after two failures, the legacy
    decode while demoted, a half-open probe after the window, recovery on
    success — the reference's DecodeHealth transitions."""
    rng = np.random.default_rng(7)
    prob = tensorize(random_pinned_pods(rng), zoned_catalog(), [NodePool()])
    want = exact(prob, ref_solve(prob, guide=None))
    tprob = convert.problem_from_arrays(prob)
    clk = FakeClock()
    health = port_dec.DecodeHealth(clock=clk)
    real = port_dec.assemble_slab_single

    def boom(*a, **k):
        raise RuntimeError("injected slab failure")

    monkeypatch.setattr(port_dec, "assemble_slab_single", boom)
    scans = _Calls(monkeypatch, port_cp, "classpack_scan")
    slab = _Calls(monkeypatch, port_cp, "classpack_slab")
    r1 = _port_solve(tprob, device_decode=True, decode_health=health)
    assert exact(tprob, r1) == want
    assert scans.n == 1 and slab.n == 1        # no second launch
    assert health.failures == 1 and health.demotions == 0

    r2 = _port_solve(tprob, device_decode=True, decode_health=health)
    assert exact(tprob, r2) == want
    assert health.demotions == 1 and not health.allow()

    r3 = _port_solve(tprob, device_decode=True, decode_health=health)
    assert exact(tprob, r3) == want
    assert slab.n == 2                         # suppressed: legacy decode

    # window expires → half-open probe; healthy assembly → recovery
    monkeypatch.setattr(port_dec, "assemble_slab_single", real)
    clk.t += 61.0
    r4 = _port_solve(tprob, device_decode=True, decode_health=health)
    assert exact(tprob, r4) == want
    assert slab.n == 3
    assert health.demotions == 0 and not health.probing
    assert health.transitions == {"demoted:error": 1,
                                  "recovered:recovered": 1}


def test_decode_health_windows_and_snapshot_roundtrip():
    """The same script through both packages' breakers: identical state
    at every step, and the snapshot round trip."""
    clk = FakeClock()
    hs = [port_dec.DecodeHealth(clock=clk), ref_dec.DecodeHealth(clock=clk)]

    def same():
        a, b = (h.snapshot_state() for h in hs)
        assert a == b
        return a

    for h in hs:
        h.report_failure()
    assert all(h.allow() for h in hs)          # one failure: still promoted
    for h in hs:
        h.report_failure()
    assert hs[0].demotions == 1
    assert hs[0].demoted_until == pytest.approx(clk.t + 60.0)
    same()
    clk.t += 61.0
    assert all(h.allow() and h.probing for h in hs)   # half-open probe
    for h in hs:
        h.report_failure("error")              # probe fails → window doubles
    assert hs[0].demotions == 2
    assert hs[0].demoted_until == pytest.approx(clk.t + 120.0)

    snap = same()
    h2 = port_dec.DecodeHealth(clock=clk)
    h2.restore_state(snap)
    assert h2.snapshot_state() == snap
    assert not h2.allow()
    clk.t += 121.0
    assert h2.allow() and h2.probing
    h2.report_success()
    assert h2.demotions == 0 and h2.failures == 0 and not h2.probing
    assert h2.transitions.get("recovered:recovered") == 1
    # the restored copy is independent state
    assert hs[0].transitions.get("recovered:recovered") is None


def test_slab_to_assignment_inverse():
    """The fallback bridge reproduces the legacy assignment vector from the
    slab triplet, as the reference's does."""
    rng = np.random.default_rng(11)
    K, P = 7, 40
    assignment = rng.integers(-1, K, size=P).astype(np.int32)
    key = np.where(assignment >= 0, assignment, K)
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=K + 1)[:K]
    back = port_dec.slab_to_assignment(order, counts, P, K)
    assert (back == assignment).all()
    np.testing.assert_array_equal(
        back, ref_dec.slab_to_assignment(order, counts, P, K))


def test_claim_requests_columnar_matches_legacy():
    from karpenter_tpu.controllers.provisioning import \
        claim_requests_columnar as ref_columnar
    from karpenter_tpu_torch.controllers.provisioning import \
        claim_requests_columnar
    rng = np.random.default_rng(9)
    prob = tensorize(random_pinned_pods(rng, total=320), zoned_catalog(),
                     [NodePool()])
    tprob = convert.problem_from_arrays(prob)
    tprob.pods = [convert._pod(p) for p in prob.pods]
    res = _port_solve(tprob)
    assert res.nodes
    for nd in res.nodes:
        legacy = ResourceList()
        for i in nd.pod_indices:
            legacy = legacy + tprob.pods[i].requests
        legacy[PODS] = legacy.get(PODS, 0) + len(nd.pod_indices)
        col = claim_requests_columnar(tprob, nd.pod_indices)
        assert col == legacy
        assert list(col) == list(legacy)   # first-seen key order too
        ref = ref_columnar(prob, nd.pod_indices)
        assert list(col.items()) == list(ref.items())


@pytest.mark.parametrize("with_existing", [False, True])
def test_slab_programs_match_the_jax_programs(with_existing):
    """class_pack_assign_slab_kernel[_fresh] on the same lowered arrays:
    order, slot_counts, slot_option and n_unsched equal."""
    rng = np.random.default_rng(3)
    prob = tensorize(random_pinned_pods(rng, total=700), zoned_catalog(),
                     [NodePool()])
    kw = {}
    if with_existing:
        ex_alloc, ex_used, ec, _ = existing_capacity(prob, E=24)
        kw = dict(existing_alloc=ex_alloc, existing_used=ex_used,
                  existing_compat=ec)
    tprob = convert.problem_from_arrays(prob)
    low = port_cp.lower_problem(tprob, **(_port_existing(
        kw["existing_alloc"], kw["existing_used"], kw["existing_compat"])
        if kw else {}))
    args = [low.req_p, low.cnt_p, low.packed, low.cap_p, low.alloc_i,
            low.price_p, low.rank_p]
    if with_existing:
        want = ref_cp.class_pack_assign_slab_kernel(
            *args, low.init_option, low.init_used, low.K, low.Ppad)
        got = port_cp.class_pack_assign_slab_kernel(
            *(torch.tensor(a) for a in args), torch.tensor(low.init_option),
            torch.tensor(low.init_used), low.K, low.Ppad)
    else:
        want = ref_cp.class_pack_assign_slab_kernel_fresh(*args, low.K,
                                                          low.Ppad)
        got = port_cp.class_pack_assign_slab_kernel_fresh(
            *(torch.tensor(a) for a in args), low.K, low.Ppad)
    for g, w, what in zip(got, want, ("order", "slot_counts", "slot_option",
                                      "n_unsched")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=what)
    assert int(got[2].ge(0).sum()) > 0


@pytest.mark.parametrize("K,n,dtype", [
    (7, 40, np.int16),
    (2048, 32768, np.int16),        # below the guard: the composite sort
    (8192, 300_000, np.int16),      # above it: the stable argsort
    (2048, 53248, np.int32),
])
def test_slab_sort_plain_is_the_stable_sort(K, n, dtype):
    rng = np.random.default_rng(K + n)
    a = rng.integers(-1, K, size=n).astype(dtype)
    order, counts = ck.classpack_slab_plain(torch.tensor(a), K)
    key = np.where(a >= 0, a, K).astype(np.int64)
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(key, kind="stable"))
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(key, minlength=K + 1)[:K])
    assert order.dtype == counts.dtype == torch.int32


def test_provisioner_gate_parity():
    """DeviceDecode through the real Provisioner: identical launch
    decisions and claim request totals with the gate on and off, and the
    reference's plan on the same fixture."""
    from karpenter_tpu.cloud import CloudProvider, FakeCloud
    from karpenter_tpu.controllers import Provisioner
    from karpenter_tpu.state import Cluster
    from karpenter_tpu_torch.api.objects import NodePool as TNodePool
    from karpenter_tpu_torch.cloud import CloudProvider as TCloudProvider
    from karpenter_tpu_torch.cloud import FakeCloud as TFakeCloud
    from karpenter_tpu_torch.controllers.provisioning import \
        Provisioner as TProvisioner
    from karpenter_tpu_torch.state import Cluster as TCluster

    def pods():
        return random_pinned_pods(np.random.default_rng(6), total=600)

    def port_plan(device_decode):
        provider = TCloudProvider(TFakeCloud(), convert.catalog_from_objects(
            zoned_catalog()))
        cluster = TCluster()
        for p in pods():
            cluster.add_pod(convert._pod(p))
        prov = TProvisioner(provider, cluster, [TNodePool()], lp_guide=False,
                            device_decode=device_decode, device="cpu")
        problem, result = prov.solve(cluster.pending_pods())
        return exact(problem, result)

    cluster = Cluster()
    for p in pods():
        cluster.add_pod(p)
    prov = Provisioner(CloudProvider(FakeCloud(), zoned_catalog()), cluster,
                       [NodePool()], lp_guide=False, device_decode=True)
    problem, result = prov.solve(cluster.pending_pods())
    assert port_plan(True) == port_plan(False) == exact(problem, result)
