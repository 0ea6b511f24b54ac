"""The port's partitioned mesh driver (parallel/driver.py, rows 15-17)
against the JAX package's, on the CPU: the cases of tests/test_partitioned.py
and the sharded cases of tests/test_decode.py, the programs themselves, the
controllers' sharded rungs, the device-fault rule and
`GOLDEN_SHARDED["megafleet-8x125k"]`.

The JAX package runs on 8 virtual CPU devices (tests/conftest.py); the port
lays the same shards on the CPU (`make_pod_mesh(n, device="cpu",
shards_per_device=8)`) and runs the kernels' plain versions.  Plans are
compared verbatim (`exact`: node order, pod order, used, alternatives, the
existing dict in insertion order, unschedulable, total_price by ==);
per-shard program outputs bit for bit; the psum'd float32 cost of the
aggregate within relative 1e-6 (`PSUM_RTOL`: another summation order).

    python tests/test_torch_partitioned.py   # print the JAX package's
                                             # GOLDEN_SHARDED"""


import jax.numpy as jnp
import numpy as np
import pytest

import bench
from helpers import cpu_pod
from karpenter_tpu.api import labels as wk
from karpenter_tpu.api.objects import NodePool
from karpenter_tpu.cloud import CloudProvider, FakeCloud
from karpenter_tpu.controllers import Provisioner
from karpenter_tpu.ops import solve_classpack as ref_solve
from karpenter_tpu.ops import tensorize
from karpenter_tpu.parallel import driver as ref_driver
from karpenter_tpu.parallel import make_pod_mesh as ref_pod_mesh
from karpenter_tpu.parallel import solve_partitioned as ref_partitioned
from karpenter_tpu.state import Cluster
from karpenter_tpu_torch import convert, workloads
from karpenter_tpu_torch._build import KernelError
from karpenter_tpu_torch.api.objects import NodePool as TNodePool
from karpenter_tpu_torch.cloud import CloudProvider as TCloudProvider
from karpenter_tpu_torch.cloud import FakeCloud as TFakeCloud
from karpenter_tpu_torch.controllers.provisioning import \
    Provisioner as TProvisioner
from karpenter_tpu_torch.ops import classpack as port_cp
from karpenter_tpu_torch.ops import classpack_kernels as ck
from karpenter_tpu_torch.ops import decode as port_dec
from karpenter_tpu_torch.ops.health import SolverHealth
from karpenter_tpu_torch.parallel import driver as port_driver
from karpenter_tpu_torch.parallel import make_pod_mesh
from karpenter_tpu_torch.state import Cluster as TCluster
from test_decode import FakeClock, exact, existing_capacity
from test_partitioned import canon, random_pinned_pods, zoned_catalog
from torch_cases import one_torch_thread  # noqa: F401

RTOL = workloads.PSUM_RTOL


def port_mesh(n=8):
    return make_pod_mesh(n, device="cpu", shards_per_device=8)


def _port(prob, n=8, **kw):
    return port_driver.solve_partitioned(convert.problem_from_arrays(prob),
                                         mesh=port_mesh(n), **kw)


def _both(prob, n=8, **kw):
    """(port result, its problem, reference result) of one solve."""
    tprob = convert.problem_from_arrays(prob)
    got = port_driver.solve_partitioned(tprob, mesh=port_mesh(n), **kw)
    want = ref_partitioned(prob, mesh=ref_pod_mesh(n), **kw)
    return got, tprob, want


def _port_existing(ex_alloc, ex_used, ec):
    a, u, c = convert.slot_state_from_arrays(dict(alloc=ex_alloc,
                                                  used=ex_used, compat=ec))
    return dict(existing_alloc=a, existing_used=u, existing_compat=c)


class _Calls:
    """Count the calls of a module function (the call runs unchanged, or
    `raises` instead)."""

    def __init__(self, monkeypatch, module, name, raises=None):
        self.n = 0
        orig = getattr(module, name)

        def wrapped(*a, **k):
            self.n += 1
            if raises is not None:
                raise raises
            return orig(*a, **k)
        monkeypatch.setattr(module, name, wrapped)


# ---- the cases of tests/test_partitioned.py ----

@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_parity_randomized(n_dev, seed):
    rng = np.random.default_rng(seed)
    prob = tensorize(random_pinned_pods(rng), zoned_catalog(), [NodePool()])
    got, tprob, want = _both(prob, n_dev, max_nodes_per_shard=512,
                             min_pods=1)
    assert got is not None
    assert exact(tprob, got) == exact(prob, want)
    # the decomposition's standard: the single-device plan
    assert canon(tprob, got) == canon(prob, ref_solve(prob, guide=None))


def test_straddling_pods_reconciled():
    rng = np.random.default_rng(3)
    pods = random_pinned_pods(rng, total=480)
    free = [cpu_pod(cpu_m=700, mem_mib=512) for _ in range(24)]
    prob = tensorize(pods + free, zoned_catalog(), [NodePool()])
    got, tprob, want = _both(prob, max_nodes_per_shard=512, min_pods=1)
    assert exact(tprob, got) == exact(prob, want)
    placed = [p for nd in got.nodes for p in nd.pod_indices]
    assert sorted(placed + list(got.existing_assignments)) == \
        list(range(len(pods) + len(free)))


@pytest.mark.parametrize("device_decode", [False, True])
def test_existing_nodes_owned_and_parity(device_decode):
    rng = np.random.default_rng(4)
    prob = tensorize(random_pinned_pods(rng, total=560), zoned_catalog(),
                     [NodePool()])
    ex_alloc, ex_used, ec, ex_zone = existing_capacity(prob)
    want = ref_partitioned(prob, mesh=ref_pod_mesh(8),
                           max_nodes_per_shard=512, min_pods=1,
                           existing_alloc=ex_alloc, existing_used=ex_used,
                           existing_compat=ec, existing_zone=ex_zone,
                           device_decode=device_decode)
    tprob = convert.problem_from_arrays(prob)
    got = port_driver.solve_partitioned(
        tprob, mesh=port_mesh(8), max_nodes_per_shard=512, min_pods=1,
        existing_zone=ex_zone, device_decode=device_decode,
        **_port_existing(ex_alloc, ex_used, ec))
    assert len(got.existing_assignments) > 0
    assert exact(tprob, got) == exact(prob, want)


def test_unshardable_falls_back_to_none():
    pods = [cpu_pod(cpu_m=500, mem_mib=256,
                    node_selector={wk.ZONE: "zone-a"}) for _ in range(64)]
    prob = tensorize(pods, zoned_catalog(("zone-a",)), [NodePool()])
    assert _port(prob, max_nodes_per_shard=64, min_pods=1) is None
    # a 1-shard mesh is never a partition
    assert _port(tensorize(random_pinned_pods(np.random.default_rng(0)),
                           zoned_catalog(), [NodePool()]), n=1,
                 min_pods=1) is None


def test_aggregate_matches_decode_and_the_reference():
    rng = np.random.default_rng(5)
    prob = tensorize(random_pinned_pods(rng, total=512), zoned_catalog(),
                     [NodePool()])
    got, tprob, want = _both(prob, max_nodes_per_shard=512, min_pods=1,
                             decode=False)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == 0
    assert got[0] == pytest.approx(want[0], rel=RTOL, abs=0)
    res = port_driver.solve_partitioned(tprob, mesh=port_mesh(8),
                                        max_nodes_per_shard=512, min_pods=1)
    oi = {id(o): j for j, o in enumerate(tprob.options)}
    dec = np.zeros(tprob.num_options, np.int64)
    for nd in res.nodes:
        dec[oi[id(nd.option)]] += 1
    np.testing.assert_array_equal(got[1], dec)
    assert got[0] == pytest.approx(res.total_price, rel=1e-5)


def test_aggregate_with_residual_matches_the_reference():
    rng = np.random.default_rng(8)
    pods = random_pinned_pods(rng, total=600)
    free = [cpu_pod(cpu_m=900, mem_mib=700) for _ in range(30)]
    prob = tensorize(pods + free, zoned_catalog(), [NodePool()])
    got, _, want = _both(prob, max_nodes_per_shard=512, min_pods=1,
                         decode=False)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert got[0] == pytest.approx(want[0], rel=RTOL, abs=0)


# ---- the sharded cases of tests/test_decode.py ----

@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_slab_parity_randomized(n_dev, seed):
    rng = np.random.default_rng(seed)
    prob = tensorize(random_pinned_pods(rng), zoned_catalog(), [NodePool()])
    got, tprob, want = _both(prob, n_dev, max_nodes_per_shard=512,
                             min_pods=1, device_decode=True)
    host = port_driver.solve_partitioned(tprob, mesh=port_mesh(n_dev),
                                         max_nodes_per_shard=512, min_pods=1)
    assert exact(tprob, got) == exact(prob, want) == exact(tprob, host)


def test_sharded_slab_parity_residuals_and_existing():
    rng = np.random.default_rng(3)
    pods = random_pinned_pods(rng, total=480)
    free = [cpu_pod(cpu_m=700, mem_mib=512) for _ in range(24)]
    prob = tensorize(pods + free, zoned_catalog(), [NodePool()])
    ex_alloc, ex_used, ec, ex_zone = existing_capacity(prob)
    kw = dict(max_nodes_per_shard=512, min_pods=1, existing_zone=ex_zone)
    want = ref_partitioned(prob, mesh=ref_pod_mesh(8), device_decode=True,
                           existing_alloc=ex_alloc, existing_used=ex_used,
                           existing_compat=ec, **kw)
    tprob = convert.problem_from_arrays(prob)
    got = port_driver.solve_partitioned(
        tprob, mesh=port_mesh(8), device_decode=True,
        **_port_existing(ex_alloc, ex_used, ec), **kw)
    assert len(got.existing_assignments) > 0
    assert exact(tprob, got) == exact(prob, want)


def test_slab_assembly_fallback(monkeypatch):
    """An injected slab-assembly failure: the plan is rebuilt from the slab
    already fetched (no second launch), identical; the breaker books it."""
    rng = np.random.default_rng(1)
    prob = tensorize(random_pinned_pods(rng), zoned_catalog(), [NodePool()])
    want = ref_partitioned(prob, mesh=ref_pod_mesh(4),
                           max_nodes_per_shard=512, min_pods=1)
    tprob = convert.problem_from_arrays(prob)
    health = port_dec.DecodeHealth(clock=FakeClock())
    boom = _Calls(monkeypatch, port_dec, "assemble_slab_sharded",
                  raises=RuntimeError("injected sharded slab failure"))
    scans = _Calls(monkeypatch, ck, "classpack_scan_sharded")
    slabs = _Calls(monkeypatch, ck, "classpack_slab_sharded")
    got = port_driver.solve_partitioned(
        tprob, mesh=port_mesh(4), max_nodes_per_shard=512, min_pods=1,
        device_decode=True, decode_health=health)
    assert boom.n == 1 and scans.n == 1 and slabs.n == 1
    assert exact(tprob, got) == exact(prob, want)
    assert health.failures == 1


def test_slab_assembly_device_fault_is_raised(monkeypatch):
    rng = np.random.default_rng(1)
    prob = tensorize(random_pinned_pods(rng), zoned_catalog(), [NodePool()])
    _Calls(monkeypatch, port_dec, "assemble_slab_sharded",
           raises=KernelError("injected device fault"))
    with pytest.raises(KernelError, match="injected"):
        _port(prob, 4, max_nodes_per_shard=512, min_pods=1,
              device_decode=True)


# ---- the programs, output for output ----

@pytest.mark.parametrize("slab", [False, True])
def test_partitioned_assign_programs_match_the_reference(monkeypatch, slab):
    """Rows 16-17 per shard on the driver's own lowered arrays, with owned
    existing nodes, a residual and an empty shard: assignment / order,
    slot_counts, slot_option and n_unsched bit for bit."""
    rng = np.random.default_rng(3)
    pods = random_pinned_pods(rng, total=480, zones=("zone-a", "zone-b",
                                                     "zone-c"))
    free = [cpu_pod(cpu_m=700, mem_mib=512) for _ in range(24)]
    prob = tensorize(pods + free, zoned_catalog(), [NodePool()])
    ex_alloc, ex_used, ec, ex_zone = existing_capacity(prob)
    ex_used[::3] = ex_alloc[::3] * 1.01           # overcommitted: free < 0
    name = ("_partitioned_assign_slab_donate" if slab
            else "_partitioned_assign_donate")
    calls = []
    orig = getattr(port_driver, name)

    def record(*a):
        calls.append(a)
        return orig(*a)
    monkeypatch.setattr(port_driver, name, record)
    tprob = convert.problem_from_arrays(prob)
    port_driver.solve_partitioned(
        tprob, mesh=port_mesh(4), max_nodes_per_shard=256, min_pods=1,
        existing_zone=ex_zone, device_decode=slab,
        **_port_existing(ex_alloc, ex_used, ec))
    (args,) = calls
    tensors, (K, Ppad, mesh) = args[:9], args[9:]
    assert int(tensors[1].sum(dim=1).eq(0).sum()) >= 1    # an empty shard
    got = orig(*args)
    ref_fn = (ref_driver._partitioned_assign_slab if slab
              else ref_driver._partitioned_assign)
    want = ref_fn(*(jnp.asarray(t.numpy()) for t in tensors), K, Ppad,
                  ref_pod_mesh(4))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy().reshape(w.shape), w)


def test_partitioned_pack_program_matches_the_reference(monkeypatch):
    rng = np.random.default_rng(6)
    prob = tensorize(random_pinned_pods(rng, total=700), zoned_catalog(),
                     [NodePool()])
    calls = []
    orig = port_driver._partitioned_pack
    monkeypatch.setattr(port_driver, "_partitioned_pack",
                        lambda *a: calls.append(a) or orig(*a))
    _port(prob, 8, max_nodes_per_shard=64, min_pods=1, decode=False)
    (args,) = calls
    got = orig(*args)
    want = ref_driver._partitioned_pack(
        *(jnp.asarray(t.numpy()) for t in args[:7]), args[7],
        ref_pod_mesh(8))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])
    assert float(got[0]) == pytest.approx(float(want[0]), rel=RTOL, abs=0)


# ---- the controllers' gate ----

def _launch_plan(pkg, sharded, pods_seed=6, **kw):
    """The reference test's Provisioner gate fixture in either package."""
    rng = np.random.default_rng(pods_seed)
    pods = random_pinned_pods(rng, total=600)
    if pkg == "ref":
        cloud, catalog, C, P, pool = FakeCloud(), zoned_catalog(), Cluster, \
            Provisioner, NodePool
    else:
        cloud, catalog, C, P, pool = TFakeCloud(), convert.catalog_from_objects(
            zoned_catalog()), TCluster, TProvisioner, TNodePool
        pods = [convert._pod(p) for p in pods]
        kw = {"device": "cpu", "mesh": port_mesh(8), **kw}
    provider = (CloudProvider if pkg == "ref" else TCloudProvider)(cloud,
                                                                   catalog)
    cluster = C()
    for p in pods:
        cluster.add_pod(p)
    prov = P(provider, cluster, [pool()], lp_guide=False,
             sharded_solve=sharded, **kw)
    problem, result = prov.solve(cluster.pending_pods())
    return (sorted((nd.option.instance_type, nd.option.zone,
                    tuple(sorted(nd.pod_indices))) for nd in result.nodes),
            sorted(result.unschedulable))


def test_provisioner_gate_parity(monkeypatch):
    sharded = _Calls(monkeypatch, port_driver, "solve_partitioned")
    got = _launch_plan("port", True)
    assert sharded.n == 1
    assert got == _launch_plan("ref", True) == _launch_plan("port", False)


def test_provisioner_sharded_rung_refusal_falls_to_jax(monkeypatch):
    """Below the pod floor, or on a 1-shard mesh, the sharded rung declines
    and the jax rung answers inline: the same plan as with the gate off."""
    scans = _Calls(monkeypatch, ck, "classpack_scan_sharded")
    want = _launch_plan("port", False)
    got = _launch_plan("port", True, mesh=make_pod_mesh(device="cpu"))
    assert got == want and scans.n == 0
    prob = convert.problem_from_arrays(tensorize(
        [cpu_pod() for _ in range(4)], zoned_catalog(), [NodePool()]))
    assert port_driver.maybe_solve_partitioned(
        prob, path="provisioning", mesh=port_mesh(8)) is None


def test_sharded_rung_logic_failure_falls_back(monkeypatch):
    """A failure of the partitioned solve's own logic is answered by the
    single-device path, as in the reference."""
    _Calls(monkeypatch, port_driver, "plan_partition",
           raises=RuntimeError("injected planner bug"))
    assert _launch_plan("port", True) == _launch_plan("port", False)


def test_kernel_fault_in_the_sharded_rung_raises_out_of_provision(
        monkeypatch):
    """A KernelError in a shard-batched kernel comes out of provision(),
    past maybe_solve_partitioned's fallback and the SolverHealth ladder;
    the single-device kernels never answer it."""
    fault = _Calls(monkeypatch, ck, "classpack_scan_sharded",
                   raises=KernelError("injected: classpack_scan_sharded"))
    single = _Calls(monkeypatch, port_cp, "classpack_scan")
    provider = TCloudProvider(TFakeCloud(), convert.catalog_from_objects(
        zoned_catalog()))
    cluster = TCluster()
    cluster.add_pods([convert._pod(p) for p in random_pinned_pods(
        np.random.default_rng(6), total=600)])
    health = SolverHealth()
    prov = TProvisioner(provider, cluster, [TNodePool()], lp_guide=False,
                        sharded_solve=True, health=health, device="cpu",
                        mesh=port_mesh(8))
    with pytest.raises(KernelError, match="injected"):
        prov.provision()
    assert fault.n == 1 and single.n == 0
    assert not cluster.nodes and not health.transitions


def test_shard_layout_fault_is_raised_not_answered(monkeypatch):
    """An operand that breaks a shard-batched wrapper's contract is a fault
    of the port's lowering: it comes out of maybe_solve_partitioned as a
    ShardLayoutError (a KernelError), and the single-device path does not
    answer the batch, unlike a failure of the driver's own logic."""
    _Calls(monkeypatch, ck, "classpack_assign_decode_sharded_plain",
           raises=ValueError("injected: shards neither contiguous nor "
                             "shared"))
    single = _Calls(monkeypatch, port_cp, "classpack_scan")
    prob = convert.problem_from_arrays(tensorize(random_pinned_pods(
        np.random.default_rng(6), total=600), zoned_catalog(), [NodePool()]))
    with pytest.raises(ck.ShardLayoutError, match="injected") as got:
        port_driver.maybe_solve_partitioned(prob, path="provisioning",
                                            mesh=port_mesh(8))
    assert isinstance(got.value, KernelError) and single.n == 0


def test_disruption_sharded_rung_matches_the_reference(monkeypatch):
    """DisruptionController(sharded_solve=True) on a zone-pinned fleet whose
    decoded accept reschedules more than MIN_PODS_DEFAULT pods: both
    packages take the sharded rung into the partitioned driver, whose
    planner refuses the batch (a delete action simulates with no launch
    options, so there are no zones to partition by), and the classpack rung
    answers — the same action, through the same routing."""
    from karpenter_tpu.api.objects import Disruption
    from karpenter_tpu.controllers.disruption import DisruptionController
    from karpenter_tpu_torch.api.objects import Disruption as TDisruption
    from karpenter_tpu_torch.controllers.disruption import \
        DisruptionController as TDisruptionController
    from helpers import make_type
    from test_consolidation_sweep import FakeClock as Clock
    zones = ("zone-a", "zone-b", "zone-c")
    catalog = [make_type("a.large", 8, 16, 0.40, zones=zones)]
    clock = Clock()
    provider = CloudProvider(FakeCloud(clock), catalog, clock=clock)
    cluster = Cluster(clock)
    pools = [NodePool(disruption=Disruption(
        consolidation_policy="WhenUnderutilized"))]
    prov = Provisioner(provider, cluster, pools, clock=clock, lp_guide=False)
    rng = np.random.default_rng(11)
    cluster.add_pods([cpu_pod(cpu_m=int(rng.integers(100, 400)),
                              mem_mib=int(rng.integers(128, 512)),
                              node_selector={wk.ZONE: zones[int(
                                  rng.integers(0, 3))]})
                      for _ in range(4000)])
    assert not prov.provision().unschedulable
    pods = list(cluster.pods.values())
    rng.shuffle(pods)
    for p in pods[:int(len(pods) * 0.4)]:
        cluster.delete_pod(p)
    calls = {"ref": [], "port": []}
    for key, mod in (("ref", ref_driver), ("port", port_driver)):
        orig = mod.solve_partitioned

        def spy(problem, *a, _orig=orig, _out=calls[key], **k):
            res = _orig(problem, *a, **k)
            _out.append((int(problem.class_counts.sum()), res is None))
            return res
        monkeypatch.setattr(mod, "solve_partitioned", spy)
    ctrl = DisruptionController(provider, cluster, pools, clock=clock,
                                stabilization_s=0.0, lp_guide=False,
                                sharded_solve=True)
    want = ctrl.consolidation_action(ctrl.candidates())
    tctrl = TDisruptionController(
        workloads.CatalogProvider(convert.catalog_from_objects(catalog)),
        convert.cluster_from_objects(cluster),
        [TNodePool(disruption=TDisruption(
            consolidation_policy="WhenUnderutilized"))],
        clock=clock, stabilization_s=0.0, lp_guide=False,
        sharded_solve=True, device="cpu", mesh=port_mesh(8))
    got = tctrl.consolidation_action(tctrl.candidates())
    assert want is not None and want.kind == "delete"
    assert workloads.action_signature(got) == \
        workloads.action_signature(want)
    assert calls["port"] == calls["ref"]
    assert calls["ref"] and all(n > port_driver.MIN_PODS_DEFAULT and refused
                                for n, refused in calls["ref"])


# ---- the megafleet: GOLDEN_SHARDED ----

@pytest.mark.parametrize("mode", sorted(workloads.MEGAFLEET_MODES))
def test_reference_produces_the_megafleet_golden(mode):
    prob = bench._megafleet_problem(workloads.MEGAFLEET_UNITS,
                                    pods_per_unit=workloads.MEGAFLEET_UNIT_PODS)
    res = ref_partitioned(prob, mesh=ref_pod_mesh(workloads.MESH_SHARDS),
                          max_nodes_per_shard=workloads.MEGAFLEET_K,
                          **workloads.MEGAFLEET_MODES[mode])
    assert workloads.sharded_answer(prob, res) == \
        workloads.GOLDEN_SHARDED["megafleet-8x125k"][mode]


@pytest.mark.parametrize("mode", sorted(workloads.MEGAFLEET_MODES))
def test_port_reproduces_the_megafleet_golden(mode):
    prob = workloads.megafleet_problem(workloads.MEGAFLEET_UNITS)
    ref = bench._megafleet_problem(workloads.MEGAFLEET_UNITS,
                                   pods_per_unit=workloads.MEGAFLEET_UNIT_PODS)
    for f in ("class_requests", "class_counts", "class_compat",
              "option_alloc", "option_price", "option_zone"):
        np.testing.assert_array_equal(getattr(prob, f), getattr(ref, f))
    res = port_driver.solve_partitioned(
        prob, mesh=port_mesh(workloads.MESH_SHARDS),
        max_nodes_per_shard=workloads.MEGAFLEET_K,
        **workloads.MEGAFLEET_MODES[mode])
    digest, total = workloads.sharded_answer(prob, res)
    gold = workloads.GOLDEN_SHARDED["megafleet-8x125k"][mode]
    assert digest == gold[0]
    if mode == "aggregate":
        assert total == pytest.approx(gold[1], rel=RTOL, abs=0)
    else:
        assert total == gold[1]


def reference_goldens():
    """GOLDEN_SHARDED as the JAX package computes it (8 virtual devices)."""
    from karpenter_tpu import api as ref_api
    from karpenter_tpu.catalog.generate import generate_catalog
    from karpenter_tpu.parallel import make_host_mesh, solve_sharded
    env = workloads.provision_env(
        workloads.SHARDED_CELL, FakeCloud, CloudProvider, Cluster,
        Provisioner, ref_api.NodePool, generate_catalog(600))
    cell = [workloads.provision_round(env, workloads.build_pods(
        rng=np.random.default_rng(seed), **kw))[0]
        for kw, seed in workloads.PROVISION_CELLS[workloads.SHARDED_CELL][1]]
    mf = bench._megafleet_problem(workloads.MEGAFLEET_UNITS,
                                  pods_per_unit=workloads.MEGAFLEET_UNIT_PODS)
    mega = {m: workloads.sharded_answer(mf, ref_partitioned(
        mf, mesh=ref_pod_mesh(8), max_nodes_per_shard=workloads.MEGAFLEET_K,
        **kw)) for m, kw in workloads.MEGAFLEET_MODES.items()}
    pods = workloads.build_pods(
        rng=np.random.default_rng(workloads.HEADLINE_SEED),
        **workloads.HEADLINE)
    hp = tensorize(pods, generate_catalog(workloads.HEADLINE_TYPES),
                   [NodePool()])
    a, u, c = workloads.existing_nodes(
        hp, workloads.HEADLINE_EXISTING,
        np.random.default_rng(workloads.EXISTING_SEED))
    head = {}
    for name, mesh in (("pods", ref_pod_mesh(8)),
                       ("hosts", make_host_mesh(2, 4))):
        for decode in (False, True):
            kw = dict(existing_alloc=a, existing_used=u,
                      existing_compat=c) if decode else {}
            head[(name, decode)] = workloads.sharded_answer(hp, solve_sharded(
                hp, mesh, max_nodes_per_shard=workloads.HEADLINE_SHARDED_K,
                decode=decode, **kw))
    return {workloads.SHARDED_CELL: cell, "megafleet-8x125k": mega,
            "headline-sharded": head}


if __name__ == "__main__":
    import pprint
    pprint.pprint(reference_goldens(), width=78)
