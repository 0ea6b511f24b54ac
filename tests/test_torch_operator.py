"""The port's operator layer (karpenter_tpu_torch/operator/) against the JAX
package's, case by case with tests/test_operator.py's cases that need no
ControllerManager, LeaderElector or HTTP endpoint (ROADMAP.md queue B3):
the options' defaults, the provider graph and the controller set, the gates
plumbed to the controllers, and restart hydration (where the reference's
cases tick a manager twice to provision, these call the Provisioner the
manager's tick calls).  Each case runs on both packages' classes and
returns plain observations that must be equal; the port runs on the CPU.

Then the port's own boundaries: `Operator()` with no device raises without
a card, the gates once refused (B7's and B9's) are read by the manager,
the chaos spec arms the injector, an option the port does not read is
refused,
and the default operator at a small size provisions two bursts and ticks
its DisruptionController as the JAX package's does, with the arena serving
the gathers warm.
"""

import importlib
from types import SimpleNamespace

import pytest

from torch_cases import clear_lp_caches as clear_package_caches
from torch_cases import one_torch_thread  # noqa: F401
from torch_lockorder import port_lock_order  # noqa: F401
from torch_refnative import reference_native_loaded  # noqa: F401
from karpenter_tpu_torch import workloads
from karpenter_tpu_torch._build import KernelError

MODULES = dict(operator="operator", options="operator.options",
               objects="api.objects", resources="api.resources",
               taints="api.taints", labels="api.labels",
               gen="catalog.generate", fake="cloud.fake")


def _package(name, extra):
    return SimpleNamespace(name=name, extra=extra, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in MODULES.items()})


REF = _package("karpenter_tpu", {})
PORT = _package("karpenter_tpu_torch", {"device": "cpu"})


def clear_lp_caches():
    clear_package_caches("karpenter_tpu", "karpenter_tpu_torch")


@pytest.fixture(autouse=True)
def _clean_lp_caches():
    clear_lp_caches()
    yield
    clear_lp_caches()


def both(case):
    ref, port = case(REF), case(PORT)
    assert ref == port
    return port


def operator(m, *a, **kw):
    return m.operator.Operator(*a, **kw, **m.extra)


def pod(m, cpu=500, **kw):
    R = m.resources
    return m.objects.Pod(requests=R.ResourceList(
        {R.CPU: cpu, R.MEMORY: 512 * 2**20}), **kw)


def seed_cloud(m, op):
    """tests/test_operator.py's `_seed_cloud`."""
    f = m.fake
    op.cloud.subnets = [f.SubnetInfo("s-a", "zone-a", 100, {}),
                        f.SubnetInfo("s-b", "zone-b", 100, {})]
    op.cloud.security_groups = [f.SecurityGroupInfo("sg", "nodes", {})]
    op.cloud.images = [f.ImageInfo("img-1", "std", "amd64", 1.0)]
    op.params.parameters = {
        "/karpenter-tpu/images/standard/1.28/amd64/latest": "img-1"}
    return op


def claims_of(nodes):
    return sorted((n.instance_type, n.zone, n.capacity_type, n.nodepool,
                   n.provider_id) for n in nodes)


# ---------------------------------------------------------------------------
# TestOptions
# ---------------------------------------------------------------------------

def test_defaults():
    """Every field of the port's Options has the reference's default (its
    command line and env defaults: tests/test_torch_main.py)."""
    import dataclasses
    from karpenter_tpu_torch.operator.options import FEATURE_GATES
    ref = dataclasses.asdict(REF.options.Options.from_args([]))
    port = dataclasses.asdict(PORT.options.Options())
    assert port == {k: ref[k] for k in port}
    assert port["feature_gates"] == ref["feature_gates"] == FEATURE_GATES
    assert port["feature_gates"]["Drift"]
    assert port["feature_gates"]["IncrementalArena"]


@pytest.mark.parametrize("field", [
    "leader_elect", "lease_path", "snapshot_path", "log_format",
    "trace_slow_ms", "enable_profiling", "incident_dir", "slo_eval_cadence_s",
    "lease_ttl_s", "obs_sample_s", "vm_memory_overhead_percent",
    "reserved_enis", "health_port", "tags"])
def test_options_the_port_does_not_read_are_refused(field):
    """An option of the reference that nothing in the port reads is not a
    field of the port's Options: setting one fails at construction instead
    of being silently ignored.  The lease and snapshot options, refused
    until B7 was ported, the logging, tracing and profiling options,
    refused until B9a was, and the incident, ring and SLO options, refused
    until B9b was, are fields with the reference's defaults.  The four the
    reference parses and never reads stay refused."""
    assert hasattr(REF.options.Options(), field)
    if field in ("leader_elect", "lease_path", "snapshot_path",
                 "lease_ttl_s", "log_format", "trace_slow_ms",
                 "enable_profiling", "incident_dir", "slo_eval_cadence_s",
                 "obs_sample_s"):
        want = getattr(REF.options.Options(), field)
        assert getattr(PORT.options.Options(**{field: want}), field) == want
        assert getattr(PORT.options.Options(), field) == want
        return
    with pytest.raises(TypeError, match=field):
        PORT.options.Options(**{field: getattr(REF.options.Options(), field)})


# ---------------------------------------------------------------------------
# TestOperatorWiring and the gates plumbed to the controllers
# ---------------------------------------------------------------------------

def test_builds_full_provider_graph():
    def case(m):
        op = operator(m, m.options.Options(interruption_queue="q"),
                      catalog=m.gen.generate_catalog(20))
        assert op.queue is not None
        assert op.cloud_provider.subnets is op.subnets
        assert op.cloud_provider.launch_templates is op.launch_templates
        assert op.cloud_provider.instance_types.pricing is op.pricing
        ctrls = m.operator.build_controllers(op)
        return (op.pricing.on_demand_price(op.catalog[0].name), sorted(ctrls),
                op.options.cluster_dns, type(op.cluster.arena).__name__,
                type(op.cloud_provider.cloud).__name__)
    price, ctrls, dns, arena, cloud = both(case)
    assert price is not None and arena == "ClusterArena"
    assert cloud == "BatchedCloud" and dns == "10.100.0.10"
    assert {"provisioning", "termination", "disruption", "lifecycle",
            "garbagecollection", "tagging", "nodeclass", "interruption",
            "pricing"} <= set(ctrls)


def test_conditional_registration():
    def case(m):
        op = operator(m, m.options.Options(isolated_network=True),
                      catalog=m.gen.generate_catalog(5))
        return sorted(m.operator.build_controllers(op))
    ctrls = both(case)
    assert "interruption" not in ctrls and "pricing" not in ctrls


def test_lpguide_feature_gate_plumbs_to_provisioner():
    def case(m):
        op = operator(m, m.options.Options(),
                      catalog=m.gen.generate_catalog(10))
        on = m.operator.build_controllers(op)["provisioning"].lp_guide
        op2 = operator(m, m.options.Options(),
                       catalog=m.gen.generate_catalog(10))
        op2.options.feature_gates["LPGuide"] = False
        off = m.operator.build_controllers(op2)["provisioning"].lp_guide
        return on, off
    assert both(case) == (True, False)


def test_sharded_solve_gate_plumbs_to_controllers():
    def case(m):
        op = operator(m, m.options.Options(),
                      catalog=m.gen.generate_catalog(10))
        c = m.operator.build_controllers(op)
        seen = [c["provisioning"].sharded_solve, c["disruption"].sharded_solve]
        op2 = operator(m, m.options.Options(),
                       catalog=m.gen.generate_catalog(10))
        op2.options.feature_gates["ShardedSolve"] = True
        c2 = m.operator.build_controllers(op2)
        seen += [c2["provisioning"].sharded_solve,
                 c2["disruption"].sharded_solve]
        return seen
    assert both(case) == [False, False, True, True]


def test_decode_and_device_lp_gates_plumb_to_provisioner():
    def case(m):
        o = m.options.Options()
        o.feature_gates.update(DeviceDecode=True, DeviceLP=True,
                               LPRefinery=True)
        op = operator(m, o, catalog=m.gen.generate_catalog(5))
        p = m.operator.build_controllers(op)["provisioning"]
        out = (p.device_decode, p.decode_health is not None, p.device_lp,
               p.lp_health is not None, p.refinery is not None,
               p.health is not None)
        p.refinery.stop()
        return out
    assert both(case) == (True, True, True, True, True, True)


# ---------------------------------------------------------------------------
# TestRestartRecovery and test_hydrated_nodes_keep_labels_and_taints
# ---------------------------------------------------------------------------

def provisioned_operator(m, clock, n_pods, catalog_size, pools=None):
    op = seed_cloud(m, operator(m, m.options.Options(),
                                catalog=m.gen.generate_catalog(catalog_size),
                                clock=lambda: clock[0]))
    if pools:
        op.nodepools.update(pools)
    ctrls = m.operator.build_controllers(op)
    return op, ctrls


def test_restart_hydrates_fleet_instead_of_gc_killing_it():
    def case(m):
        clock = [1000.0]
        op1, ctrls1 = provisioned_operator(m, clock, 6, 10)
        op1.cluster.add_pods([pod(m) for _ in range(6)])
        clock[0] += 1.1
        res = ctrls1["provisioning"].provision()
        launched = {c.provider_id for c in res.launched}
        assert launched
        clock[0] += 120  # well past the GC registration grace period
        op2 = operator(m, m.options.Options(), cloud=op1.cloud,
                       catalog=m.gen.generate_catalog(10),
                       clock=lambda: clock[0])
        assert {n.provider_id for n in op2.cluster.nodes.values()} == launched
        assert set(op2.cluster.nodeclaims) == set(op1.cluster.nodeclaims)
        gc = m.operator.build_controllers(op2)["garbagecollection"].reconcile()
        assert gc.leaked_instances == [] and gc.orphaned_nodes == []
        assert len(op2.cloud.running()) == len(launched)
        # the hydrated nodes reached the arena through its delta API
        g = op2.cluster.arena.gather([pod(m)])
        return claims_of(op2.cluster.nodes.values()), len(g[0])
    both(case)


def test_hydrated_nodes_keep_age_for_expiry():
    def case(m):
        clock = [1000.0]
        op1, ctrls1 = provisioned_operator(m, clock, 1, 5)
        op1.cluster.add_pods([pod(m)])
        clock[0] += 1.1
        ctrls1["provisioning"].provision()
        clock[0] += 5000
        op2 = operator(m, m.options.Options(), cloud=op1.cloud,
                       catalog=m.gen.generate_catalog(5),
                       clock=lambda: clock[0])
        node = next(iter(op2.cluster.nodes.values()))
        return clock[0] - node.created_at >= 5000
    assert both(case) is True


def test_hydration_is_idempotent():
    def case(m):
        clock = [1000.0]
        op, ctrls = provisioned_operator(m, clock, 1, 5)
        op.cluster.add_pods([pod(m)])
        clock[0] += 1.1
        ctrls["provisioning"].provision()
        before = len(op.cluster.nodes)
        return op.hydrate_cluster(), len(op.cluster.nodes) == before
    assert both(case) == (0, True)


def test_hydrated_nodes_keep_labels_and_taints():
    def case(m):
        clock = [1000.0]
        T = m.taints
        pool = m.objects.NodePool(template=m.objects.NodePoolTemplate(
            labels={"team": "ml"},
            taints=[T.Taint("dedicated", "NoSchedule", "ml")]))
        op1, ctrls1 = provisioned_operator(m, clock, 1, 5,
                                           pools={"default": pool})
        op1.cluster.add_pods([pod(m, tolerations=[
            T.Toleration("dedicated", "Exists")])])
        clock[0] += 1.1
        ctrls1["provisioning"].provision()
        node1 = next(iter(op1.cluster.nodes.values()))
        assert any(t.key == "dedicated" for t in node1.taints)
        op2 = operator(m, m.options.Options(), cloud=op1.cloud,
                       catalog=m.gen.generate_catalog(5),
                       clock=lambda: clock[0])
        node2 = next(iter(op2.cluster.nodes.values()))
        wk = m.labels
        assert node2.labels.get(wk.INSTANCE_TYPE) == node1.instance_type
        assert node2.labels.get(wk.ZONE) == node1.zone
        assert node2.labels.get("team") == "ml"
        assert any(t.key == "dedicated" and t.value == "ml"
                   for t in node2.taints)
        # the hostname is the node's name, from each package's counter
        return sorted((k, v) for k, v in node2.labels.items()
                      if k != wk.HOSTNAME), [
            (t.key, t.effect, t.value) for t in node2.taints]
    both(case)


def test_delete_nodeclass_blocked_by_claims():
    """test_apply_nodeclass_and_blocked_delete's `Operator.delete` half (its
    `apply` half waits for the /v1 surface, ROADMAP.md queue B3)."""
    def case(m):
        clock = [1000.0]
        op = seed_cloud(m, operator(m, m.options.Options(),
                                    catalog=m.gen.generate_catalog(10),
                                    clock=lambda: clock[0]))
        nc = m.objects.NodeClass(name="gpu", image_family="standard",
                                 role="r")
        op.node_classes["gpu"] = nc
        m.operator.build_controllers(op)["nodeclass"].reconcile(nc)
        claim = m.objects.NodeClaim(nodepool="p", node_class_ref="gpu")
        op.cluster.nodeclaims[claim.name] = claim
        seen = [op.delete("NodeClass", "gpu")]   # blocked by the claim
        claim.terminating = True
        seen += [op.delete("NodeClass", "gpu"), "gpu" in op.node_classes,
                 op.delete("NodePool", "default"),
                 op.delete("NodePool", "default")]
        with pytest.raises(ValueError):
            op.delete("Widget", "x")
        return seen
    assert both(case) == [False, True, False, True, False]


# ---------------------------------------------------------------------------
# the port's boundaries
# ---------------------------------------------------------------------------

def test_operator_without_device_raises_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from karpenter_tpu_torch.operator import Operator
    from karpenter_tpu_torch.catalog.generate import generate_catalog
    with pytest.raises(KernelError):
        Operator(catalog=generate_catalog(5))


@pytest.mark.parametrize("gate,item", [
    ("WarmRestart", "B7"), ("HAFailover", "B7"),
    ("FlightRecorder", "B9"), ("SLOEngine", "B9")])
def test_unported_gates_raise_naming_their_roadmap_item(gate, item):
    """The gates refused until their features were ported (B7: durability
    and HA; B9: the flight recorder, the SLO engine and the cost ledger)
    build an operator whose manager reads them: WarmRestart with a snapshot
    path gives it a snapshot writer, HAFailover with a leader a fence on
    the cloud provider, FlightRecorder an armed incident bus, SLOEngine an
    engine and an armed ledger; `stop()` disarms both."""
    from karpenter_tpu_torch.catalog.generate import generate_catalog
    from karpenter_tpu_torch.obs import BUS, LEDGER
    from karpenter_tpu_torch.operator import (ControllerManager, Operator,
                                              Options, build_controllers)
    from karpenter_tpu_torch.operator.manager import LeaderElector
    opts = Options()
    opts.feature_gates[gate] = True
    if item == "B9":
        op = Operator(opts, catalog=generate_catalog(5), device="cpu")
        mgr = ControllerManager(op, build_controllers(op))
        try:
            if gate == "FlightRecorder":
                assert mgr.flight is not None and mgr.slo is None
                assert BUS.armed and not LEDGER.enabled
            else:
                assert mgr.slo is not None and mgr.flight is None
                assert LEDGER.enabled and not BUS.armed
        finally:
            mgr.stop()
        assert not BUS.armed and not LEDGER.enabled
        return
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        opts.snapshot_path = f"{d}/s.bin"
        op = Operator(opts, catalog=generate_catalog(5), device="cpu")
        mgr = ControllerManager(op, build_controllers(op),
                                leader=LeaderElector(f"{d}/ha.lease", "a"))
        if gate == "WarmRestart":
            assert mgr._snapshotter is not None and mgr.fence is None
        else:
            assert mgr.fence is not None
            assert op.cloud_provider.fence is mgr.fence


def test_chaos_spec_arms_the_injector_as_the_reference():
    """`Options.chaos_spec` (refused before the injector was ported) arms
    the process-global injector in `Operator`, as the reference's does:
    the same rules and seed give the same schedule."""
    from karpenter_tpu.catalog.generate import generate_catalog as ref_gen
    from karpenter_tpu.operator import Operator as RefOperator
    from karpenter_tpu.operator import Options as RefOptions
    from karpenter_tpu.utils import chaos as ref_chaos
    from karpenter_tpu_torch.catalog.generate import generate_catalog
    from karpenter_tpu_torch.operator import Operator, Options
    from karpenter_tpu_torch.utils import chaos as port_chaos
    spec = "point=cloud.api,key=describe_instances,rate=0.5,count=4"
    schedules = []
    try:
        for op_cls, opt_cls, gen, chaos, kw in (
                (RefOperator, RefOptions, ref_gen, ref_chaos, {}),
                (Operator, Options, generate_catalog, port_chaos,
                 {"device": "cpu"})):
            op_cls(opt_cls(chaos_spec=spec, chaos_seed=5), catalog=gen(5),
                   **kw)
            assert chaos.CHAOS.enabled
            bits = []
            for _ in range(20):
                try:
                    chaos.CHAOS.inject("cloud.api", key="describe_instances")
                    bits.append(0)
                except chaos.ChaosError:
                    bits.append(1)
            schedules.append(bits)
            chaos.CHAOS.reset()
    finally:
        ref_chaos.CHAOS.reset()
        port_chaos.CHAOS.reset()
    assert schedules[0] == schedules[1] and sum(schedules[1]) == 4


def test_default_operator_provisions_and_ticks_as_the_reference():
    """The operator cell at a small size: both packages' default Operator
    over a seeded cloud, two bursts provisioned by its Provisioner and one
    DisruptionController tick 10 000 s later give the same signatures; the
    port's round 2 and tick gather warm from the arena."""
    import bench
    from karpenter_tpu.cloud.fake import ImageInfo as RefImageInfo
    from karpenter_tpu.cloud.fake import SecurityGroupInfo as RefSG
    from karpenter_tpu.cloud.fake import SubnetInfo as RefSubnetInfo
    from karpenter_tpu.operator import Operator as RefOperator
    from karpenter_tpu.operator import Options as RefOptions
    from karpenter_tpu.operator import build_controllers as ref_build
    from karpenter_tpu_torch.cloud.fake import (ImageInfo, SecurityGroupInfo,
                                                SubnetInfo)
    from karpenter_tpu_torch.operator import Operator, Options, \
        build_controllers
    from karpenter_tpu.catalog.generate import generate_catalog as ref_gen
    from karpenter_tpu_torch import convert
    rounds = [(dict(workloads.HEADLINE, spec_count=30, total=600), 0),
              (dict(workloads.PROVISION_ROUND2, spec_count=30, total=300), 5)]
    catalog = ref_gen(40)
    out = {}
    for name, kit, build, extra in (
            ("ref", SimpleNamespace(
                Operator=RefOperator, Options=RefOptions,
                build_controllers=ref_build, SubnetInfo=RefSubnetInfo,
                SecurityGroupInfo=RefSG, ImageInfo=RefImageInfo),
             bench.build_pods, dict(catalog=catalog)),
            ("port", SimpleNamespace(
                Operator=Operator, Options=Options,
                build_controllers=build_controllers, SubnetInfo=SubnetInfo,
                SecurityGroupInfo=SecurityGroupInfo, ImageInfo=ImageInfo),
             workloads.build_pods,
             dict(catalog=convert.catalog_from_objects(catalog),
                  device="cpu"))):
        clear_lp_caches()
        env = workloads.operator_env(kit, **extra)
        out[name] = workloads.operator_replay(env, build, rounds=rounds)
        if name == "port":
            gathers = env.op.cluster.arena.gathers
    assert out["port"] == out["ref"]
    assert out["port"]["rounds"][1]["bound_existing"] > 0
    assert gathers["warm"] >= 2 and gathers["fallback"] == 0
