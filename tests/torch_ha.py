"""Shared fixtures of the port's durability and HA parity tests
(tests/test_torch_snapshot.py, tests/test_torch_failover.py): a namespace
of either package's modules, the small operator stacks of
tests/test_snapshot.py and tests/test_failover.py built from it, and
`both`, which runs one case on the JAX package and on the port (on the
CPU), each in a directory of its own, with the module-global name counters
restarted before each, and asserts that their plain observations are
equal."""

import importlib
import itertools
import os
from types import SimpleNamespace

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = dict(
    objects="api.objects", resources="api.resources", taints="api.taints",
    gen="catalog.generate", fake="cloud.fake", queue="cloud.queue",
    operator="operator", manager="operator.manager",
    snapshot="state.snapshot", cluster_mod="state.cluster",
    fencing="utils.fencing", chaos="utils.chaos", lpsolve="ops.lpsolve",
    lpguide="ops.lpguide", sim="sim")


def package(name, extra):
    return SimpleNamespace(name=name, extra=extra, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in MODULES.items()})


REF = package("karpenter_tpu", {})
PORT = package("karpenter_tpu_torch", {"device": "cpu"})


def reset_counters(m) -> None:
    m.objects._ids = itertools.count()
    m.cluster_mod._names = itertools.count(1)
    m.queue._msg_ids = itertools.count(1)


def both(case, tmp_path):
    """Run `case(m, dir)` on the reference, then on the port, each in a
    fresh directory under `tmp_path`; their observations must be equal."""
    out = []
    for m in (REF, PORT):
        d = tmp_path / m.name
        d.mkdir(parents=True, exist_ok=True)
        reset_counters(m)
        out.append(case(m, d))
    assert out[0] == out[1]
    return out[1]


def seed_cloud(m, op):
    op.cloud.subnets = [m.fake.SubnetInfo("s-a", "zone-a", 10_000, {}),
                        m.fake.SubnetInfo("s-b", "zone-b", 10_000, {})]
    op.cloud.security_groups = [m.fake.SecurityGroupInfo("sg", "nodes", {})]
    op.cloud.images = [m.fake.ImageInfo("img-1", "std", "amd64", 1.0)]
    op.params.parameters = {
        "/karpenter-tpu/images/standard/1.28/amd64/latest": "img-1"}
    return op


def pod(m, name=None, cpu=500):
    R = m.resources
    return m.objects.Pod(name=name, requests=R.ResourceList(
        {R.CPU: cpu, R.MEMORY: 512 * 2**20}))


def operator(m, opts, clock, cloud=None):
    return seed_cloud(m, m.operator.Operator(
        opts, cloud=cloud, catalog=m.gen.generate_catalog(10), clock=clock,
        **m.extra))


def stack(m, clock, snap_path="", gates=(), cloud=None):
    """tests/test_snapshot.py's `stack`."""
    opts = m.operator.Options(snapshot_path=snap_path,
                              interruption_queue="q")
    for g in gates:
        opts.feature_gates[g] = True
    op = operator(m, opts, clock, cloud)
    mgr = m.operator.ControllerManager(op, m.operator.build_controllers(op),
                                       clock=clock)
    return op, mgr


def provisioned_stack(m, clk, snap_path="", gates=("WarmRestart",)):
    op, mgr = stack(m, lambda: clk[0], snap_path, gates)
    op.cluster.add_pods([pod(m) for _ in range(6)])
    mgr.tick()
    clk[0] += 1.1
    mgr.tick()
    assert op.cluster.nodes and not op.cluster.pending_pods()
    return op, mgr


def gather_of(op):
    g = op.cluster.arena.gather(list(op.cluster.pods.values()))
    assert g is not None, "gather unexpectedly fell back"
    return g


def gather_obs(g):
    """A gather's plain content: node names and the three arrays."""
    nodes, alloc, used, compat = g
    return ([n.name for n in nodes], np.asarray(alloc).tolist(),
            np.asarray(used).tolist(), np.asarray(compat).tolist())


def elector(m, path, ident, clk, ttl=15.0):
    return m.manager.LeaderElector(str(path / "ha.lease"), ident, ttl=ttl,
                                   clock=lambda: clk[0])


def ha_stack(m, path, clk, ttl=15.0, snap="", ident="self"):
    """tests/test_failover.py's `ha_stack`: an operator + manager with an
    HAFailover-gated elector wired in."""
    clock = lambda: clk[0]
    opts = m.operator.Options(snapshot_path=snap, interruption_queue="q")
    opts.feature_gates["HAFailover"] = True
    if snap:
        opts.feature_gates["WarmRestart"] = True
    op = operator(m, opts, clock)
    led = elector(m, path, ident, clk, ttl=ttl)
    mgr = m.operator.ControllerManager(op, m.operator.build_controllers(op),
                                       clock=clock, leader=led)
    return op, mgr, led


def provision(m, op, mgr, clk, n=6):
    op.cluster.add_pods([pod(m) for _ in range(n)])
    mgr.tick()
    clk[0] += 1.1
    mgr.tick()
    assert op.cluster.nodes and not op.cluster.pending_pods()
