"""The port's host lowering against the JAX package's: catalog generation,
pod batches and `tensorize` must give bit-identical arrays.

Each scenario is built twice from the same seed, once from each package's
own classes, and every `Problem` field is compared exactly."""

import dataclasses
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

import bench
import karpenter_tpu  # noqa: F401
import karpenter_tpu_torch  # noqa: F401
from karpenter_tpu_torch import workloads

PKGS = ("karpenter_tpu", "karpenter_tpu_torch")


def _mods(pkg):
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return SimpleNamespace(obj=m("api.objects"), res=m("api.resources"),
                           taints=m("api.taints"), wk=m("api.labels"),
                           req=m("api.requirements"),
                           gen=m("catalog.generate"), tz=m("ops.tensorize"))


def _req_sig(reqs):
    return {k: (r.complement, sorted(r.values), r.greater_than, r.less_than,
                r.min_values) for k, r in reqs.items()}


def _type_sig(it):
    return (it.name, dict(it.capacity), dict(it.allocatable),
            dict(it.kube_reserved), dict(it.system_reserved),
            dict(it.eviction_threshold), _req_sig(it.requirements),
            [(o.zone, o.capacity_type, o.price, o.available)
             for o in it.offerings])


@pytest.mark.parametrize("n_types", [10, 200, 600, None])
def test_generate_catalog_matches_reference(n_types):
    ref = _mods("karpenter_tpu").gen.generate_catalog(n_types)
    port = _mods("karpenter_tpu_torch").gen.generate_catalog(n_types)
    assert [_type_sig(t) for t in port] == [_type_sig(t) for t in ref]


def _pod_sig(p):
    return (dict(p.requests), dict(p.node_selector),
            [dataclasses.astuple(t) for t in p.tolerations])


def test_build_pods_matches_bench():
    kw = dict(gpu_frac=0.3, zone_frac=0.3, taint_frac=0.3)
    ref = bench.build_pods(40, 333, np.random.default_rng(5), **kw)
    port = workloads.build_pods(40, 333, np.random.default_rng(5), **kw)
    assert [_pod_sig(p) for p in port] == [_pod_sig(p) for p in ref]


def _scenario(pkg, name, seed):
    """(pods, catalog, nodepools) for one scenario, in `pkg`'s own types."""
    M = _mods(pkg)
    rng = np.random.default_rng(seed)
    Pod, RL = M.obj.Pod, M.res.ResourceList
    cpu, mem, gpu = M.res.CPU, M.res.MEMORY, M.res.GPU
    catalog = M.gen.generate_catalog(40 if name != "wide" else 120)
    pools = [M.obj.NodePool()]
    pods = []
    if name == "bench":
        build = bench.build_pods if pkg == "karpenter_tpu" else \
            workloads.build_pods
        pods = build(24, 500, rng, gpu_frac=0.2, zone_frac=0.3,
                     taint_frac=0.2)
    elif name == "taints":
        pools = [M.obj.NodePool(),
                 M.obj.NodePool(name="dedicated", weight=10,
                                template=M.obj.NodePoolTemplate(
                                    taints=[M.taints.Taint("dedicated",
                                                           value="x")],
                                    labels={"team": "ml"}))]
        for i in range(60):
            tol = ([M.taints.Toleration("dedicated", "Exists")]
                   if i % 3 == 0 else [])
            sel = {"team": "ml"} if i % 5 == 0 else {}
            pods.append(Pod(requests=RL({cpu: 250 * (1 + i % 4),
                                         mem: 2**28 * (1 + i % 3)}),
                            tolerations=tol, node_selector=sel))
    elif name == "zones":
        zone = M.wk.ZONE
        for i in range(80):
            kw = {}
            if i % 4 == 0:
                kw["node_selector"] = {zone: ("zone-a", "zone-b", "zone-c")[i % 3]}
            elif i % 4 == 1:
                kw["volume_zones"] = ["zone-b"]
            elif i % 4 == 2:
                kw["required_affinity_terms"] = [M.req.Requirements.of(
                    M.req.Requirement(zone, M.req.IN, ["zone-a", "zone-c"]))]
            pods.append(Pod(requests=RL({cpu: int(rng.integers(100, 4000)),
                                         mem: int(rng.integers(1, 64)) * 2**27}),
                            **kw))
    elif name == "gpu_extra_axis":
        for i in range(50):
            req = {cpu: 500, mem: 2**30}
            if i % 2:
                req[gpu] = int(rng.choice([1, 2, 4]))
            if i % 5 == 0:
                req["example.com/fpga"] = 1
            if i % 7 == 0:
                req["hugepages-2Mi"] = 2**21 * 4
            pods.append(Pod(requests=RL(req)))
    elif name == "hostname_caps":
        host = M.wk.HOSTNAME
        for i in range(60):
            kw = {"labels": {"app": f"a{i % 3}"}}
            if i % 3 == 0:
                kw["topology_spread"] = [M.obj.TopologySpreadConstraint(
                    topology_key=host, max_skew=2,
                    label_selector={"app": "a0"})]
            elif i % 3 == 1:
                kw["pod_affinities"] = [M.obj.PodAffinityTerm(
                    topology_key=host, anti=True, required=True,
                    label_selector={"app": "a1"})]
            pods.append(Pod(requests=RL({cpu: 300, mem: 2**29}), **kw))
    elif name == "wide":
        pools = [M.obj.NodePool(),
                 M.obj.NodePool(name="dense", weight=5,
                                template=M.obj.NodePoolTemplate(
                                    kubelet=M.obj.KubeletConfiguration(
                                        max_pods=20)))]
        for i in range(200):
            pods.append(Pod(requests=RL({cpu: int(rng.integers(50, 6000)),
                                         mem: int(rng.integers(1, 200)) * 2**26})))
    return pods, catalog, pools


def _problem_sig(prob):
    sig = dict(
        axes=tuple(prob.axes), scales=dict(prob.scales),
        zones=list(prob.zones),
        options=[dataclasses.astuple(o) for o in prob.options],
        members=[np.asarray(m, np.int64).tolist() for m in prob.class_members],
        class_order=prob.class_order().tolist(),
        class_gang=None if prob.class_gang is None else prob.class_gang.tolist(),
    )
    for f in ("class_requests", "class_counts", "class_compat",
              "class_node_cap", "option_alloc", "option_price", "option_rank",
              "option_zone", "option_captype"):
        a = getattr(prob, f)
        sig[f] = (a.dtype.str, a.shape, a.tobytes())
    return sig


@pytest.mark.parametrize("name", ["bench", "taints", "zones",
                                  "gpu_extra_axis", "hostname_caps", "wide"])
def test_tensorize_matches_reference(name):
    sigs = []
    for pkg in PKGS:
        pods, catalog, pools = _scenario(pkg, name, seed=11)
        prob = _mods(pkg).tz.tensorize(pods, catalog, pools)
        sigs.append(_problem_sig(prob))
    ref, port = sigs
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k] == ref[k], k


def test_scenarios_exercise_their_features():
    """The scenarios above really reach the lowering branches they name."""
    tz = _mods("karpenter_tpu_torch").tz
    probs = {n: tz.tensorize(*_scenario("karpenter_tpu_torch", n, seed=11))
             for n in ("taints", "gpu_extra_axis", "hostname_caps", "wide")}
    assert not probs["taints"].class_compat.all()
    assert len(probs["gpu_extra_axis"].axes) == 9       # fpga + hugepages
    assert set(probs["hostname_caps"].class_node_cap.tolist()) >= {1, 2}
    assert set(probs["wide"].option_rank.tolist()) == {0, 1}


def test_pad_to_matches_reference():
    ref = _mods("karpenter_tpu").tz.pad_to
    port = _mods("karpenter_tpu_torch").tz.pad_to
    for n in (0, 1, 255, 256, 257, 50_000, 53_248, 53_249, 70_000):
        assert port(n) == ref(n)
        assert port(n, (64, 256)) == ref(n, (64, 256))
