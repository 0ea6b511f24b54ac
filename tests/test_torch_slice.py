"""The port's class-granular solve against the JAX package's, end to end.

`karpenter_tpu.ops.classpack.solve_classpack(guide=None)` and the port's
`solve_classpack(guide=None, device="cpu")` get the same `Problem` (carried
across with `convert.problem_from_arrays`) and the same existing-node
arrays.  The plans must be identical: the bench's plan fingerprint (node
options, per-node pod runs, existing fills, unschedulable pods), each
node's `used` and its flexible `alternatives`.  The aggregate solve
(decode=False) must give the same nodes per option and unschedulable count,
with total_price within relative 1e-5 (a float32 sum in another order).

The full-width test recomputes the golden digests that `chip_smoke.py`
checks on the card from the JAX package, and the port reproduces them on the
CPU.  The cases of tests/test_classpack.py are mirrored here."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from helpers import cpu_pod, make_type, small_catalog
from karpenter_tpu.api.objects import NodePool, Pod
from karpenter_tpu.api.resources import CPU, GPU, MEMORY, PODS, ResourceList
from karpenter_tpu.catalog.generate import generate_catalog
from karpenter_tpu.ops.classpack import solve_classpack as ref_solve
from karpenter_tpu.ops.tensorize import tensorize
from karpenter_tpu_torch import convert, workloads
from karpenter_tpu_torch.ops import classpack as port_cp
from torch_cases import one_torch_thread  # noqa: F401

REL_TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _node_sig(nd):
    return (dict(nd.used), [dataclasses.astuple(o) for o in nd.alternatives])


def assert_same_plan(prob, decode=True, **kw):
    """Solve with both packages; return the reference result."""
    want = ref_solve(prob, guide=None, decode=decode, **kw)
    tprob = convert.problem_from_arrays(prob)
    if "existing_alloc" in kw:
        a, u, c = convert.slot_state_from_arrays(dict(
            alloc=kw["existing_alloc"], used=kw.get("existing_used"),
            compat=kw.get("existing_compat")))
        kw = dict(kw, existing_alloc=a, existing_used=u, existing_compat=c)
    got = port_cp.solve_classpack(tprob, guide=None, decode=decode,
                                  device="cpu", **kw)
    if decode:
        fw = workloads.plan_fingerprint(prob, want)
        fg = workloads.plan_fingerprint(tprob, got)
        for a, b in zip(fw[:5], fg[:5]):
            np.testing.assert_array_equal(a, b)
        assert fw[5] == fg[5]
        assert [_node_sig(n) for n in want.nodes] == \
            [_node_sig(n) for n in got.nodes]
    else:
        assert workloads.plan_digest(prob, want, False)[0] == \
            workloads.plan_digest(tprob, got, False)[0]
        assert abs(got.total_price - want.total_price) <= \
            REL_TOL * max(abs(want.total_price), 1e-30)
    return want


def _existing(prob, cpu=2000, mem=4096, n=1):
    R = len(prob.axes)
    alloc = np.zeros((n, R), np.float32)
    alloc[:, prob.axes.index(CPU)] = cpu
    alloc[:, prob.axes.index(MEMORY)] = mem
    alloc[:, prob.axes.index(PODS)] = 110
    return dict(existing_alloc=alloc, existing_used=np.zeros((n, R), np.float32))


# ---- the cases of tests/test_classpack.py, both decode modes ----

def _pods(name):
    if name == "single_class":
        return [cpu_pod(cpu_m=400, mem_mib=256) for _ in range(20)], None
    if name == "mixed":
        return ([cpu_pod(cpu_m=1500, mem_mib=2048) for _ in range(10)]
                + [cpu_pod(cpu_m=200, mem_mib=128) for _ in range(30)]), None
    if name == "fill_gaps":
        return ([cpu_pod(cpu_m=1200, mem_mib=512) for _ in range(3)]
                + [cpu_pod(cpu_m=100, mem_mib=64) for _ in range(6)]), None
    if name == "unschedulable":
        return [cpu_pod(cpu_m=10**6) for _ in range(3)] + [cpu_pod(cpu_m=100)], None
    if name == "gpu":
        cat = small_catalog() + [make_type("g.xlarge", 8, 32, 1.2, gpu_count=4)]
        return [Pod(requests=ResourceList({CPU: 500, GPU: 1}))
                for _ in range(8)], cat
    if name == "scale":
        rng = np.random.default_rng(3)
        specs = [(int(rng.integers(100, 4000)), int(rng.integers(128, 8192)))
                 for _ in range(12)]
        return ([cpu_pod(cpu_m=c, mem_mib=m) for c, m in specs
                 for _ in range(40)], generate_catalog(60))
    if name == "determinism":
        return [cpu_pod(cpu_m=700, mem_mib=300) for _ in range(50)], None
    raise KeyError(name)


@pytest.mark.parametrize("decode", [True, False])
@pytest.mark.parametrize("name", ["single_class", "mixed", "fill_gaps",
                                  "unschedulable", "gpu", "scale",
                                  "determinism"])
def test_fresh_solves_match_reference(name, decode):
    pods, cat = _pods(name)
    prob = tensorize(pods, cat or small_catalog(), [NodePool()])
    res = assert_same_plan(prob, decode=decode)
    if name == "unschedulable":
        assert len(res.unschedulable) == 3


@pytest.mark.parametrize("decode", [True, False])
@pytest.mark.parametrize("cpu_m,n_existing", [(300, 4), (900, 2)])
def test_existing_capacity_matches_reference(cpu_m, n_existing, decode):
    """existing_capacity_consumed_first / existing_partial_then_new."""
    prob = tensorize([cpu_pod(cpu_m=cpu_m, mem_mib=128) for _ in range(4)],
                     small_catalog(), [NodePool()])
    res = assert_same_plan(prob, decode=decode, **_existing(prob))
    if decode:
        assert len(res.existing_assignments) == n_existing


def test_host_lowering_truncates_alloc_and_ceils_used():
    """Fractional existing allocatable truncates and fractional usage rounds
    up in the int32 lowering: 2999.9 − ceil(999.2) leaves room for 3 pods of
    600m, not 3.33, and the pods' memory request of 128 MiB sits on a node
    with 4096.7 MiB."""
    prob = tensorize([cpu_pod(cpu_m=600, mem_mib=128) for _ in range(5)],
                     small_catalog(), [NodePool()])
    ex = _existing(prob, cpu=2999.9, mem=4096.7)
    ex["existing_used"][0, prob.axes.index(CPU)] = 999.2
    res = assert_same_plan(prob, **ex)
    assert len(res.existing_assignments) == 3


def test_overcommitted_existing_nodes_match_reference():
    """Existing usage above the lowered allocatable drives free space
    negative, where floor and truncating division differ."""
    pods = bench.build_pods(12, 300, np.random.default_rng(2), gpu_frac=0.1,
                            zone_frac=0.2, taint_frac=0.1)
    prob = tensorize(pods, generate_catalog(50), [NodePool()])
    a, u, c = workloads.existing_nodes(prob, 40, np.random.default_rng(3))
    u[::4, 0] = a[::4, 0] + 500.5
    for decode in (True, False):
        assert_same_plan(prob, decode=decode, existing_alloc=a,
                         existing_used=u, existing_compat=c)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_batches_match_reference(seed):
    """bench-style mixed batches (GPU, zone selectors, taints) with and
    without existing nodes, on a slot budget small enough to run out."""
    rng = np.random.default_rng(seed)
    pods = bench.build_pods(30, 900, rng, gpu_frac=0.1, zone_frac=0.3,
                            taint_frac=0.2)
    prob = tensorize(pods, generate_catalog(80), [NodePool()])
    ex = dict(zip(("existing_alloc", "existing_used", "existing_compat"),
                  workloads.existing_nodes(prob, 24, rng)))
    for kw in ({}, ex, dict(max_nodes=48), dict(ex, max_nodes=48)):
        for decode in (True, False):
            assert_same_plan(prob, decode=decode, **kw)


def test_empty_catalog_matches_reference():
    prob = tensorize([cpu_pod() for _ in range(3)], [], [NodePool()])
    assert_same_plan(prob)


# ---- the headline: 50k pods × 600 types, the goldens chip_smoke checks ----

@pytest.fixture(scope="module")
def headline():
    pods = bench.build_pods(
        rng=np.random.default_rng(workloads.HEADLINE_SEED),
        **workloads.HEADLINE)
    prob = tensorize(pods, generate_catalog(workloads.HEADLINE_TYPES),
                     [NodePool()])
    ex = workloads.existing_nodes(prob, workloads.HEADLINE_EXISTING,
                                  np.random.default_rng(workloads.EXISTING_SEED))
    return prob, dict(zip(("existing_alloc", "existing_used",
                           "existing_compat"), ex))


@pytest.mark.parametrize("n_existing", [0, workloads.HEADLINE_EXISTING])
def test_headline_goldens_from_the_reference(headline, n_existing):
    """The JAX package reproduces the committed golden digests, and the
    port (plain versions, CPU) reproduces them too.  Decoded totals are the
    same host sum; the aggregate total is a float32 device sum, held to
    relative 1e-5."""
    prob, ex = headline
    kw = ex if n_existing else {}
    tprob = convert.problem_from_arrays(prob)
    for decode in (True, False):
        gold, gold_total = workloads.GOLDEN[(n_existing, decode)]
        want = ref_solve(prob, guide=None, decode=decode, **kw)
        got = port_cp.solve_classpack(tprob, guide=None, decode=decode,
                                      device="cpu", **kw)
        for p, res in ((prob, want), (tprob, got)):
            digest, total = workloads.plan_digest(p, res, decode)
            assert digest == gold
            assert abs(total - gold_total) <= REL_TOL * gold_total
    assert prob.num_classes == 200 and prob.num_options == 3600


# ---- the port's boundaries ----

def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys, importlib\n"
        "for m in ('karpenter_tpu_torch', 'karpenter_tpu_torch.api',\n"
        "          'karpenter_tpu_torch.catalog', 'karpenter_tpu_torch.ops',\n"
        "          'karpenter_tpu_torch.ops.tensorize',\n"
        "          'karpenter_tpu_torch.ops.classpack',\n"
        "          'karpenter_tpu_torch.ops.classpack_kernels',\n"
        "          'karpenter_tpu_torch.ops.constraints',\n"
        "          'karpenter_tpu_torch.ops.ffd',\n"
        "          'karpenter_tpu_torch.ops.ffd_kernels',\n"
        "          'karpenter_tpu_torch.ops.decode',\n"
        "          'karpenter_tpu_torch.ops.health',\n"
        "          'karpenter_tpu_torch.ops.lpguide',\n"
        "          'karpenter_tpu_torch.ops.lpsolve',\n"
        "          'karpenter_tpu_torch.ops.lpsolve_kernels',\n"
        "          'karpenter_tpu_torch.ops.refinery',\n"
        "          'karpenter_tpu_torch.state', 'karpenter_tpu_torch.state.cluster',\n"
        "          'karpenter_tpu_torch.controllers',\n"
        "          'karpenter_tpu_torch.controllers.disruption',\n"
        "          'karpenter_tpu_torch.controllers.provisioning',\n"
        "          'karpenter_tpu_torch.cloud',\n"
        "          'karpenter_tpu_torch.utils.provenance',\n"
        "          'karpenter_tpu_torch.utils.watchdog',\n"
        "          'karpenter_tpu_torch.forecast.headroom',\n"
        "          'karpenter_tpu_torch.utils.events',\n"
        "          'karpenter_tpu_torch.convert',\n"
        "          'karpenter_tpu_torch.workloads',\n"
        "          'karpenter_tpu_torch._build'):\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'karpenter_tpu' or m.startswith('karpenter_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_imports_nothing_of_jax():
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src, re.M)
    assert imports and all(m.split(".")[0] not in ("jax", "karpenter_tpu")
                           for m in imports), imports


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = convert.problem_from_arrays(
        tensorize([cpu_pod()], small_catalog(), [NodePool()]))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cp.solve_classpack(prob, guide=None)


@pytest.mark.parametrize("entry,kw", [
    ("solve_ffd", dict(backend="native")),
    ("provisioner", dict(gang_scheduling=True, sharded_solve=True)),
    ("provisioner", dict(gang_scheduling=True)),
    ("provisioner", dict(gang_scheduling=True, device_decode=True))])
def test_unported_options_raise(entry, kw):
    """What is not ported yet raises and names ROADMAP.md: the native C++
    packer and gang scheduling, also beside ported options.  The slab
    decode (`device_decode`) is ported (tests/test_torch_decode.py), as are
    the sharded driver (`sharded_solve`, tests/test_torch_partitioned.py),
    the guided path, its refinery and the device LP
    (tests/test_torch_lpguide.py)."""
    from karpenter_tpu_torch.cloud import CloudProvider, FakeCloud
    from karpenter_tpu_torch.controllers.provisioning import Provisioner
    from karpenter_tpu_torch.ops.ffd import solve_ffd
    from karpenter_tpu_torch.state import Cluster
    prob = convert.problem_from_arrays(
        tensorize([cpu_pod()], small_catalog(), [NodePool()]))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if entry == "solve_ffd":
            solve_ffd(prob, device="cpu", **kw)
        else:
            provider = CloudProvider(FakeCloud(), convert.catalog_from_objects(
                small_catalog()))
            Provisioner(provider, Cluster(), [], device="cpu", **kw)


def test_guide_lp_is_skipped_where_the_reference_skips_it():
    """With existing nodes or decode=False the reference never routes to
    the guided path, so guide='lp' (the default) solves greedily."""
    prob = tensorize([cpu_pod() for _ in range(5)], small_catalog(),
                     [NodePool()])
    tprob = convert.problem_from_arrays(prob)
    for kw in (dict(decode=False), _existing(prob)):
        want = ref_solve(prob, **kw)
        got = port_cp.solve_classpack(tprob, device="cpu", **kw)
        assert len(got.nodes) == len(want.nodes)
        assert got.total_price == pytest.approx(want.total_price, rel=REL_TOL)
