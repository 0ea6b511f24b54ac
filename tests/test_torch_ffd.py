"""The port's pod-granular FFD (row 11) against the JAX package's, on the CPU.

  * `ffd_scan_plain` (K7's plain version) against the JAX program
    `ffd_pack_kernel` on the same padded inputs — the edge cases of
    tests/test_native.py (an inf-priced only fit, a score overflow, a NaN
    price, a hostname cap, existing nodes) and seeded random scans with
    existing slots, caps and slot exhaustion: every output equal, the
    float32 slot usage bit for bit;
  * `solve_ffd` of both packages with backend "jax", "native" and "numpy"
    on the cases of tests/test_ffd.py and tests/test_native.py: identical
    plans
    (node order, pod order, `used`, alternatives, existing fills,
    unschedulable list, total by ==);
  * the port's "auto" (the K7 scan) against the reference's "auto" (its
    native C++ packer where built) on batches of at most
    NATIVE_CUTOVER_ROWS rows: identical plans.
"""

import numpy as np
import pytest
import torch

from helpers import cpu_pod, make_type, small_catalog
from karpenter_tpu.api import labels as wk
from karpenter_tpu.api.objects import NodePool, Pod, PodAffinityTerm
from karpenter_tpu.api.resources import CPU, GPU, MEMORY, PODS, ResourceList
from karpenter_tpu.catalog.generate import generate_catalog
from karpenter_tpu.ops.ffd import ffd_pack_kernel as ref_kernel
from karpenter_tpu.ops.ffd import solve_ffd as ref_solve
from karpenter_tpu.ops.tensorize import tensorize
from karpenter_tpu_torch import convert, workloads
from karpenter_tpu_torch.ops import ffd as port_ffd
from karpenter_tpu_torch.ops import ffd_kernels as fk
from torch_cases import one_torch_thread  # noqa: F401
from torch_refnative import reference_native_loaded  # noqa: F401


def _random_problem(seed, n_pods=60, n_types=12):
    rng = np.random.default_rng(seed)
    pods = [Pod(requests=ResourceList({
        CPU: int(rng.integers(100, 4000)),
        MEMORY: int(rng.integers(128, 8192)) * 2**20}))
        for _ in range(n_pods)]
    return tensorize(pods, generate_catalog(n_types), [NodePool()])


def _existing(prob, n=2):
    R = prob.option_alloc.shape[1]
    return dict(existing_alloc=np.tile(prob.option_alloc[-1], (n, 1)),
                existing_used=np.zeros((n, R), np.float32))


def _problem(name):
    """(reference Problem, solve kwargs) of tests/test_ffd.py's and
    tests/test_native.py's cases."""
    if name == "inf_priced_only_fit":
        return tensorize([cpu_pod(cpu_m=32000), cpu_pod(cpu_m=500)],
                         [make_type("a.small", 2, 4, 0.10),
                          make_type("huge", 64, 256, float("inf"))],
                         [NodePool()]), {}
    if name == "score_overflow":
        return tensorize([cpu_pod(cpu_m=33000), cpu_pod(cpu_m=33000)],
                         [make_type("tiny", 1, 1, 0.05),
                          make_type("big", 64, 256, 3e38)],
                         [NodePool()]), {}
    if name == "nan_price":
        return tensorize([cpu_pod(cpu_m=32000), cpu_pod(cpu_m=500)],
                         [make_type("a.small", 2, 4, 0.10),
                          make_type("huge", 64, 256, float("nan"))],
                         [NodePool()]), {}
    if name == "node_cap":
        anti = [PodAffinityTerm(topology_key="kubernetes.io/hostname",
                                label_selector={"app": "db"}, anti=True,
                                required=True)]
        return tensorize([cpu_pod(labels={"app": "db"},
                                  pod_affinities=list(anti))
                          for _ in range(4)], small_catalog(),
                         [NodePool()]), {}
    if name == "existing_nodes":
        prob = _random_problem(11, n_pods=20)
        return prob, _existing(prob)
    if name == "existing_default_usage":
        prob = _random_problem(13, n_pods=10)
        return prob, dict(existing_alloc=np.tile(prob.option_alloc[-1],
                                                 (2, 1)))
    if name == "existing_full":
        prob = tensorize([cpu_pod(cpu_m=500, mem_mib=256)], small_catalog(),
                         [NodePool()])
        R = len(prob.axes)
        alloc = np.zeros((1, R), np.float32)
        alloc[0, prob.axes.index(CPU)] = 2000
        return prob, dict(existing_alloc=alloc, existing_used=alloc.copy())
    if name == "existing_first":
        prob = tensorize([cpu_pod(cpu_m=500, mem_mib=256)], small_catalog(),
                         [NodePool()])
        R = len(prob.axes)
        alloc = np.zeros((1, R), np.float32)
        alloc[0, prob.axes.index(CPU)] = 2000
        alloc[0, prob.axes.index(MEMORY)] = 4 * 2**30
        alloc[0, prob.axes.index(PODS)] = 110
        return prob, dict(existing_alloc=alloc,
                          existing_used=np.zeros((1, R), np.float32))
    if name == "pods_ceiling":
        return tensorize([cpu_pod(cpu_m=1, mem_mib=1) for _ in range(150)],
                         small_catalog(), [NodePool()]), {}
    if name == "overflow":
        return tensorize([cpu_pod(cpu_m=800, mem_mib=128) for _ in range(4)],
                         small_catalog(), [NodePool()]), {}
    if name == "unschedulable":
        return tensorize([cpu_pod(cpu_m=64_000)], small_catalog(),
                         [NodePool()]), {}
    if name == "constraints":
        rng = np.random.default_rng(7)
        cat = small_catalog() + [make_type("g.xlarge", 8, 32, 1.2,
                                           gpu_count=4)]
        pods = []
        for i in range(40):
            if i % 5 == 0:
                pods.append(Pod(requests=ResourceList({CPU: 500, GPU: 1})))
            elif i % 3 == 0:
                pods.append(cpu_pod(cpu_m=int(rng.integers(100, 2000)),
                                    node_selector={wk.ZONE: "zone-a"}))
            else:
                pods.append(cpu_pod(cpu_m=int(rng.integers(100, 2000))))
        return tensorize(pods, cat, [NodePool()]), {}
    if name == "tail_aware":
        catalog = [make_type("tiny", 2, 4, 0.028, zones=("zone-a",)),
                   make_type("dense", 32, 64, 0.30, zones=("zone-a",))]
        return tensorize([cpu_pod(cpu_m=1000, mem_mib=2048)
                          for _ in range(50)], catalog, [NodePool()]), {}
    if name == "random_inf_prices":
        prob = _random_problem(2, n_pods=40)
        rng = np.random.default_rng(2)
        prob.option_price[rng.random(prob.option_price.shape[0]) < 0.4] = \
            np.inf
        return prob, {}
    if name.startswith("random"):
        return _random_problem(int(name[-1])), {}
    raise KeyError(name)


EDGE = ["inf_priced_only_fit", "score_overflow", "nan_price", "node_cap",
        "existing_nodes", "existing_default_usage"]
CASES = EDGE + ["existing_full", "existing_first", "pods_ceiling",
                "overflow", "unschedulable", "constraints", "tail_aware",
                "random_inf_prices", "random_0", "random_1"]


def _port_kw(kw):
    if "existing_alloc" not in kw:
        return kw
    a, u, c = convert.slot_state_from_arrays(dict(
        alloc=kw["existing_alloc"], used=kw.get("existing_used"),
        compat=kw.get("existing_compat")))
    return dict(existing_alloc=a, existing_used=u, existing_compat=c)


def _plan(prob, res):
    """The whole plan, by option index: node order, pod order, used,
    alternatives, existing fills in dict order, unschedulable, total."""
    oi = {(o.pool, o.instance_type, o.zone, o.capacity_type): j
          for j, o in enumerate(prob.options)}

    def key(o):
        return oi[(o.pool, o.instance_type, o.zone, o.capacity_type)]
    return ([(key(n.option), list(n.pod_indices), dict(n.used),
              [key(a) for a in n.alternatives]) for n in res.nodes],
            list(res.existing_assignments.items()), list(res.unschedulable),
            res.total_price)


def _ref_program(low):
    """The JAX program on the port's lowering: per-row compat from the
    class table, everything else as lowered."""
    compat = low.ccomp[low.crow_p]
    out = ref_kernel(low.req_p, compat, low.valid, low.cid_p, low.cap_p,
                     low.rem_p, low.alloc_p, low.price_p, low.rank_p,
                     low.init_option, low.init_used, low.K)
    return [np.asarray(x) for x in out]


def _assert_outputs_equal(got, want):
    for g, w, what in zip(got, want, ("assignment", "slot_option",
                                      "slot_used", "n_open")):
        g = g.numpy()
        assert g.dtype == w.dtype, what
        np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("name", EDGE)
def test_plain_scan_matches_the_jax_program(name):
    prob, kw = _problem(name)
    tprob = convert.problem_from_arrays(prob)
    low = port_ffd.lower_ffd(tprob, **_port_kw(kw))
    got = fk.ffd_scan_plain(*port_ffd.ffd_device_args(low, "cpu"), low.K)
    _assert_outputs_equal(got, _ref_program(low))


@pytest.mark.parametrize("seed,kw", [
    (0, dict(P=384, C=12, O=96, R=4)),
    (1, dict(P=384, C=12, O=96, R=4, E=16, K=256)),
    (2, dict(P=512, C=8, O=64, R=3, K=32)),       # slot exhaustion
    (3, dict(P=256, C=40, O=128, R=5, E=8, K=128)),
])
def test_plain_scan_matches_the_jax_program_on_random_inputs(seed, kw):
    """Zero request axes, fractional usage, +inf / NaN / near-max prices,
    two pool ranks, hostname caps, existing slots, padded rows."""
    arrays, K = workloads.ffd_scan_inputs(np.random.default_rng(seed), **kw)
    (req, packed, crow, cid, valid, cap, rem, alloc, price, rank, iopt,
     iused) = arrays
    O = alloc.shape[0]
    compat = np.unpackbits(packed, axis=1, count=O).astype(bool)[crow]
    want = [np.asarray(x) for x in ref_kernel(
        req, compat, valid, cid, cap, rem, alloc, price, rank, iopt, iused,
        K)]
    got = fk.ffd_scan_plain(*(torch.tensor(a) for a in arrays), K)
    _assert_outputs_equal(got, want)


@pytest.mark.parametrize("backend", ["jax", "native", "numpy"])
@pytest.mark.parametrize("name", CASES)
def test_solve_ffd_matches_reference(name, backend):
    prob, kw = _problem(name)
    want = ref_solve(prob, backend=backend, **kw)
    tprob = convert.problem_from_arrays(prob)
    got = port_ffd.solve_ffd(tprob, backend=backend, device="cpu",
                             **_port_kw(kw))
    assert _plan(tprob, got) == _plan(prob, want)


@pytest.mark.parametrize("name", ["random_0", "constraints", "node_cap",
                                  "existing_nodes", "tail_aware"])
def test_auto_on_small_batches_matches_the_reference_auto(name):
    """≤ NATIVE_CUTOVER_ROWS rows: the reference's "auto" takes its native
    packer where built, the port's takes the K7 scan; the plans agree."""
    prob, kw = _problem(name)
    rows = int(prob.class_counts.sum()) + len(kw.get("existing_alloc", ()))
    assert rows <= port_ffd.NATIVE_CUTOVER_ROWS
    want = ref_solve(prob, **kw)
    tprob = convert.problem_from_arrays(prob)
    got = port_ffd.solve_ffd(tprob, device="cpu", **_port_kw(kw))
    assert _plan(tprob, got) == _plan(prob, want)


def test_plan_semantics_of_the_edge_cases():
    """tests/test_native.py's assertions, on the port."""
    def solve(name):
        prob, kw = _problem(name)
        return port_ffd.solve_ffd(convert.problem_from_arrays(prob),
                                  device="cpu", **_port_kw(kw))
    for name in ("inf_priced_only_fit", "nan_price"):
        res = solve(name)
        assert sorted(res.unschedulable) == [0]
        assert [n.option.instance_type for n in res.nodes] == ["a.small"]
    res = solve("score_overflow")
    assert not res.unschedulable
    assert [n.option.instance_type for n in res.nodes] == ["big", "big"]
    res = solve("node_cap")
    assert len(res.nodes) == 4 and all(len(n.pod_indices) == 1
                                       for n in res.nodes)
    assert solve("existing_nodes").existing_assignments
    res = solve("tail_aware")
    assert len(res.nodes) <= 4
    assert all(n.option.instance_type == "dense" for n in res.nodes)


def test_rem_in_class_and_the_greedy_rung_match_the_reference():
    from karpenter_tpu.ops.ffd import rem_in_class as ref_rem
    ids = np.array([0, 0, 0, 3, 3, 1, 2, 2, 2, 2], np.int32)
    np.testing.assert_array_equal(port_ffd.rem_in_class(ids), ref_rem(ids))
    assert port_ffd.NATIVE_CUTOVER_ROWS == 256


def test_native_backend_equals_the_scan_and_the_reference():
    """backend="native" runs the C++ packer on the host: the plan of the
    scan (K7's plain version) and of the reference's native backend."""
    prob, _ = _problem("random_0")
    tprob = convert.problem_from_arrays(prob)
    got = _plan(tprob, port_ffd.solve_ffd(tprob, backend="native"))
    assert got == _plan(tprob, port_ffd.solve_ffd(tprob, backend="jax",
                                                  device="cpu"))
    assert got == _plan(prob, ref_solve(prob, backend="native"))
    with pytest.raises(ValueError, match="unknown backend"):
        port_ffd.solve_ffd(tprob, backend="cuda")


def test_scan_wrapper_refuses_mixed_devices():
    arrays, K = workloads.ffd_scan_inputs(np.random.default_rng(5), P=128,
                                          C=4, O=32)
    args = [torch.tensor(a) for a in arrays]
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="devices"):
        fk.ffd_scan(*args, K)


@pytest.mark.parametrize("name", workloads.FFD_CURSOR_CASES)
def test_plain_scan_matches_the_jax_program_on_cursor_breaking_inputs(name):
    """Rows of one class that are not all identical (request, compat row or
    node cap changing inside the class, invalid rows inside it, some with
    another class's id), a class that runs out of slots, and all at once
    with existing slots: the inputs on which K7's first-fit cursor must
    reset.  Every output equal, the float32 slot usage bit for bit."""
    arrays, K = workloads.ffd_cursor_case(name, np.random.default_rng(11),
                                          P=512)
    (req, packed, crow, cid, valid, cap, rem, alloc, price, rank, iopt,
     iused) = arrays
    O = alloc.shape[0]
    compat = np.unpackbits(packed, axis=1, count=O).astype(bool)[crow]
    want = [np.asarray(x) for x in ref_kernel(
        req, compat, valid, cid, cap, rem, alloc, price, rank, iopt, iused,
        K)]
    got = fk.ffd_scan_plain(*(torch.tensor(a) for a in arrays), K)
    _assert_outputs_equal(got, want)
