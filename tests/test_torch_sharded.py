"""The port's pod-batch sharded solve (parallel/sharded.py, rows 13-14)
against the JAX package's, on the CPU: the cases of tests/test_sharded.py,
the programs themselves, the shard-batched kernels' plain versions and
`GOLDEN_SHARDED["headline-sharded"]`.

The JAX package runs on 8 virtual CPU devices (tests/conftest.py); the port
lays the same shards on the CPU (`make_pod_mesh(n, device="cpu",
shards_per_device=8)`, its counterpart of the virtual device count) and
runs the kernels' plain versions.  Integers — per-shard assignment,
slot_option and n_unsched, nodes per option, unscheduled counts, decoded
plans — must be identical; the psum'd float32 cost within relative 1e-6
(`PSUM_RTOL`: the reference's psum and the port's K8 sum in other orders);
decoded totals (host sums) by ==."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import cpu_pod, small_catalog
from karpenter_tpu.api.objects import NodePool
from karpenter_tpu.catalog.generate import generate_catalog
from karpenter_tpu.ops import tensorize
from karpenter_tpu.parallel import make_host_mesh as ref_host_mesh
from karpenter_tpu.parallel import make_pod_mesh as ref_pod_mesh
from karpenter_tpu.parallel import sharded as ref_sh
from karpenter_tpu.parallel import solve_sharded as ref_solve_sharded
from karpenter_tpu_torch import convert, workloads
from karpenter_tpu_torch.ops import classpack_kernels as ck
from karpenter_tpu_torch.parallel import sharded as port_sh
from test_decode import exact
from torch_cases import (CASES, make_case, one_torch_thread,  # noqa: F401
                         stack_shards)

RTOL = workloads.PSUM_RTOL
SHARDS = 8                      # the virtual devices of tests/conftest.py


def port_mesh(n=None, hosts=None):
    """The port's mesh over the reference's device count, on the CPU."""
    if hosts:
        return port_sh.make_host_mesh(hosts, n, device="cpu",
                                      shards_per_device=SHARDS)
    return port_sh.make_pod_mesh(n, device="cpu", shards_per_device=SHARDS)


def ref_mesh(n=None, hosts=None):
    return ref_host_mesh(hosts, n) if hosts else ref_pod_mesh(n)


def _mixed():
    pods = ([cpu_pod(cpu_m=1500, mem_mib=1024) for _ in range(40)]
            + [cpu_pod(cpu_m=300, mem_mib=256) for _ in range(80)])
    return tensorize(pods, small_catalog(), [NodePool()])


def _same_aggregate(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert got[0] == pytest.approx(want[0], rel=RTOL, abs=0)


# ---- the mesh ----

def test_axis_names_match_the_reference():
    assert (port_sh.SHARD_AXIS, port_sh.DCN_AXIS, port_sh.ICI_AXIS) == \
        (ref_sh.SHARD_AXIS, ref_sh.DCN_AXIS, ref_sh.ICI_AXIS)


def test_default_mesh_is_one_shard_per_visible_device():
    """On one device (here the CPU) the default mesh has one shard, so the
    partitioned driver declines exactly as on one TPU device."""
    mesh = port_sh.make_pod_mesh(device="cpu")
    assert mesh.shape == (1,) and mesh.size == 1
    assert mesh.axis_names == (port_sh.SHARD_AXIS,)
    assert mesh.device == torch.device("cpu")
    assert port_mesh().shape == ref_mesh().devices.shape == (SHARDS,)


def test_pod_mesh_validation_matches_the_reference():
    with pytest.raises(ValueError) as want:
        ref_pod_mesh(SHARDS + 1)
    with pytest.raises(ValueError) as got:
        port_mesh(SHARDS + 1)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="positive"):
        port_sh.make_pod_mesh(2, device="cpu", shards_per_device=0)


@pytest.mark.parametrize("hosts,chips", [(4, 4), (16, None), (3, None),
                                         (2, 0)])
def test_host_mesh_validation_matches_the_reference(hosts, chips):
    with pytest.raises(ValueError) as want:
        ref_host_mesh(hosts, chips)
    with pytest.raises(ValueError) as got:
        port_mesh(chips, hosts=hosts)
    assert str(got.value) == str(want.value)


def test_host_mesh_infers_chips():
    mesh = port_mesh(hosts=2)
    ref = ref_host_mesh(2)
    assert mesh.shape == ref.devices.shape == (2, 4)
    assert mesh.axis_names == tuple(ref.axis_names) == ("hosts", "chips")
    assert mesh.hosts == 2 and port_mesh(4).hosts == 1


# ---- split_counts and the solve ----

@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_split_counts_matches_the_reference(n):
    counts = np.random.default_rng(n).integers(0, 40, 37).astype(np.int32)
    got = port_sh.split_counts(counts, n)
    np.testing.assert_array_equal(got, ref_sh.split_counts(counts, n))
    assert (got.sum(axis=0) == counts).all()


@pytest.mark.parametrize("n,hosts", [(2, None), (4, None), (8, None),
                                     (4, 2)])
def test_aggregate_matches_the_reference(n, hosts):
    prob = _mixed()
    want = ref_solve_sharded(prob, ref_mesh(n, hosts),
                             max_nodes_per_shard=64)
    got = port_sh.solve_sharded(convert.problem_from_arrays(prob),
                                port_mesh(n, hosts), max_nodes_per_shard=64)
    _same_aggregate(got, want)
    assert got[2] == 0


@pytest.mark.parametrize("n,hosts", [(2, None), (4, None), (8, None),
                                     (4, 2)])
def test_decode_matches_the_reference(n, hosts):
    prob = _mixed()
    tprob = convert.problem_from_arrays(prob)
    want = ref_solve_sharded(prob, ref_mesh(n, hosts),
                             max_nodes_per_shard=256, decode=True)
    got = port_sh.solve_sharded(tprob, port_mesh(n, hosts),
                                max_nodes_per_shard=256, decode=True)
    assert exact(tprob, got) == exact(prob, want)
    # the audits of tests/test_sharded.py: every pod once, the fleet of the
    # aggregate path
    seen = [p for nd in got.nodes for p in nd.pod_indices]
    assert sorted(seen) == list(range(120))
    agg = port_sh.solve_sharded(tprob, port_mesh(n, hosts),
                                max_nodes_per_shard=256)
    assert len(got.nodes) == agg[1].sum()


def test_decode_existing_columns_owned():
    pods = [cpu_pod(cpu_m=500, mem_mib=256) for _ in range(64)]
    prob = tensorize(pods, small_catalog(), [NodePool()])
    E = 16
    ex_alloc = np.tile(prob.option_alloc.max(axis=0) * 2, (E, 1))
    kw = dict(max_nodes_per_shard=64, decode=True, existing_alloc=ex_alloc,
              existing_used=np.zeros_like(ex_alloc))
    want = ref_solve_sharded(prob, ref_mesh(8), **kw)
    tprob = convert.problem_from_arrays(prob)
    got = port_sh.solve_sharded(tprob, port_mesh(8), **kw)
    assert exact(tprob, got) == exact(prob, want)
    assert len(got.existing_assignments) == 64 and got.total_price == 0.0


def test_decode_existing_overcommitted_and_masked():
    """Existing columns with negative free space and a partial compat,
    dealt round-robin over the shards."""
    prob = _mixed()
    tprob = convert.problem_from_arrays(prob)
    a, u, c = workloads.existing_nodes(tprob, 24, np.random.default_rng(3))
    kw = dict(max_nodes_per_shard=128, decode=True, existing_alloc=a,
              existing_used=u, existing_compat=c)
    want = ref_solve_sharded(prob, ref_mesh(4, 2), **kw)
    got = port_sh.solve_sharded(tprob, port_mesh(4, 2), **kw)
    assert exact(tprob, got) == exact(prob, want)


# ---- the programs, output for output ----

def _lowered(prob, n, K, E=0):
    tprob = convert.problem_from_arrays(prob)
    ex = {}
    if E:
        a, u, c = workloads.existing_nodes(tprob, E,
                                           np.random.default_rng(E))
        ex = dict(existing_alloc=a, existing_compat=c)
    low = port_sh._lower(tprob, port_mesh(n), **ex)
    (order, C, Cpad, R, O, E_, Opad, requests, compat, alloc, price, rank,
     node_cap, counts) = low
    return low, ex


def test_sharded_pack_program_matches_the_reference():
    prob = _mixed()
    n, K = 8, 64
    low, _ = _lowered(prob, n, K)
    (_, _, Cpad, _, _, _, _, requests, compat, alloc, price, rank, node_cap,
     counts) = low
    args = (requests, counts, compat, node_cap, alloc, price, rank)
    want = ref_sh._sharded_pack(*map(jnp.asarray, args), K, ref_mesh(n))
    got = port_sh._sharded_pack(*map(torch.tensor, args), K, port_mesh(n))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])
    assert float(got[0]) == pytest.approx(float(want[0]), rel=RTOL, abs=0)


@pytest.mark.parametrize("hosts", [None, 2])
def test_sharded_assign_program_matches_the_reference(hosts):
    """Row 14 per shard: assignment, slot_option and n_unsched identical,
    with existing columns owned round-robin (a slot budget small enough
    that some shards run out of slots)."""
    prob = _mixed()
    n, K, E = 8, 4, 12
    mesh_shape = (2, 4) if hosts else (8,)
    low, ex = _lowered(prob, n, K, E)
    (_, C, Cpad, R, O, E, Opad, requests, compat, alloc, price, rank,
     node_cap, counts) = low
    compat_sh = np.repeat(compat[None], n, axis=0)
    init_opt = np.full((n, K), -1, np.int32)
    init_used = np.zeros((n, K, R), np.int32)
    for s in range(n):
        own = np.nonzero(np.arange(E) % n == s)[0]
        mask = np.zeros(E, bool)
        mask[own] = True
        compat_sh[s][:, O:O + E] &= mask[None, :]
        init_opt[s, :len(own)] = O + own
        init_used[s, :len(own)] = 100
    packed = np.packbits(compat_sh, axis=2)
    Ppad = 256
    shared = (requests, node_cap, alloc, price, rank)
    want = ref_sh._sharded_assign(
        jnp.asarray(requests), jnp.asarray(counts.reshape(*mesh_shape, Cpad)),
        jnp.asarray(packed.reshape(*mesh_shape, *packed.shape[1:])),
        *map(jnp.asarray, shared[1:]),
        jnp.asarray(init_opt.reshape(*mesh_shape, K)),
        jnp.asarray(init_used.reshape(*mesh_shape, K, R)), K, Ppad,
        ref_mesh(4 if hosts else 8, hosts))
    got = port_sh._sharded_assign(
        torch.tensor(requests), torch.tensor(counts), torch.tensor(packed),
        *map(torch.tensor, shared[1:]), torch.tensor(init_opt),
        torch.tensor(init_used), K, Ppad, port_mesh(4 if hosts else 8, hosts))
    for g, w, what in zip(got, want, ("assignment", "slot_option",
                                      "n_unsched")):
        w = np.asarray(w).reshape(n, -1) if what != "n_unsched" else \
            np.asarray(w).reshape(n)
        g = g.numpy().reshape(w.shape)
        assert g.dtype == w.dtype, what
        np.testing.assert_array_equal(g, w, err_msg=what)
    assert (np.asarray(want[2]).reshape(n) > 0).any()   # slots ran out


# ---- the shard-batched plain versions and K8 ----

@pytest.mark.parametrize("name", ["plain", "existing", "exhaustion_existing"])
def test_sharded_plains_equal_a_loop_of_the_single_device_plains(name):
    c = make_case(9, **CASES[name])
    n, K = 4, c["K"]
    s = stack_shards(c, n, np.random.default_rng(1), torch.device("cpu"))
    m, ok = ck.classpack_precompute_sharded(s["req"], s["cap"], s["packed"],
                                            s["alloc"], s["price"], s["rank"])
    scan = ck.classpack_scan_sharded(s["req"], s["cnt"], s["packed"],
                                     s["cap"], s["alloc"], s["price"], m, ok,
                                     s["iopt"], s["iused"], K, True)
    a = ck.classpack_assign_decode_sharded(scan[4], s["cnt"], c["Ppad"])
    agg = ck.classpack_aggregate_sharded(scan[0], s["price"], scan[2],
                                         scan[3])
    order, counts = ck.classpack_slab_sharded(a, K)
    for i in range(n):
        m1, ok1 = ck.classpack_precompute_plain(s["req"][i], s["cap"][i],
                                                s["packed"][i], s["alloc"],
                                                s["price"], s["rank"])
        assert torch.equal(m[i], m1) and torch.equal(ok[i], ok1)
        one = ck.classpack_scan_plain(
            s["req"][i], s["cnt"][i], s["packed"][i], s["cap"][i], s["alloc"],
            s["price"], m1, ok1, None if s["iopt"] is None else s["iopt"][i],
            None if s["iused"] is None else s["iused"][i], K, True)
        for x, y in zip(scan, one):
            assert torch.equal(x[i], y)
        a1 = ck.classpack_assign_decode_plain(one[4], s["cnt"][i], c["Ppad"])
        assert torch.equal(a[i], a1)
        assert torch.equal(agg[i], ck.classpack_aggregate_plain(
            one[0], s["price"], one[2], one[3]))
        o1, c1 = ck.classpack_slab_plain(a1, K)
        assert torch.equal(order[i], o1) and torch.equal(counts[i], c1)
    assert int(agg[1, 2]) == 0 and int(agg[1, 1]) == int(
        (s["iopt"][1] >= 0).sum() if s["iopt"] is not None else 0)


@pytest.mark.parametrize("hosts,chips", [(1, 8), (2, 4), (4, 2), (1, 1)])
def test_shard_psum_plain_sums_in_the_stated_order(hosts, chips):
    """K8's plain version: per host the float32 left fold over its chips,
    then the left fold of the host partials — checked against numpy's
    float32 adds in that order, bit for bit; the integer fields exact."""
    rng = np.random.default_rng(hosts * 10 + chips)
    n, L = hosts * chips, 40
    v = np.zeros((n, L), np.float32)
    v[:, 0] = rng.uniform(0, 3000, n).astype(np.float32)
    v[:, 1:] = rng.integers(0, 5000, (n, L - 1)).astype(np.float32)
    want = None
    for h in range(hosts):
        part = v[h * chips].copy()
        for c in range(1, chips):
            part = np.float32(part + v[h * chips + c])
        want = part if want is None else np.float32(want + part)
    got = ck.shard_psum(torch.tensor(v), hosts).numpy()
    assert got.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(got[1:], v[:, 1:].astype(np.int64).sum(0))
    with pytest.raises(ValueError, match="hosts"):
        ck.shard_psum(torch.tensor(v), n + 1)


def test_sharded_wrappers_refuse_mixed_layouts():
    c = make_case(2)
    req = torch.tensor(c["req"])
    cap = torch.tensor(c["cap"])
    packed = torch.tensor(np.packbits(c["comp"], axis=1))
    # a transposed stack is neither a stack of contiguous shards nor shared
    bad = req.unsqueeze(0).expand(2, *req.shape).transpose(1, 2)
    with pytest.raises(ValueError, match="shards"):
        ck._shard_stride(bad, "requests", torch.int32, tuple(bad.shape))
    with pytest.raises(TypeError):
        ck._shard_stride(cap.unsqueeze(0).float(), "node_cap", torch.int32,
                         (1, cap.shape[0]))
    assert ck._shard_stride(packed.expand(3, *packed.shape), "p",
                            torch.uint8, (3, *packed.shape)) == 0


def test_sharded_contract_faults_are_device_faults():
    """A shard-batched wrapper's contract fault is a ShardLayoutError: a
    KernelError (one of DEVICE_FAULTS, raised past the driver's fallback)
    that is still the TypeError / ValueError of a single-device wrapper."""
    from karpenter_tpu_torch.ops.classpack import DEVICE_FAULTS
    c = make_case(2)
    flat = torch.zeros((8, 5))
    with pytest.raises(ck.ShardLayoutError, match="hosts") as got:
        ck.shard_psum(flat, 3)
    assert isinstance(got.value, DEVICE_FAULTS)
    assert isinstance(got.value, ValueError)
    req = torch.tensor(c["req"]).unsqueeze(0)
    cnt = torch.tensor(c["cnt"]).unsqueeze(0)
    with pytest.raises(ck.ShardLayoutError, match="together"):
        ck.classpack_scan_sharded(req, cnt, None, None, None, None, None,
                                  None, torch.zeros((1, 4), dtype=torch.int32),
                                  None, 4)
    assert issubclass(ck.ShardLayoutError, TypeError)


# ---- the headline over the mesh: GOLDEN_SHARDED ----

def _headline():
    pods = workloads.build_pods(
        rng=np.random.default_rng(workloads.HEADLINE_SEED),
        **workloads.HEADLINE)
    prob = tensorize(pods, generate_catalog(workloads.HEADLINE_TYPES),
                     [NodePool()])
    tprob = convert.problem_from_arrays(prob)
    a, u, c = workloads.existing_nodes(
        tprob, workloads.HEADLINE_EXISTING,
        np.random.default_rng(workloads.EXISTING_SEED))
    return prob, tprob, dict(existing_alloc=a, existing_used=u,
                             existing_compat=c)


def _assert_golden(got, gold, psum):
    assert got[0] == gold[0]
    if psum:
        assert got[1] == pytest.approx(gold[1], rel=RTOL, abs=0)
    else:
        assert got[1] == gold[1]


@pytest.mark.parametrize("mesh", ["pods", "hosts"])
def test_reference_produces_the_headline_sharded_golden(mesh):
    prob, tprob, ex = _headline()
    m = ref_mesh(8) if mesh == "pods" else ref_mesh(4, 2)
    gold = workloads.GOLDEN_SHARDED["headline-sharded"]
    K = workloads.HEADLINE_SHARDED_K
    for decode in (False, True):
        res = ref_solve_sharded(prob, m, max_nodes_per_shard=K,
                                decode=decode, **(ex if decode else {}))
        got = workloads.sharded_answer(prob, res)
        assert got[0] == gold[(mesh, decode)][0]
        assert got[1] == gold[(mesh, decode)][1]


@pytest.mark.parametrize("mesh", ["pods", "hosts"])
def test_port_reproduces_the_headline_sharded_golden(mesh):
    _, tprob, ex = _headline()
    m = port_mesh(8) if mesh == "pods" else port_mesh(4, 2)
    gold = workloads.GOLDEN_SHARDED["headline-sharded"]
    K = workloads.HEADLINE_SHARDED_K
    for decode in (False, True):
        res = port_sh.solve_sharded(tprob, m, max_nodes_per_shard=K,
                                    decode=decode, **(ex if decode else {}))
        _assert_golden(workloads.sharded_answer(tprob, res),
                       gold[(mesh, decode)], psum=not decode)
