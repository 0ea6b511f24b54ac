"""The port's native C++ packer (karpenter_tpu_torch/native) against the scan
K7's plain version and the JAX package's native packer, on the CPU.

  * the cases of tests/test_native.py (seeded problems, an oracle total,
    existing nodes with and without their usage, nothing fits, a hostname
    cap, an inf-priced only fit, a score overflow, a NaN price, a catalog
    40% inf-priced): the port's `solve_ffd_native` plan equals the JAX
    package's native plan and the port's "jax" plan (K7's plain version)
    — node order, pod order, `used`, alternatives, existing fills,
    unschedulable, total by == — and, where tests/test_native.py asks,
    the greedy rung's;
  * the same cases and seeded scan inputs at the slot level: the port's
    `ffd_pack_native`, the JAX package's and `ffd_scan_plain` give the same
    assignment, slot options and float32 slot usage, bit for bit;
  * tests/test_native.py's plan assertions, on the port's native packer;
  * the loader: a hashed library under build/native reused by a second
    build, two processes building at once leaving one complete library,
    and `available()` False without a compiler;
  * the JAX package's library after a torn load (tests/torch_refnative.py):
    loaded again before each case, and a load error raised, never a skip,
    when it stays missing.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import cpu_pod, make_type, oracle_ffd
from karpenter_tpu import native as ref_native
from karpenter_tpu.api.objects import NodePool
from karpenter_tpu.ops.tensorize import tensorize
from karpenter_tpu_torch import convert, native, workloads
from karpenter_tpu_torch.ops import ffd as port_ffd
from karpenter_tpu_torch.ops import ffd_kernels as fk
from test_torch_ffd import _plan, _port_kw, _problem, _random_problem
from torch_cases import one_torch_thread  # noqa: F401
from torch_refnative import reference_native
from torch_refnative import reference_native_loaded  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case(name):
    """(reference Problem, solve kwargs) of tests/test_native.py's cases."""
    if name == "nothing_fits":
        return tensorize([cpu_pod(cpu_m=64000)],
                         [make_type("tiny", 1, 1, 0.05)], [NodePool()]), {}
    if name == "oracle":
        return _random_problem(7, n_pods=40), {}
    if name.startswith("inf_prices_"):
        seed = int(name[-1])
        prob = _random_problem(seed, n_pods=40)
        rng = np.random.default_rng(seed)
        prob.option_price[rng.random(prob.option_price.shape[0]) < 0.4] = \
            np.inf
        return prob, {}
    return _problem(name)


CASES = ["random_0", "random_1", "random_2", "random_3", "oracle",
         "existing_nodes", "nothing_fits", "node_cap", "inf_priced_only_fit",
         "score_overflow", "nan_price", "inf_prices_0", "inf_prices_1",
         "inf_prices_2", "inf_prices_3", "existing_default_usage"]
# the cases where tests/test_native.py also holds the greedy rung's plan
WITH_GREEDY = ["nan_price", "inf_prices_0", "inf_prices_1", "inf_prices_2",
               "inf_prices_3"]


@pytest.mark.parametrize("name", CASES)
def test_native_plan_equals_the_reference_native_and_the_scan(name):
    prob, kw = _case(name)
    want = ref_native.solve_ffd_native(prob, **kw)
    tprob = convert.problem_from_arrays(prob)
    pkw = _port_kw(kw)
    got = native.solve_ffd_native(tprob, **pkw)
    plan = _plan(tprob, got)
    assert plan == _plan(prob, want)
    assert plan == _plan(tprob, port_ffd.solve_ffd(
        tprob, backend="jax", device="cpu", **pkw))
    assert plan == _plan(tprob, port_ffd.solve_ffd(
        tprob, backend="native", **pkw))
    if name in WITH_GREEDY:
        assert plan == _plan(tprob, port_ffd.solve_ffd(
            tprob, backend="numpy", **pkw))


def _scan_arrays(low):
    return (low.req_p, np.packbits(low.ccomp, axis=1), low.crow_p, low.cid_p,
            low.valid, low.cap_p, low.rem_p, low.alloc_p, low.price_p,
            low.rank_p, low.init_option, low.init_used)


def _assert_slots_equal(arrays, K):
    """The port's native packer, the JAX package's and K7's plain version
    on one scan input: every output equal, slot usage bit for bit."""
    want = [t.numpy() for t in fk.ffd_scan_plain(
        *(torch.tensor(np.ascontiguousarray(a)) for a in arrays), K)]
    args = workloads.ffd_native_args(arrays, K)
    P = len(args["requests"])
    assert (want[0][P:] == -1).all()
    for got in (native.ffd_pack_native(**args),
                ref_native.ffd_pack_native(**args)):
        a, so, su, n = got
        np.testing.assert_array_equal(a, want[0][:P], err_msg="assignment")
        np.testing.assert_array_equal(so, want[1], err_msg="slot_option")
        np.testing.assert_array_equal(su.view(np.int32),
                                      want[2].view(np.int32),
                                      err_msg="slot_used bits")
        assert n == int(want[3])


@pytest.mark.parametrize("name", CASES)
def test_native_slots_equal_the_scan_bit_for_bit(name):
    prob, kw = _case(name)
    low = port_ffd.lower_ffd(convert.problem_from_arrays(prob),
                             **_port_kw(kw))
    _assert_slots_equal(_scan_arrays(low), low.K)


@pytest.mark.parametrize("seed,kw", [
    (0, dict(P=384, C=12, O=96, R=4)),
    (1, dict(P=384, C=12, O=96, R=4, E=16, K=256)),
    (2, dict(P=512, C=8, O=64, R=3, K=32)),       # slot exhaustion
    (3, dict(P=256, C=40, O=128, R=5, E=8, K=128)),
])
def test_native_slots_equal_the_scan_on_random_inputs(seed, kw):
    """Zero request axes, fractional usage, +inf / NaN / near-max prices,
    two pool ranks, hostname caps, existing slots, slot exhaustion."""
    _assert_slots_equal(*workloads.ffd_scan_inputs(
        np.random.default_rng(seed), **kw))


def test_plan_semantics_on_the_native_packer():
    """tests/test_native.py's assertions, on the port."""
    def solve(name):
        prob, kw = _case(name)
        return native.solve_ffd_native(convert.problem_from_arrays(prob),
                                       **_port_kw(kw))
    assert solve("nothing_fits").unschedulable == [0]
    res = solve("node_cap")
    assert not res.unschedulable and len(res.nodes) == 4
    assert all(len(n.pod_indices) == 1 for n in res.nodes)
    for name in ("inf_priced_only_fit", "nan_price"):
        res = solve(name)
        assert sorted(res.unschedulable) == [0]
        assert [n.option.instance_type for n in res.nodes] == ["a.small"]
    res = solve("score_overflow")
    assert not res.unschedulable
    assert [n.option.instance_type for n in res.nodes] == ["big", "big"]
    assert solve("existing_nodes").existing_assignments
    assert solve("existing_default_usage").existing_assignments
    for seed in range(4):
        assert np.isfinite(solve(f"inf_prices_{seed}").total_price)
    prob, _ = _case("oracle")
    new_nodes, unsched, total = oracle_ffd(prob)
    res = solve("oracle")
    assert sorted(res.unschedulable) == sorted(unsched)
    assert res.total_price == pytest.approx(total)
    assert len(res.nodes) == len(new_nodes)


# ---- the loader ----

def test_build_is_hashed_idempotent_and_tracks_flags(monkeypatch):
    first = native.build()
    assert first == native.build() == native.target()
    assert first.parent == native.BUILD_DIR
    assert first.name.startswith("ffd-") and first.suffix == ".so"
    assert native.available()
    monkeypatch.setattr(native, "CXX_FLAGS", [*native.CXX_FLAGS, "-g"])
    assert native.target() != first


def test_two_processes_building_at_once_leave_one_library(tmp_path):
    code = ("import sys; from pathlib import Path; "
            "import karpenter_tpu_torch.native as n; "
            "n.BUILD_DIR = Path(sys.argv[1]); print(n.build())")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=180)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[0] == outs[1]
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(outs[0])]


def test_unavailable_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "CXX", "no-such-compiler")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    with pytest.raises(native.NativeBuildError, match="not found"):
        native.build()
    assert not native.available()
    prob, _ = _case("random_0")
    with pytest.raises(RuntimeError, match="unavailable"):
        port_ffd.solve_ffd(convert.problem_from_arrays(prob),
                           backend="native")


# ---- the reference's library after a torn load ----

def test_reference_native_reloads_after_a_torn_load(monkeypatch):
    """A worker that loaded the JAX package's library while another worker
    was still writing it is left with `_lib = None`, `_build_failed =
    True`: `reference_native()` loads it again, and the slot comparison
    that failed in such a worker passes."""
    monkeypatch.setattr(ref_native, "_lib", None)
    monkeypatch.setattr(ref_native, "_build_failed", True)
    assert not ref_native.available()
    assert reference_native() is ref_native
    assert ref_native._lib is not None and not ref_native._build_failed
    assert ref_native.available()
    test_native_slots_equal_the_scan_bit_for_bit("existing_default_usage")


def test_reference_native_raises_the_load_error_at_its_deadline(
        monkeypatch, tmp_path):
    """A library that never loads is an error, not a skip."""
    bad = tmp_path / "_libffd.so"
    bad.write_bytes(b"not an ELF file")
    monkeypatch.setattr(ref_native, "_lib", None)
    monkeypatch.setattr(ref_native, "_build_failed", True)
    monkeypatch.setattr(ref_native, "_LIB", str(bad))
    monkeypatch.setattr(ref_native, "_SRC", str(bad))
    with pytest.raises(OSError, match="_libffd.so"):
        reference_native(deadline_s=0.5)
