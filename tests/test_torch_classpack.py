"""Each ported classpack kernel against the JAX program it replaces.

The same seeded numpy inputs go through the JAX package's jit'd programs
(on the CPU) and through the port's compositions of its kernel wrappers,
which on CPU tensors run the kernels' plain PyTorch versions:

  rows 1/3  class_pack_kernel[_packed]            (K1 precompute + K2 scan)
  rows 2/4/9 class_pack_aggregate_kernel[_packed|_fresh]   (+ K4 aggregate)
  rows 5/6  class_pack_assign_kernel[_fresh]      (+ K3 assign decode)

Integer outputs must be equal; the aggregate's float32 total_cost may differ
by relative 1e-5, because the two sum the launched prices in another order.
The cases cover the parity traps: negative free space (floor division),
float32 score overflow at SCORE_CAP, +inf / NaN (non-launchable) columns,
padded pod rows, slot exhaustion, hostname caps and pool-weight ranks
(tests/torch_cases.py builds them; tests/test_torch_cuda.py holds the same
cases against the CUDA kernels on a card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.ops import classpack as ref
from karpenter_tpu_torch.ops import classpack as port
from karpenter_tpu_torch.ops import classpack_kernels as ck
from torch_cases import CASES, make_case, one_torch_thread  # noqa: F401

REL_TOL = 1e-5


def _case(name, seed=0):
    return make_case(seed, **CASES[name])


def _jax_args(c, packed):
    comp = np.packbits(c["comp"], axis=1) if packed else c["comp"]
    return [jnp.asarray(a) for a in (c["req"], c["cnt"], comp, c["cap"],
                                     c["alloc"], c["price"], c["rank"])]


def _torch_args(c, packed, dev="cpu"):
    comp = np.packbits(c["comp"], axis=1) if packed else c["comp"]
    return [torch.tensor(a, device=dev) for a in (c["req"], c["cnt"], comp,
                                                  c["cap"], c["alloc"],
                                                  c["price"], c["rank"])]


def _jax_init(c):
    K, R = c["K"], c["req"].shape[1]
    if c["iopt"] is None:
        return jnp.full((K,), -1, jnp.int32), jnp.zeros((K, R), jnp.int32)
    return jnp.asarray(c["iopt"]), jnp.asarray(c["iused"])


def _torch_init(c, dev="cpu"):
    if c["iopt"] is None:
        return None, None
    return (torch.tensor(c["iopt"], device=dev),
            torch.tensor(c["iused"], device=dev))


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b.cpu() if hasattr(b, "cpu") else b)
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _close(a, b):
    """total_cost within REL_TOL (equal infinities included: the overflow
    case sums float32 prices near the maximum)."""
    a, b = float(a), float(b)
    return a == b or abs(a - b) <= REL_TOL * max(abs(a), 1e-30)


def _agg_eq(a, b):
    a, b = np.asarray(a), b.cpu().numpy()
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[1:], b[1:])
    assert _close(a[0], b[0])


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_pack_kernel_matches_jax(name, emit, packed):
    """Rows 1 and 3: the scan's full state after the last class."""
    c = _case(name)
    fn_r = ref.class_pack_kernel_packed if packed else ref.class_pack_kernel
    fn_p = port.class_pack_kernel_packed if packed else port.class_pack_kernel
    want = fn_r(*_jax_args(c, packed), *_jax_init(c), max_nodes=c["K"],
                emit_takes=emit)
    got = fn_p(*_torch_args(c, packed), *_torch_init(c), c["K"], emit)
    for w, g, what in zip(want, got, ("slot_option", "slot_used", "n_open",
                                      "n_unsched", "takes")):
        _eq(w, g, what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_aggregate_kernels_match_jax(name):
    """Rows 2, 4 and 9: [total_cost, n_open, n_unsched, nodes_per_option]."""
    c = _case(name, seed=1)
    K = c["K"]
    _agg_eq(ref.class_pack_aggregate_kernel(*_jax_args(c, False),
                                            *_jax_init(c), max_nodes=K),
            port.class_pack_aggregate_kernel(*_torch_args(c, False),
                                             *_torch_init(c), K))
    _agg_eq(ref.class_pack_aggregate_kernel_packed(*_jax_args(c, True),
                                                   *_jax_init(c), max_nodes=K),
            port.class_pack_aggregate_kernel_packed(*_torch_args(c, True),
                                                    *_torch_init(c), K))
    if c["iopt"] is None:
        _agg_eq(ref.class_pack_aggregate_kernel_fresh(*_jax_args(c, True),
                                                      max_nodes=K),
                port.class_pack_aggregate_kernel_fresh(*_torch_args(c, True),
                                                       K))


@pytest.mark.parametrize("name", sorted(CASES))
def test_assign_kernels_match_jax(name):
    """Rows 5 and 6: per-pod slot (int16 below 2^15 slots), slot→option and
    the unscheduled count; padded pod rows must come out −1."""
    c = _case(name, seed=2)
    K, Ppad = c["K"], c["Ppad"]
    if c["iopt"] is None:
        want = ref.class_pack_assign_kernel_fresh(
            *_jax_args(c, True), max_nodes=K, n_pods=Ppad)
        got = port.class_pack_assign_kernel_fresh(*_torch_args(c, True), K,
                                                  Ppad)
    else:
        want = ref.class_pack_assign_kernel(
            *_jax_args(c, True), *_jax_init(c), max_nodes=K, n_pods=Ppad)
        got = port.class_pack_assign_kernel(*_torch_args(c, True),
                                            *_torch_init(c), K, Ppad)
    assert got[0].dtype == torch.int16
    for w, g, what in zip(want, got, ("assignment", "slot_option",
                                      "n_unsched")):
        _eq(w, g, what)
    P = int(c["cnt"].sum())
    assert (got[0][P:] == -1).all()


def test_slot_exhaustion_counts_overflow_as_unscheduled():
    c = _case("exhaustion")
    _, _, n_open, n_unsched, takes = port.class_pack_kernel(
        *_torch_args(c, False), None, None, c["K"], True)
    assert int(n_open) == c["K"]
    assert int(n_unsched) > 0
    assert int(takes.sum()) + int(n_unsched) == int(c["cnt"].sum())


def test_overflow_case_keeps_the_viable_option():
    """All scores clamp to SCORE_CAP except option 0's: the scan must still
    open nodes (no pod becomes unschedulable through the overflow)."""
    c = _case("overflow")
    slot_option, _, n_open, n_unsched, _ = port.class_pack_kernel(
        *_torch_args(c, False), None, None, c["K"], False)
    assert int(n_open) > 0 and int(n_unsched) == 0


def test_repeat_classes_matches_jnp_repeat():
    for counts, n in (([2, 1, 0, 0], 6), ([0, 3, 0, 2], 5), ([4, 4], 6),
                      ([1, 0, 2], 9)):
        want = np.asarray(jnp.repeat(jnp.arange(len(counts)),
                                     jnp.asarray(counts),
                                     total_repeat_length=n))
        got = ck.repeat_classes(torch.tensor(counts, dtype=torch.int32), n)
        np.testing.assert_array_equal(want, got.numpy())


EDGES = ("every pod in one class", "empty classes", "all takes zero",
         "padding rows", "truncated repeat", "seeded")


def _row_local_decode(takes, counts, n_pods):
    """K3's design (csrc/classpack.cu assign_decode_kernel) in numpy: each
    class's pod rows from counts[<c], each pod's slot the first whose
    within-row inclusive scan exceeds its rank; the last class also takes
    the padded rows."""
    C, K = takes.shape
    out = np.full(n_pods, -7, np.int64)
    for c in range(C):
        incl = np.cumsum(takes[c].astype(np.int64))
        lo = int(counts[:c].astype(np.int64).sum())
        hi = n_pods if c == C - 1 else min(lo + int(counts[c]), n_pods)
        rk = np.arange(max(lo, 0), max(hi, lo)) - lo
        out[lo:hi] = np.where(rk < incl[-1],
                              np.searchsorted(incl, rk, side="right"), -1)
    assert (out != -7).all(), "a pod row was not written"
    return out


@pytest.mark.parametrize("K", [1, 7, 64])
@pytest.mark.parametrize("name", EDGES)
def test_row_local_decode_equals_the_global_scan(name, K):
    """The one-launch K3 decodes each class from its own row: on inputs K2
    could emit (takes >= 0, row totals <= counts) that equals the
    reference's global cumsum + searchsorted, which the plain version
    computes."""
    from karpenter_tpu_torch import workloads
    takes, counts, n_pods = workloads.assign_decode_edges(
        12, K, 240, np.random.default_rng(K))[name]
    want = ck.classpack_assign_decode_plain(torch.tensor(takes),
                                            torch.tensor(counts), n_pods)
    assert want.dtype == torch.int16
    np.testing.assert_array_equal(_row_local_decode(takes, counts, n_pods),
                                  want.numpy())


def test_pack_bits_round_trip_matches_numpy():
    rng = np.random.default_rng(3)
    for O in (8, 13, 512, 1000):
        m = rng.random((5, O)) < 0.5
        packed = ck.pack_bits(torch.tensor(m))
        np.testing.assert_array_equal(packed.numpy(), np.packbits(m, axis=1))
        np.testing.assert_array_equal(ck.unpack_bits(packed, O).numpy(), m)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    ck.reset_launches()
    c = _case("existing")
    port.class_pack_aggregate_kernel_packed(*_torch_args(c, True),
                                            *_torch_init(c), c["K"])
    port.class_pack_assign_kernel(*_torch_args(c, True), *_torch_init(c),
                                  c["K"], c["Ppad"])
    assert ck.LAUNCHES == {k: 0 for k in ck.KERNELS}


def test_mixed_devices_are_refused():
    t = torch.zeros(3, dtype=torch.int32)
    meta = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ck.classpack_aggregate(t, meta.float(), t[0], t[1])


@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("name", ["plain", "existing", "exhaustion_existing",
                                  "caps_ranks"])
def test_pack_kernel_with_empty_classes_between_matches_jax(name, emit):
    """Classes of count 0 (and one of a negative count) between non-empty
    ones, not only in the padded tail: the reference steps through them
    and they take nothing, open nothing and add no unscheduled pod, which
    is what lets the kernels skip them."""
    c = _case(name, seed=3)
    C = int((c["cnt"] > 0).sum())
    c["cnt"][:C:3] = 0
    c["cnt"][1] = -5
    want = ref.class_pack_kernel_packed(*_jax_args(c, True), *_jax_init(c),
                                        max_nodes=c["K"], emit_takes=emit)
    got = port.class_pack_kernel_packed(*_torch_args(c, True),
                                        *_torch_init(c), c["K"], emit)
    for w, g, what in zip(want, got, ("slot_option", "slot_used", "n_open",
                                      "n_unsched", "takes")):
        _eq(w, g, what)
    takes = np.asarray(want[4])
    assert not takes[c["cnt"] <= 0].any()
