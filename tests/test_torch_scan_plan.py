"""K2's cluster plan and the arithmetic of its class step, on the CPU.

`scan_plan` (ops/classpack_kernels.py) is a plain host function: from the
scan's shape and the card's attributes it picks the cluster size, the
threads and slots a thread, and where the slot state and the staged class
inputs live.  It must take every (K, R) the scan took before (K up to
kp_max_slots() = 32 768, R up to 32), on an H100 SXM (132 SMs, 232 448
bytes of shared memory a block can opt into) and on a card that runs no
cluster of more than one CTA.

Two numpy models repeat the kernel's integer steps and are held against
the reference's formulas: the floor division by a class's invariant
request through a multiplier (`floordiv_magic_model`), over int32 edge
cases, and the greedy first-fit fill split over a cluster's CTAs
(`scan_fill_model`: each warp's prefix from the exchanged warp totals, the
uint32 prefix, the class's sum of takes) against `np.cumsum`, on seeded
fits and on fits whose sums wrap."""

import numpy as np
import pytest

from karpenter_tpu_torch.ops import classpack_kernels as ck

SMS = 132
OPTIN = 232_448
INT_MIN, INT_MAX = -2**31, 2**31 - 1

KS = (1, 2, 31, 32, 33, 255, 256, 1000, 1024, 1025, 2048, 4096, 5000, 8192,
      16_384, 32_767, 32_768)
OS = (1, 100, 512, 600, 3600, 4096, 8192, 32_768)


def _h100(cs, T, S, smem):
    # clusters of up to 8 CTAs everywhere; of 16 on fewer GPCs
    return 16 if cs <= 8 else 7


def _no_clusters(cs, T, S, smem):
    return 16 if cs == 1 else 0


def _check(plan, K, R, O):
    assert plan is not None, (K, R, O)
    cs, T, S = plan.cluster, plan.threads, plan.slots_per_thread
    assert cs in ck.SCAN_CLUSTERS
    assert T % 32 == 0 and ck.SCAN_MIN_THREADS <= T <= ck.SCAN_THREADS
    assert S in (1, 2, 4, 8, 16, 32)
    assert plan.per_cta * cs >= K and S * T >= plan.per_cta
    assert (plan.per_cta, S, T) == ck.scan_geometry(K, cs)
    assert plan.smem == ck.scan_smem_bytes(cs, T, S, R, O, plan.state_smem,
                                           plan.stage)
    assert plan.smem + ck.SCAN_STATIC_SMEM <= OPTIN
    assert not plan.stage or O % 128 == 0


@pytest.mark.parametrize("R", [1, 2, 7, 12, 32])
@pytest.mark.parametrize("card", [_h100, _no_clusters])
def test_scan_plan_takes_every_shape_the_old_kernel_took(R, card):
    for K in KS:
        for O in OS:
            for n in (1, 8):
                plan = ck.scan_plan(K, R, O, n, SMS, OPTIN, card)
                _check(plan, K, R, O)
                if card is _no_clusters:
                    assert plan.cluster == 1


@pytest.mark.parametrize("K,R,O,n,want", [
    # the headline (K = 8192, R = 7, Opad 4096): sixteen CTAs of 512 slots
    (8192, 7, 4096, 1, (16, True, True)),
    # live round 2 (K = 2048, Opad 8192): sixteen CTAs of 128 slots
    (2048, 7, 8192, 1, (16, True, True)),
    # the megafleet's 8 shards (K = 4096, R = 2, Opad 512): clusters of 16
    # would not all be resident (7 on this card), clusters of 8 are
    (4096, 2, 512, 8, (8, True, True)),
    # one shard of it: sixteen CTAs
    (4096, 2, 512, 1, (16, True, True)),
    # the consolidation accept's 1024 slots: eight CTAs of 128
    (1024, 7, 512, 1, (8, True, True)),
    # fewer slots than a preferred CTA holds: one CTA
    (37, 7, 4096, 1, (1, True, True)),
    # K3's widest slots at the headline's width: state in shared memory
    (32_768, 7, 4096, 1, (16, True, True)),
    # past every cluster's shared memory: the state spills to a global slice
    (32_768, 32, 4096, 1, (16, False, True)),
    # options not a multiple of 128: read in place
    (8192, 7, 3600, 1, (16, True, False)),
    # the widest option bucket (past 8192 options): no staging fits
    (1000, 7, 32_768, 1, (4, True, False)),
    # ... and with the state past every cluster's shared memory
    (32_768, 32, 32_768, 1, (16, False, False)),
    (32_768, 32, 3600, 1, (16, False, False)),
])
def test_scan_plan_prefers_shared_memory_and_large_clusters(K, R, O, n, want):
    plan = ck.scan_plan(K, R, O, n, SMS, OPTIN, _h100)
    _check(plan, K, R, O)
    assert (plan.cluster, plan.state_smem, plan.stage) == want


def test_scan_plan_spills_only_when_no_cluster_holds_the_state():
    for K in KS:
        for R in (7, 32):
            plan = ck.scan_plan(K, R, 4096, 1, SMS, OPTIN, _h100)
            if plan.state_smem:
                continue
            for cs in ck.SCAN_CLUSTERS:
                _, S, T = ck.scan_geometry(K, cs)
                need = ck.scan_smem_bytes(cs, T, S, R, 4096, True, False)
                assert need + ck.SCAN_STATIC_SMEM > OPTIN, (K, R, cs)


@pytest.mark.parametrize("cs,K", [(1, 64), (2, 256), (4, 512), (8, 1024),
                                  (16, 2048)])
def test_scan_plan_picks_each_cluster_size_by_shape(cs, K):
    """Each cluster size is the plan's own pick at some slot count (the card
    tests and chip_smoke.py reach every size this way), on both sides of
    the staging."""
    for O in (4096, 32_768):
        plan = ck.scan_plan(K, 7, O, 1, SMS, OPTIN, _h100)
        _check(plan, K, 7, O)
        assert (plan.cluster, plan.state_smem, plan.stage) == \
            (cs, True, O == 4096)
    # a card that runs no cluster of more than one CTA takes one CTA
    assert ck.scan_plan(K, 7, 4096, 1, SMS, OPTIN, _no_clusters).cluster == 1


def test_scan_plan_refuses_past_the_kernel():
    for K, R in ((0, 7), (32_769, 7), (8192, 0), (8192, 33)):
        assert ck.scan_plan(K, R, 4096, 1, SMS, OPTIN, _h100) is None
    # a card whose blocks opt into too little shared memory for any table
    assert ck.scan_plan(8192, 7, 4096, 1, SMS, 2048, _h100) is None


def test_scan_plan_unaligned_rows_are_read_in_place():
    plan = ck.scan_plan(8192, 7, 4096, 1, SMS, OPTIN, _h100, aligned=False)
    _check(plan, 8192, 7, 4096)
    assert not plan.stage


# ---- the floor division by an invariant divisor ----

DIVISORS = (1, 2, 3, 7, 100, 1000, 4096, 2**16 + 1, 2**30 - 1, 2**30,
            2**30 + 1, 2**31 - 1)


def _edges(q):
    base = {INT_MIN, INT_MIN + 1, -2**30, -1, 0, 1, 2**30, INT_MAX - 1,
            INT_MAX}
    for m in (-3, -2, -1, 1, 2, 3):
        for d in (-1, 0, 1):
            v = m * q + d
            if INT_MIN <= v <= INT_MAX:
                base.add(v)
    return sorted(base)


@pytest.mark.parametrize("q", DIVISORS)
def test_magic_division_equals_floor_divide_on_int32_edges(q):
    xs = _edges(q)
    want = np.floor_divide(np.array(xs, np.int64), q)
    got = [ck.floordiv_magic_model(x, q) for x in xs]
    np.testing.assert_array_equal(got, want)


def test_magic_division_equals_floor_divide_seeded():
    rng = np.random.default_rng(11)
    a = rng.integers(INT_MIN, INT_MAX, 4000, endpoint=True)
    q = np.concatenate([rng.integers(1, 2**31 - 1, 2000, endpoint=True),
                        rng.integers(1, 5000, 2000)])
    want = np.floor_divide(a, q)
    got = [ck.floordiv_magic_model(x, d) for x, d in zip(a, q)]
    np.testing.assert_array_equal(got, want)


def test_magic_multiplier_is_the_exact_ceiling():
    """The multiplier the kernels compute per class from float32 estimates
    (`magic_model`) is exactly ceil(2^(31+l) / q) for every small divisor
    and on both sides of every power of two up to 2^31 - 1."""
    qs = set(range(1, 5000))
    for e in range(1, 32):
        for d in (-2, -1, 0, 1, 2):
            if 1 <= (1 << e) + d <= 2**31 - 1:
                qs.add((1 << e) + d)
    for q in sorted(qs):
        m, shift = ck.magic_model(q)
        assert m == -(-(1 << shift) // q) and m < 2**32, q


# ---- the fill split over a cluster ----

def _reference_fill(fit, cnt):
    """The reference's step (ops/classpack.py :96-99) in int32: prefix =
    cumsum(fit) - fit, take = min(max(cnt - prefix, 0), fit), taken =
    sum(take), all wrapping."""
    fit = np.asarray(fit, np.int32)
    with np.errstate(over="ignore"):
        prefix = np.cumsum(fit, dtype=np.int32) - fit
        take = np.minimum(np.maximum(np.int32(cnt) - prefix, 0), fit)
        taken = take.sum(dtype=np.int32)
    return take, int(taken)


@pytest.mark.parametrize("K", [1, 37, 1024, 2048, 8192])
@pytest.mark.parametrize("cs", [1, 2, 4, 8])
def test_cluster_fill_equals_the_reference_seeded(K, cs):
    rng = np.random.default_rng(K * 31 + cs)
    per, S, T = ck.scan_geometry(K, cs)
    for _ in range(3):
        fit = np.where(rng.random(K) < 0.6, rng.integers(0, 40, K), 0)
        for cnt in (1, int(fit.sum()) // 2 + 1, int(fit.sum()),
                    int(fit.sum()) + 7):
            want = _reference_fill(fit, cnt)
            got = ck.scan_fill_model(fit, cnt, cs, T, S)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]


@pytest.mark.parametrize("cs", [1, 2, 8])
def test_cluster_fill_equals_the_reference_where_sums_wrap(cs):
    """Fits of 2^30 (a class with no positive request, uncapped): the
    prefix wraps in uint32, the takes' sum in int32; the model's second
    exchange must give the reference's numbers."""
    K = 64
    per, S, T = ck.scan_geometry(K, cs)
    rng = np.random.default_rng(5)
    cases = [np.full(K, 2**30), np.where(np.arange(K) % 3 == 0, 2**30, 5),
             rng.integers(2**29, 2**30, K, endpoint=True)]
    for fit in cases:
        for cnt in (1, 2**30 + 3, INT_MAX, INT_MAX - 2**30):
            want = _reference_fill(fit, cnt)
            got = ck.scan_fill_model(fit, cnt, cs, T, S)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
