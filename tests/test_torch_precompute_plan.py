"""K1's tile plan and K4's cluster plan, and the arithmetic of both kernels,
on the CPU (no card, no JAX).

`precompute_plan` (ops/classpack_kernels.py) is a plain host function: from
K1's shape and the card's attributes it picks the classes a tile, the
options a CTA (threads × groups of 4 options a thread), the cluster of CTAs
that covers a class's options, and whether the CTA's alloc rows are staged
in shared memory.  It must cover every option and class exactly once, fill
the card's SMs at every main path's shape, and take every shape the
kernel took before (C ≥ 1, O ≥ 1, R ≤ 32, n ≤ 65535) up to the options one
cluster covers, on an H100 SXM (132 SMs, 232 448 bytes of shared memory a
block can opt into) and on a card that runs no cluster of more than one
CTA.  `aggregate_plan` does the same for K4's cluster over a shard's slots.

Numpy models repeat the kernels' steps and are held against the plain
versions: K1's divisions by a class's multipliers and its tiled best-rank
reduction (`precompute_tile_model`), K1's staging index map, and K4's
float32 cost in the kernel's order with its exact counts
(`aggregate_sum_model`)."""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.ops import classpack_kernels as ck
from torch_cases import (PRECOMPUTE_EDGE_SHAPES, PRECOMPUTE_PATH_SHAPES,
                         make_precompute_case, make_slot_case,
                         precompute_args)

SMS = 132
OPTIN = 232_448
REL_TOL = 1e-5
INT_MIN, INT_MAX = -2**31, 2**31 - 1


def _h100(cs, T, G, smem):
    # clusters of up to 8 CTAs everywhere; of 16 on fewer GPCs
    return 16 if cs <= 8 else 7


def _no_clusters(cs, T, G, smem):
    return 16 if cs == 1 else 0


def _agg_h100(cs, T, smem):
    return 16 if cs <= 8 else 7


def _agg_no_clusters(cs, T, smem):
    return 16 if cs == 1 else 0


def _check_plan(plan, C, O, R):
    assert plan is not None, (C, O, R)
    T, G, ot, cs = plan.threads, plan.groups, plan.options, plan.cluster
    assert T % 32 == 0 and T in ck.PRE_THREADS and G in ck.PRE_GROUPS
    assert ot == 4 * G * T
    assert 1 <= cs <= 16 and 1 <= plan.classes <= ck.PRE_MAX_CLASSES
    # every option in exactly one CTA of the cluster, none of them empty
    assert cs * ot >= O > (cs - 1) * ot
    # every class in exactly one tile, none of them empty
    tiles = plan.tiles(C)
    assert tiles * plan.classes >= C > (tiles - 1) * plan.classes
    assert plan.smem == ck.precompute_smem_bytes(R, ot, plan.stage,
                                                 plan.classes, T)
    assert plan.smem + ck.PRE_STATIC_SMEM <= OPTIN
    # each option belongs to one (CTA, thread, group, lane of the group)
    o = np.arange(O)
    cta, oi = o // ot, o % ot
    thread, group = (oi // 4) % T, (oi // 4) // T
    assert (group < G).all()
    key = ((cta * T + thread) * G + group) * 4 + oi % 4
    assert np.unique(key).size == O


SHAPES = {**PRECOMPUTE_PATH_SHAPES, **PRECOMPUTE_EDGE_SHAPES,
          "n65535": (65_535, 4, 512, 7), "R0": (1, 20, 512, 0),
          "O3600": (1, 256, 3600, 7), "O262144": (1, 4, 262_144, 7)}


@pytest.mark.parametrize("card", [_h100, _no_clusters])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_precompute_plan_covers_every_option_and_class_once(name, card):
    n, C, O, R = SHAPES[name]
    plan = ck.precompute_plan(C, O, R, n, SMS, OPTIN, card)
    if card is _no_clusters and O > 4 * 8 * 1024:
        assert plan is None     # one CTA covers at most 32 768 options
        return
    _check_plan(plan, C, O, R)
    if card is _no_clusters:
        assert plan.cluster == 1


@pytest.mark.parametrize("card", [_h100, _no_clusters])
@pytest.mark.parametrize("name", sorted(PRECOMPUTE_PATH_SHAPES))
def test_precompute_plan_fills_the_sms_on_every_path(name, card):
    """A CTA on nearly every SM (7/8 of them: the headline's 128 CTAs of
    1024 threads beat 256 on an H100) and PRE_MIN_WARPS warps an SM."""
    n, C, O, R = PRECOMPUTE_PATH_SHAPES[name]
    plan = ck.precompute_plan(C, O, R, n, SMS, OPTIN, card)
    _check_plan(plan, C, O, R)
    ctas = n * plan.tiles(C) * plan.cluster
    assert 8 * ctas >= 7 * SMS
    assert ctas * plan.threads >= 32 * ck.PRE_MIN_WARPS * SMS


@pytest.mark.parametrize("name,want", [
    # (cluster, threads, groups, classes a tile, staged)
    ("headline", (1, 1024, 1, 2, True)),
    ("live-round-2", (1, 1024, 2, 2, False)),
    ("consolidation-500", (1, 128, 1, 2, True)),
    ("megafleet-row-17", (1, 128, 1, 1, True)),
])
def test_precompute_plan_at_the_main_paths(name, want):
    n, C, O, R = PRECOMPUTE_PATH_SHAPES[name]
    plan = ck.precompute_plan(C, O, R, n, SMS, OPTIN, _h100)
    assert (plan.cluster, plan.threads, plan.groups, plan.classes,
            plan.stage) == want


@pytest.mark.parametrize("O,want", [(4097, 2), (65_536, 2), (100_000, 4),
                                    (262_144, 8), (524_288, 16)])
def test_precompute_plan_clusters_past_one_cta(O, want):
    """Past 32 768 options (1024 threads x 8 groups of 4) a class's options
    span a cluster; below, one CTA covers them (4097: 1024 threads x 2
    groups)."""
    plan = ck.precompute_plan(4, O, 7, 1, SMS, OPTIN, _h100)
    _check_plan(plan, 4, O, 7)
    assert plan.cluster == (1 if O <= 32_768 else want)


def test_precompute_plan_reads_the_catalog_once_a_tile():
    """The headline's catalog reads: every CTA reads its options' rows once
    for all the classes of its tile, so a launch reads the catalog
    ceil(C / classes) times, where one block per class read it C times."""
    n, C, O, R = PRECOMPUTE_PATH_SHAPES["headline"]
    plan = ck.precompute_plan(C, O, R, n, SMS, OPTIN, _h100)
    row = R * 4 + 8                                  # alloc, price, rank
    old, new = C * O * row, plan.tiles(C) * O * row
    assert (old, new) == (37_748_736, 18_874_368)    # 36 MiB -> 18 MiB


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_precompute_plan_stages_what_fits(name):
    n, C, O, R = SHAPES[name]
    plan = ck.precompute_plan(C, O, R, n, SMS, OPTIN, _h100)
    fits = ck.precompute_smem_bytes(R, plan.options, True, plan.classes,
                                    plan.threads) + ck.PRE_STATIC_SMEM <= OPTIN
    assert plan.stage == (fits and R > 0)
    if not plan.stage:
        assert plan.smem == plan.classes * plan.threads * 4


def test_precompute_plan_refuses_past_the_kernel():
    for C, O, R, n in ((0, 512, 7, 1), (8, 0, 7, 1), (8, 512, 33, 1),
                       (8, 512, 7, 0), (8, 512, 7, 65_536),
                       (8, 16 * 4 * 8 * 1024 + 1, 7, 1)):
        assert ck.precompute_plan(C, O, R, n, SMS, OPTIN, _h100) is None
    assert ck.precompute_plan(8, 32_769, 7, 1, SMS, OPTIN,
                              _no_clusters) is None
    # a card that schedules no cluster at all
    assert ck.precompute_plan(8, 512, 7, 1, SMS, OPTIN,
                              lambda *a: 0) is None


# ---- the arithmetic ----

DIVISORS = (1, 2, 3, 7, 100, 1000, 4096, 2**16 + 1, 2**30 - 1, 2**30,
            2**30 + 1, 2**31 - 1)


@pytest.mark.parametrize("q", DIVISORS)
def test_floordiv_magic_np_floors_every_numerator(q):
    rng = np.random.default_rng(q % 1000)
    a = np.concatenate([
        rng.integers(INT_MIN, INT_MAX, 20_000, dtype=np.int64),
        np.array([INT_MIN, INT_MIN + 1, -q - 1, -q, -q + 1, -1, 0, 1,
                  q - 1, q, q + 1, INT_MAX - 1, INT_MAX], np.int64)])
    a = a[(a >= INT_MIN) & (a <= INT_MAX)]
    np.testing.assert_array_equal(ck.floordiv_magic_np(a, q),
                                  np.floor_divide(a, q))


MODEL_SHAPES = {
    "C1": (1, 512, 7), "O1": (20, 1, 7), "O7": (20, 7, 7),
    "O100": (40, 100, 5), "O600": (24, 600, 7), "O4097": (12, 4097, 7),
    "R32": (16, 512, 32), "R0": (6, 512, 0),
}


@pytest.mark.parametrize("trap", [None, "all_inf"])
@pytest.mark.parametrize("card", [_h100, _no_clusters])
@pytest.mark.parametrize("name", sorted(MODEL_SHAPES))
def test_tile_model_matches_plain(name, card, trap):
    """The tiled best-rank reduction (threads, redux.sync warps, the CTA,
    the cluster's CTAs) and the divisions by multipliers give the plain
    version's m and ok, bit for bit, under the plan at that shape; with
    with_ok=False the same m and no ok."""
    C, O, R = MODEL_SHAPES[name]
    c = make_precompute_case(C * 31 + O, n=1, C=C, O=O, R=R, trap=trap)
    args = precompute_args(c, shard=0)
    plan = ck.precompute_plan(C, O, R, 1, SMS, OPTIN, card)
    want_m, want_ok = ck.classpack_precompute_plain(*args)
    got_m, got_ok = ck.precompute_tile_model(*[a.numpy() for a in args],
                                             plan)
    np.testing.assert_array_equal(got_m, want_m.numpy())
    np.testing.assert_array_equal(got_ok, want_ok.numpy())
    m_only, none = ck.precompute_tile_model(*[a.numpy() for a in args], plan,
                                            with_ok=False)
    assert none is None
    np.testing.assert_array_equal(m_only, want_m.numpy())
    if trap == "all_inf":
        assert not got_ok.any()


def test_model_cases_hold_the_traps():
    """The seeded inputs reach every trap the tests name."""
    c = make_precompute_case(5, n=2, C=64, O=600, R=7)
    req, alloc = c["req"], c["alloc"]
    assert (req == 1).any() and (req <= 0).any() and (req >= 2**30 - 2).any()
    assert (c["cap"] == 0).any() and (c["cap"] == 1).any()
    assert (alloc < 0).any() and (alloc == INT_MIN).any() \
        and (alloc == INT_MAX).any()
    assert np.isinf(c["price"]).any() and np.isnan(c["price"]).any()
    m, ok = ck.classpack_precompute_plain(*precompute_args(c, shard=0))
    assert (~ok.bool().any(1)).any() and ok.bool().any(1).any()
    assert (m == 0).any() and (m < 0).any()


@pytest.mark.parametrize("shard", [0, 1])
def test_with_ok_false_returns_the_same_m(shard):
    c = make_precompute_case(11, n=2, C=48, O=600, R=7)
    args = precompute_args(c, shard=shard)
    m, ok = ck.classpack_precompute(*args)
    m2, none = ck.classpack_precompute(*args, with_ok=False)
    assert none is None and ok is not None
    assert torch.equal(m, m2)
    m3, none = ck.classpack_precompute_plain(*args, with_ok=False)
    assert none is None and torch.equal(m, m3)


# ---- K4: the cluster plan and the cost's order ----

AGG_SHAPES = [(K, O, n) for K in (0, 1, 37, 2048, 2049, 4096, 8192, 32_768)
              for O in (1, 512, 4096, 8192) for n in (1, 8)]


@pytest.mark.parametrize("card", [_agg_h100, _agg_no_clusters])
def test_aggregate_plan_splits_every_slot_once(card):
    for K, O, n in AGG_SHAPES:
        plan = ck.aggregate_plan(K, O, n, OPTIN, card)
        assert plan is not None, (K, O, n)
        cs, per = plan.cluster, plan.per_cta
        assert cs in (1, 2, 4, 8, 16) and plan.threads % 32 == 0
        assert per >= 1 and cs * per >= K
        assert K == 0 or (cs - 1) * per < K         # no CTA without a slot
        assert plan.smem == 4 * O and plan.smem + ck.AGG_STATIC_SMEM <= OPTIN
        # a shard's cluster never depends on the shard count: a
        # shard-batched launch sums as the shard's single launch does
        assert plan == ck.aggregate_plan(K, O, 1, OPTIN, card)
        if card is _agg_no_clusters:
            assert cs == 1


@pytest.mark.parametrize("K,O,want", [
    (8192, 4096, 1),           # the headline's aggregate: one CTA
    (4096, 512, 1),            # the megafleet's row 15, each shard
    (32_768, 8192, 4),         # K3's widest slots: 4 CTAs of 8192
    (16_384, 512, 2),
    (2, 16_384, 2),            # more bins than a CTA's span, but no CTA
    (1, 16_384, 1),            # without a slot
    (1, 1, 1),
    (0, 512, 1),
])
def test_aggregate_plan_cluster_by_span(K, O, want):
    for n in (1, 8):
        assert ck.aggregate_plan(K, O, n, OPTIN, _agg_h100).cluster == want
        assert ck.aggregate_plan(K, O, n, OPTIN,
                                 _agg_no_clusters).cluster == 1


def test_aggregate_plan_refuses_past_the_kernel():
    assert ck.aggregate_plan(8192, 0, 1, OPTIN, _agg_h100) is None
    assert ck.aggregate_plan(8192, 512, 0, OPTIN, _agg_h100) is None
    assert ck.aggregate_plan(8192, 512, 65_536, OPTIN, _agg_h100) is None
    # a histogram wider than a CTA's shared memory
    assert ck.aggregate_plan(8192, OPTIN // 4, 1, OPTIN, _agg_h100) is None
    # a card that schedules no cluster at all
    assert ck.aggregate_plan(8192, 512, 1, OPTIN, lambda *a: 0) is None


@pytest.mark.parametrize("kind", ["runs", "hot", "closed", "all_inf"])
@pytest.mark.parametrize("K,O", [(1, 1), (37, 512), (8192, 4096),
                                 (32_768, 1), (32_768, 8192)])
@pytest.mark.parametrize("card", [_agg_h100, _agg_no_clusters])
def test_aggregate_sum_model_matches_plain(K, O, kind, card):
    """The kernel's summation order gives a cost within REL_TOL of the plain
    version's (prices over six decades) and exact counts; the same inputs
    give the same bits twice."""
    s = make_slot_case(K * 7 + O, n=1, K=K, O=O, kind=kind)
    plan = ck.aggregate_plan(K, O, 1, OPTIN, card)
    so, price = s["slot_option"][0], s["price"]
    cost, counts = ck.aggregate_sum_model(so, price, plan)
    again, _ = ck.aggregate_sum_model(so, price, plan)
    assert cost.dtype == np.float32 and cost.tobytes() == again.tobytes()
    want = ck.classpack_aggregate_plain(
        torch.tensor(so), torch.tensor(price),
        torch.tensor(s["n_open"][0]), torch.tensor(s["n_unsched"][0]))
    np.testing.assert_array_equal(counts.astype(np.float32),
                                  want[3:].numpy())
    w = float(want[0])
    assert cost == w or abs(float(cost) - w) <= REL_TOL * max(abs(w), 1e-30)
    if kind in ("closed", "all_inf"):
        assert cost == 0 and not counts.any()
    if kind == "hot" and np.isfinite(price[so[0]]):
        assert counts[so[0]] == K
