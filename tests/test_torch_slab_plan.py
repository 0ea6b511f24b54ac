"""K6's row-block plan (ops/classpack_kernels.py `slab_plan`), a plain host
function, on the CPU, and the stable order its cut gives.

The plan decides, from the slab's shape and two device attributes, how
each shard's rows are cut into row blocks (one histogram row each) and how
many warps a scatter block has (one table of K + 1 counts each).  The card
here is an H100 SXM: 132 SMs and 227 KB (232 448 bytes) of shared memory a
block can opt into.  `_cut_order` repeats the three launches' arithmetic
with numpy over the plan's blocks and warps (each warp's rows in order, its
first position per key from the key's total before it, the earlier blocks'
and the earlier warps' counts), so the cut is held against the reference's
stable sort without a card."""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.ops import classpack_kernels as ck

SMS = 132
OPTIN = 232_448

# name -> (n rows per shard, K, shards)
ENVELOPES = {
    "live round 2": (32_768, 2048, 1),
    "noguide": (53_248, 2048, 1),
    "megafleet row 17": (131_072, 4096, 8),
    "above the guard": (300_000, 8192, 1),
    "above the guard, 2 shards": (300_000, 8192, 2),
    "headline K": (53_248, 8192, 1),
    "K3's widest slots": (4096, 32_768, 1),
    "fewer rows than keys": (100, 4096, 8),
    "one row": (1, 1, 1),
    "more shards than SMs": (5000, 64, 300),
    "odd": (1061, 256, 3),
}


def _check(plan, n, K, n_sh, sms, smem):
    keys = K + 1
    tiles = -(-keys // ck.SLAB_TILE)
    assert plan.blocks >= 1 and plan.seg >= 1
    assert plan.blocks * plan.seg >= n > (plan.blocks - 1) * plan.seg
    assert 1 <= plan.warps <= ck.SLAB_WARPS
    assert (plan.warps * keys + tiles) * 4 <= smem and keys * 4 <= smem
    # about one block per SM over all shards, each of about K + 1 rows or
    # more (the rows evened out over the blocks)
    assert plan.blocks <= max(1, sms // n_sh)
    assert plan.blocks == 1 or 2 * plan.seg > keys


@pytest.mark.parametrize("name", sorted(ENVELOPES))
def test_slab_plan_envelopes(name):
    n, K, n_sh = ENVELOPES[name]
    plan = ck.slab_plan(n, K, n_sh, SMS, OPTIN)
    assert plan is not None
    _check(plan, n, K, n_sh, SMS, OPTIN)


def test_slab_plan_main_paths():
    """The cuts of the main paths' slabs: a block per SM over the 8 shards
    of the megafleet (16 each), 2048-row blocks at K = 2048."""
    assert ck.slab_plan(131_072, 4096, 8, SMS, OPTIN) == ck.SlabPlan(
        blocks=16, seg=8192, warps=8)
    assert ck.slab_plan(32_768, 2048, 1, SMS, OPTIN) == ck.SlabPlan(
        blocks=16, seg=2048, warps=8)
    assert ck.slab_plan(300_000, 8192, 1, SMS, OPTIN).warps == 7


def test_slab_plan_refuses_past_the_shared_memory():
    assert ck.slab_plan(1000, 58_111, 1, SMS, OPTIN) is None
    assert ck.slab_plan(1000, 32_768, 1, SMS, OPTIN).warps == 1
    for bad in ((0, 16, 1), (16, 0, 1), (16, 16, 0)):
        assert ck.slab_plan(*bad, SMS, OPTIN) is None
    assert ck.slab_plan(16, 16, 1, 0, OPTIN) is None


def test_slab_plan_over_a_grid():
    rng = np.random.default_rng(0)
    for _ in range(400):
        n = int(rng.integers(1, 400_000))
        K = int(rng.integers(1, 40_000))
        n_sh = int(rng.integers(1, 16))
        sms = int(rng.integers(1, 200))
        smem = int(rng.choice([49_152, 101_376, 232_448]))
        plan = ck.slab_plan(n, K, n_sh, sms, smem)
        if (K + 1) * 4 + 4 * -(-(K + 1) // ck.SLAB_TILE) > smem:
            assert plan is None
        else:
            _check(plan, n, K, n_sh, sms, smem)


def _cut_order(a, K, plan):
    """The kernels' order of one shard's slots under `plan`, with numpy."""
    keys = K + 1
    key = np.where(a >= 0, a, K).astype(np.int64)
    n = len(key)
    blocks = [key[b * plan.seg:(b + 1) * plan.seg]
              for b in range(plan.blocks)]
    hist = np.stack([np.bincount(b, minlength=keys) for b in blocks])
    first = np.concatenate([[0], np.cumsum(hist.sum(0))[:-1]])
    before = np.cumsum(hist, axis=0) - hist
    order = np.full(n, -1, np.int64)
    sub = -(-plan.seg // plan.warps)
    for b, rows in enumerate(blocks):
        run = first + before[b]
        for w in range(plan.warps):
            mine = rows[w * sub:(w + 1) * sub]
            for j, k in enumerate(mine):
                order[run[k]] = b * plan.seg + w * sub + j
                run[k] += 1
    return order, hist.sum(0)[:K]


@pytest.mark.parametrize("n,K,sms,smem", [
    (1061, 256, SMS, OPTIN), (5000, 64, 7, 49_152), (9000, 700, 3, 12_000),
    (300, 4096, SMS, OPTIN), (20_000, 1000, 2, OPTIN)])
def test_the_cut_gives_the_reference_order(n, K, sms, smem):
    rng = np.random.default_rng(n + K)
    # K3-shaped: each class's pods in rising slots, then its unplaced rows
    runs = [np.sort(rng.integers(-1, K, size=int(s)))
            for s in rng.multinomial(n, np.ones(9) / 9)]
    a = np.concatenate([np.concatenate([r[r >= 0], r[r < 0]]) for r in runs])
    a = np.where(rng.random(n) < 0.5, a, rng.integers(-1, K, size=n))
    plan = ck.slab_plan(n, K, 1, sms, smem)
    assert plan.blocks > 1 or n <= K + 1
    order, counts = _cut_order(a, K, plan)
    want, want_counts = ck.classpack_slab_plain(
        torch.tensor(a.astype(np.int32)), K)
    np.testing.assert_array_equal(order, want.numpy())
    np.testing.assert_array_equal(counts, want_counts.numpy())
