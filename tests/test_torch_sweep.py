"""The consolidation sweep program and its host wrapper, against the JAX
package's.

`class_pack_sweep_kernel` is B masked aggregate solves in one call (the
JAX package vmaps `class_pack_aggregate_kernel`; the port runs K1 + K5, here
their plain versions on the CPU).  Both get the same seeded numpy inputs:
caps of inf, below every price and in between, rows with every column
masked and rows with zero counts, overcommitted existing slots, slot
exhaustion, and a row whose mask removes the best pool rank.  n_new and
n_unsched must be equal; the cost may differ by relative 1e-5 (float32 sums
in another order).

`solve_classpack_sweep` gets the same `Problem` (carried across with
`convert.problem_from_arrays`) and existing-node arrays in both packages;
its rows and its `device_calls` must agree, also where B forces the
reference's chunking into several calls."""

import numpy as np
import pytest
import torch

import bench
from karpenter_tpu.api.objects import NodePool
from karpenter_tpu.catalog.generate import generate_catalog
from karpenter_tpu.ops import classpack as ref_cp
from karpenter_tpu.ops.tensorize import tensorize
from karpenter_tpu_torch import convert, workloads
from karpenter_tpu_torch.ops import classpack as port_cp
from karpenter_tpu_torch.ops import classpack_kernels as ck
from torch_cases import (SWEEP_CASES, make_sweep_case, one_torch_thread,  # noqa: F401
                         sweep_args)

REL_TOL = 1e-5


def _assert_rows(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=REL_TOL, atol=0)


@pytest.mark.parametrize("name", sorted(SWEEP_CASES))
def test_sweep_program_matches_reference(name):
    s = make_sweep_case(3, **SWEEP_CASES[name])
    args = sweep_args(s)
    want = np.asarray(ref_cp.class_pack_sweep_kernel(*args, s["K"]))
    ck.reset_launches()
    got = port_cp.class_pack_sweep_kernel(
        *(torch.tensor(a) for a in args), s["K"]).numpy()
    _assert_rows(got, want)
    # the fixed probes: zero counts and an all-masked row place nothing
    assert got[1].tolist() == [0.0, 0.0, 0.0]
    assert got[2, 1] == 0 and got[2, 0] == 0
    # the CPU ran the plain versions: no kernel launched
    assert all(v == 0 for v in ck.LAUNCHES.values())


def test_sweep_rows_match_single_aggregate_solves():
    """Each sweep row is the aggregate solve of its own masked problem: the
    port's sweep against the port's K1 + K2 + K4 program, row by row."""
    s = make_sweep_case(5, **SWEEP_CASES["pool_ranks_existing"])
    t = [torch.tensor(a) for a in sweep_args(s)]
    req, counts, packed, cap, alloc, price, rank, mask, caps, iopt, iused = t
    rows = port_cp.class_pack_sweep_kernel(*t, s["K"])
    compat = ck.unpack_bits(packed, alloc.shape[0])
    for b in range(counts.shape[0]):
        pr = torch.where(mask[b] & (price < caps[b]), price, float("inf"))
        flat = port_cp.class_pack_aggregate_kernel(
            req, counts[b].contiguous(), compat & mask[b][None, :], cap,
            alloc, pr, rank, iopt, iused, s["K"])
        want = torch.stack([flat[0], flat[3:].sum(), flat[2]])
        assert rows[b, 1:].tolist() == want[1:].tolist(), b
        assert float(rows[b, 0]) == pytest.approx(float(want[0]), rel=REL_TOL)


def test_masking_the_best_pool_picks_the_next_rank():
    """Row 5 of the ranked case masks every rank-0 option: its launches come
    from rank 1 only, which a shared best-rank mask would get wrong."""
    s = make_sweep_case(3, **SWEEP_CASES["pool_ranks_existing"])
    t = [torch.tensor(a) for a in sweep_args(s)]
    rows = port_cp.class_pack_sweep_kernel(*t, s["K"])
    assert rows[5, 1] > 0 and rows[5, 2] < rows[0, 2] + s["counts"][5].sum()
    want = np.asarray(ref_cp.class_pack_sweep_kernel(*sweep_args(s), s["K"]))
    _assert_rows(rows.numpy(), want)


# ---- the host wrapper ----

@pytest.fixture(scope="module")
def sweep_problem():
    rng = np.random.default_rng(21)
    pods = bench.build_pods(24, 600, rng, gpu_frac=0.1, zone_frac=0.3,
                            taint_frac=0.2)
    prob = tensorize(pods, generate_catalog(40), [NodePool()])
    a, u, c = workloads.existing_nodes(prob, 30, rng)
    return prob, dict(existing_alloc=a, existing_used=u, existing_compat=c)


def _sweep_inputs(prob, B, seed, E):
    rng = np.random.default_rng(seed)
    counts = np.where(rng.random((B, prob.num_classes)) < 0.4,
                      rng.integers(0, 8, (B, prob.num_classes)), 0)
    mask = rng.random((B, E)) < 0.8
    fin = prob.option_price[np.isfinite(prob.option_price)]
    caps = np.where(rng.random(B) < 0.3, np.inf, rng.choice(fin, B))
    return counts.astype(np.int32), mask, caps.astype(np.float32)


@pytest.mark.parametrize("B,existing,capped", [
    (5, True, True),        # one call, bucket 8
    (40, False, True),      # bucket 128, no existing columns
    (600, True, False),     # more rows than the largest bucket: 2 calls
])
def test_solve_classpack_sweep_matches_reference(sweep_problem, B, existing,
                                                 capped):
    prob, ex = sweep_problem
    E = len(ex["existing_alloc"])
    counts, mask, caps = _sweep_inputs(prob, B, B, E)
    kw = dict(price_cap_b=caps if capped else None)
    if existing:
        kw.update(ex, exist_mask_b=mask)
    want = ref_cp.solve_classpack_sweep(prob, counts, **kw)
    tprob = convert.problem_from_arrays(prob)
    if existing:
        a, u, c = convert.slot_state_from_arrays(dict(
            alloc=ex["existing_alloc"], used=ex["existing_used"],
            compat=ex["existing_compat"]))
        kw.update(existing_alloc=a, existing_used=u, existing_compat=c)
    got = port_cp.solve_classpack_sweep(tprob, counts, device="cpu", **kw)
    assert got.device_calls == want.device_calls
    assert got.device_calls == (2 if B > 512 else 1)
    np.testing.assert_array_equal(got.new_nodes, want.new_nodes)
    np.testing.assert_array_equal(got.unschedulable, want.unschedulable)
    np.testing.assert_allclose(got.total_price, want.total_price,
                               rtol=REL_TOL, atol=0)
    assert (got.new_nodes > 0).any()
    if capped:
        assert (got.unschedulable > 0).any()


def test_sweep_with_no_columns_reports_every_pod_unschedulable():
    prob = tensorize(bench.build_pods(4, 20, np.random.default_rng(0)), [],
                     [NodePool()])
    counts = np.ones((3, prob.num_classes), np.int32)
    got = port_cp.solve_classpack_sweep(convert.problem_from_arrays(prob),
                                        counts, device="cpu")
    want = ref_cp.solve_classpack_sweep(prob, counts)
    assert got.device_calls == want.device_calls == 0
    np.testing.assert_array_equal(got.unschedulable, want.unschedulable)


def test_sweep_defaults_to_cuda_and_raises_without_it(monkeypatch,
                                                      sweep_problem):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob, _ = sweep_problem
    counts = np.ones((2, prob.num_classes), np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cp.solve_classpack_sweep(convert.problem_from_arrays(prob),
                                      counts)


# ---- K5's plan and its option choice, on the CPU ----

def _h100_blocks(T, S, smem):
    return max(0, min(2048 // T, (232_448 - 1024) // (smem + 4096)))


@pytest.mark.parametrize("R", [1, 2, 7, 32])
def test_sweep_plan_takes_every_shape_the_old_kernel_took(R):
    """Every (K <= kp_sweep_max_slots() = 8192, R <= 32) at any width and
    row count gets a layout; shared memory is used up to the opt-in
    budget, not the old 40 KB."""
    for K in (1, 2, 255, 256, 512, 1000, 1280, 2048, 4096, 8192):
        for O in (1, 100, 512, 2048, 8192, 32_768):
            for B in (1, 32, 128, 512):
                plan = ck.sweep_plan(K, R, O, B, 132, 232_448, _h100_blocks)
                assert plan is not None, (K, R, O, B)
                T, S = plan.threads, plan.slots_per_thread
                assert T == ck.SWEEP_THREADS and S * T >= K and S <= 32
                assert plan.smem == ck.sweep_smem_bytes(
                    T, S, R, O, plan.state_smem, plan.inv_smem, plan.stage)
                assert plan.smem + ck.SWEEP_STATIC_SMEM <= 232_448
                assert not plan.stage or O % 128 == 0
                state = S * T * (R + 1) * 4
                if state + 512 + ck.SWEEP_STATIC_SMEM <= 232_448:
                    assert plan.state_smem, (K, R, O, B)


def test_sweep_plan_at_the_consolidation_cell():
    # the first frontier (B = 32) and every prefix (B = 512), K = 512,
    # Opad 512; the replace face (B = 128, Opad 2048)
    for B, O in ((32, 512), (512, 512), (128, 2048)):
        plan = ck.sweep_plan(512, 7, O, B, 132, 232_448, _h100_blocks)
        assert (plan.threads, plan.state_smem, plan.inv_smem, plan.stage) \
            == (512, True, True, True)
    # past the old 40 KB budget (K = 2048, R = 5: 48 KB) the state stays in
    # shared memory now; K = 8192, R = 7 (256 KB) spills
    assert ck.sweep_plan(2048, 5, 512, 8, 132, 232_448,
                         _h100_blocks).state_smem
    assert not ck.sweep_plan(8192, 7, 512, 8, 132, 232_448,
                             _h100_blocks).state_smem
    assert ck.sweep_plan(8193, 7, 512, 8, 132, 232_448, _h100_blocks) is None


@pytest.mark.parametrize("K,O,want", [
    (512, 4096, (True, True, True)),
    (512, 3600, (True, True, False)),       # options not a multiple of 128
    (512, 32_768, (True, False, False)),    # invariants past the budget
    (8192, 4096, (False, True, True)),      # state past the budget
    (8192, 3600, (False, True, False)),
    (8192, 32_768, (False, False, False)),
])
def test_sweep_plan_reaches_each_layout_by_shape(K, O, want):
    """Each of K5's layouts is the plan's own pick at some shape (the card
    tests hold each against plain); unaligned rows are read in place."""
    plan = ck.sweep_plan(K, 7, O, 8, 132, 232_448, _h100_blocks)
    assert (plan.state_smem, plan.inv_smem, plan.stage) == want
    plan = ck.sweep_plan(K, 7, O, 8, 132, 232_448, _h100_blocks,
                         aligned=False)
    assert (plan.state_smem, plan.inv_smem, plan.stage) == want[:2] + (False,)


def _two_pass(rank, launchable, score):
    """The reference's rule (ops/classpack.py :343-353 through
    class_pack_aggregate_kernel): best rank among the launchable options
    (BIG when none), keep that rank, argmin of the kept scores."""
    BIG = 2**30
    rank = np.asarray(rank, np.int64)
    ok = np.asarray(launchable, bool)
    best = np.where(ok, rank, BIG).min()
    ok = ok & (rank == best)
    sc = np.where(ok, np.asarray(score, np.float32), np.float32(np.inf))
    j = int(np.argmin(sc))
    return j, bool(np.isfinite(sc[j]))


def _adversarial_choices(rng):
    O = 64
    yield np.zeros(O), np.zeros(O, bool), np.ones(O)          # none launchable
    yield np.zeros(O), np.ones(O, bool), np.full(O, 3.0)       # all tie
    r = np.zeros(O)
    r[::2] = 1
    yield r, np.ones(O, bool), np.arange(O, 0, -1.0)           # rank beats score
    s = np.full(O, 2.0)
    s[5], s[9] = -0.0, 0.0                                     # -0.0 == 0.0
    yield np.zeros(O), np.ones(O, bool), s
    r = np.full(O, 2**30 + 5)                                  # past BIG
    yield r, np.ones(O, bool), np.ones(O)
    r[7] = 2**30                                               # exactly BIG
    yield r, np.ones(O, bool), np.ones(O)
    r = np.full(O, 2**31 - 1)
    r[3] = 4
    yield r, np.ones(O, bool), np.ones(O)
    yield np.zeros(O), np.ones(O, bool), np.full(O, 3.38e38)   # SCORE_CAP ties
    for _ in range(40):
        r = rng.integers(0, 3, O)
        ok = rng.random(O) < rng.random()
        sc = rng.choice([1.0, 2.0, 3.5, np.float32(3.38e38)], O)
        yield r, ok, sc


def test_sweep_option_choice_is_one_lexicographic_minimum():
    """K5's single (rank, score, index) minimum against the two-pass rule
    of classpack_sweep_plain, on adversarial and seeded options."""
    rng = np.random.default_rng(17)
    for rank, ok, score in _adversarial_choices(rng):
        assert ck.sweep_choice_model(rank, ok, score) == \
            _two_pass(rank, ok, score)
