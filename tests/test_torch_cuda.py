"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here is marked `cuda` and skips without a card: a CUDA kernel
has no CPU mode.  The file imports neither JAX nor the JAX package, so it
runs on the card's machine as it is:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Integer outputs must be equal; the aggregate's float32 total_cost may differ
by relative 1e-5 (the kernel sums the launched prices in another order)."""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.api.objects import NodePool
from karpenter_tpu_torch.catalog.generate import generate_catalog
from karpenter_tpu_torch.ops import classpack as cp
from karpenter_tpu_torch.ops import classpack_kernels as ck
from karpenter_tpu_torch.ops.tensorize import tensorize
from torch_cases import CASES, make_case

REL_TOL = 1e-5


def _close(a, b):
    a, b = float(a), float(b)
    return a == b or abs(a - b) <= REL_TOL * max(abs(a), 1e-30)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _on(c, dev):
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    args = [t(a) for a in (c["req"], c["cnt"], np.packbits(c["comp"], axis=1),
                           c["cap"], c["alloc"], c["price"], c["rank"])]
    init = (None, None) if c["iopt"] is None else (t(c["iopt"]), t(c["iused"]))
    return args, init


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernels_match_plain(cuda_device, name):
    c = make_case(4, **CASES[name])
    (req, cnt, packed, cap, alloc, price, rank), (iopt, iused) = \
        _on(c, cuda_device)
    K = c["K"]
    ck.reset_launches()
    m, ok = ck.classpack_precompute(req, cap, packed, alloc, price, rank)
    m0, ok0 = ck.classpack_precompute_plain(req, cap, packed, alloc, price,
                                            rank)
    assert torch.equal(m, m0) and torch.equal(ok, ok0)
    for emit in (False, True):
        got = ck.classpack_scan(req, cnt, packed, cap, alloc, price, m, ok,
                                iopt, iused, K, emit)
        want = ck.classpack_scan_plain(req, cnt, packed, cap, alloc, price,
                                       m0, ok0, iopt, iused, K, emit)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    slot_option, _, n_open, n_unsched, takes = got
    a = ck.classpack_assign_decode(takes, cnt, c["Ppad"])
    assert torch.equal(a, ck.classpack_assign_decode_plain(takes, cnt,
                                                           c["Ppad"]))
    g = ck.classpack_aggregate(slot_option, price, n_open, n_unsched)
    w = ck.classpack_aggregate_plain(slot_option, price, n_open, n_unsched)
    assert torch.equal(g[1:], w[1:])
    assert _close(g[0], w[0])
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {"classpack_precompute": 1, "classpack_scan": 2,
                           "classpack_assign_decode": 1,
                           "classpack_aggregate": 1}


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_inputs(cuda_device):
    (req, cnt, packed, cap, alloc, price, rank), _ = \
        _on(make_case(0, **CASES["plain"]), cuda_device)
    with pytest.raises(TypeError):
        ck.classpack_precompute(req.to(torch.int64), cap, packed, alloc,
                                price, rank)
    with pytest.raises(ValueError):
        ck.classpack_precompute(req, cap, packed[:, :-1].contiguous(), alloc,
                                price, rank)
    with pytest.raises(ValueError):
        ck.classpack_precompute(req.t().contiguous().t(), cap, packed, alloc,
                                price, rank)
    with pytest.raises(ValueError):
        ck.classpack_precompute(req, cap.cpu(), packed, alloc, price, rank)


@pytest.mark.cuda
def test_cuda_solve_matches_cpu_and_the_goldens(cuda_device):
    """The headline solves on the card reproduce the golden digests (which
    the JAX package computes on the CPU, tests/test_torch_slice.py), and a
    small batch solves identically on the card and on the CPU."""
    pods = workloads.build_pods(
        rng=np.random.default_rng(workloads.HEADLINE_SEED),
        **workloads.HEADLINE)
    prob = tensorize(pods, generate_catalog(workloads.HEADLINE_TYPES),
                     [NodePool()])
    a, u, cm = workloads.existing_nodes(
        prob, workloads.HEADLINE_EXISTING,
        np.random.default_rng(workloads.EXISTING_SEED))
    ex = dict(existing_alloc=a, existing_used=u, existing_compat=cm)
    for n_existing, kw in ((0, {}), (workloads.HEADLINE_EXISTING, ex)):
        for decode in (True, False):
            got = cp.solve_classpack(prob, guide=None, decode=decode, **kw)
            gold, gold_total = workloads.GOLDEN[(n_existing, decode)]
            digest, total = workloads.plan_digest(prob, got, decode)
            assert digest == gold
            assert _close(total, gold_total)
    small = tensorize(workloads.build_pods(20, 700, np.random.default_rng(9),
                                           gpu_frac=0.1, zone_frac=0.3),
                      generate_catalog(60), [NodePool()])
    for decode in (True, False):
        on_card = cp.solve_classpack(small, guide=None, decode=decode)
        on_cpu = cp.solve_classpack(small, guide=None, decode=decode,
                                    device="cpu")
        assert workloads.plan_digest(small, on_card, decode)[0] == \
            workloads.plan_digest(small, on_cpu, decode)[0]
