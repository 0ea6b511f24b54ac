"""Seeded kernel inputs for the port's kernel tests, shared by the CPU
parity tests (tests/test_torch_classpack.py) and the card tests
(tests/test_torch_cuda.py).  numpy and torch only: the card's machine runs
the latter without JAX."""

import numpy as np
import pytest
import torch

BIG = 2**30


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the CPU plain versions on one thread: the suite runs them beside
    timing-sensitive tests in other worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_case(seed, C=20, Cpad=64, O=40, Opad=512, R=5, E=0, K=256,
              trap=None):
    """Padded kernel inputs as the solve lowers them (numpy)."""
    rng = np.random.default_rng(seed)
    cols = O + E
    req = np.zeros((Cpad, R), np.int32)
    req[:C, 0] = rng.integers(100, 4000, C)
    req[:C, 1] = rng.integers(64, 8000, C)
    req[:C, 2] = 1                                     # the pods axis
    if R > 3:
        req[:C, 3] = np.where(rng.random(C) < 0.2, rng.integers(1, 3, C), 0)
    cnt = np.zeros(Cpad, np.int32)
    cnt[:C] = rng.integers(1, 40, C)
    cap = np.full(Cpad, BIG, np.int32)
    comp = np.zeros((Cpad, Opad), bool)
    comp[:C, :cols] = rng.random((C, cols)) < 0.7
    alloc = np.zeros((Opad, R), np.int32)
    alloc[:O, 0] = rng.choice([2000, 4000, 8000, 16000, 32000], O)
    alloc[:O, 1] = alloc[:O, 0] * rng.choice([2, 4, 8], O)
    alloc[:O, 2] = 110
    if R > 3:
        alloc[:O, 3] = np.where(rng.random(O) < 0.3, 4, 0)
    price = np.full(Opad, np.inf, np.float32)
    price[:O] = np.sort(rng.uniform(0.05, 5.0, O)).astype(np.float32)
    rank = np.full(Opad, BIG - 1, np.int32)
    rank[:cols] = 0
    iopt = iused = None
    if E:
        alloc[O:cols] = alloc[rng.integers(0, O, E)]
        iopt = np.full(K, -1, np.int32)
        iopt[:E] = np.arange(O, cols, dtype=np.int32)
        iused = np.zeros((K, R), np.int32)
        iused[:E] = (alloc[O:cols] * rng.uniform(0, 0.9, (E, R))).astype(np.int32)
        # overcommitted existing nodes: free < 0 needs floor division
        iused[:E:3, 0] = alloc[O:cols:3, 0] + rng.integers(1, 500, len(range(0, E, 3)))
    if trap == "overflow":
        # price × ceil(rem/m) overflows float32: scores clamp at SCORE_CAP
        # and tie, so the lowest (cheapest-sorted) index must win
        price[:O] = np.float32(3e38)
        price[0] = np.float32(1e38)
        req[:C, 0] = rng.integers(3000, 9000, C)
    elif trap == "nonfinite":
        price[rng.random(Opad) < 0.3] = np.inf
        price[:O][rng.random(O) < 0.1] = np.nan
    elif trap == "caps_ranks":
        cap[:C] = np.where(rng.random(C) < 0.5, rng.integers(1, 4, C), BIG)
        rank[:O] = np.where(rng.random(O) < 0.4, 1, 0)
        comp[:C, :O] &= (rng.random((C, O)) < 0.9)
    return dict(req=req, cnt=cnt, comp=comp, cap=cap, alloc=alloc,
                price=price, rank=rank, iopt=iopt, iused=iused, K=K,
                Ppad=int(cnt.sum()) + 37)


# few distinct shapes on purpose: each (K, R) pair costs the JAX side one
# compile of every program
CASES = {
    "plain": dict(),
    "existing": dict(E=12),
    "overflow": dict(trap="overflow"),
    "nonfinite_many_axes": dict(trap="nonfinite", E=6, R=9, O=100),
    "caps_ranks": dict(trap="caps_ranks"),
    "exhaustion": dict(K=16),
    "exhaustion_existing": dict(K=16, E=12),
    # C == Cpad, more pods than slots: the padded pod rows repeat a class
    # that has pods
    "full_classes": dict(C=64, Cpad=64),
}
