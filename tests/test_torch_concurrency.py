"""tests/test_concurrency.py on both packages, case by case
(tests/torch_suites.py): the reference's assertions hold on the port, and
the values they compare are equal."""

import pytest

from torch_lockorder import port_lock_order  # noqa: F401
from torch_suites import Suite

# the seq numbers each thread reads depend on the threads' timing; the
# solver caches' sizes, on what the process solved before
SUITE = Suite("test_concurrency",
              outcomes=("TestCacheConcurrency::test_unavailable_offerings",),
              bounds=("TestSolverCaches::",))

# its metric and tracing cases are in tests/test_torch_metrics.py and
# test_torch_tracing.py
METRICS = ("test_counter_histogram_totals_exact",
           "test_ring_bounded_and_stacks_isolated_under_hammer",
           "test_cross_thread_attach_under_contention")


@pytest.mark.parametrize("case", SUITE.cases(exclude=METRICS))
def test_concurrency(case, request):
    SUITE.both(case, request)
