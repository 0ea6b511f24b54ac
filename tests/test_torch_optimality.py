"""tests/test_optimality.py on both packages, case by case
(tests/torch_suites.py): the reference's assertions hold on the port, and
the values they compare are equal — the plans' costs against the exact
optima, and the certified bounds (`class_lp_bound`, `dual_feasible_bound`,
`gg_bound`) of ops/lpbound.py and ops/ggbound.py beside them."""

import pytest

from torch_cases import one_torch_thread  # noqa: F401
from torch_suites import Suite

SUITE = Suite("test_optimality")


@pytest.mark.parametrize("case", SUITE.cases())
def test_optimality(case, request):
    SUITE.both(case, request)
