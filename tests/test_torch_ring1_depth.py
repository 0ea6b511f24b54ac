"""tests/test_ring1_depth.py on both packages, case by case
(tests/torch_suites.py): the reference's assertions hold on the port, and
the values they compare are equal."""

import pytest

from torch_suites import Suite

SUITE = Suite("test_ring1_depth")


@pytest.mark.parametrize("case", SUITE.cases())
def test_ring1_depth(case, request):
    SUITE.both(case, request)
