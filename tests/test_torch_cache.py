"""tests/test_cache.py on both packages, case by case
(tests/torch_suites.py): the reference's assertions hold on the port, and
the values they compare are equal."""

import pytest

from torch_suites import Suite

SUITE = Suite("test_cache")


@pytest.mark.parametrize("case", SUITE.cases())
def test_cache(case, request):
    SUITE.both(case, request)
