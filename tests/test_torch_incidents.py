"""tests/test_incidents.py on both packages, case by case
(tests/torch_suites.py): the reference's assertions hold on the port, and
the values they compare are equal."""

import pytest

from torch_cases import one_torch_thread  # noqa: F401
from torch_suites import Suite, obs_disarmed  # noqa: F401
from torch_refnative import reference_native_loaded  # noqa: F401

SUITE = Suite("test_incidents")


@pytest.mark.parametrize("case", SUITE.cases())
def test_incidents(case, request):
    SUITE.both(case, request)
