"""tests/test_launch_path.py on both packages, case by case
(tests/torch_suites.py): the reference's assertions hold on the port, and
the values they compare are equal."""

import pytest

from torch_suites import Suite
from torch_refnative import reference_native_loaded  # noqa: F401

SUITE = Suite("test_launch_path")


@pytest.mark.parametrize("case", SUITE.cases())
def test_launch_path(case, request):
    SUITE.both(case, request)
