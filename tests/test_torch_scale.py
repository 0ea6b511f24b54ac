"""tests/test_scale.py on both packages, case by case
(tests/torch_suites.py): the reference's assertions hold on the port, and
the values they compare are equal."""

import pytest

from torch_suites import Suite
from torch_refnative import reference_native_loaded  # noqa: F401

# two cases hold their wall time to the reference's budget
SUITE = Suite("test_scale",
              bounds=("test_node_dense_500", "test_full_loop_reference_scale"))


@pytest.mark.parametrize("case", SUITE.cases())
def test_scale(case, request):
    SUITE.both(case, request)
