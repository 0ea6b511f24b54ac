"""The port's lock-order recorder, enabled around a test module.

`tests/conftest.py` enables the JAX package's recorder for the session; the
port's components build their locks through the port's own `named_lock`
(`karpenter_tpu_torch/analysis/lockorder.py`), which that recorder never
sees.  A port test module that builds threaded components imports
`port_lock_order`: while the module runs, every port lock built is a
recording proxy, and at the module's end any lock-order inversion the
port's `RECORDER` observed fails it (a latent AB/BA deadlock).  Kill
switch: KARPENTER_TPU_LOCK_ORDER=0, as for the reference's recorder.
"""

import os

import pytest

from karpenter_tpu_torch.analysis.lockorder import RECORDER


def assert_no_inversions(recorder) -> None:
    bad = recorder.inversions()
    assert not bad, (
        "lock-order inversions observed in the port (potential "
        "deadlock):\n" + "\n".join(bad))


@pytest.fixture(scope="module", autouse=True)
def port_lock_order():
    if os.environ.get("KARPENTER_TPU_LOCK_ORDER", "1") == "0":
        yield None
        return
    prev = RECORDER.enabled
    RECORDER.reset()
    RECORDER.enabled = True
    try:
        yield RECORDER
    finally:
        RECORDER.enabled = prev
        assert_no_inversions(RECORDER)
