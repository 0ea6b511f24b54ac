"""The JAX package's native packer, loaded for the port's parity tests.

`karpenter_tpu.native` compiles its library in place (`g++ -o _libffd.so`)
the first time a process asks for it, and a process that loads the file
while another process is still writing it marks the library unavailable
for the rest of its life (`_build_failed`).  Under xdist every worker asks
at once: tests/test_native.py calls `available()` at import, during
collection.  A worker that loses that race would hand the port's tests a
reference with no native packer: a `RuntimeError` from its native rung, or
a plan from the rung below.

`reference_native()` undoes such a torn load: under a file lock shared by
the workers it clears the module's failure flag and asks again, until the
library loads or the deadline passes, and then raises the last load
error.  It never skips.  The `reference_native_loaded` fixture calls it
before each case of a test module that imports it.
"""

from __future__ import annotations

import ctypes
import fcntl
import pathlib
import time

import pytest

LOCK = pathlib.Path(__file__).resolve().parents[1] / "build" / \
    "ref-native.lock"
DEADLINE_S = 120.0
PAUSE_S = 0.25


def reference_native(deadline_s: float = DEADLINE_S):
    """`karpenter_tpu.native` with its library loaded; raises the last
    load error when it is still missing after `deadline_s`."""
    from karpenter_tpu import native
    if native._lib is not None:
        return native
    LOCK.parent.mkdir(parents=True, exist_ok=True)
    end = time.monotonic() + deadline_s
    last: BaseException = OSError(f"{native._LIB} did not load")
    with open(LOCK, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            while native._lib is None:
                with native._lock:
                    native._build_failed = False
                if native._load() is not None:   # `available()`, unpatched
                    break
                try:                       # the loader logs, not raises
                    ctypes.CDLL(native._LIB)
                except OSError as e:
                    last = e
                if time.monotonic() >= end:
                    raise last
                time.sleep(PAUSE_S)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    return native


@pytest.fixture(autouse=True)
def reference_native_loaded():
    """The reference's native packer loaded before each case (active in a
    test module that imports it)."""
    reference_native()
