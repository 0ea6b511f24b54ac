"""`chip_smoke.py` phase 17(d)'s two fault checks and phase 18(c)-(d)'s
fence and restart checks, run on the CPU.

Each drives a small operator (`chip_smoke.small_operator`) on the port to
the tick under test and arms a KernelError on the next launch of K1 or K7
(on the CPU the patched wrapper raises before its plain version runs):

  * `headroom_fault`: a Forecast operator whose demand ramps, then a tick
    in which only the HeadroomController reconciles; the error must leave
    `tick()` through its dry-run solve (`_within_budget`), with one more
    reconcile counted and nothing else booked;
  * `preemption_fault`: a GangScheduling operator whose gang was rejected
    and whose victims the disruption tick evicted; the error must leave
    `tick()` through the provisioner's re-solve, with the cluster, the gang
    registry and the plan queue as they were;
  * `restart_fault`: a WarmRestart operator's final snapshot holds four
    pods pending; the error, armed in the restored successor's first
    solve, must leave `tick()` through `Provisioner.solve` with no
    snapshot written for that tick (the file keeps its bytes) and nothing
    booked, and the next tick solves and writes.

`fence_refusals` deposes an HAFailover operator's elector by a rival's
acquisition: its tick is skipped, and its snapshot write, launch and
terminate are refused (StaleFenceError for the last two) with nothing
written, launched or deleted and each refusal counted once.

A failed check calls `sys.exit(1)`, which fails the test.  No JAX.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("check", ["headroom_fault", "preemption_fault",
                                   "restart_fault"])
def test_a_kernel_error_leaves_the_tick_with_nothing_booked(check):
    getattr(chip_smoke, check)(torch, "cpu", device="cpu")


def test_a_deposed_replica_is_refused_every_write():
    chip_smoke.fence_refusals(torch, "cpu", device="cpu")
