"""The cell `sim-long-soak-480` on the JAX package: its SimHarness replays
scenarios/long-soak.yaml at seed 0 for 480 virtual seconds (the firehose:
8 pods a second, a 100 ms consolidation cadence, 3408 pods and 287
launches), and the report's `workloads.sim_digest` must be
`workloads.GOLDEN_SIM_SOAK`, which the port reproduces on the CPU
(tests/test_torch_sim_soak_cell.py) and `chip_smoke.py` phase 15(b) on the
card.  About a minute on one CPU worker, so the cell's two halves are files
of their own.

    python tests/test_torch_sim_soak_golden.py    # print GOLDEN_SIM_SOAK
"""

import os
import sys

from torch_cases import clear_lp_caches
from karpenter_tpu.sim import SimHarness, load_scenario
from karpenter_tpu_torch import workloads

SCENARIOS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenarios")


def reference_soak():
    cell = workloads.SIM_SOAK
    clear_lp_caches("karpenter_tpu")
    try:
        sc = load_scenario(os.path.join(SCENARIOS, cell["scenario"]))
        run = SimHarness(sc, seed=cell["seed"],
                         duration_s=cell["duration_s"]).run()
    finally:
        clear_lp_caches("karpenter_tpu")
    return workloads.sim_digest(run.report)


def test_jax_package_soak_cell_produces_golden_sim_soak():
    assert reference_soak() == workloads.GOLDEN_SIM_SOAK


if __name__ == "__main__":
    print(repr(reference_soak()))
    sys.exit(0)
