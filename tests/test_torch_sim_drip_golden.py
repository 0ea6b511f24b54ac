"""The cell `sim-steady-state-drip-480` on the JAX package: its SimHarness
replays scenarios/steady-state-drip.yaml at seed 0 for 480 virtual seconds
(a warm fleet of 40 pods, one short job every two minutes, a 100 ms
consolidation cadence whose sweeps start after the 300 s that
tests/golden/sim-steady-state-drip.json pins), and the report's
`workloads.sim_digest` must be `workloads.GOLDEN_SIM_DRIP`, which the port
reproduces on the CPU (tests/test_torch_sim_drip_cell.py) and
`chip_smoke.py` phase 15(b) on the card.  About 75 s on one CPU worker, so
the cell's two halves are files of their own.

    python tests/test_torch_sim_drip_golden.py    # print GOLDEN_SIM_DRIP
"""

import os
import sys

from torch_cases import clear_lp_caches
from torch_refnative import reference_native_loaded  # noqa: F401
from karpenter_tpu.sim import SimHarness, load_scenario
from karpenter_tpu_torch import workloads

SCENARIOS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenarios")


def reference_drip():
    cell = workloads.SIM_DRIP
    clear_lp_caches("karpenter_tpu")
    try:
        sc = load_scenario(os.path.join(SCENARIOS, cell["scenario"]))
        run = SimHarness(sc, seed=cell["seed"],
                         duration_s=cell["duration_s"]).run()
    finally:
        clear_lp_caches("karpenter_tpu")
    return workloads.sim_digest(run.report)


def test_jax_package_drip_cell_produces_golden_sim_drip():
    assert reference_drip() == workloads.GOLDEN_SIM_DRIP


if __name__ == "__main__":
    print(repr(reference_drip()))
    sys.exit(0)
