"""The cell `sim-steady-state-drip-480` on the port, on the CPU: the port's
SimHarness (`device="cpu"`) replays scenarios/steady-state-drip.yaml as
tests/test_torch_sim_drip_golden.py replays it on the JAX package, and
must reproduce `workloads.GOLDEN_SIM_DRIP` byte for byte (the report's
sha256), with the cluster's arena (the IncrementalArena gate, on by
default) serving its gathers warm.  About two minutes on one CPU worker.
"""

import os

from torch_cases import clear_lp_caches, one_torch_thread  # noqa: F401
from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.sim import SimHarness, load_scenario

SCENARIOS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenarios")


def test_port_drip_cell_reproduces_golden_sim_drip():
    cell = workloads.SIM_DRIP
    clear_lp_caches()
    try:
        sc = load_scenario(os.path.join(SCENARIOS, cell["scenario"]))
        h = SimHarness(sc, seed=cell["seed"], duration_s=cell["duration_s"],
                       device="cpu")
        run = h.run()
    finally:
        clear_lp_caches()
    assert workloads.sim_digest(run.report) == workloads.GOLDEN_SIM_DRIP
    gathers = h.cluster.arena.gathers
    assert gathers["warm"] > 0 and gathers["fallback"] == 0
