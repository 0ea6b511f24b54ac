"""tests/test_slo.py on both packages, case by case (tests/torch_suites.py):
the reference's assertions hold on the port, and the values they compare
are equal."""

import pytest

from torch_cases import one_torch_thread  # noqa: F401
from torch_suites import Suite, obs_disarmed  # noqa: F401

# Their compared values hold the `tick_duration` SLI's `bad`,
# `budget_remaining`, `burn`, `alerts` and `alerting`, which count the
# reconciles that took longer than 1 s of wall time (the reference's first
# reconcile in a process compiles its programs): their comparisons are
# recorded by outcome.  tests/test_torch_obs.py holds the rest of the gated
# report field by field.
# `test_gate_off_snapshot_has_no_obs_sections` compares the whole snapshot,
# whose `counters` section has no `fleet_ids` in the port (the counter the
# reference's fake cloud never draws, state/snapshot.py): recorded by
# outcome too.  tests/test_torch_snapshot.py compares the sections.
SUITE = Suite("test_slo", outcomes=(
    "test_spot_reclaim_storm_gate_on_budgets_and_ledger",
    "TestManagerWiring::test_chaos_restart_ledger_and_budgets_survive",
    "TestManagerWiring::test_gate_off_snapshot_has_no_obs_sections"))


@pytest.mark.parametrize("case", SUITE.cases())
def test_slo(case, request):
    SUITE.both(case, request)
