"""CLI: replay a scenario through the virtual-clock simulator.

    python -m karpenter_tpu_torch.sim scenarios/diurnal.yaml --seed 0

Prints the deterministic report JSON to stdout (or --out); the wall-clock
speedup line goes to stderr so piping stdout stays byte-stable across
runs.  --log writes the append-only event log as JSON lines.  The
controllers solve on the card; `main(argv, device="cpu")` is how a test
runs the CLI on the CPU (the command line has no such flag).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from .harness import SimHarness
from .report import report_to_json
from .scenario import ScenarioError, load_scenario


def main(argv=None, device="cuda") -> int:
    p = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.sim",
        description="Deterministic virtual-clock cluster simulation")
    p.add_argument("scenario", help="scenario YAML file (see scenarios/)")
    p.add_argument("--seed", type=int, default=0,
                   help="expansion seed (default 0)")
    p.add_argument("--duration", type=float, default=None,
                   help="override scenario duration_s (virtual seconds)")
    p.add_argument("--out", default="",
                   help="write the report JSON here instead of stdout")
    p.add_argument("--log", default="",
                   help="write the event log (JSON lines) to this file")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="INFO-level controller logging")
    p.add_argument("--flight-recorder", action="store_true",
                   help="arm the incident flight recorder (FlightRecorder "
                        "gate): the report grows an `incidents` section")
    p.add_argument("--slo", action="store_true",
                   help="arm the SLO engine + cost ledger (SLOEngine "
                        "gate): the report grows `slo.budgets` and "
                        "`ledger` sections")
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.ERROR,
        format="%(levelname)s %(name)s %(message)s", stream=sys.stderr)

    try:
        scenario = load_scenario(args.scenario)
    except ScenarioError as e:
        print(f"scenario error: {e}", file=sys.stderr)
        return 2
    harness = SimHarness(scenario, seed=args.seed,
                         duration_s=args.duration,
                         flight_recorder=True if args.flight_recorder
                         else None,
                         slo=True if args.slo else None, device=device)
    run = harness.run()

    doc = report_to_json(run.report)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(doc)
    else:
        sys.stdout.write(doc)
    if args.log:
        with open(args.log, "w") as fh:
            for entry in run.log:
                fh.write(json.dumps(entry, sort_keys=True) + "\n")
    print(f"replayed {run.virtual_seconds:.0f} virtual seconds "
          f"({run.events_delivered} events) in {run.wall_seconds:.2f}s wall "
          f"— {run.speedup:.0f}x real time", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
