"""simcheck — validate a simulator scenario file without running it.

The port of the JAX package's `tools/simcheck.py`: the same flags, the
same summary and exit codes, over `karpenter_tpu_torch.sim`.  It expands
the scenario on the host and launches nothing on the card.

Loads the YAML, runs the schema/semantic validation the harness would,
expands the event stream for a seed, and prints a summary: per-kind event
counts, total pods that will arrive, and the virtual time span.  Exit 0
means the scenario is runnable; exit 2 names the first problem.

    python -m karpenter_tpu_torch.tools.simcheck scenarios/diurnal.yaml [--seed N]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenario", help="scenario YAML file")
    ap.add_argument("--seed", type=int, default=0,
                    help="expansion seed (default 0)")
    args = ap.parse_args(argv)

    from ..sim import events as ev
    from ..sim.scenario import ScenarioError, expand, load_scenario
    try:
        sc = load_scenario(args.scenario)
        stream = expand(sc, args.seed)
    except ScenarioError as e:
        print(f"INVALID: {e}", file=sys.stderr)
        return 2

    by_kind = {}
    pods = 0
    for _, event in stream:
        by_kind[event.kind] = by_kind.get(event.kind, 0) + 1
        if isinstance(event, ev.PodArrival):
            pods += len(event.pods)
    span = sc.duration_s + sc.settle_s
    print(f"scenario: {sc.name}")
    print(f"valid: yes (seed {args.seed})")
    print(f"virtual span: {span:.0f}s "
          f"({span / 3600:.1f}h, settle {sc.settle_s:.0f}s)")
    print(f"events: {len(stream)}")
    for kind in sorted(by_kind):
        print(f"  {kind}: {by_kind[kind]}")
    print(f"pods arriving: {pods}")
    if sc.forecast is not None:
        fc = sc.forecast
        state = "on" if fc.enabled else "off"
        print(f"forecast: {state} ({fc.model}, horizon {fc.horizon_s:.0f}s, "
              f"lead {fc.lead_s:.0f}s, ttl {fc.ttl_s:.0f}s, "
              f"season {fc.season_s:.0f}s, z={fc.confidence:g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
