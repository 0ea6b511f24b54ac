"""graftlint — codebase-aware static analysis for karpenter_tpu_torch.

The port of the JAX package's `tools/graftlint.py`: the same flags, output
and exit codes, over `karpenter_tpu_torch/` with the port's checkers and
its own baseline.

Usage:
    python -m karpenter_tpu_torch.tools.graftlint                  # non-baselined findings
    python -m karpenter_tpu_torch.tools.graftlint --fix-hints      # + one-line remediation
    python -m karpenter_tpu_torch.tools.graftlint --all            # include grandfathered
    python -m karpenter_tpu_torch.tools.graftlint --family determinism
    python -m karpenter_tpu_torch.tools.graftlint --write-baseline # grandfather everything
    python -m karpenter_tpu_torch.tools.graftlint --json           # machine-readable
    python -m karpenter_tpu_torch.tools.graftlint --list-rules     # rule catalog + hints

Exit codes: 0 clean (stale baseline entries only warn), 1 new findings,
2 usage/config error.  tests/test_torch_graftlint.py runs it over the
whole package; see docs/static-analysis.md for the conventions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..analysis import (RULES, default_checkers, load_baseline, partition,
                        run_analysis, write_baseline)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

default_checkers()  # rules register at checker-module import time

PACKAGE = "karpenter_tpu_torch"
DEFAULT_BASELINE = os.path.join(PACKAGE, "tools", "graftlint-baseline.json")
FAMILIES = ("torch-hotpath", "determinism", "lock-discipline",
            "observability")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m karpenter_tpu_torch.tools."
                                      "graftlint", description=__doc__)
    ap.add_argument("--root", default=REPO_ROOT)
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file, relative to --root "
                         f"(default {DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline entirely")
    ap.add_argument("--write-baseline", action="store_true",
                    help="grandfather every current finding and exit 0")
    ap.add_argument("--family", action="append", choices=FAMILIES,
                    help="restrict to one checker family (repeatable)")
    ap.add_argument("--fix-hints", action="store_true",
                    help="print the suggested remediation under each finding")
    ap.add_argument("--all", action="store_true",
                    help="also print grandfathered (baselined) findings")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as a JSON document")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid in sorted(RULES):
            r = RULES[rid]
            print(f"{rid} [{r.family}] {r.summary}")
            print(f"    fix: {r.hint}")
        return 0

    if not os.path.isdir(os.path.join(args.root, PACKAGE)):
        print(f"graftlint: no {PACKAGE} package under {args.root}",
              file=sys.stderr)
        return 2

    findings = run_analysis(args.root, families=args.family)

    baseline_path = os.path.join(args.root, args.baseline)
    if args.write_baseline:
        write_baseline(baseline_path, findings)
        print(f"graftlint: baselined {len(findings)} finding(s) -> "
              f"{args.baseline}")
        return 0

    baseline = set() if args.no_baseline else load_baseline(baseline_path)
    new, old, stale = partition(findings, baseline)

    if args.as_json:
        print(json.dumps({
            "new": [vars(f) for f in new],
            "grandfathered": [vars(f) for f in old],
            "stale_baseline": sorted(stale),
        }, indent=2))
        return 1 if new else 0

    for f in new:
        print(f.render(fix_hints=args.fix_hints))
    if args.all:
        for f in old:
            print(f"[baselined] {f.render(fix_hints=args.fix_hints)}")
    for key in sorted(stale):
        print(f"warning: stale baseline entry (fixed? prune it): {key}",
              file=sys.stderr)
    summary = (f"graftlint: {len(new)} new finding(s), "
               f"{len(old)} grandfathered, {len(stale)} stale baseline "
               f"entr{'y' if len(stale) == 1 else 'ies'}")
    print(summary if new else summary + " — clean")
    return 1 if new else 0


if __name__ == "__main__":
    raise SystemExit(main())
