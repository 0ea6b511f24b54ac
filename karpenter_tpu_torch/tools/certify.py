"""certify — measure a packing plan's cost against certified lower bounds.

The port of the JAX package's `tools/certify.py`: the same flags and the
same JSON.  Run it with `python -m karpenter_tpu_torch.tools.certify`: the
plan is solved on the card, and the Gilmore-Gomory bound screens its
pricing LPs in one PDHG launch there; `--device cpu` runs the kernels'
plain versions on the host instead.

Builds a synthetic workload (or reads sizes from flags), solves it with the
production packer, and prints the plan cost against the exact class-LP
bound (fast) and, with --gg, the tighter offline Gilmore-Gomory
configuration-LP bound (minutes; valid at every iteration).

    python -m karpenter_tpu_torch.tools.certify --pods 10000 --types 200 \\
        --specs 100 --gg

See docs/design-relaxation.md for what the bounds can and cannot certify.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.tools.certify",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pods", type=int, default=10_000)
    ap.add_argument("--types", type=int, default=200)
    ap.add_argument("--specs", type=int, default=100,
                    help="distinct pod shapes in the batch")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--zone-frac", type=float, default=0.3)
    ap.add_argument("--gpu-frac", type=float, default=0.0)
    ap.add_argument("--gg", action="store_true",
                    help="also run the Gilmore-Gomory bound (minutes)")
    ap.add_argument("--integral", action="store_true",
                    help="also bracket the exact INTEGRAL optimum: GG "
                         "column generation plus an integer restricted "
                         "master whose solution is a real buildable fleet "
                         "(minutes; settles bound-slack vs packer-waste)")
    ap.add_argument("--gg-iters", type=int, default=20)
    ap.add_argument("--gg-time-limit", type=float, default=600.0)
    ap.add_argument("--device", default="cuda",
                    help="where the plan and the GG pricing screen run: "
                         "cuda (the card, the default) or cpu (the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    import numpy as np

    from ..api.objects import NodePool
    from ..catalog.generate import generate_catalog
    from ..ops.classpack import solve_classpack
    from ..ops.ggbound import gg_bound, integral_bracket
    from ..ops.lpbound import class_lp_bound
    from ..ops.tensorize import tensorize
    from ..workloads import build_pods

    rng = np.random.default_rng(args.seed)
    pods = build_pods(args.specs, args.pods, rng,
                      zone_frac=args.zone_frac, gpu_frac=args.gpu_frac)
    prob = tensorize(pods, generate_catalog(args.types), [NodePool()])
    t0 = time.perf_counter()
    plan = solve_classpack(prob, device=args.device)
    solve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lp = class_lp_bound(prob)
    lp_s = time.perf_counter() - t0
    out = {
        "pods": args.pods, "types": args.types,
        "plan_cost": round(plan.total_price, 2),
        "nodes": len(plan.nodes),
        "unschedulable": len(plan.unschedulable),
        "solve_seconds": round(solve_s, 2),
        "class_lp_bound": round(lp, 2),
        "ratio_vs_class_lp": round(plan.total_price / lp, 4) if lp else None,
        "class_lp_seconds": round(lp_s, 1),
    }
    bound_kw = dict(iters=args.gg_iters, time_limit_s=args.gg_time_limit,
                    warm_plan=plan, log=lambda s: print(s, file=sys.stderr),
                    device=True, lp_device=args.device)
    if args.integral:
        t0 = time.perf_counter()
        lb, ub, info = integral_bracket(prob, **bound_kw)
        out.update({
            "integral_lb": round(lb, 2),
            "integral_ub": round(ub, 2) if ub != float("inf") else None,
            "ratio_vs_achievable": round(plan.total_price / ub, 4)
            if ub and ub != float("inf") else None,
            "bracket_seconds": round(time.perf_counter() - t0, 1),
        })
    if args.gg:
        t0 = time.perf_counter()
        gg, info = gg_bound(prob, **bound_kw)
        out.update({
            "gg_bound": round(gg, 2),
            "ratio_vs_gg": round(plan.total_price / gg, 4) if gg else None,
            "gg_converged": info["converged"],
            "gg_iters": info["iters"],
            "gg_seconds": round(time.perf_counter() - t0, 1),
        })
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
