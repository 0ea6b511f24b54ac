"""allocatable-diff: compare the overhead model's predicted allocatable
against observed node allocatable — the analog of the reference's
tools/allocatable-diff, which flags instance types whose computed
kube-reserved/eviction overhead drifts from reality.

The port of the JAX package's `tools/allocatable_diff.py`: the same flags,
the same JSON rows and exit codes, over `karpenter_tpu_torch.catalog`.

Usage:
    python -m karpenter_tpu_torch.tools.allocatable_diff        # whole catalog
    python -m karpenter_tpu_torch.tools.allocatable_diff --types m5.large,c5.xlarge
    python -m karpenter_tpu_torch.tools.allocatable_diff --observed obs.yaml
      where obs.yaml maps instance type → {cpu: "...", memory: "..."}
"""

from __future__ import annotations

import argparse
import json
import sys

import yaml


def main(argv=None) -> int:
    from ..api.resources import CPU, MEMORY, format_quantity, parse_quantity
    from ..catalog.generate import generate_catalog

    p = argparse.ArgumentParser(prog="allocatable-diff")
    p.add_argument("--types", default="", help="comma list; default all")
    p.add_argument("--observed", default="",
                   help="YAML of type → {cpu, memory} observed allocatable")
    p.add_argument("--catalog-size", type=int, default=200)
    ns = p.parse_args(argv)

    catalog = generate_catalog(ns.catalog_size)
    want = set(filter(None, ns.types.split(",")))
    observed = {}
    if ns.observed:
        with open(ns.observed) as f:
            observed = yaml.safe_load(f) or {}

    rows = []
    for it in catalog:
        if want and it.name not in want:
            continue
        alloc = it.allocatable
        row = {
            "type": it.name,
            "capacity": {"cpu": format_quantity(it.capacity[CPU], CPU),
                         "memory": format_quantity(it.capacity[MEMORY], MEMORY)},
            "overhead": {"cpu": format_quantity(it.overhead_total[CPU], CPU),
                         "memory": format_quantity(it.overhead_total[MEMORY],
                                                   MEMORY)},
            "allocatable": {"cpu": format_quantity(alloc[CPU], CPU),
                            "memory": format_quantity(alloc[MEMORY], MEMORY)},
        }
        if it.name in observed:
            obs = observed[it.name]
            d_cpu = alloc[CPU] - parse_quantity(obs.get("cpu", 0), CPU)
            d_mem = alloc[MEMORY] - parse_quantity(obs.get("memory", 0), MEMORY)
            row["diff"] = {"cpu": format_quantity(d_cpu, CPU),
                           "memory": format_quantity(d_mem, MEMORY),
                           "cpu_ok": d_cpu == 0, "memory_ok": d_mem == 0}
        rows.append(row)
    json.dump(rows, sys.stdout, indent=2)
    print()
    if observed:
        bad = [r["type"] for r in rows if "diff" in r
               and not (r["diff"]["cpu_ok"] and r["diff"]["memory_ok"])]
        if bad:
            print(f"MISMATCH: {bad}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
