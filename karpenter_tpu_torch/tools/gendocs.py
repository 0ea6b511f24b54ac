"""gendocs — generate the instance-types reference page from the live
catalog (analog of the reference's docs generator,
hack/docs/instancetypes_gen_docs.go: group types by family, emit
requirement labels and capacity/allocatable tables per type, sorted by cpu
then memory).

The port of the JAX package's `tools/gendocs.py`: the same flags and the
same page, over `karpenter_tpu_torch.catalog`; only the header names this
command.

    python -m karpenter_tpu_torch.tools.gendocs --types 60 > docs/instance-types.md
"""

from __future__ import annotations

import argparse
import sys

COMMAND = "python -m karpenter_tpu_torch.tools.gendocs"


def _fmt(res: str, qty: int) -> str:
    if res == "memory" or res.endswith("storage"):
        for unit, scale in (("Gi", 2**30), ("Mi", 2**20)):
            if qty % scale == 0:
                return f"{qty // scale}{unit}"
        return str(qty)
    if res == "cpu":
        return str(qty // 1000) if qty % 1000 == 0 else f"{qty}m"
    return str(qty)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--types", type=int, default=60)
    ap.add_argument("--out", default="-")
    args = ap.parse_args(argv)

    from ..catalog.generate import generate_catalog

    catalog = generate_catalog(args.types)
    # family grouping, cpu-then-memory sort — the reference's page order
    families = {}
    for it in catalog:
        families.setdefault(it.name.split(".")[0], []).append(it)

    out = sys.stdout if args.out == "-" else open(args.out, "w")
    print("# Instance Types", file=out)
    print(f"\nGenerated from the live catalog (`{COMMAND}`); the",
          file=out)
    print("requirement labels below are exactly the ones the solver's",
          file=out)
    print("dense compat lowering matches against.\n", file=out)
    for fam in sorted(families):
        print(f"## {fam} family", file=out)
        for it in sorted(families[fam],
                         key=lambda t: (t.capacity.get("cpu", 0),
                                        t.capacity.get("memory", 0))):
            print(f"### `{it.name}`", file=out)
            print("#### Labels", file=out)
            print("| Label | Value |", file=out)
            print("|--|--|", file=out)
            for key in sorted(it.requirements):
                req = it.requirements[key]
                vals = ",".join(sorted(str(v) for v in req.values)) \
                    if req.values else req.operator
                print(f"| `{key}` | `{vals}` |", file=out)
            print("#### Resources", file=out)
            print("| Resource | Capacity | Allocatable |", file=out)
            print("|--|--|--|", file=out)
            alloc = it.allocatable
            for res in sorted(it.capacity):
                cap = it.capacity[res]
                if not cap:
                    continue
                print(f"| `{res}` | {_fmt(res, cap)} | "
                      f"{_fmt(res, alloc.get(res, 0))} |", file=out)
            offs = sorted({(o.capacity_type, round(o.price, 4))
                           for o in it.offerings if o.available})
            print("#### Offerings", file=out)
            print("| Capacity type | $/hour |", file=out)
            print("|--|--|", file=out)
            for ct, price in offs:
                print(f"| {ct} | {price} |", file=out)
            print("", file=out)
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
