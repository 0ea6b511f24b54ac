"""karpenter-tpu-convert: migrate legacy (v1alpha) manifests to the current
API — the analog of the reference's karpenter-convert
(tools/karpenter-convert/README.md).

The port of the JAX package's `tools/convert.py`: the same flags and the
same output, over `karpenter_tpu_torch.api.legacy`.

Usage:
    python -m karpenter_tpu_torch.tools.convert -f old.yaml     # converted YAML on stdout
    python -m karpenter_tpu_torch.tools.convert -f old.yaml -o new.yaml
    cat old.yaml | python -m karpenter_tpu_torch.tools.convert  # stdin

Multi-document YAML streams convert document by document; unknown kinds
fail loudly unless --ignore-unknown is given.
"""

from __future__ import annotations

import argparse
import sys

import yaml


def main(argv=None) -> int:
    from ..api.legacy import convert_manifest

    p = argparse.ArgumentParser(prog="karpenter-tpu-convert")
    p.add_argument("-f", "--filename", default="-",
                   help="input manifest file ('-' == stdin)")
    p.add_argument("-o", "--output", default="-",
                   help="output file ('-' == stdout)")
    p.add_argument("--ignore-unknown", action="store_true",
                   help="pass through kinds the converter does not know")
    ns = p.parse_args(argv)

    if ns.filename == "-":
        raw = sys.stdin.read()
    else:
        with open(ns.filename) as f:
            raw = f.read()
    docs = [d for d in yaml.safe_load_all(raw) if d]
    out_docs = []
    for doc in docs:
        try:
            out_docs.append(convert_manifest(doc))
        except ValueError:
            if ns.ignore_unknown:
                out_docs.append(doc)
            else:
                raise
    text = yaml.safe_dump_all(out_docs, sort_keys=False)
    if ns.output == "-":
        sys.stdout.write(text)
    else:
        with open(ns.output, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
