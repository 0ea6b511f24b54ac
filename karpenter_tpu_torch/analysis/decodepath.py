"""decode-path checker (JH007/JH008) — torch-hotpath family.

A copy of the JAX package's `analysis/decodepath.py`, in the port's
hot-path family.

The DeviceDecode contract (`ops/decode.py`) is that plan assembly is
COLUMNAR: every artifact comes from gather/repeat/reduceat over slab
arrays, never a per-pod Python round.  That discipline rots the same way
the kernel disciplines do — one innocent `for pod in pods:` in a decode
assembler and the 1M-pod tick is back to seconds.  These rules hold
decode-annotated modules (a module carrying a standalone
`# graftlint: decode-path` marker line) to it:

  * JH007 — a Python loop over data rows: any `for`/`while`/comprehension
    whose iterable is not a literal `range(...)` call.  Per-NODE loops
    (bounded by cluster size, not pod count) are written as `range()`
    over node counts and stay clean; the residual-reconcile merge is the
    one grandfathered exception in
    karpenter_tpu_torch/tools/graftlint-baseline.json.
  * JH008 — host round-trips: `np.asarray(x.tolist())`-shaped calls
    anywhere, and `.tolist()` inside a loop body (a bulk `.tolist()` at
    the column boundary is the idiom; one per iteration is the rot).
"""

from __future__ import annotations

import ast
import re
from typing import List

from .core import Checker, Finding, SourceFile, rule

rule("JH007", "torch-hotpath",
     "per-pod Python loop in a decode-annotated module",
     "replace the row loop with column ops (gather/repeat/reduceat); "
     "per-node loops must iterate a literal range() over node counts — "
     "or baseline the finding when the loop is provably node-bounded "
     "(the residual-reconcile merge is)")
rule("JH008", "torch-hotpath",
     "host round-trip (.tolist() re-wrapped or inside a loop) in a "
     "decode-annotated module",
     "keep the data in one ndarray end to end; convert to Python lists "
     "once, at the final column boundary, never per iteration and never "
     "just to rebuild an array")

_MARKER_RE = re.compile(r"^\s*#\s*graftlint:\s*decode-path\s*$")
_ARRAY_WRAPPERS = {"asarray", "array", "as_tensor", "tensor"}


def _is_decode_module(sf: SourceFile) -> bool:
    return any(_MARKER_RE.match(line) for line in sf.lines)


def _target_names(node: ast.AST) -> List[str]:
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, (ast.Tuple, ast.List)):
        out: List[str] = []
        for elt in node.elts:
            out.extend(_target_names(elt))
        return out
    return ["_"]


def _is_range_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "range")


def _is_tolist_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "tolist")


def _wraps_tolist(call: ast.Call) -> bool:
    """`np.asarray(x.tolist())` / `torch.tensor(d["k"].tolist())` shapes —
    any array-constructor whose first argument is a `.tolist()` call."""
    fn = call.func
    if not (isinstance(fn, ast.Attribute) and fn.attr in _ARRAY_WRAPPERS):
        return False
    return bool(call.args) and _is_tolist_call(call.args[0])


class DecodePathChecker(Checker):
    family = "torch-hotpath"

    def check_file(self, sf: SourceFile) -> List[Finding]:
        if not _is_decode_module(sf):
            return []
        out: List[Finding] = []
        parents = sf.parents()
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.For) and not _is_range_call(node.iter):
                out.append(Finding(
                    "JH007", sf.rel, node.lineno, sf.scope_of(node),
                    ",".join(_target_names(node.target)),
                    "per-pod Python loop in decode-hot module — iterate "
                    "columns, not rows"))
            elif isinstance(node, ast.While):
                out.append(Finding(
                    "JH007", sf.rel, node.lineno, sf.scope_of(node),
                    "while",
                    "while loop in decode-hot module — decode assembly "
                    "must be straight-line column ops"))
            elif isinstance(node, ast.comprehension) and \
                    not _is_range_call(node.iter):
                out.append(Finding(
                    "JH007", sf.rel, node.iter.lineno, sf.scope_of(node.iter),
                    ",".join(_target_names(node.target)),
                    "per-pod comprehension in decode-hot module — iterate "
                    "columns, not rows"))
            elif isinstance(node, ast.Call):
                if _wraps_tolist(node):
                    out.append(Finding(
                        "JH008", sf.rel, node.lineno, sf.scope_of(node),
                        "asarray-of-tolist",
                        "array → list → array round-trip — keep the "
                        "ndarray"))
                elif _is_tolist_call(node) and \
                        self._in_loop_body(node, parents):
                    out.append(Finding(
                        "JH008", sf.rel, node.lineno, sf.scope_of(node),
                        "tolist-in-loop",
                        ".tolist() inside a loop body — hoist the bulk "
                        "conversion out of the loop"))
        return out

    @staticmethod
    def _in_loop_body(node: ast.AST, parents) -> bool:
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.For, ast.While, ast.ListComp,
                                ast.SetComp, ast.DictComp,
                                ast.GeneratorExp)):
                return True
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return False
            cur = parents.get(cur)
        return False
