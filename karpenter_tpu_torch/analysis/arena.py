"""arena-discipline checker family (AR*).

A copy of the JAX package's `analysis/arena.py` over the port's arena,
snapshot and ingest modules.

The persistent cluster arena (ops/arena.py) keeps the solver's input
tensors alive across ticks; its bit-identity contract with the
from-scratch `tensorize_nodes` path holds only if every slab mutation
flows through the typed delta API, under the state lock.  Two lexical
rules keep that closed:

  * AR001 — a write to an arena slab tensor (``slab_alloc``,
    ``slab_used``, ``slab_compat``, ``slab_live``) anywhere OUTSIDE
    `karpenter_tpu_torch/ops/arena.py`.  Consumers get copies from `gather()`;
    nothing else may reach into the slab.
  * AR002 — a function inside `ops/arena.py` that writes a slab tensor
    without a `# guarded-by:` / `# graftlint: holds(...)` lock annotation
    on its `def` line (or the line above).  Every delta-API entry point
    documents the externally-held state lock the same way the Cluster's
    maps do (see analysis/locks.py for the convention).

Writes are: assignment / augmented assignment whose target chain touches
a slab attribute (``self.slab_used[slot] = ...``, ``arena.slab_live[i] =
False``), `del` on such a chain, and in-place ndarray mutator calls
(``.fill(...)``, ``.sort()``, ``.resize(...)``, ``.put(...)``) on one.
Reads are out of scope — `gather()`'s fancy indexing copies, so reads
can't corrupt the slab.

The WarmRestart layer adds a third rule with a WIDER net on a NARROWER
scope:

  * AR003 — snapshot-path code (`state/snapshot.py`, `state/ingest.py`)
    touching a slab attribute AT ALL (read or write), or a
    `setattr`/`getattr` anywhere outside `ops/arena.py` whose name
    argument is a slab-attr string literal.  Serialization is exactly
    the place a generic ``for k, v in sections: setattr(arena, k, v)``
    loop slips past AR001's lexical write detection — restore must flow
    through ``ClusterArena.snapshot_state()/restore_state()`` so slab ⇄
    registry consistency stays arena-owned.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Tuple

from .core import Checker, Finding, SourceFile, rule

rule("AR001", "arena-discipline",
     "arena slab tensor mutated outside the delta API module",
     "route the mutation through a ClusterArena delta method "
     "(apply_*/touch_node/compact/rebuild) in ops/arena.py — consumers "
     "must treat gather() output as read-only copies")
rule("AR002", "arena-discipline",
     "slab-mutating arena method lacks a lock annotation",
     "annotate the def line with `# guarded-by: caller(state_lock)` (or "
     "`# graftlint: holds(<lock>)`) — every slab write happens under the "
     "operator's state lock")
rule("AR003", "arena-discipline",
     "snapshot-path code touches arena slab tensors directly",
     "serialize/restore slabs only through ClusterArena.snapshot_state() "
     "/ restore_state() — the snapshot layer must never read, write, or "
     "setattr/getattr slab_* attributes itself")

ARENA_MODULE = "karpenter_tpu_torch/ops/arena.py"
SNAPSHOT_MODULES = ("karpenter_tpu_torch/state/snapshot.py",
                    "karpenter_tpu_torch/state/ingest.py")
SLAB_ATTRS = frozenset({"slab_alloc", "slab_used", "slab_compat",
                        "slab_live"})
_NDARRAY_MUTATORS = frozenset({"fill", "sort", "resize", "put"})
_ANNOT_RE = re.compile(
    r"#\s*(guarded-by:|graftlint:\s*holds\()")


def _chain_slab_attr(node: ast.AST) -> Optional[str]:
    """First slab attribute named anywhere in an Attribute/Subscript
    chain (``self.slab_used[slot]`` → 'slab_used')."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if isinstance(node, ast.Attribute) and node.attr in SLAB_ATTRS:
            return node.attr
        node = node.value
    return None


def _slab_writes(tree: ast.AST) -> List[Tuple[ast.AST, str, str]]:
    """(node, slab-attr, kind) for every slab write site under `tree`."""
    writes: List[Tuple[ast.AST, str, str]] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                attr = _chain_slab_attr(tgt)
                if attr is not None:
                    writes.append((node, attr, "assign"))
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                attr = _chain_slab_attr(tgt)
                if attr is not None:
                    writes.append((node, attr, "del"))
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _NDARRAY_MUTATORS:
            attr = _chain_slab_attr(node.func.value)
            if attr is not None:
                writes.append((node, attr, node.func.attr))
    return writes


def _def_annotated(sf: SourceFile, fn: ast.FunctionDef) -> bool:
    for lineno in (fn.lineno, fn.lineno - 1):
        if _ANNOT_RE.search(sf.line_text(lineno)):
            return True
    return False


class ArenaDisciplineChecker(Checker):
    family = "arena-discipline"

    def check_file(self, sf: SourceFile) -> List[Finding]:
        if sf.rel == ARENA_MODULE:
            return self._check_arena_module(sf)
        findings: List[Finding] = []
        for node, attr, kind in _slab_writes(sf.tree):
            findings.append(Finding(
                "AR001", sf.rel, node.lineno, sf.scope_of(node),
                f"{attr}:{kind}",
                f"mutation of arena slab tensor {attr!r} ({kind}) outside "
                f"the delta API ({ARENA_MODULE})"))
        findings.extend(self._check_snapshot_path(sf))
        return findings

    def _check_snapshot_path(self, sf: SourceFile) -> List[Finding]:
        """AR003: snapshot-path slab access + string-driven setattr/getattr
        (the generic restore-loop escape hatch AR001's lexical write
        detection cannot see)."""
        findings: List[Finding] = []
        snapshot_mod = sf.rel in SNAPSHOT_MODULES
        for node in ast.walk(sf.tree):
            if snapshot_mod and isinstance(node, ast.Attribute) and \
                    node.attr in SLAB_ATTRS:
                findings.append(Finding(
                    "AR003", sf.rel, node.lineno, sf.scope_of(node),
                    f"{node.attr}:access",
                    f"snapshot-path access to slab tensor {node.attr!r} — "
                    f"use ClusterArena.snapshot_state()/restore_state()"))
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id in ("setattr", "getattr") and \
                    len(node.args) >= 2 and \
                    isinstance(node.args[1], ast.Constant) and \
                    node.args[1].value in SLAB_ATTRS:
                findings.append(Finding(
                    "AR003", sf.rel, node.lineno, sf.scope_of(node),
                    f"{node.args[1].value}:{node.func.id}",
                    f"{node.func.id}() on slab tensor "
                    f"{node.args[1].value!r} outside the delta API"))
        return findings

    def _check_arena_module(self, sf: SourceFile) -> List[Finding]:
        findings: List[Finding] = []
        parents = sf.parents()
        flagged = set()
        for node, attr, kind in _slab_writes(sf.tree):
            # walk up to the enclosing def; __init__ (slab creation) and
            # module level are exempt, everything else needs the annotation
            cur: Optional[ast.AST] = node
            fn: Optional[ast.FunctionDef] = None
            while cur is not None:
                if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fn = cur
                    break
                cur = parents.get(cur)
            if fn is None or fn.name == "__init__" or fn in flagged:
                continue
            if not _def_annotated(sf, fn):
                flagged.add(fn)
                findings.append(Finding(
                    "AR002", sf.rel, fn.lineno, sf.scope_of(node),
                    fn.name,
                    f"method {fn.name!r} mutates slab tensor {attr!r} "
                    f"without a lock annotation on its def line"))
        return findings
