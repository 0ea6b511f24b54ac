"""lock-discipline checker family (LK*).

A copy of the JAX package's `analysis/locks.py`.

Convention: a shared attribute is annotated where it is first assigned
(normally in `__init__`) with a trailing comment

    self._open: Dict = {}          # guarded-by: _lock
    self.nodes: Dict = {}          # guarded-by: caller(state_lock)

`guarded-by: <lock>` says every *write* to the attribute must be
lexically inside `with self.<lock>:` in the same class.  The
`caller(<lock>)` form documents an externally-held lock (the Cluster's
maps are mutated only under the Operator's `state_lock`, which the
ControllerManager's tick holds) — no lexical check is possible, but the
contract is recorded and the lock-order recorder still observes it at
test time.

Helper methods that are only ever called with the lock already held
(e.g. `Batcher._close`) are marked on their `def` line:

    def _close(self, key, bucket):  # graftlint: holds(_lock)

Rules:
  * LK001 — write to a guarded attribute outside `with self.<lock>:`.
  * LK002 — malformed annotation: the named lock attribute is never
    assigned in the class (typo-proofing the convention).

Writes are: assignment/augmented assignment to `self.X` (including
`self.X.field = ...` and `self.X[k] = ...`), `del self.X[...]`, and
mutating method calls (`self.X.append/add/pop/update/...`).  Reads are
deliberately out of scope — the codebase's read paths take snapshots
under the lock and the checker stays lexical, not alias-tracking.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Checker, Finding, SourceFile, rule

rule("LK001", "lock-discipline",
     "write to a guarded attribute outside its lock",
     "wrap the write in `with self.<lock>:`, or mark the enclosing helper "
     "`# graftlint: holds(<lock>)` if every caller already holds it")
rule("LK002", "lock-discipline",
     "guarded-by annotation names a lock the class never defines",
     "fix the lock name in the `# guarded-by:` comment (or assign "
     "`self.<lock>` in __init__)")

_GUARD_RE = re.compile(r"#\s*guarded-by:\s*(caller\()?([A-Za-z_][\w.]*)\)?")
_HOLDS_RE = re.compile(r"#\s*graftlint:\s*holds\(([A-Za-z_][\w.]*)\)")

_MUTATORS = {"append", "add", "pop", "popitem", "discard", "remove",
             "clear", "update", "extend", "insert", "setdefault",
             "appendleft", "popleft", "__setitem__"}


def _self_attr(node: ast.AST) -> Optional[str]:
    """`self.X` → 'X' (depth-1 only)."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _self_attr_root(node: ast.AST) -> Optional[str]:
    """Root attribute of a `self.X[...].y...` chain → 'X'."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        direct = _self_attr(node)
        if direct is not None:
            return direct
        node = node.value
    return None


class _ClassGuards:
    def __init__(self) -> None:
        self.guards: Dict[str, str] = {}          # attr -> lock name
        self.caller_guards: Dict[str, str] = {}   # attr -> external lock
        self.guard_lines: Dict[str, int] = {}
        self.lock_attrs: Set[str] = set()         # every self.X assigned


def _scan_class(sf: SourceFile, cls: ast.ClassDef) -> _ClassGuards:
    out = _ClassGuards()
    for node in ast.walk(cls):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                attr = _self_attr(tgt)
                if attr is None:
                    continue
                out.lock_attrs.add(attr)
                m = _GUARD_RE.search(sf.line_text(node.lineno))
                if m:
                    if m.group(1):
                        out.caller_guards[attr] = m.group(2)
                    else:
                        out.guards[attr] = m.group(2)
                        out.guard_lines[attr] = node.lineno
    return out


def _with_locks(sf: SourceFile, node: ast.AST,
                stop: ast.FunctionDef) -> Set[str]:
    """Lock attribute names held by enclosing `with self.<lock>` blocks
    between `node` and the enclosing method `stop`."""
    held: Set[str] = set()
    parents = sf.parents()
    cur = parents.get(node)
    while cur is not None and cur is not stop:
        if isinstance(cur, (ast.With, ast.AsyncWith)):
            for item in cur.items:
                attr = _self_attr(item.context_expr)
                if attr is not None:
                    held.add(attr)
        cur = parents.get(cur)
    # the method itself may run entirely under the lock via `with` at its
    # top level even for `node is stop` descendants — handled above; also
    # honor a holds() marker on the def line or the line above it
    for lineno in (stop.lineno, stop.lineno - 1):
        m = _HOLDS_RE.search(sf.line_text(lineno))
        if m:
            held.add(m.group(1))
    return held


class LockDisciplineChecker(Checker):
    family = "lock-discipline"

    def check_file(self, sf: SourceFile) -> List[Finding]:
        findings: List[Finding] = []
        classes = {n.name: n for n in ast.walk(sf.tree)
                   if isinstance(n, ast.ClassDef)}
        for cls in classes.values():
            findings.extend(self._check_class(sf, cls, classes))
        return findings

    def _inherited_attrs(self, sf: SourceFile, cls: ast.ClassDef,
                         classes: Dict[str, ast.ClassDef]) -> Set[str]:
        """self.X assignments of same-file base classes (transitively) —
        locks like _Metric._lock are defined once in the base."""
        out: Set[str] = set()
        seen = {cls.name}
        frontier = [cls]
        while frontier:
            cur = frontier.pop()
            for base in cur.bases:
                name = base.id if isinstance(base, ast.Name) else None
                if name and name in classes and name not in seen:
                    seen.add(name)
                    out |= _scan_class(sf, classes[name]).lock_attrs
                    frontier.append(classes[name])
        return out

    def _check_class(self, sf: SourceFile, cls: ast.ClassDef,
                     classes: Dict[str, ast.ClassDef]) -> List[Finding]:
        guards = _scan_class(sf, cls)
        known_attrs = guards.lock_attrs | \
            self._inherited_attrs(sf, cls, classes)
        findings: List[Finding] = []
        for attr, lock in guards.guards.items():
            if lock not in known_attrs:
                findings.append(Finding(
                    "LK002", sf.rel, guards.guard_lines.get(attr, cls.lineno),
                    f"{cls.name}", attr,
                    f"{cls.name}.{attr} is guarded-by {lock!r} but the "
                    f"class never assigns self.{lock}"))
        if not guards.guards:
            return findings
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                continue
            if method.name == "__init__":
                continue
            findings.extend(self._check_method(sf, cls, method, guards))
        return findings

    def _writes_in(self, method: ast.FunctionDef
                   ) -> List[Tuple[ast.AST, str, str]]:
        """(node, guarded-attr-candidate, kind) for every write site."""
        writes: List[Tuple[ast.AST, str, str]] = []
        for node in ast.walk(method):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    attr = _self_attr_root(tgt)
                    if attr is not None:
                        writes.append((node, attr, "assign"))
            elif isinstance(node, ast.Delete):
                for tgt in node.targets:
                    attr = _self_attr_root(tgt)
                    if attr is not None:
                        writes.append((node, attr, "del"))
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATORS:
                attr = _self_attr_root(node.func.value)
                if attr is not None:
                    writes.append((node, attr, node.func.attr))
        return writes

    def _check_method(self, sf: SourceFile, cls: ast.ClassDef,
                      method: ast.FunctionDef,
                      guards: _ClassGuards) -> List[Finding]:
        findings: List[Finding] = []
        for node, attr, kind in self._writes_in(method):
            lock = guards.guards.get(attr)
            if lock is None:
                continue
            held = _with_locks(sf, node, method)
            if lock not in held:
                findings.append(Finding(
                    "LK001", sf.rel, node.lineno,
                    f"{cls.name}.{method.name}", f"{attr}:{kind}",
                    f"write to {cls.name}.{attr} ({kind}) outside "
                    f"`with self.{lock}:`"))
        return findings
