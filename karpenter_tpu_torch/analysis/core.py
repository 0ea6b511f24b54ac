"""graftlint core: findings, rules, suppression, and the baseline.

A copy of the JAX package's `analysis/core.py`; `iter_sources` reads
`karpenter_tpu_torch/` by default and the checkers are the port's.

The framework is deliberately small: a `SourceFile` wraps one parsed
module (AST + raw lines, so trailing-comment conventions like
`# guarded-by:` stay visible), a `Checker` contributes findings either
per file or across the whole repo (the observability contract needs the
metrics module AND the docs page at once), and `run_analysis` stitches
them together, applies `# graftlint: disable=` suppressions, and sorts.

Finding identity (`Finding.key`) is `rule|path|scope|detail` — no line
numbers — so the committed baseline survives unrelated edits that shift
lines.  `scope` is the enclosing qualified name (`Cls.method` or
`<module>`); `detail` is a rule-chosen discriminator (the attribute
written, the call flagged) that keeps two findings in one scope apart.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple


@dataclass(frozen=True)
class Rule:
    rule_id: str
    family: str
    summary: str
    hint: str


RULES: Dict[str, Rule] = {}


def rule(rule_id: str, family: str, summary: str, hint: str) -> Rule:
    r = Rule(rule_id, family, summary, hint)
    RULES[rule_id] = r
    return r


@dataclass
class Finding:
    rule: str
    path: str       # repo-relative, forward slashes
    line: int
    scope: str      # enclosing qualname or '<module>'
    detail: str     # stable discriminator within the scope
    message: str

    @property
    def key(self) -> str:
        return f"{self.rule}|{self.path}|{self.scope}|{self.detail}"

    def render(self, fix_hints: bool = False) -> str:
        out = f"{self.path}:{self.line}: {self.rule} {self.message} [{self.scope}]"
        if fix_hints and self.rule in RULES:
            out += f"\n    fix: {RULES[self.rule].hint}"
        return out


class SourceFile:
    """One parsed module: AST, raw lines, repo-relative path."""

    def __init__(self, path: str, rel: str, text: str, tree: ast.Module):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = tree
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None

    @classmethod
    def load(cls, path: str, root: str) -> Optional["SourceFile"]:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                text = fh.read()
            tree = ast.parse(text, filename=path)
        except (OSError, SyntaxError, ValueError):
            return None
        return cls(path, os.path.relpath(path, root), text, tree)

    # ---- structure helpers used by every checker ----
    def parents(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for parent in ast.walk(self.tree):
                for child in ast.iter_child_nodes(parent):
                    self._parents[child] = parent
        return self._parents

    def scope_of(self, node: ast.AST) -> str:
        """Qualified enclosing scope name, e.g. `Batcher.add`."""
        parts: List[str] = []
        parents = self.parents()
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            cur = parents.get(cur)
        return ".".join(reversed(parts)) if parts else "<module>"

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


_SUPPRESS_RE = re.compile(r"#\s*graftlint:\s*disable=([A-Z0-9,\s]+)")


def _suppressed_rules(line: str) -> Set[str]:
    m = _SUPPRESS_RE.search(line)
    if not m:
        return set()
    return {r.strip() for r in m.group(1).split(",") if r.strip()}


def is_suppressed(sf: SourceFile, finding: Finding) -> bool:
    """A finding is suppressed by `# graftlint: disable=<RULE>` on its own
    line or on the line directly above (for lines too long to annotate)."""
    for lineno in (finding.line, finding.line - 1):
        if finding.rule in _suppressed_rules(sf.line_text(lineno)):
            return True
    return False


class Checker:
    """Base checker.  Subclasses override `check_file` (per module) and/or
    `check_repo` (whole-source-set rules like the metrics↔docs contract)."""

    family = "generic"

    def check_file(self, sf: SourceFile) -> List[Finding]:
        return []

    def check_repo(self, sources: Sequence[SourceFile],
                   root: str) -> List[Finding]:
        return []


_SKIP_DIRS = {"__pycache__", ".git", "csrc"}


def iter_sources(root: str,
                 subdirs: Sequence[str] = ("karpenter_tpu_torch",)) -> List[SourceFile]:
    out: List[SourceFile] = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                sf = SourceFile.load(os.path.join(dirpath, fn), root)
                if sf is not None:
                    out.append(sf)
    return out


def default_checkers() -> List[Checker]:
    from .arena import ArenaDisciplineChecker
    from .decodepath import DecodePathChecker
    from .determinism import DeterminismChecker
    from .locks import LockDisciplineChecker
    from .observability import ObservabilityChecker
    from .robustness import RobustnessChecker
    from .torchhot import TorchHotPathChecker
    return [TorchHotPathChecker(), DecodePathChecker(), DeterminismChecker(),
            LockDisciplineChecker(), ObservabilityChecker(),
            ArenaDisciplineChecker(), RobustnessChecker()]


def run_analysis(root: str,
                 checkers: Optional[Sequence[Checker]] = None,
                 families: Optional[Sequence[str]] = None,
                 sources: Optional[Sequence[SourceFile]] = None) -> List[Finding]:
    """Run every checker over the package; returns suppression-filtered
    findings sorted by (path, line, rule)."""
    if checkers is None:
        checkers = default_checkers()
    if families:
        checkers = [c for c in checkers if c.family in set(families)]
    if sources is None:
        sources = iter_sources(root)
    by_rel = {sf.rel: sf for sf in sources}
    findings: List[Finding] = []
    for checker in checkers:
        for sf in sources:
            findings.extend(checker.check_file(sf))
        findings.extend(checker.check_repo(sources, root))
    kept = []
    for f in findings:
        sf = by_rel.get(f.path)
        if sf is not None and is_suppressed(sf, f):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.rule, f.detail))
    return kept


# ---------------------------------------------------------------------------
# Baseline: grandfathered findings we decided not to fix (yet).
# ---------------------------------------------------------------------------

def load_baseline(path: str) -> Set[str]:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return set()
    return set(doc.get("findings", []))


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    doc = {
        "comment": "graftlint grandfathered findings; regenerate with "
                   "`python -m karpenter_tpu_torch.tools.graftlint --write-baseline`. "
                   "Keys are "
                   "rule|path|scope|detail (line-number free, so unrelated "
                   "edits don't invalidate them).",
        "findings": sorted({f.key for f in findings}),
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2)
        fh.write("\n")


def partition(findings: Sequence[Finding], baseline: Set[str]
              ) -> Tuple[List[Finding], List[Finding], Set[str]]:
    """Split into (new, grandfathered) and report baseline keys that no
    longer match anything (stale — fixed or renamed; prune them)."""
    new: List[Finding] = []
    old: List[Finding] = []
    seen: Set[str] = set()
    for f in findings:
        seen.add(f.key)
        (old if f.key in baseline else new).append(f)
    return new, old, baseline - seen
