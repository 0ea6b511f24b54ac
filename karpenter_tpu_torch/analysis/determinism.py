"""determinism checker family (DT*).

A copy of the JAX package's `analysis/determinism.py`: the frontier is
`karpenter_tpu_torch.sim`, the allowlist the port's two shims.

The simulator's contract is byte-identical reports for identical seeds
(tests/golden/); PR 4's Operator truthiness bug showed how a single
wall-clock or ordering leak breaks a golden three layers away.  These
rules police the leak classes in every module *reachable from
`karpenter_tpu_torch.sim`* (computed from the static import graph — the sim
drives the real controller stack, so most of the package is in scope):

  * DT001 — wall-clock reads (`time.time()`, `datetime.now()`, …).
    Injectable-clock *defaults* (`clock: ... = time.time`) are references,
    not calls, and are fine; the allowlisted shims (`utils/tracing.py`
    display timestamps, `sim/harness.py` wall-speedup metric) are the two
    places a real clock is read on purpose.
  * DT002 — unseeded global RNG (`random.*`, `np.random.*`); all sim
    randomness flows through `np.random.default_rng([seed, ...])` streams.
  * DT003 — iteration over a `set` (literal, constructor, comprehension,
    or set-algebra expression) feeding control flow or output.  Set order
    is hash-randomized across runs for str keys; `sorted(...)` it.  Dict
    iteration is NOT flagged: CPython dicts are insertion-ordered, and
    deterministic insertions give deterministic iteration.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Checker, Finding, SourceFile, rule

rule("DT001", "determinism",
     "wall-clock read in a sim-reachable module",
     "take an injectable `clock: Callable[[], float]` (default time.time) "
     "and call self.clock(); the simulator substitutes virtual time")
rule("DT002", "determinism",
     "unseeded global RNG in a sim-reachable module",
     "use a seeded np.random.default_rng([seed, stream_id]) stream owned "
     "by the caller; never the process-global random/np.random state")
rule("DT003", "determinism",
     "iteration over an unordered set in a sim-reachable module",
     "wrap the set in sorted(...) before iterating (hash randomization "
     "makes str-keyed set order differ across runs)")

# the two intentional wall-clock reads (display timestamps / wall speedup)
DT001_ALLOWLIST = ("karpenter_tpu_torch/utils/tracing.py",
                   "karpenter_tpu_torch/sim/harness.py")

_WALLCLOCK = {("time", "time"), ("datetime", "now"), ("datetime", "utcnow"),
              ("datetime", "today"), ("date", "today")}
_NP_RNG_OK = {"default_rng", "Generator", "SeedSequence", "PCG64", "Philox",
              "BitGenerator"}
_RANDOM_OK = {"Random", "SystemRandom", "getstate"}
_SET_CTORS = {"set", "frozenset"}
_SET_METHODS = {"union", "intersection", "difference",
                "symmetric_difference", "copy"}


def module_name(rel: str) -> str:
    mod = rel[:-3] if rel.endswith(".py") else rel
    mod = mod.replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


def import_graph(sources: Sequence[SourceFile]) -> Dict[str, Set[str]]:
    """module → imported package-internal modules (static, best-effort)."""
    known = {module_name(sf.rel) for sf in sources}
    graph: Dict[str, Set[str]] = {}

    def resolve(candidates: List[str]) -> Optional[str]:
        for c in candidates:
            if c in known:
                return c
        return None

    for sf in sources:
        mod = module_name(sf.rel)
        pkg_parts = mod.split(".")
        deps: Set[str] = set()
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    target = resolve([alias.name])
                    if target:
                        deps.add(target)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    # relative: level 1 = containing package
                    base = ".".join(pkg_parts[: len(pkg_parts) - node.level])
                else:
                    base = ""
                stem = ".".join(p for p in (base, node.module or "") if p)
                for alias in node.names:
                    target = resolve([f"{stem}.{alias.name}" if stem
                                      else alias.name, stem])
                    if target:
                        deps.add(target)
        graph[mod] = deps
    return graph


def reachable_from_sim(sources: Sequence[SourceFile]) -> Set[str]:
    graph = import_graph(sources)
    frontier = [m for m in graph if m.startswith("karpenter_tpu_torch.sim")]
    seen: Set[str] = set(frontier)
    while frontier:
        cur = frontier.pop()
        for dep in graph.get(cur, ()):
            if dep not in seen:
                seen.add(dep)
                frontier.append(dep)
    return seen


# ---------------------------------------------------------------------------
# set-expression classification (DT003)
# ---------------------------------------------------------------------------

def _collect_set_names(scope: ast.AST) -> Set[str]:
    """Names bound to set-like values anywhere in the scope subtree.  Two
    passes so `prev = cur`-style rebinds of an already-known set resolve."""
    known: Set[str] = set()
    for _ in range(2):
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign):
                pairs: List[Tuple[ast.AST, ast.AST]] = []
                for tgt in node.targets:
                    if isinstance(tgt, ast.Tuple) and \
                            isinstance(node.value, ast.Tuple) and \
                            len(tgt.elts) == len(node.value.elts):
                        pairs.extend(zip(tgt.elts, node.value.elts))
                    else:
                        pairs.append((tgt, node.value))
                for tgt, val in pairs:
                    if isinstance(tgt, ast.Name) and is_set_expr(val, known):
                        known.add(tgt.id)
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                ann = ast.dump(node.annotation).lower()
                if "'set'" in ann or (node.value is not None and
                                      is_set_expr(node.value, known)):
                    known.add(node.target.id)
    return known


def is_set_expr(node: ast.AST, known: Set[str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Name):
        return node.id in known
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id in _SET_CTORS:
            return True
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SET_METHODS:
            return is_set_expr(node.func.value, known)
        return False
    if isinstance(node, ast.BinOp) and \
            isinstance(node.op, (ast.BitOr, ast.BitAnd, ast.BitXor, ast.Sub)):
        return is_set_expr(node.left, known) or \
            is_set_expr(node.right, known)
    return False


class DeterminismChecker(Checker):
    family = "determinism"

    def check_repo(self, sources: Sequence[SourceFile],
                   root: str) -> List[Finding]:
        in_scope = reachable_from_sim(sources)
        findings: List[Finding] = []
        for sf in sources:
            if module_name(sf.rel) not in in_scope:
                continue
            findings.extend(self._check_clock_rng(sf))
            findings.extend(self._check_set_iteration(sf))
        return findings

    def _check_clock_rng(self, sf: SourceFile) -> List[Finding]:
        findings: List[Finding] = []
        clock_ok = sf.rel in DT001_ALLOWLIST
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (isinstance(f, ast.Attribute) and
                    isinstance(f.value, ast.Name)):
                continue
            base, attr = f.value.id, f.attr
            if (base, attr) in _WALLCLOCK and not clock_ok:
                findings.append(Finding(
                    "DT001", sf.rel, node.lineno, sf.scope_of(node),
                    f"{base}.{attr}",
                    f"{base}.{attr}() reads the wall clock in a "
                    "sim-reachable module"))
            elif base == "random" and attr not in _RANDOM_OK:
                findings.append(Finding(
                    "DT002", sf.rel, node.lineno, sf.scope_of(node),
                    f"random.{attr}",
                    f"random.{attr}() uses the unseeded process-global RNG"))
        # np.random.<fn>: one attribute deeper (np.random is an Attribute)
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Attribute) and \
                    f.value.attr == "random" and \
                    isinstance(f.value.value, ast.Name) and \
                    f.value.value.id in ("np", "numpy") and \
                    f.attr not in _NP_RNG_OK:
                findings.append(Finding(
                    "DT002", sf.rel, node.lineno, sf.scope_of(node),
                    f"np.random.{f.attr}",
                    f"np.random.{f.attr}() uses the unseeded global "
                    "NumPy RNG"))
        return findings

    def _check_set_iteration(self, sf: SourceFile) -> List[Finding]:
        findings: List[Finding] = []
        scopes: List[ast.AST] = [sf.tree]
        scopes += [n for n in ast.walk(sf.tree)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        flagged: Set[int] = set()
        for scope in scopes:
            known = _collect_set_names(scope)
            for node in ast.walk(scope):
                iters: List[ast.AST] = []
                if isinstance(node, (ast.For, ast.AsyncFor)):
                    iters.append(node.iter)
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.GeneratorExp, ast.DictComp)):
                    iters.extend(g.iter for g in node.generators)
                for it in iters:
                    if is_set_expr(it, known) and it.lineno not in flagged:
                        flagged.add(it.lineno)
                        findings.append(Finding(
                            "DT003", sf.rel, it.lineno, sf.scope_of(node),
                            ast.unparse(it)[:60] if hasattr(ast, "unparse")
                            else "set-iter",
                            "iteration order over a set is not "
                            "deterministic across runs"))
        return findings
