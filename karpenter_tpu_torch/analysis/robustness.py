"""robustness checker family (RS*).

A copy of the JAX package's `analysis/robustness.py` with the port's
manager, supervisor and funnel modules exempt.

The supervision stack (operator/supervisor.py, ops/health.py,
utils/watchdog.py, utils/chaos.py) only works if faults actually reach
it and if its closed registries stay closed.  Three lexical rules:

  * RS001 — an ``except Exception``/bare ``except`` handler that swallows
    (no ``raise`` in the handler body) around a try body calling
    ``.reconcile()`` or ``.provision()``, anywhere outside the manager's
    `_supervised` funnel.  An inline swallow hides controller faults
    from the supervisor: no backoff, no circuit, no quarantine record —
    exactly the pre-supervision crash-loop this PR removed.
  * RS002 — a literal ``CHAOS.inject("<point>")`` whose point is not in
    `utils.chaos.POINTS`.  The registry is closed both ways: the chaos
    scenario schema validates against it, so an unregistered call site
    would be unreachable from any spec (and a typo would silently never
    fire).
  * RS003 — a literal ``run_with_deadline(..., "<phase>")`` whose phase
    is not in `utils.watchdog.PHASES`.  Same two-way contract: the
    `karpenter_watchdog_trips_total{phase}` label set and the docs
    enumerate the registry.
  * RS004 — a ``write_snapshot(...)`` call or a ``.create_fleet(`` /
    ``.terminate_instances(`` attribute call outside the fence-checked
    funnels (`state/snapshot.py`, `cloud/provider.py`,
    `cloud/batcher.py`).  HA fencing (utils/fencing.py) only holds if
    EVERY snapshot write and cloud mutation flows through a funnel that
    validates the fencing epoch — a new call site elsewhere is an
    unfenced write a deposed leader could still land.

`operator/manager.py` and `operator/supervisor.py` are exempt from RS001
— they ARE the supervision machinery (the manager's `_supervised` is the
one sanctioned except-Exception around a reconcile call).
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .core import Checker, Finding, SourceFile, rule

rule("RS001", "robustness",
     "controller fault swallowed outside the supervisor",
     "route the reconcile/provision call through the manager's "
     "supervised tick (operator/supervisor.py) instead of an inline "
     "except-Exception — supervision needs to see the failure to back "
     "off, open the circuit, and record the quarantine")
rule("RS002", "robustness",
     "CHAOS.inject point not in the registered POINTS set",
     "add the point to utils/chaos.py POINTS (and docs/robustness.md) "
     "before using it — unregistered points raise at inject time and "
     "can never be targeted by a chaos spec")
rule("RS003", "robustness",
     "run_with_deadline phase not in the registered PHASES set",
     "add the phase to utils/watchdog.py PHASES (and the "
     "karpenter_watchdog_trips_total docs row) before using it")
rule("RS004", "robustness",
     "snapshot write / cloud mutation outside the fence-checked funnel",
     "route the write through state/snapshot.py (SnapshotWriter or "
     "write_snapshot with the manager's fence) or the cloud provider's "
     "create/delete funnel — unfenced call sites let a deposed leader "
     "mutate shared state after a newer epoch took over")

_RS001_EXEMPT = frozenset({"karpenter_tpu_torch/operator/manager.py",
                           "karpenter_tpu_torch/operator/supervisor.py"})
_SUPERVISED_CALLS = frozenset({"reconcile", "provision"})
# the fence-checked funnels themselves: the only modules allowed to call
# the raw snapshot/cloud mutation seams (RS004 keeps them closed)
_RS004_EXEMPT = frozenset({"karpenter_tpu_torch/state/snapshot.py",
                           "karpenter_tpu_torch/cloud/provider.py",
                           "karpenter_tpu_torch/cloud/batcher.py"})
_RS004_CLOUD_CALLS = frozenset({"create_fleet", "terminate_instances"})


def _points() -> frozenset:
    from ..utils.chaos import POINTS
    return POINTS


def _phases() -> frozenset:
    from ..utils.watchdog import PHASES
    return PHASES


def _broad_handler(h: ast.ExceptHandler) -> bool:
    if h.type is None:
        return True
    names = []
    if isinstance(h.type, ast.Name):
        names = [h.type.id]
    elif isinstance(h.type, ast.Tuple):
        names = [e.id for e in h.type.elts if isinstance(e, ast.Name)]
    return any(n in ("Exception", "BaseException") for n in names)


def _swallows(h: ast.ExceptHandler) -> bool:
    return not any(isinstance(n, ast.Raise) for n in ast.walk(h))


def _supervised_call_in(body: List[ast.stmt]) -> Optional[str]:
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _SUPERVISED_CALLS:
                return node.func.attr
    return None


def _is_chaos_inject(call: ast.Call) -> bool:
    f = call.func
    return isinstance(f, ast.Attribute) and f.attr == "inject" and \
        isinstance(f.value, (ast.Name, ast.Attribute)) and \
        (f.value.id if isinstance(f.value, ast.Name)
         else f.value.attr) == "CHAOS"


def _rs004_escape(call: ast.Call) -> Optional[str]:
    """The mutation seam this call escapes through, or None.  Both the
    bare-name and module-qualified spellings of `write_snapshot` count;
    the cloud seams are method calls on whatever holds the substrate."""
    f = call.func
    if isinstance(f, ast.Name) and f.id == "write_snapshot":
        return "write_snapshot"
    if isinstance(f, ast.Attribute):
        if f.attr == "write_snapshot":
            return "write_snapshot"
        if f.attr in _RS004_CLOUD_CALLS:
            return f.attr
    return None


def _is_run_with_deadline(call: ast.Call) -> bool:
    f = call.func
    name = f.id if isinstance(f, ast.Name) else \
        f.attr if isinstance(f, ast.Attribute) else ""
    return name == "run_with_deadline"


def _literal(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class RobustnessChecker(Checker):
    family = "robustness"

    def check_file(self, sf: SourceFile) -> List[Finding]:
        findings: List[Finding] = []
        points, phases = _points(), _phases()
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Try) and sf.rel not in _RS001_EXEMPT:
                called = _supervised_call_in(node.body)
                if called is not None:
                    for h in node.handlers:
                        if _broad_handler(h) and _swallows(h):
                            findings.append(Finding(
                                "RS001", sf.rel, h.lineno, sf.scope_of(h),
                                called,
                                f"except-Exception swallows a "
                                f".{called}() fault outside the "
                                f"supervisor — backoff/circuit/quarantine "
                                f"never see it"))
            elif isinstance(node, ast.Call):
                if sf.rel not in _RS004_EXEMPT:
                    seam = _rs004_escape(node)
                    if seam is not None:
                        findings.append(Finding(
                            "RS004", sf.rel, node.lineno,
                            sf.scope_of(node), seam,
                            f"{seam}() called outside the fence-checked "
                            f"funnel — a deposed leader could land this "
                            f"write with a stale fencing epoch"))
                if _is_chaos_inject(node) and node.args:
                    point = _literal(node.args[0])
                    if point is not None and point not in points:
                        findings.append(Finding(
                            "RS002", sf.rel, node.lineno, sf.scope_of(node),
                            point,
                            f"CHAOS.inject point {point!r} is not in "
                            f"utils.chaos.POINTS"))
                elif _is_run_with_deadline(node):
                    phase = _literal(node.args[2]) if len(node.args) >= 3 \
                        else next((_literal(kw.value) for kw in node.keywords
                                   if kw.arg == "phase"), None)
                    if phase is not None and phase not in phases:
                        findings.append(Finding(
                            "RS003", sf.rel, node.lineno, sf.scope_of(node),
                            phase,
                            f"run_with_deadline phase {phase!r} is not in "
                            f"utils.watchdog.PHASES"))
        return findings
