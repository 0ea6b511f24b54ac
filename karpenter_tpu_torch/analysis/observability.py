"""observability-contract checker family (OB*).

A copy of the JAX package's `analysis/observability.py` over the port's
metric, tracing and SLO modules (`obs/` exempt from OB006); it reads
`docs/metrics.md` as it is.

Three contracts, all repo-level (they need more than one file at once):

  * metrics ↔ docs — every family registered in `utils/metrics.py`
    (`REGISTRY.counter/gauge/histogram("name", ...)`) has a row in
    `docs/metrics.md`, and every table row names a registered family.
    Legacy aliases (`LEGACY_ALIASES`) are served, not registered; they
    are excluded from both directions.
  * bounded labels — label names whose value space grows with workload
    (`pod`, `uid`, `provider_id`, …) are rejected at registration sites.
    `node_name` is allowed: the scrape-time collector deletes stale
    series when nodes terminate, which is the upstream convention.
  * span-name registry — every literal `tracing.span("...")` name is
    drawn from `utils/tracing.SPAN_NAMES`; dynamic names must go through
    `tracing.registered(...)` (which asserts membership at runtime).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Checker, Finding, SourceFile, rule

rule("OB001", "observability",
     "metric family registered but not documented in docs/metrics.md",
     "add a `| family | type | labels | meaning |` row to the table in "
     "docs/metrics.md")
rule("OB002", "observability",
     "docs/metrics.md documents a family that is not registered",
     "remove the stale row, or register the family in utils/metrics.py")
rule("OB003", "observability",
     "metric label with unbounded cardinality",
     "drop the label or key it on a bounded dimension (nodepool, reason, "
     "method); per-object series need scrape-time stale-series cleanup "
     "like the node_name collector")
rule("OB004", "observability",
     "span name not in the utils/tracing.SPAN_NAMES registry",
     "add the literal to SPAN_NAMES (one registry keeps the "
     "trace_span_duration label set enumerable)")
rule("OB005", "observability",
     "dynamic span name bypasses the registry",
     "wrap the expression in tracing.registered(...) so membership is "
     "asserted at runtime, or switch to a literal from SPAN_NAMES")
rule("OB006", "observability",
     "trip-site counter incremented without publishing to the incident bus",
     "call obs.incidents.publish_incident(kind, detail) in the same "
     "function that increments the trip counter — the flight recorder "
     "only captures what the bus sees (RS004-style funnel rule)")
rule("OB007", "observability",
     "SLI references a metric family that is not registered",
     "every family literal in an obs/slo.py SLI(...) spec must name a "
     "REGISTRY family (modulo the _count/_bucket/_sum histogram "
     "suffixes) — a typo here silently evaluates the SLO against an "
     "always-empty series (OB001-style two-way contract)")

METRICS_MODULE = "karpenter_tpu_torch/utils/metrics.py"
TRACING_MODULE = "karpenter_tpu_torch/utils/tracing.py"
SLO_MODULE = "karpenter_tpu_torch/obs/slo.py"
DOCS_PAGE = "docs/metrics.md"

UNBOUNDED_LABELS = {"pod", "pod_name", "uid", "provider_id", "instance_id",
                    "trace_id", "span_id", "request_id", "message_id"}

_ROW_RE = re.compile(r"^\|\s*`([a-z0-9_*]+)`")

# OB006: metric factories whose `.inc()` marks a fault-handling trip
# site.  Every increment site must also publish to the incident bus —
# otherwise the flight recorder has a blind spot for exactly the events
# it exists to capture.  The obs/ package itself is exempt (it IS the
# bus; the recorder increments bundle/suppression counters there).
TRIP_FAMILIES = frozenset({
    "supervisor_quarantines",     # circuit opened / controller quarantined
    "watchdog_trips",             # hard deadline abandoned a phase
    "leader_fence_refusals",      # stale fencing epoch refused a mutation
    "degradation_transitions",    # SolverHealth ladder moved
    "decode_transitions",         # DecodeHealth breaker moved
    "gang_rejections",            # all-or-nothing gang admission rejected
})

_OB006_EXEMPT_PREFIX = "karpenter_tpu_torch/obs/"


def _trip_inc_family(node: ast.AST) -> Optional[str]:
    """`metrics.watchdog_trips().inc(...)` → "watchdog_trips"; None for
    any call that is not a trip-family increment."""
    if not (isinstance(node, ast.Call) and
            isinstance(node.func, ast.Attribute) and
            node.func.attr == "inc"):
        return None
    inner = node.func.value
    if not isinstance(inner, ast.Call):
        return None
    f = inner.func
    name = f.attr if isinstance(f, ast.Attribute) else \
        f.id if isinstance(f, ast.Name) else ""
    return name if name in TRIP_FAMILIES else None


def _publishes_incident(func: ast.AST) -> bool:
    for node in ast.walk(func):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else \
            f.id if isinstance(f, ast.Name) else ""
        if name == "publish_incident":
            return True
    return False


def registered_families(metrics_sf: SourceFile
                        ) -> Dict[str, Tuple[int, Tuple[str, ...]]]:
    """family name → (lineno, label names) from REGISTRY.<kind>() calls."""
    out: Dict[str, Tuple[int, Tuple[str, ...]]] = {}
    for node in ast.walk(metrics_sf.tree):
        if not (isinstance(node, ast.Call) and
                isinstance(node.func, ast.Attribute) and
                node.func.attr in ("counter", "gauge", "histogram")):
            continue
        base = node.func.value
        if not (isinstance(base, ast.Name) and
                base.id in ("REGISTRY", "self")):
            continue
        if base.id == "self":   # Registry's own factory methods
            continue
        if not (node.args and isinstance(node.args[0], ast.Constant) and
                isinstance(node.args[0].value, str)):
            continue
        name = node.args[0].value
        labels: Tuple[str, ...] = ()
        for kw in node.keywords:
            if kw.arg == "labels":
                labels = tuple(
                    c.value for c in ast.walk(kw.value)
                    if isinstance(c, ast.Constant) and
                    isinstance(c.value, str))
        out[name] = (node.lineno, labels)
    return out


_SLI_FAMILY_KEYWORDS = ("families", "bad_families", "good_families")
_HISTOGRAM_SUFFIXES = ("_count", "_bucket", "_sum")


def sli_family_refs(slo_sf: SourceFile) -> List[Tuple[str, int, str]]:
    """Every family literal referenced by an `SLI(...)` spec in
    obs/slo.py, as (family, lineno, sli_name) tuples.  An SLI call whose
    three family keywords are all empty is surfaced as ("", lineno,
    name) — an indicator with no inputs can never be computed."""
    out: List[Tuple[str, int, str]] = []
    for node in ast.walk(slo_sf.tree):
        if not (isinstance(node, ast.Call) and (
                (isinstance(node.func, ast.Name) and
                 node.func.id == "SLI") or
                (isinstance(node.func, ast.Attribute) and
                 node.func.attr == "SLI"))):
            continue
        sli_name = next(
            (kw.value.value for kw in node.keywords
             if kw.arg == "name" and isinstance(kw.value, ast.Constant) and
             isinstance(kw.value.value, str)), "?")
        refs = 0
        for kw in node.keywords:
            if kw.arg not in _SLI_FAMILY_KEYWORDS:
                continue
            for c in ast.walk(kw.value):
                if isinstance(c, ast.Constant) and \
                        isinstance(c.value, str) and c.value:
                    out.append((c.value, c.lineno, sli_name))
                    refs += 1
        if refs == 0:
            out.append(("", node.lineno, sli_name))
    return out


def _strip_histogram_suffix(family: str) -> str:
    for suffix in _HISTOGRAM_SUFFIXES:
        if family.endswith(suffix):
            return family[: -len(suffix)]
    return family


def legacy_aliases(metrics_sf: SourceFile) -> Set[str]:
    for node in ast.walk(metrics_sf.tree):
        if isinstance(node, ast.Assign) and \
                any(isinstance(t, ast.Name) and t.id == "LEGACY_ALIASES"
                    for t in node.targets) and \
                isinstance(node.value, ast.Dict):
            return {v.value for v in node.value.values
                    if isinstance(v, ast.Constant) and
                    isinstance(v.value, str)}
    return set()


def documented_families(docs_path: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    try:
        with open(docs_path, "r", encoding="utf-8") as fh:
            for i, line in enumerate(fh, start=1):
                m = _ROW_RE.match(line.strip())
                if m and "*" not in m.group(1):
                    out.setdefault(m.group(1), i)
    except OSError:
        pass
    return out


def span_registry(tracing_sf: SourceFile) -> Set[str]:
    for node in ast.walk(tracing_sf.tree):
        if isinstance(node, ast.Assign) and \
                any(isinstance(t, ast.Name) and t.id == "SPAN_NAMES"
                    for t in node.targets):
            return {c.value for c in ast.walk(node.value)
                    if isinstance(c, ast.Constant) and
                    isinstance(c.value, str)}
    return set()


def _is_registered_call(node: ast.AST) -> bool:
    """`tracing.registered(...)` / `registered(...)` wrapper."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    name = f.attr if isinstance(f, ast.Attribute) else \
        f.id if isinstance(f, ast.Name) else ""
    return name == "registered"


class ObservabilityChecker(Checker):
    family = "observability"

    def check_repo(self, sources: Sequence[SourceFile],
                   root: str) -> List[Finding]:
        by_rel = {sf.rel: sf for sf in sources}
        findings: List[Finding] = []
        metrics_sf = by_rel.get(METRICS_MODULE)
        tracing_sf = by_rel.get(TRACING_MODULE)
        if metrics_sf is not None:
            findings.extend(self._check_metrics_docs(metrics_sf, root))
            findings.extend(self._check_labels(metrics_sf))
            slo_sf = by_rel.get(SLO_MODULE)
            if slo_sf is not None:
                findings.extend(self._check_sli_families(slo_sf, metrics_sf))
        spans = span_registry(tracing_sf) if tracing_sf is not None else set()
        for sf in sources:
            if sf.rel == TRACING_MODULE:
                continue    # the registry itself; Tracer.span(name) is the API
            findings.extend(self._check_spans(sf, spans))
        for sf in sources:
            findings.extend(self._check_trip_funnel(sf))
        return findings

    def _check_trip_funnel(self, sf: SourceFile) -> List[Finding]:
        """OB006: every trip-counter increment shares a function with a
        publish_incident call.  Lexical like RS004 — the contract is
        that the SAME code path feeds both the metric and the bus."""
        if sf.rel.startswith(_OB006_EXEMPT_PREFIX) or \
                sf.rel == METRICS_MODULE:
            return []
        findings: List[Finding] = []
        parents = sf.parents()
        for node in ast.walk(sf.tree):
            family = _trip_inc_family(node)
            if family is None:
                continue
            func: Optional[ast.AST] = node
            while func is not None and not isinstance(
                    func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                func = parents.get(func)
            if func is not None and _publishes_incident(func):
                continue
            findings.append(Finding(
                "OB006", sf.rel, node.lineno, sf.scope_of(node), family,
                f"trip counter {family} incremented without a "
                "publish_incident in the same function — the flight "
                "recorder cannot see this trip"))
        return findings

    def _check_sli_families(self, slo_sf: SourceFile,
                            metrics_sf: SourceFile) -> List[Finding]:
        """OB007: the SLI registry must reference only registered metric
        families — the two-way half that matters here is SLI→registry
        (registry→docs is already OB001's job).  Histogram-derived
        series (`_count`/`_bucket`/`_sum`) resolve to their base family.
        """
        findings: List[Finding] = []
        defined = set(registered_families(metrics_sf))
        for family, lineno, sli_name in sli_family_refs(slo_sf):
            if family == "":
                findings.append(Finding(
                    "OB007", slo_sf.rel, lineno, "<module>", sli_name,
                    f"SLI {sli_name} declares no metric families — an "
                    "indicator with no inputs always reads empty"))
                continue
            if _strip_histogram_suffix(family) not in defined:
                findings.append(Finding(
                    "OB007", slo_sf.rel, lineno, "<module>",
                    f"{sli_name}:{family}",
                    f"SLI {sli_name} references unregistered family "
                    f"{family} — the SLO would evaluate against an "
                    "always-empty series"))
        return findings

    def _check_metrics_docs(self, metrics_sf: SourceFile,
                            root: str) -> List[Finding]:
        findings: List[Finding] = []
        defined = registered_families(metrics_sf)
        aliases = legacy_aliases(metrics_sf)
        documented = documented_families(os.path.join(root, DOCS_PAGE))
        for name in sorted(set(defined) - set(documented) - aliases):
            lineno, _ = defined[name]
            findings.append(Finding(
                "OB001", METRICS_MODULE, lineno, "<module>", name,
                f"family {name} registered but undocumented in "
                f"{DOCS_PAGE}"))
        for name in sorted(set(documented) - set(defined) - aliases):
            findings.append(Finding(
                "OB002", METRICS_MODULE, documented[name], "<docs>", name,
                f"{DOCS_PAGE} row {documented[name]} documents unknown "
                f"family {name}"))
        return findings

    def _check_labels(self, metrics_sf: SourceFile) -> List[Finding]:
        findings: List[Finding] = []
        for name, (lineno, labels) in registered_families(metrics_sf).items():
            bad = sorted(set(labels) & UNBOUNDED_LABELS)
            if bad:
                findings.append(Finding(
                    "OB003", METRICS_MODULE, lineno, "<module>",
                    f"{name}:{','.join(bad)}",
                    f"family {name} uses unbounded label(s) {bad}"))
        return findings

    def _check_spans(self, sf: SourceFile,
                     spans: Set[str]) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                f.id if isinstance(f, ast.Name) else ""
            if name != "span":
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                if spans and arg.value not in spans:
                    findings.append(Finding(
                        "OB004", sf.rel, node.lineno, sf.scope_of(node),
                        arg.value,
                        f"span name {arg.value!r} missing from "
                        "tracing.SPAN_NAMES"))
            elif not _is_registered_call(arg):
                findings.append(Finding(
                    "OB005", sf.rel, node.lineno, sf.scope_of(node),
                    ast.unparse(arg)[:60] if hasattr(ast, "unparse")
                    else "dynamic",
                    "dynamic span name bypasses the SPAN_NAMES registry"))
        return findings
