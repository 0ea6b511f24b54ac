"""The observability lint's trip-site and SLI rules run over the port.

`PortObservabilityChecker` is the port's own `ObservabilityChecker`
(`karpenter_tpu_torch/analysis/observability.py`) with two of its rules,
its paths taken from a package's name (`utils/metrics.py`, `obs/slo.py`,
the `obs/` exemption), so that it runs over either package:

- OB006: every trip-counter increment (supervisor quarantines, watchdog
  trips, fence refusals, ladder and decode transitions, gang rejections)
  has a `publish_incident` in the same function;
- OB007: every metric family an SLI of `obs/slo.py` names is registered.

Both must find nothing, over the same trip sites and incident kinds as the
reference's; and each rule flags a planted breach (a trip site with its
publish removed, an SLI family misspelt), so neither passes vacuously.
"""

import ast
import collections

from karpenter_tpu_torch.analysis.core import SourceFile, iter_sources
from karpenter_tpu_torch.analysis.observability import (
    ObservabilityChecker, _trip_inc_family)

from torch_ha import REPO

PORT_PKG = "karpenter_tpu_torch"


class PortObservabilityChecker(ObservabilityChecker):
    """OB006 and OB007 over a package's sources, with the metric module,
    the SLO module and the exempt `obs/` prefix of `package`."""

    def __init__(self, package=PORT_PKG):
        self.metrics = f"{package}/utils/metrics.py"
        self.slo = f"{package}/obs/slo.py"
        self.exempt = f"{package}/obs/"

    def check_repo(self, sources, root):
        by_rel = {sf.rel: sf for sf in sources}
        findings = self._check_sli_families(by_rel[self.slo],
                                            by_rel[self.metrics])
        for sf in sources:
            if sf.rel.startswith(self.exempt) or sf.rel == self.metrics:
                continue
            findings.extend(self._check_trip_funnel(sf))
        return findings


def _sources(package):
    return iter_sources(REPO, subdirs=(package,))


def _rel(sf, package):
    return sf.rel[len(package) + 1:]


def _sites(package):
    """(module, family) of every trip-counter increment, and (module, kind)
    of every `publish_incident` outside obs/, of `package`."""
    trips, kinds = collections.Counter(), collections.Counter()
    for sf in _sources(package):
        rel = _rel(sf, package)
        if rel.startswith(("obs/", "analysis/", "tools/")):
            continue
        for node in ast.walk(sf.tree):
            family = _trip_inc_family(node)
            if family is not None:
                trips[(rel, family)] += 1
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", getattr(node.func, "attr", "")) \
                    == "publish_incident" and node.args:
                kinds[(rel, node.args[0].value)] += 1
    return trips, kinds


def _findings(sources, rule, package=PORT_PKG):
    return [f for f in PortObservabilityChecker(package).check_repo(
        sources, REPO) if f.rule == rule]


def test_every_trip_site_publishes_an_incident():
    assert _findings(_sources(PORT_PKG), "OB006") == []
    # the port's trip sites and publishes are the reference's
    assert _sites(PORT_PKG) == _sites("karpenter_tpu")
    trips, kinds = _sites(PORT_PKG)
    assert len(trips) == 6 and sum(kinds.values()) == 11
    # the reference's own sources, through the same mapping, are clean too
    assert _findings(_sources("karpenter_tpu"), "OB006",
                     "karpenter_tpu") == []


def test_every_sli_family_is_registered():
    sources = _sources(PORT_PKG)
    assert _findings(sources, "OB007") == []
    slo = next(sf for sf in sources if sf.rel == f"{PORT_PKG}/obs/slo.py")
    assert "controller_runtime_reconcile_time_seconds" in slo.text


def _planted(sources, rel, old, new):
    out = []
    for sf in sources:
        if sf.rel == rel:
            assert old in sf.text, (rel, old)
            text = sf.text.replace(old, new, 1)
            sf = SourceFile(sf.path, sf.rel, text, ast.parse(text))
        out.append(sf)
    return out


def test_each_rule_flags_a_planted_breach():
    sources = _sources(PORT_PKG)
    bad = _planted(sources, f"{PORT_PKG}/operator/supervisor.py",
                   'publish_incident("circuit_open"', 'print("circuit_open"')
    found = _findings(bad, "OB006")
    assert [(f.path, f.detail) for f in found] == [
        (f"{PORT_PKG}/operator/supervisor.py", "supervisor_quarantines")]
    bad = _planted(sources, f"{PORT_PKG}/obs/slo.py",
                   '"karpenter_decode_demoted"', '"karpenter_decode_demote"')
    assert [f.detail for f in _findings(bad, "OB007")] == [
        "decode_uptime:karpenter_decode_demote"]
