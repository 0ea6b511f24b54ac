"""The port's static analysis (karpenter_tpu_torch/analysis/, its graftlint
CLI and baseline) against the JAX package's.

- tests/test_graftlint.py's 72 test functions run on both packages, case
  by case (tests/torch_suites.py): the planted sources' `karpenter_tpu/`
  paths map to `karpenter_tpu_torch/`, the reference's assertions hold on
  the port, and the values they compare are equal.  The port's copy of the
  suite reads its own baseline and runs its own CLI, and its eight
  jit-source cases of JH001-JH006 are replaced, one for one, by
  torch-hotpath cases (`TORCH_CASES`); the three of JH004 and JH005 show
  that the port's catalog lacks them.
- The gate: zero non-baselined findings over the port and no stale
  baseline entry, each baseline key with its reason in README.md.
- Parity: every lint annotation and every `named_lock` call of the port
  is the reference's, on the counterpart line, but for the departures
  listed here with their reasons.
- The operator's state lock reenters as the reference's does (not at all);
  the port's lock-order recorder flags a planted inversion; and the
  analysis and its CLI import neither `jax` nor `karpenter_tpu`.
"""

import ast
import collections
import os
import re
import subprocess
import sys
import textwrap
import threading

import pytest

from karpenter_tpu_torch.analysis import iter_sources, load_baseline
from karpenter_tpu_torch.analysis.lockorder import (LockOrderRecorder,
                                                    _RecordingLock)
from torch_lockorder import assert_no_inversions, port_lock_order  # noqa: F401
from torch_suites import Suite, port_on_cpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = "karpenter_tpu_torch"
PORT_BASELINE = os.path.join(REPO, PORT_PKG, "tools",
                             "graftlint-baseline.json")

# ---------------------------------------------------------------------------
# tests/test_graftlint.py on both packages
# ---------------------------------------------------------------------------

# The port's cases of JH001-JH006, by the reference's names.  Each pairs a
# flagged source with a clean one whose findings add nothing, so its
# assertions compare what the reference's case compares.
TORCH_CASES = {
    "test_jh001_item_flagged_only_in_hot_modules": '''
        def test_jh001_item_flagged_only_in_hot_modules():
            src = """
                import torch

                def decode(out: torch.Tensor):
                    return out.sum().item()
            """
            hot = TorchHotPathChecker().check_file(
                _sf(src, "karpenter_tpu/ops/x.py"))
            cold = TorchHotPathChecker().check_file(
                _sf(src, "karpenter_tpu/sim/x.py"))
            assert _rules(hot) == ["JH001"]
            assert _rules(cold) == []
    ''',
    "test_jh002_block_until_ready_flagged_everywhere": '''
        def test_jh002_block_until_ready_flagged_everywhere():
            flagged = """
                import torch

                def wait(x):
                    torch.cuda.synchronize()
            """
            clean = """
                def wait(x, done):
                    done.record()
                    return x.to("cpu", non_blocking=True)
            """
            out = TorchHotPathChecker().check_file(
                _sf(flagged, "karpenter_tpu/sim/x.py"))
            out += TorchHotPathChecker().check_file(
                _sf(clean, "karpenter_tpu/sim/x.py"))
            assert _rules(out) == ["JH002"]
    ''',
    "test_jh003_python_branch_on_traced_param": '''
        def test_jh003_python_branch_on_traced_param():
            flagged = """
                import torch

                def kern(x: torch.Tensor, n: int):
                    if x.sum() > 0:
                        return x
                    return n
            """
            clean = """
                import torch

                def kern(x: torch.Tensor, n: int):
                    if x.shape[0] > n and x.is_cuda:
                        return x
                    return torch.where(x > 0, x, n)
            """
            out = TorchHotPathChecker().check_file(
                _sf(flagged, "karpenter_tpu/ops/x.py"))
            out += TorchHotPathChecker().check_file(
                _sf(clean, "karpenter_tpu/ops/x.py"))
            assert "JH003" in _rules(out)
    ''',
    "test_jh003_static_params_are_branchable": '''
        def test_jh003_static_params_are_branchable():
            src = """
                import torch

                def kern(x: torch.Tensor, n: int):
                    if n > 4:
                        return x * 2
                    return x
            """
            out = TorchHotPathChecker().check_file(
                _sf(src, "karpenter_tpu/ops/x.py"))
            assert "JH003" not in _rules(out)
    ''',
    "test_jh004_dynamic_static_spec": '''
        def test_jh004_dynamic_static_spec():
            src = """
                import jax
                from functools import partial

                SPEC = (0, 1)

                @partial(jax.jit, static_argnums=SPEC)
                def kern(a, b, c):
                    return a + c
            """
            out = TorchHotPathChecker().check_file(
                _sf(src, "karpenter_tpu/ops/x.py"))
            assert "JH004" not in RULES
            assert _rules(out) == []
    ''',
    "test_jh005_missing_donation_and_the_donated_negative": '''
        def test_jh005_missing_donation_and_the_donated_negative():
            bad = """
                import torch

                def kern(prices: torch.Tensor, init_used: torch.Tensor):
                    return init_used + prices
            """
            out = TorchHotPathChecker().check_file(
                _sf(bad, "karpenter_tpu/ops/x.py"))
            assert "JH005" not in RULES
            assert _rules(out) == []
    ''',
    "test_jh005_call_form_specs_and_the_donated_negative": '''
        def test_jh005_call_form_specs_and_the_donated_negative():
            bad = """
                import jax
                from functools import partial

                def _impl(prices, init_used, n):
                    return init_used + prices

                _assign = partial(jax.jit, static_argnames=("n",))(_impl)
                _other = jax.jit(_impl, static_argnames=("n",))
            """
            out = TorchHotPathChecker().check_file(
                _sf(bad, "karpenter_tpu/parallel/x.py"))
            assert "JH005" not in RULES
            assert _rules(out) == []
    ''',
    "test_jh006_host_conversion_of_traced_value": '''
        def test_jh006_host_conversion_of_traced_value():
            flagged = """
                import torch

                def launch(x: torch.Tensor, out: torch.Tensor):
                    n = int(x.sum())
                    _lib().kp_launch(n, out)
                    return out
            """
            clean = """
                import torch

                def launch(x: torch.Tensor, out: torch.Tensor):
                    _lib().kp_launch(x.shape[0], out)
                    return float(out[0])
            """
            out = TorchHotPathChecker().check_file(
                _sf(flagged, "karpenter_tpu/ops/x_kernels.py"))
            out += TorchHotPathChecker().check_file(
                _sf(clean, "karpenter_tpu/ops/x_kernels.py"))
            assert "JH006" in _rules(out)
    ''',
}

# Cases whose port side shows what the port lacks on purpose: their values
# are not compared (the reference's and the port's assertions each hold).
NOT_COMPARED = {
    "test_jh004_dynamic_static_spec":
        "JH004 checks a jax.jit spec; the port's catalog has no JH004",
    "test_jh005_missing_donation_and_the_donated_negative":
        "JH005 checks a jax.jit spec; the port's catalog has no JH005",
    "test_jh005_call_form_specs_and_the_donated_negative":
        "JH005 checks a jax.jit spec; the port's catalog has no JH005",
}

# Where the reference's values name what the port's catalog cannot hold
# (its eleven JH005 findings and baseline keys), those are dropped from
# its side before the comparison.
JH005_FREE = {"test_baseline_is_committed_and_known_shape"}
# test_every_emitted_rule_is_registered observes each finding's rule and
# the whole catalog: compared by the rules (the reference's JH005 findings
# dropped) and the catalog's ids but JH004 and JH005; the hot-path rules'
# texts are the port's own.
CATALOG_IDS = {"test_every_emitted_rule_is_registered"}


def _port_graftlint(src):
    """The port's copy of tests/test_graftlint.py: its baseline, its CLI,
    its hot-path checker and family, and the torch-hotpath cases."""
    pairs = [
        ('BASELINE = os.path.join(REPO, "tools", "graftlint-baseline.json")',
         f'BASELINE = os.path.join(REPO, "{PORT_PKG}", "tools", '
         '"graftlint-baseline.json")'),
        (f"from {PORT_PKG}.analysis.jaxhot import JaxHotPathChecker",
         f"from {PORT_PKG}.analysis.torchhot import TorchHotPathChecker"),
        ('[sys.executable, os.path.join(REPO, "tools", "graftlint.py"), '
         '*argv]',
         f'[sys.executable, "-m", "{PORT_PKG}.tools.graftlint", *argv]'),
        ('assert fams == {"jax-hotpath",', 'assert fams == {"torch-hotpath",'),
        # the port's gate honours in-place suppressions, as run_analysis
        # does: test_rs004_only_unfenced_call_is_the_planted_leak holds
        # the one suppressed RS004 to the replay's planted leak
        ('            for f in checker.check_file(sf) if f.rule == "RS004"]',
         '            for f in checker.check_file(sf) if f.rule == "RS004"\n'
         '            and not is_suppressed(sf, f)]'),
    ]
    for old, new in pairs:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    lines = src.split("\n")
    defs = [n for n in ast.parse(src).body
            if isinstance(n, ast.FunctionDef) and n.name in TORCH_CASES]
    assert {d.name for d in defs} == set(TORCH_CASES)
    for d in sorted(defs, key=lambda d: -d.lineno):
        body = re.sub(r"\bkarpenter_tpu\b", PORT_PKG,
                      textwrap.dedent(TORCH_CASES[d.name]).strip("\n"))
        lines[d.lineno - 1:d.end_lineno] = body.split("\n")
    return "\n".join(lines)


# Compared by their outcomes: the modules reachable from `sim/`, which are
# each package's own (the port's kernel wrappers, the reference's jit
# modules), and the CLI's output, which prints each package's catalog and
# its count of grandfathered findings (1 and 12).
SUITE = Suite("test_graftlint", port_source=_port_graftlint,
              outcomes=("test_dt001_obs_package_sim_reachable_and_clean",
                        "test_cli_"))

_NAMES = (("torch-hotpath", "jax-hotpath"),)


def _norm(v):
    """Port observations with the port's own names mapped to the
    reference's (as `plain` maps the package name)."""
    if isinstance(v, str):
        for port, ref in _NAMES:
            v = v.replace(port, ref)
        return v
    if isinstance(v, tuple) and len(v) == 2 and v[0] == "set":
        return ("set", sorted(_norm(x) for x in v[1]))
    if isinstance(v, (list, tuple)):
        return type(v)(_norm(x) for x in v)
    return v


def _no_jh005(v):
    """The reference's observation less its JH005 keys and findings."""
    if isinstance(v, str):
        return v
    if isinstance(v, tuple) and len(v) == 2 and v[0] == "set":
        return ("set", [x for x in v[1] if not x.startswith("'JH005|")])
    if isinstance(v, (list, tuple)):
        return type(v)(_no_jh005(x) for x in v)
    return v


def _catalog_ids(obs):
    """(rule, RULES) pairs → the rules but JH005, and the set of catalogs'
    ids but JH004 and JH005."""
    rules = [r for r in obs[0::2] if r != "JH005"]
    ids = {tuple(k for k, _ in c[1] if k not in ("JH004", "JH005"))
           for c in obs[1::2]}
    return rules, ids


@pytest.mark.parametrize("case", SUITE.cases())
def test_graftlint(case, request):
    name = case.partition("[")[0]
    ref = SUITE.run("karpenter_tpu", case, request)
    with port_on_cpu():
        port = SUITE.run(PORT_PKG, case, request)
    if name in NOT_COMPARED:
        return
    port = _norm(port)
    if name in JH005_FREE:
        ref = _no_jh005(ref)
    if name in CATALOG_IDS:
        ref, port = _catalog_ids(ref), _catalog_ids(port)
    assert port == ref


def test_every_reference_case_runs_on_the_port():
    cases = {c.values[0] for c in SUITE.cases()}
    assert len(cases) == 72
    assert set(TORCH_CASES) <= cases and set(NOT_COMPARED) <= set(TORCH_CASES)


# ---------------------------------------------------------------------------
# the gate and the baseline
# ---------------------------------------------------------------------------

def test_baseline_holds_only_the_reasoned_residual_merge():
    """The port's baseline is the reference's JH007 alone (no JH005: the
    port's catalog has none), and README.md gives each key its reason."""
    baseline = load_baseline(PORT_BASELINE)
    assert baseline == {
        f"JH007|{PORT_PKG}/ops/decode.py|merge_residual_used|eid"}
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as fh:
        readme = fh.read()
    for key in baseline:
        assert f"`{key}`" in readme, key


def test_rs004_only_unfenced_call_is_the_planted_leak():
    """The one mutation call outside the fenced funnels is the disruption
    replay's planted leak (a test workload the reference keeps outside
    its package), suppressed in place with its reason."""
    from karpenter_tpu_torch.analysis.core import is_suppressed
    from karpenter_tpu_torch.analysis.robustness import RobustnessChecker
    checker = RobustnessChecker()
    hits = [(sf, f) for sf in iter_sources(REPO)
            for f in checker.check_file(sf) if f.rule == "RS004"]
    assert [(f.path, f.scope, f.detail) for _, f in hits] == [
        (f"{PORT_PKG}/workloads.py", "disruption_replay", "create_fleet")]
    assert all(is_suppressed(sf, f) for sf, f in hits)


# ---------------------------------------------------------------------------
# parity of the annotations and of the named locks
# ---------------------------------------------------------------------------

_ANNOT_RE = re.compile(r"#\s*(guarded-by:\s*\S+|graftlint:\s*(?:holds\([^)]*\)"
                       r"|decode-path|disable=[A-Z0-9,]+))")


def _annotations(package):
    """(module, scope, attribute or marker, annotation) of every lint
    annotation of `package` outside analysis/ and tools/.  An annotation
    on a def's signature names the def; on an assignment, the attribute
    assigned; a suppression, the statement it covers and the reason on the
    comment line above it."""
    out = collections.Counter()
    for sf in iter_sources(REPO, subdirs=(package,)):
        rel = sf.rel[len(package) + 1:]
        if rel.startswith(("analysis/", "tools/")):
            continue
        owner, stmts = {}, {}
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for line in range(node.lineno, node.body[0].lineno):
                    owner.setdefault(line, node)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                owner.setdefault(node.lineno, node)
            if isinstance(node, ast.stmt):
                stmts.setdefault(node.lineno, node)
        for i, line in enumerate(sf.lines, 1):
            for m in _ANNOT_RE.finditer(line):
                text = re.sub(r"\s+", " ", m.group(1))
                node = owner.get(i)
                if text.endswith("decode-path"):
                    key = (rel, "<module>", "decode-path", text)
                elif "disable=" in text:
                    alone = line.lstrip().startswith("#")
                    above = sf.line_text(i - 1).strip() if alone else ""
                    reason = above.lstrip("# ") if above.startswith("#") \
                        else ""
                    key = (rel, sf.scope_of(stmts[i + 1 if alone else i]),
                           text, reason)
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    key = (rel, sf.scope_of(node), "def", text)
                else:
                    tgt = node.targets[0] if isinstance(node, ast.Assign) \
                        else node.target
                    key = (rel, sf.scope_of(node), tgt.attr, text)
                out[key] += 1
    return out


_STATE = "guarded-by: caller(state_lock)"
# the reference's annotations the port has no counterpart for
REF_ONLY = {
    ("ops/arena.py", "ClusterArena.__init__", "gang_residents", _STATE):
        "the gang-resident index stays out: nothing reads it (PR 14)",
    ("ops/arena.py", "ClusterArena.gangs_on", "def", _STATE):
        "the gang-resident index stays out: nothing reads it (PR 14)",
    ("ops/arena.py", "ClusterArena.apply_offering_change", "def", _STATE):
        "dropped with no caller in either package (PR 11)",
}
# the port's annotations of code the reference does not have
PORT_ONLY = {
    ("ops/arena.py", "ClusterArena._take_slot", "def", _STATE):
        "the slot taking that the reference inlines in apply_node_add",
    ("ops/arena.py", "ClusterArena._drop_slot", "def", _STATE):
        "the slot release that the reference inlines in apply_node_remove",
    ("ops/arena.py", "ClusterArena._maybe_compact", "def", _STATE):
        "the compaction trigger that the reference inlines",
    ("ops/classpack_kernels.py", "step_cycles", "graftlint: disable=JH001",
     "a measurement's one read-back, never on a solve's path"):
        "the clock probe of K2's and K5's bounds, a port-only measurement",
    ("workloads.py", "disruption_replay", "graftlint: disable=RS004",
     "the replay plants an instance no claim owns, for the GC to find"):
        "the replay's planted leak; the reference keeps its workloads "
        "outside the package",
}


def test_annotations_are_the_references():
    ref, port = _annotations("karpenter_tpu"), _annotations(PORT_PKG)
    assert sum(ref.values()) == 73
    assert set(ref) - set(port) == set(REF_ONLY)
    assert set(port) - set(ref) == set(PORT_ONLY)
    shared = set(ref) & set(port)
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}


def _named_locks(package):
    """(module, role, factory) of every `named_lock` call of `package`."""
    out = collections.Counter()
    for sf in iter_sources(REPO, subdirs=(package,)):
        rel = sf.rel[len(package) + 1:]
        if rel.startswith("analysis/"):
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id == "named_lock":
                factory = ast.unparse(node.args[1]) if len(node.args) > 1 \
                    else "threading.Lock"
                out[(rel, node.args[0].value, factory)] += 1
    return out


def test_named_locks_are_the_references():
    """Every lock the reference builds through `named_lock`, the port
    builds with the same role and lock type."""
    ref, port = _named_locks("karpenter_tpu"), _named_locks(PORT_PKG)
    assert port == ref
    assert len(port) == 12


# ---------------------------------------------------------------------------
# the state lock and the recorder
# ---------------------------------------------------------------------------

def _operator(package):
    import importlib
    op_mod = importlib.import_module(f"{package}.operator.operator")
    gen = importlib.import_module(f"{package}.catalog.generate")
    kw = {"device": "cpu"} if package == PORT_PKG else {}
    return op_mod.Operator(catalog=gen.generate_catalog(4),
                           clock=lambda: 100.0, **kw)


def test_state_lock_reenters_as_the_references():
    """Both operators' state locks are plain locks: a second acquire on
    the holding thread would wait, and another thread's acquire waits."""
    def reentry(package):
        lock = _operator(package).state_lock
        with lock:
            again = lock.acquire(blocking=False)
            if again:
                lock.release()
            other = []
            t = threading.Thread(
                target=lambda: other.append(lock.acquire(timeout=0.05)))
            t.start()
            t.join()
        return again, other
    assert reentry("karpenter_tpu") == reentry(PORT_PKG) == (False, [False])


def test_recorder_sees_the_ports_locks(port_lock_order):
    """Under the module's recorder the port's components build recording
    locks, and a scrape under the state lock records its order."""
    if port_lock_order is None:
        pytest.skip("recorder disabled via KARPENTER_TPU_LOCK_ORDER=0")
    from karpenter_tpu_torch.utils import metrics
    op = _operator(PORT_PKG)
    assert isinstance(op.state_lock, _RecordingLock)
    assert isinstance(op.cloud._lock, _RecordingLock)
    metrics.REGISTRY.expose()
    assert {"metrics.collector", "state"} <= port_lock_order.roles()
    assert ("metrics.collector", "state") in port_lock_order.edges()
    assert_no_inversions(port_lock_order)


def test_a_planted_inversion_is_flagged():
    rec = LockOrderRecorder()
    rec.enable()
    a, b = (_RecordingLock(threading.Lock(), n, rec) for n in ("a", "b"))
    with a, b:
        pass

    def other_order():
        with b, a:
            pass
    t = threading.Thread(target=other_order)
    t.start()
    t.join()
    with pytest.raises(AssertionError, match="lock-order inversion"):
        assert_no_inversions(rec)


# ---------------------------------------------------------------------------
# no JAX
# ---------------------------------------------------------------------------

_NO_JAX = r"""
import importlib, importlib.abc, pkgutil, sys

class Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "karpenter_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Blocked())
import karpenter_tpu_torch.analysis as analysis
for info in pkgutil.iter_modules(analysis.__path__):
    importlib.import_module(f"karpenter_tpu_torch.analysis.{info.name}")
from karpenter_tpu_torch.tools import graftlint
rc = graftlint.main([])
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "karpenter_tpu"))
print("RC", rc, "LEAKED", leaked)
"""


def test_analysis_and_cli_run_without_jax():
    """The analysis and its CLI, with `jax` and `karpenter_tpu` blocked,
    run the gate over the tree: 0 new findings, 0 stale entries, exit 0."""
    p = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": REPO})
    assert p.returncode == 0, p.stderr[-2000:]
    assert "RC 0 LEAKED []" in p.stdout, p.stdout[-2000:]
    assert "0 new finding(s), 1 grandfathered, 0 stale baseline entries" \
        in p.stdout
