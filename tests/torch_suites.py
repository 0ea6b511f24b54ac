"""Run a reference test suite on both packages, case by case.

`Suite("test_requirements")` loads tests/test_requirements.py twice: once
as it is (the JAX package, `REF`) and once with every `karpenter_tpu`
import, and `helpers`, bound to the port (`PORT`).  Each of the suite's
cases (its functions and class methods, each parametrisation on its own)
then runs on both, in the `both(case)` pattern of the other port tests:

- the reference's own assertions are checked on either package;
- the values every assertion compares (each side of a comparison, or the
  tested value itself) are recorded, reduced to plain data, as the case's
  observations, and those of the port must equal those of the reference.

The port runs on the CPU: while its side runs, each of its functions whose
`device` / `lp_device` defaults to "cuda" defaults to "cpu" instead (the
other parity tests pass `device="cpu"` by hand).  Before either side the
package's name and span-id counters restart, its metric registry and
tracer ring are emptied and its LP caches are cleared, so both sides name
their objects alike, count from zero and solve from cold caches.
"""

from __future__ import annotations

import ast
import dataclasses
import enum
import importlib
import inspect
import itertools
import pathlib
import pkgutil
import random
import re
import sys
import threading
import time
import types
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from torch_cases import clear_lp_caches

TESTS = pathlib.Path(__file__).parent
_YEAR_S = 365 * 86400.0
# keys of the tracer's JSON export that hold wall-clock times
_WALL_KEYS = frozenset({"duration_ms", "start_unix"})


# ---------------------------------------------------------------------------
# observations
# ---------------------------------------------------------------------------

def _text(s: str) -> str:
    # a root tool's port names itself by module where the reference's names
    # its script (gendocs' page header)
    s = re.sub(r"python -m karpenter_tpu_torch\.tools\."
               r"(simcheck|gendocs|allocatable_diff|convert)\b",
               r"tools/\1.py", s)
    s = s.replace("karpenter_tpu_torch", "karpenter_tpu")
    return re.sub(r" at 0x[0-9a-fA-F]+", "", s)


def plain(v, depth=0):
    """`v` as plain data that compares equal across the packages: their
    objects by class name and fields, tensors and arrays by values.  A
    float within a year of now is a wall-clock stamp (objects' creation
    times, records' `ts`), recorded by its presence alone; the suites'
    fake clocks start near 0.  So are a trace's `duration_ms` and
    `start_unix`."""
    if v is None or isinstance(v, (bool, int)):
        return v
    if isinstance(v, float):
        if abs(v - time.time()) < _YEAR_S:
            return "<wall>"
        return ("float", repr(v))
    if isinstance(v, str):
        return _text(v)
    if isinstance(v, bytes):
        return _text(v.decode("latin-1"))
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.name)
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.generic):
        return plain(v.item(), depth)
    if isinstance(v, np.ndarray):
        return ("array", v.shape, plain(v.tolist(), depth))
    if depth > 6:
        return type(v).__name__
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [plain(x, depth + 1) for x in v])
    if isinstance(v, (set, frozenset)):
        return ("set", sorted(repr(plain(x, depth + 1)) for x in v))
    if isinstance(v, dict):
        items = [(plain(k, depth + 1),
                  "<wall>" if k in _WALL_KEYS else plain(x, depth + 1))
                 for k, x in v.items()]
        return ("dict", sorted(items, key=repr))
    if isinstance(v, BaseException):
        return (type(v).__name__, _text(str(v)))
    if isinstance(v, type):
        return ("class", v.__name__)
    if dataclasses.is_dataclass(v):
        return (type(v).__name__, [
            (f.name, plain(getattr(v, f.name, None), depth + 1))
            for f in dataclasses.fields(v)])
    return type(v).__name__


class _Observe(ast.NodeTransformer):
    """Wrap what each `assert` tests in `__obs__(...)`, which records the
    value and returns it, so the assertion and its short-circuits are kept."""

    def visit_Assert(self, node):
        node.test = self._wrap(node.test)
        return node

    def _wrap(self, e):
        if isinstance(e, ast.BoolOp):
            e.values = [self._wrap(v) for v in e.values]
            return e
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Not):
            e.operand = self._wrap(e.operand)
            return e
        if isinstance(e, ast.Compare):
            e.left = self._call(e.left)
            e.comparators = [self._call(c) for c in e.comparators]
            return e
        return self._call(e)

    @staticmethod
    def _call(e):
        return ast.copy_location(ast.Call(
            func=ast.Name("__obs__", ast.Load()), args=[e], keywords=[]), e)


class _Bounds(_Observe):
    """For cases that hold a wall-clock time, or a size that depends on the
    process's history, to a bound: an ordering comparison is recorded by
    its outcome alone."""

    def _wrap(self, e):
        if isinstance(e, ast.Compare) and any(
                isinstance(op, (ast.Lt, ast.LtE, ast.Gt, ast.GtE))
                for op in e.ops):
            return self._call(e)
        return super()._wrap(e)


class _Outcomes(_Observe):
    """For cases whose compared values depend on timing: a comparison is
    recorded by its outcome alone."""

    def _wrap(self, e):
        if isinstance(e, ast.Compare):
            return self._call(e)
        return super()._wrap(e)


# ---------------------------------------------------------------------------
# loading a suite for a package
# ---------------------------------------------------------------------------

def _port_source(src: str) -> str:
    src = re.sub(r"\bkarpenter_tpu\b", "karpenter_tpu_torch", src)
    # a root tool started as a script runs as the port's module
    src = re.sub(r'os\.path\.join\((\w+), "tools", '
                 r'"(simcheck|gendocs|allocatable_diff|convert)\.py"\)',
                 r'"-m", "karpenter_tpu_torch.tools.\2"', src)
    src = re.sub(r"^(\s*)from helpers import", r"\1from _port_helpers import",
                 src, flags=re.M)
    return re.sub(r"^(\s*)import helpers\b", r"\1import _port_helpers as helpers",
                  src, flags=re.M)


def _port_helpers():
    mod = sys.modules.get("_port_helpers")
    if mod is None:
        path = TESTS / "helpers.py"
        mod = types.ModuleType("_port_helpers")
        mod.__file__ = str(path)
        exec(compile(_port_source(path.read_text()), str(path), "exec"),
             mod.__dict__)
        sys.modules["_port_helpers"] = mod
    return mod


def _load(suite: str, package: str, transform,
          port_source=None) -> types.ModuleType:
    path = TESTS / f"{suite}.py"
    src = path.read_text()
    if package != "karpenter_tpu":
        _port_helpers()
        src = _port_source(src)
        if port_source is not None:
            src = port_source(src)
    tree = transform.visit(ast.parse(src, str(path)))
    ast.fix_missing_locations(tree)
    mod = types.ModuleType(f"_{package}__{suite}")
    mod.__file__ = str(path)
    mod.__dict__["__obs__"] = None
    exec(compile(tree, str(path), "exec"), mod.__dict__)
    return mod


def _marks(obj):
    return list(getattr(obj, "pytestmark", []))


def _param_sets(marks):
    """Every parametrize mark's argument names and value count, outermost
    first, as pytest stacks them."""
    out = []
    for m in reversed([m for m in marks if m.name == "parametrize"]):
        names, values = m.args[0], m.args[1]
        names = [n.strip() for n in names.split(",")] \
            if isinstance(names, str) else list(names)
        out.append((names, len(values)))
    return out


def _param_values(marks, picks):
    args = {}
    pms = list(reversed([m for m in marks if m.name == "parametrize"]))
    for m, (names, _), i in zip(pms, _param_sets(marks), picks):
        v = m.args[1][i]
        v = v.values if hasattr(v, "values") and hasattr(v, "marks") else v
        if len(names) == 1:
            v = (v,)
        args.update(zip(names, v))
    return args


def _fixture_fn(obj):
    """The function under a module-level `@pytest.fixture`, else None."""
    get = getattr(obj, "_get_wrapped_function", None)     # pytest >= 8.4
    if callable(get):
        return get()
    wrapped = getattr(obj, "__pytest_wrapped__", None)
    return wrapped.obj if wrapped is not None else None


# ---------------------------------------------------------------------------
# the port on the CPU
# ---------------------------------------------------------------------------

_PORT_MODULES = []


def _import_port():
    """Every module of the port, so that none is imported (with its "cuda"
    defaults) after the patch."""
    if not _PORT_MODULES:
        pkg = importlib.import_module("karpenter_tpu_torch")
        for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            if not info.name.endswith("__main__"):
                _PORT_MODULES.append(importlib.import_module(info.name))


def _cuda_defaults():
    """(function, kind, key) of every port function whose device parameter
    defaults to "cuda"."""
    _import_port()
    found = []
    seen = set()
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == "karpenter_tpu_torch"
                               or name.startswith("karpenter_tpu_torch.")):
            continue
        objs = list(vars(mod).values())
        for o in list(objs):
            if isinstance(o, type) and o.__module__ == name:
                objs.extend(vars(o).values())
        for o in objs:
            f = getattr(o, "__func__", o)
            if not isinstance(f, types.FunctionType) or id(f) in seen:
                continue
            seen.add(id(f))
            for i, d in enumerate(f.__defaults__ or ()):
                if isinstance(d, str) and d == "cuda":
                    found.append((f, "pos", i))
            for k, d in (f.__kwdefaults__ or {}).items():
                if isinstance(d, str) and d == "cuda":
                    found.append((f, "kw", k))
    return found


@contextmanager
def port_on_cpu():
    patched = _cuda_defaults()
    saved = [(f, f.__defaults__, dict(f.__kwdefaults__ or {}))
             for f, _, _ in patched]
    for f, kind, key in patched:
        if kind == "pos":
            d = list(f.__defaults__)
            d[key] = "cpu"
            f.__defaults__ = tuple(d)
        else:
            f.__kwdefaults__ = {**f.__kwdefaults__, key: "cpu"}
    try:
        yield
    finally:
        for f, d, kw in saved:
            f.__defaults__ = d
            f.__kwdefaults__ = kw or None


# ---------------------------------------------------------------------------
# the suite
# ---------------------------------------------------------------------------

class Suite:
    """A reference suite loaded for both packages.  `bounds` names the cases
    (by `case_id` prefix) that hold wall-clock times, or cache sizes that
    depend on the process's history, to a bound: their ordering
    comparisons are recorded by outcome.  `outcomes` names those
    whose compared values depend on timing: all their comparisons are
    recorded by outcome.  Assertions made on other threads than the case's
    are checked but not recorded: their order is the threads'
    interleaving.  `ref_setup(monkeypatch)`, when given, configures the
    reference before each of its runs: the port's configuration, where the
    two differ on purpose.  `port_source(src)`, when given, rewrites the
    port's copy of the suite's source after its package names are mapped:
    where a port module has another name, or a case another body."""

    def __init__(self, suite: str, bounds=(), outcomes=(), ref_setup=None,
                 port_source=None):
        self.suite = suite
        self.bounds = tuple(bounds)
        self.outcomes = tuple(outcomes)
        self.ref_setup = ref_setup
        self.port_source = port_source
        self._mods = {}

    def module(self, package, mode=_Observe):
        key = (package, mode)
        if key not in self._mods:
            self._mods[key] = _load(self.suite, package, mode(),
                                    self.port_source)
        return self._mods[key]

    def _items(self, mod):
        for name, obj in vars(mod).items():
            if name.startswith("test") and inspect.isfunction(obj):
                yield name, None, obj
            elif name.startswith("Test") and inspect.isclass(obj):
                for mname, fn in vars(obj).items():
                    if mname.startswith("test") and inspect.isfunction(fn):
                        yield f"{name}::{mname}", obj, fn

    def cases(self, only=None, exclude=()):
        """pytest params: one per case, carrying the case's own marks;
        `only` / `exclude` select cases by name."""
        mod = self.module("karpenter_tpu")
        out = []
        for qual, cls, fn in self._items(mod):
            name = qual.rpartition("::")[2]
            if (only is not None and name not in only) or name in exclude:
                continue
            marks = _marks(cls) + _marks(fn)
            own = [getattr(pytest.mark, m.name)(*m.args, **m.kwargs)
                   for m in marks if m.name != "parametrize"]
            sets = _param_sets(marks)
            for picks in itertools.product(*[range(n) for _, n in sets]):
                cid = qual + ("[" + "-".join(map(str, picks)) + "]"
                              if picks else "")
                out.append(pytest.param(cid, marks=own, id=cid))
        return out

    def run(self, package, case_id, request):
        """The case on `package`: its observations.  Fixtures the suite
        does not define come from `request` (pytest's own: tmp_path,
        monkeypatch, caplog)."""
        mode = (_Outcomes if self.outcomes and case_id.startswith(self.outcomes)
                else _Bounds if self.bounds and case_id.startswith(self.bounds)
                else _Observe)
        mod = self.module(package, mode)
        qual, _, picks = case_id.partition("[")
        picks = [int(p) for p in picks.rstrip("]").split("-")] if picks else []
        cls_name, _, fn_name = qual.rpartition("::")
        cls = getattr(mod, cls_name) if cls_name else None
        fn = getattr(cls or mod, fn_name)
        marks = _marks(cls) + _marks(fn)
        args = _param_values(marks, picks)
        obs = []
        me = threading.get_ident()

        def observe(v):
            if threading.get_ident() == me:
                obs.append(plain(v))
            return v

        mod.__dict__["__obs__"] = observe
        importlib.import_module(f"{package}.sim.harness")._reset_global_counters()
        tracing = importlib.import_module(f"{package}.utils.tracing")
        tracing._ids = itertools.count(1)
        tracing.TRACER.reset()
        importlib.import_module(f"{package}.utils.metrics").REGISTRY.reset()
        clear_lp_caches(package)
        random.seed(0)
        np.random.seed(0)
        mp = pytest.MonkeyPatch()
        if package == "karpenter_tpu" and self.ref_setup is not None:
            self.ref_setup(mp)
        teardown = []
        try:
            call_args = self._fixtures(mod, fn, args, mp, request, teardown)
            if cls is not None:
                inst = cls()
                if hasattr(inst, "setup_method"):
                    inst.setup_method(fn)
                getattr(inst, fn_name)(**call_args)
                if hasattr(inst, "teardown_method"):
                    inst.teardown_method(fn)
            else:
                fn(**call_args)
        finally:
            for gen in reversed(teardown):
                next(gen, None)
            mp.undo()
            mod.__dict__["__obs__"] = None
        return obs

    def _fixtures(self, mod, fn, args, mp, request, teardown):
        params = [p for p in inspect.signature(fn).parameters if p != "self"]
        out = {}
        for p in params:
            if p in args:
                out[p] = args[p]
            elif p == "monkeypatch":
                out[p] = mp
            elif p == "tmp_path":
                out[p] = request.getfixturevalue("tmp_path_factory").mktemp(
                    "case")
            elif _fixture_fn(getattr(mod, p, None)) is None:
                out[p] = request.getfixturevalue(p)
                if p == "caplog":
                    out[p].clear()       # each package's records its own
            else:
                fx = _fixture_fn(getattr(mod, p))
                v = fx(**self._fixtures(mod, fx, {}, mp, request, teardown))
                if inspect.isgenerator(v):
                    teardown.append(v)
                    v = next(v)
                out[p] = v
        return out

    def both(self, case_id, request):
        """The case on each package; the observations must be equal."""
        ref = self.run("karpenter_tpu", case_id, request)
        with port_on_cpu():
            port = self.run("karpenter_tpu_torch", case_id, request)
        if ref != port:
            at = next((i for i, (a, b) in enumerate(zip(ref, port)) if a != b),
                      min(len(ref), len(port)))
            raise AssertionError(
                f"{self.suite}::{case_id}: observation {at} of "
                f"{len(ref)} / {len(port)} differs: reference "
                f"{ref[at] if at < len(ref) else '<none>'!r}, port "
                f"{port[at] if at < len(port) else '<none>'!r}")
        return port


# ---------------------------------------------------------------------------
# either package's modules, for the parity cases written in the port's tests
# ---------------------------------------------------------------------------

def package(name, **modules):
    """A namespace of `name`'s modules: attribute → module path under it."""
    return types.SimpleNamespace(name=name, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in modules.items()})


@pytest.fixture(autouse=True)
def obs_disarmed():
    """Both packages' incident bus and cost ledger (process globals)
    disarmed around each case, as tests/test_incidents.py's and
    test_slo.py's own autouse fixtures do; active in a test module that
    imports it."""
    mods = [importlib.import_module(f"{name}.obs")
            for name in ("karpenter_tpu", "karpenter_tpu_torch")]

    def disarm():
        for m in mods:
            m.BUS.disarm()
            m.LEDGER.disarm()
    disarm()
    yield
    disarm()


def four_types(m):
    """tests/helpers.py's small_catalog, built from package `m`'s catalog
    module (on-demand in zones a and b)."""
    ct = importlib.import_module(f"{m.name}.catalog")
    out = []
    for name, cpu, mem, price in (("a.small", 2, 4, 0.10),
                                  ("a.medium", 4, 8, 0.20),
                                  ("a.large", 8, 16, 0.40),
                                  ("a.xlarge", 16, 32, 0.80)):
        info = ct.InstanceTypeInfo(name=name, cpu_m=cpu * 1000,
                                   memory_bytes=mem * ct.GiB, arch="amd64")
        out.append(ct.new_instance_type(info, [
            ct.Offering(z, "on-demand", price) for z in ("zone-a", "zone-b")]))
    return out
