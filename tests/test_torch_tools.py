"""The root tools on both packages, and the port's deployment manifest.

- `tools/{simcheck,gendocs,allocatable_diff,convert}.py` (the JAX
  package's, loaded by path) and `karpenter_tpu_torch.tools.*` run in
  process on the same inputs, as their scripts would run: the same stdout
  byte for byte, the same exit code and the same last line of stderr.
  The one difference allowed is the command gendocs' header names.
- Each port tool runs as `python -m karpenter_tpu_torch.tools.<name>` in a
  process with `jax`, `jaxlib` and `karpenter_tpu` blocked: the reference's
  output, no such module loaded, and neither torch nor a kernel library
  nor the native packer loaded (the tools are host code).
- `workloads.GOLDEN_TOOLS`, which `chip_smoke.py` phase 22 checks on the
  card's host, is what the reference tools give on `workloads.tool_cases`.
- deploy/karpenter-tpu-torch.yaml is deploy/karpenter-tpu.yaml but for the
  fields a GPU deployment of the port changes.
"""

import contextlib
import copy
import importlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import traceback

import pytest
import yaml

from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.api.resources import MEMORY, parse_quantity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = os.path.join(REPO, "scenarios")
TOOLS = ("simcheck", "gendocs", "allocatable_diff", "convert")
REF_HEADER = "`tools/gendocs.py`"
PORT_HEADER = "`python -m karpenter_tpu_torch.tools.gendocs`"


def _load_ref(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path      # the reference's sys.path.insert
    return mod


def ref_main(name):
    """The reference tool's `main` as a function of argv (its gendocs
    reads `sys.argv`)."""
    main = _load_ref(name).main
    if name != "gendocs":
        return main

    def with_argv(argv):
        saved = sys.argv
        sys.argv = ["gendocs.py", *argv]
        try:
            return main()
        finally:
            sys.argv = saved
    return with_argv


def port_main(name):
    return importlib.import_module(f"karpenter_tpu_torch.tools.{name}").main


def run(main, argv, stdin=""):
    """`main(argv)` as its script would run it: (exit code, stdout, last
    line of stderr).  An exception ends it as the interpreter would: exit
    1, the exception's own line last on stderr."""
    out, err = io.StringIO(), io.StringIO()
    saved = sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = main(argv)
            except SystemExit as e:
                rc = e.code
            except Exception as e:
                print(traceback.format_exception_only(type(e), e)[-1],
                      end="", file=sys.stderr)
                rc = 1
    finally:
        sys.stdin = saved
    lines = err.getvalue().strip().splitlines()
    return rc, out.getvalue(), lines[-1] if lines else ""


def both(name, argv, stdin=""):
    """The reference's and the port's runs, gendocs' header read as the
    port's."""
    want = run(ref_main(name), argv, stdin)
    got = run(port_main(name), argv, stdin)
    if name == "gendocs":
        want = (want[0], want[1].replace(REF_HEADER, PORT_HEADER), want[2])
    return want, got


@pytest.fixture
def tool_files(tmp_path):
    """`workloads.TOOLS_OBSERVED` and `LEGACY_DOCS` written as YAML, as
    chip_smoke.py's phase 22 writes them: (observed, legacy)."""
    observed, legacy = tmp_path / "observed.yaml", tmp_path / "legacy.yaml"
    observed.write_text(yaml.safe_dump(workloads.TOOLS_OBSERVED))
    legacy.write_text(yaml.safe_dump_all(workloads.LEGACY_DOCS))
    return str(observed), str(legacy)


# ---------------------------------------------------------------------------
# the tools against the reference's, in process
# ---------------------------------------------------------------------------

SCENARIO_FILES = sorted(f for f in os.listdir(SCENARIOS) if f.endswith(".yaml"))
BAD_SCENARIO = "name: bad\nworkload: []\n"      # tests/test_sim.py's
SIMCHECK_CASES = [[f] for f in SCENARIO_FILES] + [
    ["diurnal.yaml", "--seed", "1"], ["bad.yaml"]]


@pytest.mark.parametrize("args", SIMCHECK_CASES,
                         ids=[" ".join(a) for a in SIMCHECK_CASES])
def test_simcheck_matches_the_reference(args, tmp_path):
    if args[0] == "bad.yaml":
        path = tmp_path / "bad.yaml"
        path.write_text(BAD_SCENARIO)
    else:
        path = os.path.join(SCENARIOS, args[0])
    want, got = both("simcheck", [str(path), *args[1:]])
    assert got == want
    if args[0] == "bad.yaml":
        assert got[0] == 2 and got[2].startswith("INVALID: ")
        assert got[1] == ""
    else:
        assert got[0] == 0 and "valid: yes" in got[1]


GENDOCS_CASES = [["--types", "6"], ["--types", "1000"],
                 ["--types", "6", "--out"]]


@pytest.mark.parametrize("args", GENDOCS_CASES,
                         ids=[" ".join(a) for a in GENDOCS_CASES])
def test_gendocs_matches_the_reference(args, tmp_path):
    if args[-1] == "--out":
        ref_out, port_out = tmp_path / "ref.md", tmp_path / "port.md"
        want = run(ref_main("gendocs"), [*args, str(ref_out)])
        got = run(port_main("gendocs"), [*args, str(port_out)])
        assert got == want == (0, "", "")
        page = port_out.read_text()
        assert page == ref_out.read_text().replace(REF_HEADER, PORT_HEADER)
    else:
        want, got = both("gendocs", args)
        assert got == want and got[0] == 0
        page = got[1]
    assert page.count(PORT_HEADER) == 1 and REF_HEADER not in page
    n = int(args[1])
    assert page.count("\n### `") == min(n, 703)


ALLOC_CASES = [[], ["--catalog-size", "1000"],
               ["--types", "m5.large,c5.xlarge"],
               ["--catalog-size", "1000", "--observed"],
               ["--catalog-size", "1000", "--types", "m5.large,c5.xlarge",
                "--observed"]]


@pytest.mark.parametrize("args", ALLOC_CASES,
                         ids=[" ".join(a) or "default" for a in ALLOC_CASES])
def test_allocatable_diff_matches_the_reference(args, tool_files):
    observed = args[-1:] == ["--observed"]
    argv = [*args, tool_files[0]] if observed else args
    want, got = both("allocatable_diff", argv)
    assert got == want
    rows = json.loads(got[1])
    if observed:
        # m5.large as the model predicts it, c5.xlarge 80m of cpu over it
        assert got[0] == 1 and got[2] == "MISMATCH: ['c5.xlarge']"
        diffs = {r["type"]: r["diff"] for r in rows if "diff" in r}
        assert diffs["m5.large"]["cpu_ok"] and diffs["m5.large"]["memory_ok"]
        assert diffs["c5.xlarge"] == {"cpu": "-80m", "memory": "0",
                                      "cpu_ok": False, "memory_ok": True}
    else:
        assert got[0] == 0 and got[2] == ""
        assert all("diff" not in r for r in rows)


DEPLOYMENT = {"apiVersion": "apps/v1", "kind": "Deployment",
              "metadata": {"name": "web"}}
CONVERT_CASES = ["legacy", "deployment", "deployment --ignore-unknown",
                 "mixed --ignore-unknown", "legacy -o", "legacy stdin"]


@pytest.mark.parametrize("case", CONVERT_CASES)
def test_convert_matches_the_reference(case, tool_files, tmp_path):
    docs = {"legacy": workloads.LEGACY_DOCS, "deployment": [DEPLOYMENT],
            "mixed": [*workloads.LEGACY_DOCS, DEPLOYMENT]}[case.split()[0]]
    src = tmp_path / "in.yaml"
    src.write_text(yaml.safe_dump_all(docs))
    flags = ["--ignore-unknown"] if "--ignore-unknown" in case else []
    if case.endswith("stdin"):
        want, got = both("convert", flags, stdin=src.read_text())
    elif case.endswith("-o"):
        ref_out, port_out = tmp_path / "ref.yaml", tmp_path / "port.yaml"
        want = run(ref_main("convert"), ["-f", str(src), "-o", str(ref_out)])
        got = run(port_main("convert"), ["-f", str(src), "-o", str(port_out)])
        assert got == want == (0, "", "")
        assert port_out.read_text() == ref_out.read_text()
        want = got = (0, port_out.read_text(), "")
    else:
        want, got = both("convert", ["-f", str(src), *flags])
    assert got == want
    if case == "deployment":
        assert got == (1, "", "ValueError: cannot convert kind 'Deployment'")
        return
    kinds = [d["kind"] for d in yaml.safe_load_all(got[1])]
    assert kinds == {"legacy": ["NodePool", "NodeClass"],
                     "deployment": ["Deployment"],
                     "mixed": ["NodePool", "NodeClass", "Deployment"]}[
                         case.split()[0]]


# ---------------------------------------------------------------------------
# `python -m`, with the JAX package blocked
# ---------------------------------------------------------------------------

_NO_JAX = r"""
import importlib.abc, runpy, sys

class Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "karpenter_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Blocked())
name = sys.argv[1]
sys.argv = [name, *sys.argv[2:]]
try:
    runpy.run_module(f"karpenter_tpu_torch.tools.{name}", run_name="__main__",
                     alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "karpenter_tpu"))
torch = sys.modules.get("torch")
build = sys.modules.get("karpenter_tpu_torch._build")
native = sys.modules.get("karpenter_tpu_torch.native")
print("RC", rc, "LEAKED", leaked, "TORCH", torch is not None,
      "CUDA", bool(torch and torch.cuda.is_initialized()),
      "LIBS", sorted(build._LIBS) if build else [],
      "NATIVE", native._lib if native else None, file=sys.stderr)
"""

M_CASES = {
    "simcheck": ["scenarios/diurnal.yaml"],
    "gendocs": ["--types", "6"],
    "allocatable_diff": ["--types", "m5.large,c5.xlarge"],
    "convert": ["-f", "legacy.yaml"],
}


@pytest.mark.parametrize("name", TOOLS)
def test_tool_runs_as_a_module_without_jax(name, tool_files):
    args = [os.path.basename(tool_files[1]) if a == "legacy.yaml" else a
            for a in M_CASES[name]]
    cwd = os.path.dirname(tool_files[1]) if name == "convert" else REPO
    p = subprocess.run([sys.executable, "-c", _NO_JAX, name, *args],
                       cwd=cwd, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": REPO})
    report = p.stderr.strip().splitlines()[-1]
    assert p.returncode == 0, p.stderr[-2000:]
    assert report == ("RC 0 LEAKED [] TORCH False CUDA False LIBS [] "
                      "NATIVE None"), \
        p.stderr[-2000:]
    if name == "convert":
        args = ["-f", tool_files[1]]
    elif name == "simcheck":
        args = [os.path.join(REPO, args[0])]
    want, _ = both(name, args)
    assert (0, p.stdout) == want[:2]


# ---------------------------------------------------------------------------
# GOLDEN_TOOLS
# ---------------------------------------------------------------------------

def test_tool_cases_cover_the_golden():
    cases = workloads.tool_cases(SCENARIOS, "observed.yaml", "legacy.yaml")
    assert [key for key, _, _ in cases] == list(workloads.GOLDEN_TOOLS)
    # every scenario but long-soak.yaml, whose expansion alone takes 14-17 s
    # of host: the in-process cases above run it
    assert list(workloads.TOOLS_SCENARIOS) == [
        f for f in SCENARIO_FILES if f != "long-soak.yaml"]


def test_legacy_docs_are_test_serialize_s():
    spec = importlib.util.spec_from_file_location(
        "_ref_test_serialize", os.path.join(REPO, "tests", "test_serialize.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    legacy = mod.TestLegacyConversion
    assert workloads.LEGACY_DOCS == [legacy.PROVISIONER, legacy.NODE_TEMPLATE]


@pytest.mark.parametrize("key", list(workloads.GOLDEN_TOOLS))
def test_golden_tools_are_the_reference_tools_digests(key, tool_files):
    """Each GOLDEN_TOOLS entry is what the reference's tool gives (the
    cases above hold the port's to the reference's on these inputs)."""
    cases = {k: (tool, argv) for k, tool, argv in
             workloads.tool_cases(SCENARIOS, *tool_files)}
    tool, argv = cases[key]
    rc, out, last = run(ref_main(tool), argv)
    out = out.replace(REF_HEADER, PORT_HEADER)
    assert (rc, workloads.tool_digest(tool, out), last) == \
        workloads.GOLDEN_TOOLS[key]


# ---------------------------------------------------------------------------
# deploy/karpenter-tpu-torch.yaml
# ---------------------------------------------------------------------------

def _manifest(name):
    with open(os.path.join(REPO, "deploy", name)) as f:
        text = f.read()
    return text, [d for d in yaml.safe_load_all(text) if d]


def _controller(docs):
    dep = next(d for d in docs if d["kind"] == "Deployment")
    return dep, dep["spec"]["template"]["spec"]


def test_port_manifest_differs_from_the_reference_only_where_listed():
    _, ref = _manifest("karpenter-tpu.yaml")
    text, port = _manifest("karpenter-tpu-torch.yaml")
    want = copy.deepcopy(ref)
    _, pod = _controller(want)
    _, port_pod = _controller(port)
    ctr, port_ctr = pod["containers"][0], port_pod["containers"][0]
    assert "karpenter-tpu-torch" in port_ctr["image"]
    ctr["image"] = port_ctr["image"]
    ctr["command"] = ["python", "-m", "karpenter_tpu_torch"]
    ctr["resources"]["limits"]["nvidia.com/gpu"] = 1
    ctr["resources"]["limits"]["memory"] = \
        port_ctr["resources"]["limits"]["memory"]
    pod["tolerations"].append({"key": "nvidia.com/gpu", "operator": "Exists",
                               "effect": "NoSchedule"})
    assert port == want
    # the HA pair, the PDB and the anti-affinity are the reference's
    dep, _ = _controller(port)
    assert dep["spec"]["replicas"] == 2
    assert any(d["kind"] == "PodDisruptionBudget" for d in port)
    assert "podAntiAffinity" in port_pod["affinity"]
    assert re.search(r"#.*standby.*holds its card while idle", text)


def test_port_manifest_memory_limit_covers_the_measured_peak():
    """The memory limit is at least 1.5x the operator process's peak RSS
    that the manifest cites (chip_smoke.py's `[deploy]` line), with the
    card's name and power limit."""
    text, port = _manifest("karpenter-tpu-torch.yaml")
    m = re.search(r"peak RSS ([\d.]+) MiB \(chip_smoke\.py \[deploy\], "
                  r"NVIDIA [^,]+, [\d.]+ W", text)
    assert m, "the manifest cites no measured peak RSS"
    _, pod = _controller(port)
    limit = pod["containers"][0]["resources"]["limits"]["memory"]
    assert parse_quantity(limit, MEMORY) >= 1.5 * float(m.group(1)) * 2**20
