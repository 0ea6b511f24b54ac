"""torch-hotpath checker family (JH*): the port's counterpart of the JAX
package's `analysis/jaxhot.py`.

The port's solver hot path is eager PyTorch around hand-written CUDA
kernels: `ops/*_kernels.py` wraps each launch, and `ops/` and `parallel/`
feed and decode them.  A launch is asynchronous; a host read of a device
tensor is not.  Each such read stalls the host until the stream drains,
and it rots the same quiet way the reference's tracer leaks do.  The rules
keep the meaning of the reference's ids where it carries over:

  * JH001 — `.item()` in a hot module (`ops/`, `parallel/`): a
    host-device sync per scalar; decode once, at the host boundary.
  * JH002 — `torch.cuda.synchronize()`, or an event's or stream's
    `.synchronize()`, anywhere in the package: timing barriers belong to
    the measurement scripts and the tests, outside it.
  * JH003 — a Python `if`/`while` whose test is a tensor value in a hot
    module: `bool(tensor)` is an implicit sync (where the reference's
    rule catches a branch on a tracer inside jit).
  * JH006 — `float()`/`int()`/`bool()`/`np.asarray()`/`np.array()` of a
    tensor inside an `ops/*_kernels.py` wrapper (a function that launches
    through the kernel library, `_lib()`), outside its decode boundary
    (its `return` statements).

JH004 (non-literal static_argnums / static_argnames) and JH005 (jit
scratch buffers without donation) check a `jax.jit` spec.  Eager PyTorch
has no such spec: a wrapper takes its sizes as plain host ints and
allocates the buffers it writes.  So neither rule has a meaning here, and
the port's catalog leaves both out.

Which names hold tensors is inferred per function, lexically: parameters
annotated `torch.Tensor`, and names bound to a `torch.<fn>(...)` call, to
a tensor's method, subscript or arithmetic, or to another tensor name.
Host metadata (`.shape`, `.dtype`, `.device`, `.numel()`, ...) is never a
tensor value.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from .core import Checker, Finding, SourceFile, rule

rule("JH001", "torch-hotpath",
     ".item() host-device sync in a hot-path module",
     "keep the value on the device; decode once at the host boundary "
     "with one .cpu() / .tolist() over the whole result batch")
rule("JH002", "torch-hotpath",
     "torch.cuda / event / stream .synchronize() inside the package",
     "remove it — only the measurement scripts need an explicit barrier; "
     "the decode's copy to the host is already a sync point")
rule("JH003", "torch-hotpath",
     "Python branch on a tensor value in a hot-path module",
     "branch on host data (sizes, flags), or keep the choice on the "
     "device with torch.where; `if tensor:` copies it to the host")
rule("JH006", "torch-hotpath",
     "host conversion (float/int/bool/np.asarray) of a tensor inside a "
     "kernel wrapper",
     "move the conversion to the wrapper's return (its decode boundary) "
     "or to the caller's decode; before or between launches it stalls "
     "the stream")

HOT_PREFIXES = ("karpenter_tpu_torch/ops/", "karpenter_tpu_torch/parallel/")
KERNEL_MODULE_PREFIX = "karpenter_tpu_torch/ops/"
KERNEL_MODULE_SUFFIX = "_kernels.py"
_HOST_CONVERTERS = {"float", "int", "bool"}
_NP_CONVERTERS = {"asarray", "array"}
# torch.<fn> calls that return no tensor
_TORCH_NON_TENSOR = {"device", "dtype", "Size", "is_tensor", "numel",
                     "is_floating_point", "is_complex", "get_default_dtype",
                     "set_default_dtype", "no_grad", "inference_mode",
                     "enable_grad", "set_grad_enabled", "is_grad_enabled",
                     "manual_seed", "Generator", "finfo", "iinfo",
                     "compile", "load", "save", "get_num_threads",
                     "set_num_threads", "result_type", "promote_types",
                     "can_cast", "is_nonzero"}
# tensor methods and attributes that return host data
_HOST_METHODS = {"item", "tolist", "numpy", "size", "dim", "numel",
                 "nelement", "element_size", "data_ptr", "is_contiguous",
                 "stride", "storage_offset", "get_device",
                 "is_floating_point", "is_complex", "untyped_storage"}
_HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "requires_grad", "itemsize", "nbytes"}


def _is_tensor_annotation(node: Optional[ast.AST]) -> bool:
    if node is None:
        return False
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr == "Tensor":
            return True
        if isinstance(n, ast.Name) and n.id == "Tensor":
            return True
        if isinstance(n, ast.Constant) and isinstance(n.value, str) and \
                "Tensor" in n.value:
            return True
    return False


def is_tensor_expr(node: ast.AST, known: Set[str]) -> bool:
    """Whether `node` evaluates to a tensor, by the module's rules."""
    if isinstance(node, ast.Name):
        return node.id in known
    if isinstance(node, ast.Subscript):
        return is_tensor_expr(node.value, known)
    if isinstance(node, ast.Attribute):
        if node.attr in _HOST_ATTRS:
            return False
        return node.attr in ("T", "mT", "real", "imag") and \
            is_tensor_expr(node.value, known)
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name) and f.value.id == "torch":
                return f.attr not in _TORCH_NON_TENSOR
            if f.attr in _HOST_METHODS:
                return False
            return is_tensor_expr(f.value, known)
        return False
    if isinstance(node, ast.BinOp):
        return is_tensor_expr(node.left, known) or \
            is_tensor_expr(node.right, known)
    if isinstance(node, ast.UnaryOp):
        return not isinstance(node.op, ast.Not) and \
            is_tensor_expr(node.operand, known)
    if isinstance(node, ast.Compare):
        if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
               for op in node.ops):
            return False
        return any(is_tensor_expr(e, known)
                   for e in [node.left] + node.comparators)
    if isinstance(node, ast.IfExp):
        return is_tensor_expr(node.body, known) or \
            is_tensor_expr(node.orelse, known)
    return False


def tensor_names(fn: ast.AST) -> Set[str]:
    """Names bound to tensors anywhere in `fn`.  Two passes, so a rebind
    of an already-known tensor name resolves (as determinism.py's set
    names do)."""
    known: Set[str] = set()
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        args = fn.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if _is_tensor_annotation(a.annotation):
                known.add(a.arg)
    for _ in range(2):
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and \
                            is_tensor_expr(node.value, known):
                        known.add(tgt.id)
                    elif isinstance(tgt, ast.Tuple) and \
                            isinstance(node.value, ast.Tuple) and \
                            len(tgt.elts) == len(node.value.elts):
                        for t, v in zip(tgt.elts, node.value.elts):
                            if isinstance(t, ast.Name) and \
                                    is_tensor_expr(v, known):
                                known.add(t.id)
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                if _is_tensor_annotation(node.annotation) or (
                        node.value is not None and
                        is_tensor_expr(node.value, known)):
                    known.add(node.target.id)
            elif isinstance(node, ast.AugAssign) and \
                    isinstance(node.target, ast.Name) and \
                    is_tensor_expr(node.value, known):
                known.add(node.target.id)
    return known


def _truth_is_tensor(test: ast.AST, known: Set[str]) -> bool:
    """Whether taking `test`'s truth value reads a tensor."""
    if isinstance(test, ast.BoolOp):
        return any(_truth_is_tensor(v, known) for v in test.values)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _truth_is_tensor(test.operand, known)
    return is_tensor_expr(test, known)


def _launches(fn: ast.AST) -> bool:
    """A kernel wrapper: its body calls the kernel library, `_lib()`."""
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and
               n.func.id == "_lib" for n in ast.walk(fn))


def _functions(tree: ast.AST) -> List[ast.FunctionDef]:
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _own_nodes(fn: ast.AST):
    """The nodes of `fn`'s body, not those of functions nested in it."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


class TorchHotPathChecker(Checker):
    family = "torch-hotpath"

    def check_file(self, sf: SourceFile) -> List[Finding]:
        findings: List[Finding] = []
        hot = sf.rel.startswith(HOT_PREFIXES)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                if hot and node.func.attr == "item" and not node.args:
                    findings.append(Finding(
                        "JH001", sf.rel, node.lineno, sf.scope_of(node),
                        "item", ".item() forces a host-device sync"))
                if node.func.attr == "synchronize":
                    findings.append(Finding(
                        "JH002", sf.rel, node.lineno, sf.scope_of(node),
                        "synchronize",
                        ".synchronize() barrier inside the package"))
        if hot:
            findings.extend(self._check_branches(sf))
        if sf.rel.startswith(KERNEL_MODULE_PREFIX) and \
                sf.rel.endswith(KERNEL_MODULE_SUFFIX):
            findings.extend(self._check_wrappers(sf))
        return findings

    def _check_branches(self, sf: SourceFile) -> List[Finding]:
        """JH003: `if`/`while` on a tensor value, in each function."""
        findings: List[Finding] = []
        for fn in _functions(sf.tree):
            known = tensor_names(fn)
            for node in _own_nodes(fn):
                if isinstance(node, (ast.If, ast.While)) and \
                        _truth_is_tensor(node.test, known):
                    findings.append(Finding(
                        "JH003", sf.rel, node.lineno, sf.scope_of(node),
                        ast.unparse(node.test)[:60],
                        f"branch on a tensor value inside {fn.name}: "
                        "an implicit host-device sync"))
        return findings

    def _check_wrappers(self, sf: SourceFile) -> List[Finding]:
        """JH006: host conversion of a tensor in a wrapper, outside its
        return statements."""
        findings: List[Finding] = []
        parents = sf.parents()
        for fn in _functions(sf.tree):
            if not _launches(fn):
                continue
            known = tensor_names(fn)
            for node in _own_nodes(fn):
                if not (isinstance(node, ast.Call) and node.args and
                        is_tensor_expr(node.args[0], known)):
                    continue
                f = node.func
                if isinstance(f, ast.Name) and f.id in _HOST_CONVERTERS:
                    conv = f.id
                elif isinstance(f, ast.Attribute) and \
                        f.attr in _NP_CONVERTERS and \
                        isinstance(f.value, ast.Name) and \
                        f.value.id in ("np", "numpy"):
                    conv = f"np.{f.attr}"
                else:
                    continue
                if self._in_return(node, fn, parents):
                    continue
                arg = ast.unparse(node.args[0])[:40]
                findings.append(Finding(
                    "JH006", sf.rel, node.lineno, sf.scope_of(node),
                    f"{conv}:{arg}",
                    f"{conv}({arg}) copies a tensor to the host inside "
                    f"kernel wrapper {fn.name}"))
        return findings

    @staticmethod
    def _in_return(node: ast.AST, fn: ast.AST, parents) -> bool:
        cur = parents.get(node)
        while cur is not None and cur is not fn:
            if isinstance(cur, ast.Return):
                return True
            cur = parents.get(cur)
        return False
