"""Build the CUDA sources under `csrc/` into shared libraries, at first use.

Each `csrc/<name>.cu` is compiled on its own by `nvcc` for `sm_90a` into
`build/kernels/<name>-<hash>.so` at the repository root, where the hash
covers the source and the flags, so an edited source rebuilds and an
unchanged one is reused.  All sources compile in parallel (one `nvcc` each,
started together).  The libraries have a plain C interface and are loaded
with ctypes; nothing is linked against torch, which keeps a build to
seconds.

    python -m karpenter_tpu_torch._build      # build all, print ptxas lines

Raises `KernelError` if `nvcc` is missing or fails, or a library does not
load: there is no other way to the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel of the port did not build, load or launch, or there is no
    card to run it on.  Callers with a fallback (the provisioning ladder)
    let it through: a kernel fault is never answered by work on the host."""


class KernelLimitError(KernelError, ValueError):
    """The input is past what a kernel was built for (resource axes,
    slots): a fault of the port, not of the input, so it too is no cause
    to move the work to the host."""


class KernelContractError(KernelLimitError, TypeError):
    """A kernel wrapper was given operands that break its contract (mixed
    devices, dtype, shape, layout, an empty envelope).  Only the port's own
    programs call the wrappers, so this is a fault of the port's lowering,
    and a KernelError: no ladder answers it on the host.  It is also the
    TypeError or ValueError a caller of a plain function would expect."""


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise KernelError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels of karpenter_tpu_torch are built from source with "
            "nvcc at first use")
    return nvcc


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Compile every named source (default: all of `csrc/*.cu`) that has no
    library for its current hash yet; returns name → library path.  The
    compiler's output (`-Xptxas -v`: registers, shared memory, spills) is
    kept beside each library as `<lib>.log`."""
    srcs = sorted(CSRC.glob("*.cu"))
    if names is not None:
        srcs = [s for s in srcs if s.stem in names]
    out = {s.stem: _target(s) for s in srcs}
    todo = [s for s in srcs if not out[s.stem].exists()]
    if not todo:
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for s in todo:
        tmp = out[s.stem].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for s, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{s.name}:\n{log}")
            continue
        out[s.stem].with_suffix(".so.log").write_text(log)
        os.replace(tmp, out[s.stem])   # atomic: concurrent builders agree
    if failed:
        raise KernelError("nvcc failed\n" + "\n".join(failed))
    return out


def build_log(name: str) -> str:
    """The `-Xptxas -v` output of the build that produced `name`'s library."""
    path = _target(CSRC / f"{name}.cu").with_suffix(".so.log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelError(f"cannot load {path}: {e}") from e
            _LIBS[name] = lib
    return lib


if __name__ == "__main__":
    for stem, path in build_all().items():
        print(f"{stem}: {path}")
        for line in build_log(stem).splitlines():
            if "ptxas" in line:
                print("  " + line.strip())
