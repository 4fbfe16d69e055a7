"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``build/repro_torch_kernels/lib<name>-<digest>.so`` at the
repository root, at first use.  The digest covers the source, every
``csrc`` header it includes (``#include "x.cuh"``, followed through the
headers) and the flags, so an edited source or header never loads a stale
library.  ``build`` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module of the
port, and a machine without a GPU usually has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("flash_attention", "fused_add_rmsnorm", "flash_decode", "rmsnorm",
           "ssd_scan", "add", "flash_attention_bwd", "fused_add_rmsnorm_bwd")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME`` (as ``torch.utils.cpp_extension`` finds
    it), else from ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME
    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("repro_torch kernels: nvcc not found (set "
                           "CUDA_HOME or put nvcc on PATH)")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources_of(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every local header it includes, directly or
    through another header, each once, in the order first reached."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha1()
    for path in sources_of(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, dict]:
    """Compile every source in ``names`` that has no current library, one
    ``nvcc`` process each, started together.  Returns, per source, the
    seconds its build took (0 when it was current) and the compiler's
    register/shared-memory report.  Raises with the compiler's output if
    any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    out: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            out[name] = {"seconds": 0.0, "log": "", "path": str(target)}
            continue
        nvcc = nvcc or nvcc_path()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed: List[str] = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode})\n{log}")
            continue
        os.replace(tmp, target)         # atomic: never a torn library
        out[name] = {"seconds": seconds, "log": log, "path": str(target)}
    if failed:
        raise RuntimeError("repro_torch kernel build failed:\n"
                           + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str,
          codes: Optional[Dict[int, str]] = None) -> None:
    """Raise unless a launch returned 0 (its ``cudaGetLastError``)."""
    if rc == 0:
        return
    if rc < 0:
        msg = (codes or {}).get(rc, "unsupported argument")
    else:
        msg = lib.repro_cuda_error_string(rc).decode()
    raise RuntimeError(f"{what}: kernel launch failed ({rc}): {msg}")
