"""Build and load the package's CUDA sources as plain-C shared libraries.

Each ``csrc/*.cu`` is compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/kernels/`` at the repository root (named by a hash of the
source and flags, so an edited source rebuilds) and loaded with ``ctypes``.
Nothing here runs at import time; on a machine without ``nvcc`` the build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

# name -> loaded library; ctypes handles live as long as the process.
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(source: str) -> str:
    path = os.path.join(CSRC_DIR, source)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def compile_command(source: str, out: str, extra: Optional[List[str]] = None) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, *(extra or []), "-o", out, os.path.join(CSRC_DIR, source)]


def build_all(sources: List[str], extra: Optional[List[str]] = None) -> Dict[str, dict]:
    """Compile the sources whose libraries do not exist yet, in parallel
    (one nvcc each, all started together).  Each output is written to a
    temporary name and renamed, so concurrent builders never load a
    half-written file.  Returns per-source seconds, compiler output and
    library path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.time()
    for src in sources:
        out = library_path(src)
        if os.path.exists(out):
            procs[src] = (None, out, None)
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        p = subprocess.Popen(compile_command(src, tmp, extra), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs[src] = (p, out, tmp)
    report = {}
    for src, (p, out, tmp) in procs.items():
        if p is None:
            report[src] = {"seconds": 0.0, "log": "cached", "path": out}
            continue
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        os.replace(tmp, out)
        report[src] = {"seconds": time.time() - t0, "log": log, "path": out}
    return report


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; cached per process."""
    lib = _LIBS.get(source)
    if lib is None:
        lib = ctypes.CDLL(build_all([source])[source]["path"])
        _LIBS[source] = lib
    return lib
