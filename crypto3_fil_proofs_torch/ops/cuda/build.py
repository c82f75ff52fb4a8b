"""Build the CUDA kernels of csrc/ with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes `build/torch_kernels/lib<name>.so`, a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). A library is rebuilt when it is older than any source in
csrc/. Builds run in parallel, one nvcc per source, and a failed build
raises with nvcc's error output.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

from ... import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "csrc")
OUT_DIR = os.path.join(BUILD_DIR, "torch_kernels")
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas' register / spill report of each library built by this process
ptxas_reports: dict[str, str] = {}


def sources() -> list[str]:
    """Kernel names: one per csrc/*.cu."""
    return sorted(os.path.splitext(os.path.basename(p))[0] for p in glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    return os.path.join(OUT_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    so = _lib_path(name)
    if not os.path.exists(so):
        return True
    newest = max(os.path.getmtime(p) for p in glob.glob(os.path.join(CSRC, "*.cu*")))
    return os.path.getmtime(so) < newest


def build(names: list[str] | None = None) -> None:
    """Compile the named kernels (all by default) that are missing or
    stale, all nvcc processes at once."""
    names = sources() if names is None else names
    todo = [n for n in names if _stale(n)]
    if not todo:
        return
    nvcc = _nvcc()
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = []
    for name in todo:
        tmp = f"{_lib_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )))
    errors = []
    for name, tmp, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{err}{out}")
            continue
        ptxas_reports[name] = err + out
        os.replace(tmp, _lib_path(name))  # atomic publish
    if errors:
        raise RuntimeError("\n".join(errors))


def count(launches: dict, key) -> None:
    """One more launch of `key` in a wrapper's counter dict; exact when
    several threads launch at once (a mesh's shards, prove_many)."""
    with _count_lock:
        launches[key] += 1


def load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib
