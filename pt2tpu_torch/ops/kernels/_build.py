"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first use
into ``build/kernels/`` at the root of the checkout (listed in .gitignore):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and of the sources it includes
from ``csrc/`` (``#include "<file>"``), so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

__all__ = ["CSRC_DIR", "BUILD_DIR", "build", "load"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _digest(src: str) -> str:
    """A hash of ``src`` and, in turn, of every ``csrc/`` file it includes."""
    h, todo, seen = hashlib.sha256(), [src], set()
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        h.update(text)
        for inc in re.findall(rb'^#include "([^"]+)"', text, re.M):
            todo.append(os.path.join(CSRC_DIR, inc.decode()))
    return h.hexdigest()[:12]


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` (if not built yet) and return the .so path."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    digest = _digest(src)
    so = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src,
    ]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src} (exit {res.returncode}):\n{res.stderr}"
        )
    os.replace(tmp, so)
    with open(so + ".log", "w") as f:
        f.write(f"{' '.join(cmd)}\nbuilt in {time.perf_counter() - t0:.1f} s\n")
        f.write(res.stdout + res.stderr)
    return so


def load(name: str) -> ctypes.CDLL:
    """Build (once per process) and load ``csrc/<name>.cu``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib
