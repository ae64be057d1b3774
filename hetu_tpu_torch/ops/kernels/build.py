"""Build the port's CUDA sources with ``nvcc`` at first use.

Each source under ``hetu_tpu_torch/csrc/`` exposes a plain C interface and
is compiled for Hopper (``sm_90a``) into a shared library under
``hetu_tpu_torch/_build/``, loaded with ``ctypes``.  The library's file
name carries a hash of the source, so an edited source is rebuilt and a
stale library is never loaded.  A C interface keeps PyTorch's headers out
of the build: such a file compiles in seconds, where one including
``torch/extension.h`` takes minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]

_libs = {}
_lock = threading.Lock()


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found at {path}: the port's CUDA kernels build on a "
            "machine with the CUDA toolkit (set CUDA_HOME)")
    return path


def library_path(source: str) -> str:
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def build(source: str) -> str:
    """Compile ``csrc/<source>`` unless its library exists; returns the
    library path.  The compiler's report (registers, shared memory,
    spills) is kept beside it as ``<library>.log``."""
    out = library_path(source)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(f"{out}.log", "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(build(source))
        return lib
