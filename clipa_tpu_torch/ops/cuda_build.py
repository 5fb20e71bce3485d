"""Builds the package's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
``nvcc`` into ``clipa_tpu_torch/build/<stem>-<hash>.so`` (the hash covers the
source and the flags, so an edited source rebuilds), then loaded with
``ctypes``. Nothing here runs at import time: a module that owns a kernel
calls :func:`load_library` from the function that launches it. A missing
``nvcc`` or a failed compile raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# One lock per source: different sources build in parallel (one nvcc each).
_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# Per source: seconds nvcc took in this process (0.0: a cached .so was used).
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or NVCC); the CUDA "
                       "kernels are built from clipa_tpu_torch/csrc at first "
                       "use")


def library_path(source: str) -> str:
    """Path of the shared library built from csrc/`source`."""
    src = os.path.join(CSRC_DIR, source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def load_library(source: str) -> ctypes.CDLL:
    """Compiles csrc/`source` if its hashed library is missing, loads it.
    Thread-safe; calls for different sources build concurrently."""
    with _locks_guard:
        lock = _locks.setdefault(source, threading.Lock())
    with lock:
        if source in _libs:
            return _libs[source]
        out = library_path(source)
        if os.path.exists(out):
            build_seconds[source] = 0.0
        else:
            nvcc = _nvcc()
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, source)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                os.remove(tmp)
                raise RuntimeError(
                    f"nvcc failed on {source} (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)  # atomic: concurrent builds agree
            build_seconds[source] = seconds
        lib = ctypes.CDLL(out)
        _libs[source] = lib
        return lib
