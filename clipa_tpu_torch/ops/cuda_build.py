"""Builds the package's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
``nvcc`` into ``clipa_tpu_torch/build/<stem>-<hash>.so`` (the hash covers the
source, the csrc headers it includes and the flags, so an edited source or
header rebuilds), then loaded with
``ctypes``. Nothing here runs at import time: a module that owns a kernel
calls :func:`load_library` from the function that launches it. A missing
``nvcc`` or a failed compile raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

# --split-compile=0: the device code's optimisation and ptxas run on every
# core (fused_attention_bwd.cu instantiates some hundred kernels)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--split-compile=0", "-shared", "-Xcompiler", "-fPIC")

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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(source: str) -> list[str]:
    """csrc/`source` and the csrc headers it includes with #include "...",
    transitively, each once, in the order first reached."""
    seen, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.append(name)
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return seen


def library_path(source: str) -> str:
    """Path of the shared library built from csrc/`source`; the hash covers
    the source, the csrc headers it includes and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _sources(source):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
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


def load_entries(source: str, entries, argtypes) -> ctypes.CDLL:
    """:func:`load_library`, with the C entry points named in `entries`
    typed as ``int f(*argtypes)`` and ``clipa_cuda_error_string`` (which
    every source exports) as ``const char* f(int)``."""
    lib = load_library(source)
    if lib.clipa_cuda_error_string.argtypes is None:
        for entry in entries:
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_int
            fn.argtypes = list(argtypes)
        lib.clipa_cuda_error_string.restype = ctypes.c_char_p
        lib.clipa_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    """Raises if an entry point returned a cudaError_t other than 0."""
    if err:
        raise RuntimeError(
            f"{what} launch failed: "
            f"{lib.clipa_cuda_error_string(err).decode()} (cudaError {err})")
