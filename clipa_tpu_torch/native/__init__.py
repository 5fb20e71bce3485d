"""Native (C++) host components: JPEG decode and crop, WordPiece, TFRecord scan.

Port of ``clipa_tpu/native``: the same three sources under ``src/`` (copied;
``wordpiece.cc`` only adds a comment on who owns the output buffer) and the
same C API, bound with ctypes. A ctypes call releases the GIL for its
duration, so the pipeline's threads decode and tokenize in parallel.

The library is built at first use with

    g++ -O3 -fPIC -std=c++17 -Wall -march=native src/*.cc -shared -ljpeg

into ``clipa_tpu_torch/build/libclipa_native-<hash>.so``; the hash covers the
sources and the command, as ``ops/cuda_build.library_path``'s does, so an
edited source rebuilds, and nothing is written into the package directory.
libjpeg is the system's where its headers are installed
(``/usr/include/jpeglib.h``, as the JAX package's Makefile assumes). Where
they are not, the build links the libjpeg-turbo that Pillow's wheel bundles
(``pillow.libs/libjpeg-*.so.62*``, the libjpeg 6.2 ABI) through the 6.2-API
headers kept in ``include/`` (libjpeg-turbo 2.1.5; its licence is
``include/COPYRIGHT``). A failed build raises with g++'s output. Everything
here has a pure-Python fallback (PIL, the Python tokenizer and reader), so
the package works without a compiler.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import tempfile
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(os.path.join(_DIR, "src", f)
                for f in ("wordpiece.cc", "jpeg_decode.cc", "tfrecord.cc"))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native")
SYSTEM_HEADER = "/usr/include/jpeglib.h"

_lock = threading.Lock()
_lib = None
_build_failed = False
# Seconds g++ took for the last build in this process (0.0: a cached
# library was used); None until build() has run.
build_seconds = None


def _pillow_libjpeg() -> str:
    """The libjpeg shared object bundled in Pillow's wheel."""
    try:
        import PIL
    except ImportError as e:
        raise RuntimeError(f"no {SYSTEM_HEADER} and no Pillow: cannot "
                           f"build the native JPEG decoder") from e
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    found = sorted(glob.glob(os.path.join(libs, "libjpeg*.so.62*")))
    if not found:
        raise RuntimeError(f"no {SYSTEM_HEADER} and no libjpeg 6.2 in "
                           f"{libs}: cannot build the native JPEG decoder")
    return found[0]


def jpeg_route() -> str:
    """The libjpeg a build links: "system" where SYSTEM_HEADER exists, else
    "pillow" (Pillow's bundled libjpeg-turbo)."""
    return "system" if os.path.exists(SYSTEM_HEADER) else "pillow"


def _command(out: str) -> list:
    if jpeg_route() == "system":
        link = ["-ljpeg"]
    else:
        lib = _pillow_libjpeg()
        link = [f"-I{os.path.join(_DIR, 'include')}", lib,
                f"-Wl,-rpath,{os.path.dirname(lib)}"]
    return ["g++", *CXXFLAGS, *SOURCES, "-o", out, "-shared", *link]


def library_path() -> str:
    """Path of the library built from the sources; the hash covers the
    sources, the headers of ``include/`` and the command (the libjpeg it
    links among them)."""
    digest = hashlib.sha256(" ".join(_command("")).encode())
    headers = sorted(glob.glob(os.path.join(_DIR, "include", "*.h")))
    for path in (*SOURCES, *headers):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR,
                        f"libclipa_native-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compiles the native library if its hashed file is missing; returns
    its path. Raises RuntimeError with g++'s output on a failed build."""
    global build_seconds
    out = library_path()
    with _lock:
        if os.path.exists(out):
            build_seconds = 0.0
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = _command(tmp)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError:
            os.remove(tmp)
            raise
        if proc.returncode != 0:
            os.remove(tmp)
            raise RuntimeError(f"g++ failed on the native library (exit "
                               f"{proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)   # atomic: concurrent builds agree
        build_seconds = time.perf_counter() - t0
    return out


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Types the C entry points of a loaded library (the JAX package's
    signatures)."""
    # --- wordpiece ---
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.wp_destroy.argtypes = [ctypes.c_void_p]
    lib.wp_encode.restype = ctypes.c_int64
    lib.wp_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_int64,
                              ctypes.POINTER(ctypes.c_int32),
                              ctypes.c_int64]
    # --- jpeg ---
    lib.jpeg_info.restype = ctypes.c_int
    lib.jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                              ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_int)]
    lib.jpeg_decode_crop_resize.restype = ctypes.c_int
    lib.jpeg_decode_crop_resize.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    # --- tfrecord ---
    lib.tfr_scan.restype = ctypes.c_int64
    lib.tfr_scan.argtypes = [ctypes.c_char_p,
                             ctypes.POINTER(ctypes.c_int64),
                             ctypes.POINTER(ctypes.c_int64),
                             ctypes.c_int64, ctypes.c_int]
    lib.tfr_crc32c_masked.restype = ctypes.c_uint32
    lib.tfr_crc32c_masked.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    return lib


def load() -> ctypes.CDLL:
    """Loads (building if needed) the native library; a build that failed
    once is not retried in this process."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        raise RuntimeError("native build previously failed")
    try:
        lib = ctypes.CDLL(build())
    except (OSError, RuntimeError):
        _build_failed = True
        raise
    _lib = declare(lib)
    return _lib


def available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        load()
        return True
    except (OSError, RuntimeError):
        return False
