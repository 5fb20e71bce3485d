"""Path IO for local paths and remote URLs (gs://, s3://, file://, ...).

Port of ``clipa_tpu/pathio.py``. Remote IO goes through :mod:`fsspec` (a
dependency of PyTorch), which ships gs/s3/file/memory backends; the last
makes remote semantics testable offline. A missing ``fsspec`` raises
``ImportError``: there is no local fallback for a URL.

Two usage patterns in the trainer:
  * **direct reads/writes** of single files (``npload``/``npsave``,
    ``model_init=gs://.../params.npz``) go through :func:`open_file`;
  * a **remote workdir** is staged on local disk (:func:`stage_dir_for`) and
    mirrored with :mod:`clipa_tpu_torch.train.remote_sync`: pulled before
    resume, pushed during and after training. Checkpoints, JSONL appends
    and profiler traces all want a real filesystem.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import IO

_SCHEME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")


def is_remote(path: str) -> bool:
    """True for URL-style paths (gs://, s3://, file://, memory://, ...)."""
    return bool(path) and bool(_SCHEME_RE.match(str(path)))


def _url_to_fs(path: str):
    import fsspec
    return fsspec.core.url_to_fs(str(path))


def local_path(path: str) -> str:
    """`path` for a caller that needs a real local file or directory;
    raises NotImplementedError for a URL."""
    if is_remote(path):
        raise NotImplementedError(
            f"remote path {path!r} where a local path is required (stage a "
            f"remote workdir with pathio.stage_dir_for)")
    return str(path)


def open_file(path: str, mode: str = "rb") -> IO:
    """Opens a local path or a remote URL (through fsspec)."""
    if is_remote(path):
        import fsspec
        return fsspec.open(str(path), mode).open()
    return open(path, mode)


def exists(path: str) -> bool:
    if is_remote(path):
        fs, p = _url_to_fs(path)
        return fs.exists(p)
    return os.path.exists(path)


def makedirs(path: str) -> None:
    if is_remote(path):
        fs, p = _url_to_fs(path)
        fs.makedirs(p, exist_ok=True)
    else:
        os.makedirs(path, exist_ok=True)


def replace(src: str, dst: str) -> None:
    """Atomic-where-possible rename. A local rename is atomic; object
    stores copy and delete."""
    if is_remote(dst):
        fs, s = _url_to_fs(src)
        _, d = _url_to_fs(dst)
        fs.mv(s, d)
    else:
        os.replace(src, dst)


def write_bytes_atomic(path: str, payload: bytes) -> None:
    """Writes `payload` to ``<path>-TEMPORARY`` and renames it over `path`,
    local or remote."""
    tmp = str(path) + "-TEMPORARY"
    parent = dirname(path)
    if parent:
        makedirs(parent)
    with open_file(tmp, "wb") as f:
        f.write(payload)
    replace(tmp, path)


def dirname(path: str) -> str:
    if is_remote(path):
        scheme, rest = str(path).split("://", 1)
        head = rest.rpartition("/")[0]
        return f"{scheme}://{head}" if head else ""
    return os.path.dirname(os.path.abspath(path))


def join(base: str, *parts: str) -> str:
    if is_remote(base):
        return "/".join([str(base).rstrip("/"),
                         *[p.strip("/") for p in parts]])
    return os.path.join(base, *parts)


def stage_dir_for(remote_url: str, root: str | None = None) -> str:
    """The local staging dir of a remote workdir: ``<root>/<the URL's last
    40 characters, sanitized>-<sha1(URL)[:12]>``, under ``root``, else
    ``$CLIPA_STAGE_ROOT``, else ``/tmp/clipa_stage`` (the JAX package's
    name for the same URL).

    Derived from the URL, not random, so a restarted process on the same
    host reuses its stage: local artifacts not yet synced (metrics.jsonl)
    survive a crash between syncs.
    """
    root = root or os.environ.get("CLIPA_STAGE_ROOT", "/tmp/clipa_stage")
    tag = hashlib.sha1(str(remote_url).encode()).hexdigest()[:12]
    name = re.sub(r"[^A-Za-z0-9_.-]+", "_", str(remote_url))[-40:]
    return os.path.join(root, f"{name}-{tag}")
