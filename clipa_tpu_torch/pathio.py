"""Path IO for local paths.

Port of the local-path half of ``clipa_tpu/pathio.py``. The JAX package
also reads and writes remote URLs (``gs://``, ``s3://``, ...) through
fsspec and stages a remote workdir on local disk; here a remote URL raises
``NotImplementedError`` (ROADMAP A4).
"""

from __future__ import annotations

import os
import re
from typing import IO

_SCHEME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")


def is_remote(path: str) -> bool:
    """True for URL-style paths (gs://, s3://, file://, memory://, ...)."""
    return bool(path) and bool(_SCHEME_RE.match(str(path)))


def local_path(path: str) -> str:
    """`path` as a local path; raises NotImplementedError for a remote
    URL."""
    if is_remote(path):
        raise NotImplementedError(
            f"remote path {path!r}: only local paths are ported (remote "
            f"workdirs and checkpoints: ROADMAP A4)")
    return str(path)


def open_file(path: str, mode: str = "rb") -> IO:
    return open(local_path(path), mode)


def dirname(path: str) -> str:
    return os.path.dirname(os.path.abspath(local_path(path)))
