"""Workdir -> remote storage sync.

Port of ``clipa_tpu/train/remote_sync.py``: a one-shot :func:`sync`, the
reverse :func:`pull` run before resume, and :class:`SyncThread`, the
background keep-syncing loop the trainer runs on the lead process.

Protocols:
  * plain and ``file://`` paths: a pure-Python recursive copy (size and
    mtime delta),
  * ``gs://``: ``gsutil -m rsync -r``,
  * ``s3://``: ``aws s3 sync``.
The command-line tools run as subprocesses; no cloud SDK is imported.

Never mirrored: files ending in ``.tmp``, ``.lock`` or ``-TEMPORARY``
(atomic writes in flight), and directories whose name holds an in-flight
checkpoint marker: the port's ``CheckpointManager`` writes each step into
``.<step>-TEMPORARY-<random>`` and renames it when whole
(``checkpoint.IN_FLIGHT_MARKER``), the JAX package's Orbax into
``*.orbax-checkpoint-tmp-*``. Syncing either would mirror a torn step.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
import time
from typing import Optional

from clipa_tpu_torch.train.checkpoint import IN_FLIGHT_MARKER

EXCLUDE_SUFFIXES = (".tmp", ".lock", "-TEMPORARY")
EXCLUDE_DIR_MARKERS = ("orbax-checkpoint-tmp", IN_FLIGHT_MARKER)

_GS_EXCLUDE_RE = (r".*orbax-checkpoint-tmp.*|.*-TEMPORARY-.*|.*-TEMPORARY$"
                  r"|.*\.tmp$|.*\.lock$")
_S3_EXCLUDES = ["--exclude", "*orbax-checkpoint-tmp*",
                "--exclude", "*-TEMPORARY-*", "--exclude", "*-TEMPORARY",
                "--exclude", "*.tmp", "--exclude", "*.lock"]


def _sync_local(local_dir: str, remote_dir: str) -> bool:
    remote_dir = remote_dir.removeprefix("file://")
    for root, dirs, files in os.walk(local_dir):
        dirs[:] = [d for d in dirs
                   if not any(m in d for m in EXCLUDE_DIR_MARKERS)]
        rel = os.path.relpath(root, local_dir)
        dst_root = os.path.join(remote_dir, rel) if rel != "." else remote_dir
        os.makedirs(dst_root, exist_ok=True)
        for f in files:
            if f.endswith(EXCLUDE_SUFFIXES):
                continue
            src, dst = os.path.join(root, f), os.path.join(dst_root, f)
            try:
                st = os.stat(src)
                if os.path.exists(dst):
                    dt = os.stat(dst)
                    if dt.st_size == st.st_size and dt.st_mtime >= st.st_mtime:
                        continue
                shutil.copy2(src, dst)
            except OSError as e:
                print(f"remote_sync: failed to copy {src}: {e}")
                return False
    return True


def _run(cmd: list[str]):
    """The command's CompletedProcess, or None when its tool is missing."""
    try:
        return subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
    except FileNotFoundError as e:
        print(f"remote_sync: {cmd[0]} not available: {e}")
        return None


def _sync_cli(cmd: list[str]) -> bool:
    result = _run(cmd)
    if result is None:
        return False
    if result.returncode:
        print(f"remote_sync: {' '.join(cmd[:3])} failed: "
              f"{result.stderr.decode(errors='replace')[:500]}")
    return result.returncode == 0


def sync(local_dir: str, remote_dir: str) -> bool:
    """One sync pass, local -> remote; returns success."""
    if remote_dir.startswith("s3://"):
        return _sync_cli(["aws", "s3", "sync", local_dir, remote_dir,
                          *_S3_EXCLUDES])
    if remote_dir.startswith("gs://"):
        return _sync_cli(["gsutil", "-m", "rsync", "-r",
                          "-x", _GS_EXCLUDE_RE, local_dir, remote_dir])
    return _sync_local(local_dir, remote_dir)


def pull(remote_dir: str, local_dir: str) -> bool:
    """Reverse sync, remote workdir -> local stage, run before resume so
    that a run restarted on a fresh host resumes from the workdir's
    checkpoint. A missing remote (a fresh run) is success; a missing tool
    or a failed copy is not."""
    if remote_dir.startswith("s3://"):
        return _sync_cli(["aws", "s3", "sync", remote_dir, local_dir,
                          *_S3_EXCLUDES])
    if remote_dir.startswith("gs://"):
        # rsync fails on a source path that does not exist: probe first
        probe = _run(["gsutil", "ls", remote_dir])
        if probe is None:
            return False
        if probe.returncode:
            return True
        os.makedirs(local_dir, exist_ok=True)
        return _sync_cli(["gsutil", "-m", "rsync", "-r",
                          "-x", _GS_EXCLUDE_RE, remote_dir, local_dir])
    src = remote_dir.removeprefix("file://")
    if not os.path.isdir(src):
        return True
    os.makedirs(local_dir, exist_ok=True)
    return _sync_local(src, local_dir)


class SyncThread:
    """Background keep-syncing loop: :func:`sync` every `every_seconds` on
    a daemon thread (the sync is IO- and subprocess-bound), and once more
    at :meth:`stop`. `passes` holds (success, seconds) of each pass."""

    def __init__(self, local_dir: str, remote_dir: str,
                 every_seconds: float = 300.0):
        self.local_dir, self.remote_dir = local_dir, remote_dir
        self.every_seconds = every_seconds
        self.passes: list[tuple[bool, float]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _sync(self) -> bool:
        t0 = time.perf_counter()
        ok = sync(self.local_dir, self.remote_dir)
        self.passes.append((ok, time.perf_counter() - t0))
        return ok

    def start(self):
        def run():
            while not self._stop.wait(self.every_seconds):
                self._sync()
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="remote-sync")
        self._thread.start()
        return self

    def stop(self, final_sync: bool = True) -> bool:
        """Stops the loop (a pass in flight runs to its end); with
        `final_sync`, one last pass, whose success it returns."""
        self._stop.set()
        if self._thread:
            self._thread.join()
        return self._sync() if final_sync else True
