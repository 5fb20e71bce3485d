"""The port's remote workdir mirroring (clipa_tpu_torch/train/remote_sync.py
and the trainer's staging) against clipa_tpu's, offline.

``file://`` remotes take the pure-Python copy; ``gs://`` and ``s3://`` are
held by their command lines, with ``subprocess.run`` replaced, so no test
runs ``gsutil`` or ``aws`` or reaches the network. The end-to-end case is
the JAX package's tests/test_remote_workdir.py:114 in the port: the smoke
trainer on a ``file://`` workdir trains to 4, loses its local stage (a
restart on a fresh host) and resumes to 6 from the pull; its losses and
final parameters equal, bit for bit, the same two runs on one local
workdir that is never lost.
"""

import hashlib
import json
import os
import re
import shutil
import subprocess
import time

import pytest
import torch

from clipa_tpu.train import remote_sync as jax_remote_sync
from clipa_tpu_torch.config import load_config
from clipa_tpu_torch.train import checkpoint, loop, remote_sync

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "clipa_tpu_torch", "configs", "smoke.py")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _files(root):
    return sorted(os.path.relpath(os.path.join(r, f), root)
                  for r, _, fs in os.walk(root) for f in fs)


def _workdir(root):
    """A workdir with what a run leaves, and what is written in flight."""
    for rel, text in [
            ("metrics.jsonl", "{}\n"), ("params.npz", "npz"),
            ("checkpoints/4/state.pt", "step 4"),
            ("checkpoints/2/state.pt", "step 2"),
            ("params.npz-TEMPORARY", "torn"), ("x.tmp", "tmp"),
            ("run.lock", "lock"),
            ("checkpoints/6.orbax-checkpoint-tmp-123/data", "torn")]:
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)


KEPT = ["checkpoints/2/state.pt", "checkpoints/4/state.pt", "metrics.jsonl",
        "params.npz"]


@pytest.mark.parametrize("module", [remote_sync, jax_remote_sync],
                         ids=["port", "jax"])
def test_pull_of_a_missing_remote_is_success(module, tmp_path):
    assert module.pull(f"file://{tmp_path}/nonexistent",
                       str(tmp_path / "stage"))


def test_sync_mirrors_the_jax_packages_file_set(tmp_path):
    _workdir(str(tmp_path / "local"))
    assert remote_sync.sync(str(tmp_path / "local"),
                            f"file://{tmp_path}/ours")
    assert jax_remote_sync.sync(str(tmp_path / "local"),
                                f"file://{tmp_path}/theirs")
    assert _files(tmp_path / "ours") == _files(tmp_path / "theirs") == KEPT


@pytest.mark.parametrize("direction", ["sync", "pull"])
def test_in_flight_checkpoint_dirs_are_never_mirrored(direction, tmp_path):
    """The port's CheckpointManager writes a step into a directory whose
    name holds IN_FLIGHT_MARKER; neither direction copies it."""
    src = tmp_path / "src"
    _workdir(str(src))
    torn = src / "checkpoints" / f".6{checkpoint.IN_FLIGHT_MARKER}a1b2"
    torn.mkdir()
    (torn / "state.pt").write_text("torn")
    dst = tmp_path / "dst"
    if direction == "sync":
        assert remote_sync.sync(str(src), f"file://{dst}")
    else:
        assert remote_sync.pull(f"file://{src}", str(dst))
    assert _files(dst) == KEPT


def test_checkpoint_manager_writes_in_flight_under_the_marker(
        tmp_path, monkeypatch):
    seen = []
    save = torch.save

    def spy(obj, path):
        seen.append(os.path.basename(os.path.dirname(path)))
        save(obj, path)

    monkeypatch.setattr(checkpoint.torch, "save", spy)
    manager = checkpoint.CheckpointManager(str(tmp_path))
    manager.save(7, {"step": 7})
    manager.close()
    assert len(seen) == 1 and checkpoint.IN_FLIGHT_MARKER in seen[0]
    assert any(m in seen[0] for m in remote_sync.EXCLUDE_DIR_MARKERS)
    assert manager.all_steps() == [7]


class _Commands:
    """Records the command lines handed to subprocess.run and answers with
    the given return codes (a missing tool: FileNotFoundError)."""

    def __init__(self, *codes):
        self.codes, self.calls = list(codes), []

    def __call__(self, cmd, **kw):
        self.calls.append(cmd)
        code = self.codes.pop(0)
        if code is None:
            raise FileNotFoundError(cmd[0])
        return subprocess.CompletedProcess(cmd, code, b"", b"")


def test_cloud_command_lines_and_their_exclusions(tmp_path, monkeypatch):
    run = _Commands(0, 0, 1, 0, 0)
    monkeypatch.setattr(remote_sync.subprocess, "run", run)
    assert remote_sync.sync("/stage", "gs://b/run")
    assert remote_sync.sync("/stage", "s3://b/run")
    assert remote_sync.pull("gs://b/missing", "/stage")   # ls fails: fresh
    assert remote_sync.pull("gs://b/run", str(tmp_path / "stage"))
    gs, s3, probe, ls, rsync = run.calls
    assert gs[:5] == ["gsutil", "-m", "rsync", "-r", "-x"]
    assert gs[6:] == ["/stage", "gs://b/run"]
    assert s3[:5] == ["aws", "s3", "sync", "/stage", "s3://b/run"]
    assert probe == ["gsutil", "ls", "gs://b/missing"]
    assert ls == ["gsutil", "ls", "gs://b/run"]
    assert rsync[-2:] == ["gs://b/run", str(tmp_path / "stage")]
    excluded = re.compile(gs[5])
    for rel in (f"checkpoints/.6{checkpoint.IN_FLIGHT_MARKER}a1/state.pt",
                "checkpoints/6.orbax-checkpoint-tmp-1/x",
                "params.npz-TEMPORARY", "a.tmp", "b.lock"):
        assert excluded.fullmatch(rel), rel
    for rel in KEPT:
        assert not excluded.fullmatch(rel), rel
    jax_excluded = re.compile(jax_remote_sync._GS_EXCLUDE_RE)
    for rel in ("checkpoints/6.orbax-checkpoint-tmp-1/x", "a.tmp", *KEPT):
        assert bool(excluded.fullmatch(rel)) == bool(
            jax_excluded.fullmatch(rel))


def test_a_missing_cloud_tool_fails_the_sync_and_the_pull(monkeypatch):
    run = _Commands(None, None, None)
    monkeypatch.setattr(remote_sync.subprocess, "run", run)
    assert not remote_sync.sync("/stage", "gs://b/run")
    assert not remote_sync.sync("/stage", "s3://b/run")
    assert not remote_sync.pull("gs://b/run", "/stage")


def test_gs_workdir_without_gsutil_raises_and_does_not_start_fresh(
        tmp_path, monkeypatch):
    monkeypatch.setenv("CLIPA_STAGE_ROOT", str(tmp_path / "stage_root"))
    monkeypatch.setattr(remote_sync.subprocess, "run", _Commands(None))
    config = load_config(f"{SMOKE}:steps=2,batch=4")
    with pytest.raises(RuntimeError, match="Failed to pull remote workdir"):
        loop.train(config, "gs://bucket/run", device="cpu")
    stages = os.listdir(tmp_path / "stage_root")
    assert len(stages) == 1 and stages[0].endswith(
        "-" + hashlib.sha1(b"gs://bucket/run").hexdigest()[:12])
    assert _files(tmp_path / "stage_root") == []   # nothing trained


def test_sync_thread_syncs_on_its_period_and_at_stop(tmp_path):
    local, remote = tmp_path / "local", tmp_path / "remote"
    local.mkdir()
    (local / "a.txt").write_text("a")
    syncer = remote_sync.SyncThread(str(local), f"file://{remote}",
                                    every_seconds=0.05).start()
    for _ in range(200):
        if (remote / "a.txt").exists():
            break
        time.sleep(0.02)
    (local / "b.txt").write_text("b")
    assert syncer.stop(final_sync=True)
    assert _files(remote) == ["a.txt", "b.txt"]
    assert len(syncer.passes) >= 2 and all(ok for ok, _ in syncer.passes)
    assert not syncer._thread.is_alive()


def test_remote_sync_path_mirrors_a_local_workdir(tmp_path):
    config = load_config(f"{SMOKE}:steps=2,batch=4")
    config.remote_sync = {"path": f"file://{tmp_path}/mirror",
                          "every_seconds": 3600}
    loop.train(config, str(tmp_path / "run"), device="cpu")
    assert _files(tmp_path / "mirror") == _files(tmp_path / "run")
    assert "params.npz" in _files(tmp_path / "mirror")


def test_a_failed_final_sync_raises(tmp_path, monkeypatch):
    config = load_config(f"{SMOKE}:steps=2,batch=4")
    config.remote_sync = {"path": "gs://bucket/mirror", "every_seconds": 3600}
    monkeypatch.setattr(remote_sync.subprocess, "run", _Commands(None))
    with pytest.raises(RuntimeError, match="final sync"):
        loop.train(config, str(tmp_path / "run"), device="cpu")


def _train(steps, workdir):
    config = load_config(f"{SMOKE}:steps={steps},batch=16")
    config.ckpt_steps = 2
    config.log_training_steps = 1
    return loop.train(config, workdir, device="cpu")


def _losses(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [(r["step"], r["training_loss"]) for r in rows
            if "training_loss" in r]


def test_file_workdir_resumes_from_the_pull_bit_for_bit(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("CLIPA_STAGE_ROOT", str(tmp_path / "stage_root"))
    remote = f"file://{tmp_path}/remote_run"
    rdir = tmp_path / "remote_run"
    assert _train(4, remote)["step"] == 4
    for rel in ("metrics.jsonl", "params.npz", "config.json",
                "checkpoints/4/state.pt"):
        assert (rdir / rel).exists(), rel   # the final sync pushed them
    shutil.rmtree(tmp_path / "stage_root")  # a restart on a fresh host
    resumed = _train(6, remote)
    assert resumed["step"] == 6

    local = str(tmp_path / "local_run")     # the same two runs, never lost
    _train(4, local)
    kept = _train(6, local)
    ours = _losses(rdir / "metrics.jsonl")
    assert [s for s, _ in ours] == [1, 2, 3, 4, 5, 6]  # resumed at 4
    assert ours == _losses(os.path.join(local, "metrics.jsonl"))
    for name, p in kept["params"].items():
        assert torch.equal(resumed["params"][name], p), name
    for key in ("mu", "nu"):
        for name, m in kept["opt"][key].items():
            assert torch.equal(resumed["opt"][key][name], m), (key, name)
