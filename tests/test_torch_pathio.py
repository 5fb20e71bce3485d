"""The port's remote path IO (clipa_tpu_torch/pathio.py and the npz and
checkpoint IO of train/checkpoint.py) against clipa_tpu's, offline.

Remote URLs go through fsspec's ``memory://`` and ``file://`` backends,
the branch ``gs://`` and ``s3://`` take; no test opens a cloud URL. Path
strings (is_remote, join, dirname, stage_dir_for) must equal the JAX
package's for the same inputs; npz files must round-trip bit for bit, bf16
included, and read in the other package.
"""

import os
import sys
import uuid

import numpy as np
import pytest
import torch

from clipa_tpu import pathio as jax_pathio
from clipa_tpu.train import checkpoint as jax_checkpoint
from clipa_tpu_torch import pathio
from clipa_tpu_torch.train import checkpoint

PATHS = ["gs://bucket/run", "s3://bucket/run", "file:///tmp/x",
         "memory://x", "/tmp/x", "relative/path", "", None,
         "gs://bucket/run/params.npz:img"]


@pytest.mark.parametrize("path", PATHS)
def test_is_remote_matches_the_jax_package(path):
    assert pathio.is_remote(path) == jax_pathio.is_remote(path)


@pytest.mark.parametrize("base,parts", [
    ("gs://b/run", ("checkpoints",)), ("gs://b/run/", ("a", "b")),
    ("file:///tmp/run", ("/checkpoints/", "4")), ("/tmp/x", ("y",)),
    ("memory://root", ("a/b", "c"))])
def test_join_matches_the_jax_package(base, parts):
    assert pathio.join(base, *parts) == jax_pathio.join(base, *parts)


@pytest.mark.parametrize("path", [
    "gs://b/run/params.npz", "gs://bucket", "file:///tmp/run/metrics.jsonl",
    "/tmp/x/y.npz", "relative/y.npz"])
def test_dirname_matches_the_jax_package(path):
    assert pathio.dirname(path) == jax_pathio.dirname(path)


@pytest.mark.parametrize("url", [
    "gs://bucket/run1", "gs://bucket/run2", "s3://a-very-long-bucket-name/"
    "with/a/deep/path/to/the/run/of/clipa", "file:///tmp/remote run"])
def test_stage_dir_is_the_jax_packages(url, tmp_path, monkeypatch):
    monkeypatch.delenv("CLIPA_STAGE_ROOT", raising=False)
    assert pathio.stage_dir_for(url) == jax_pathio.stage_dir_for(url)
    assert pathio.stage_dir_for(url, str(tmp_path)) == \
        jax_pathio.stage_dir_for(url, str(tmp_path))
    monkeypatch.setenv("CLIPA_STAGE_ROOT", str(tmp_path / "env"))
    stage = pathio.stage_dir_for(url)
    assert stage == jax_pathio.stage_dir_for(url)
    assert stage.startswith(str(tmp_path / "env") + os.sep)
    assert stage == pathio.stage_dir_for(url)   # deterministic
    assert stage != pathio.stage_dir_for(url + "x")


def _data():
    rng = np.random.RandomState(0)
    bf16 = torch.from_numpy(rng.randn(3, 4).astype(np.float32)).bfloat16()
    return {"img/w": rng.randn(2, 3).astype(np.float32),
            "img/b": np.arange(5, dtype=np.int32),
            "t": bf16.view(torch.int16).numpy().view("V2")}


def _url(kind, tmp_path, name="sub/ckpt.npz"):
    if kind == "memory":
        return f"memory://{uuid.uuid4().hex}/{name}"
    return f"file://{tmp_path}/{name}"


@pytest.mark.parametrize("kind", ["memory", "file"])
def test_npsave_npload_round_trip_over_urls(kind, tmp_path):
    url = _url(kind, tmp_path)
    data = _data()
    checkpoint.npsave(data, url)
    assert pathio.exists(url)
    assert not pathio.exists(url + "-TEMPORARY")
    back = checkpoint.npload(url)
    assert set(back) == set(data)
    for k, v in data.items():
        assert back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes()
    if kind == "file":
        assert (tmp_path / "sub" / "ckpt.npz").exists()
        assert not (tmp_path / "sub" / "ckpt.npz-TEMPORARY").exists()


@pytest.mark.parametrize("kind", ["memory", "file"])
def test_npz_over_urls_reads_in_the_other_package(kind, tmp_path):
    data = _data()
    ours, theirs = _url(kind, tmp_path, "a.npz"), _url(kind, tmp_path,
                                                         "b.npz")
    checkpoint.npsave(data, ours)
    jax_checkpoint.npsave(data, theirs)
    for got in (jax_checkpoint.npload(ours), checkpoint.npload(theirs)):
        assert {k: v.tobytes() for k, v in got.items()} == \
            {k: v.tobytes() for k, v in data.items()}


@pytest.mark.parametrize("kind", ["memory", "file"])
def test_load_params_with_a_subtree_after_a_scheme(kind, tmp_path):
    """``<url>:img``: the scheme's ``:`` is not a subtree key's (the JAX
    package's tests/test_remote_workdir.py:66)."""
    tree = {"params": {"img": {"w": np.ones((2, 2), np.float32)},
                       "txt": {"w": np.zeros((2,), np.float32)}}}
    url = _url(kind, tmp_path, "c.npz")
    jax_checkpoint.save_checkpoint(tree, url)
    full = checkpoint.load_params(url)
    assert set(full) == {"img", "txt"}   # the params/ prefix dug out
    sub = checkpoint.load_params(url + ":img")
    ref = jax_checkpoint.load_params(url + ":img")
    assert set(sub) == set(ref) == {"w"}
    np.testing.assert_array_equal(sub["w"].numpy(), ref["w"])
    leaf = checkpoint.load_params(url + ":txt/w")
    np.testing.assert_array_equal(leaf.numpy(), tree["params"]["txt"]["w"])


def test_load_params_with_a_subtree_on_a_local_path(tmp_path):
    path = str(tmp_path / "p.npz")
    checkpoint.save_params({"img": {"w": torch.ones(2)}}, path)
    np.testing.assert_array_equal(
        checkpoint.load_params(f"{path}:img")["w"].numpy(), np.ones(2))


def test_checkpoint_manager_does_not_abspath_a_url(tmp_path, monkeypatch):
    """A URL is never made into ``<cwd>/gs:/...``: the manager works on a
    remote workdir's local stage, and refuses the URL itself."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="local path is required"):
        checkpoint.CheckpointManager("gs://bucket/run/checkpoints")
    assert not (tmp_path / "gs:").exists()
    manager = checkpoint.CheckpointManager("rel/dir")
    assert os.path.isabs(manager.directory)
    assert manager.directory == str(tmp_path / "rel" / "dir")
    manager.close()


def test_load_state_reads_a_step_over_a_url(tmp_path):
    manager = checkpoint.CheckpointManager(str(tmp_path / "ckpts"))
    manager.save(3, {"params": {"w": torch.arange(4.0)}, "step": 3})
    manager.close()
    for url in (f"file://{tmp_path}/ckpts/3",
                f"file://{tmp_path}/ckpts/3/state.pt"):
        state = checkpoint.load_state(url)
        assert state["step"] == 3
        assert torch.equal(state["params"]["w"], torch.arange(4.0))


def test_remote_file_operations_on_memory_urls():
    root = f"memory://{uuid.uuid4().hex}"
    pathio.makedirs(f"{root}/a/b")
    pathio.write_bytes_atomic(f"{root}/a/b/f.bin", b"payload")
    assert pathio.exists(f"{root}/a/b/f.bin")
    assert not pathio.exists(f"{root}/a/b/f.bin-TEMPORARY")
    pathio.replace(f"{root}/a/b/f.bin", f"{root}/a/g.bin")
    assert not pathio.exists(f"{root}/a/b/f.bin")
    with pathio.open_file(f"{root}/a/g.bin") as f:
        assert f.read() == b"payload"


def test_a_missing_fsspec_raises_import_error(monkeypatch, tmp_path):
    """No local fallback for a URL: without fsspec, remote IO raises."""
    monkeypatch.setitem(sys.modules, "fsspec", None)
    for fn in (pathio.open_file, pathio.exists, pathio.makedirs):
        with pytest.raises(ImportError):
            fn(f"file://{tmp_path}/x")
    with pytest.raises(ImportError):
        checkpoint.npsave(_data(), f"file://{tmp_path}/x.npz")
    assert not (tmp_path / "x.npz").exists()
    with open(tmp_path / "local.bin", "wb") as f:   # local paths need none
        f.write(b"x")
    with pathio.open_file(str(tmp_path / "local.bin")) as f:
        assert f.read() == b"x"
