"""Checkpoints: flat npz files and the trainer's resumable step directories.

Port of ``clipa_tpu/train/checkpoint.py``:

  * **flat npz**, on a local path or a URL (``gs://``, ``file://``, ...,
    through ``pathio``): keys are slash-joined parameter names, bf16
    stored as ``V2`` void bytes, written atomically (:func:`npsave`,
    :func:`save_params`, or in the background by
    :class:`AsyncCheckpointWriter`) and read (:func:`load_params`, with the
    ``file.npz:subtree`` syntax, also after a URL's scheme):
    wire-compatible with the JAX package's files and released CLIPA
    weights when the tensors are in the JAX layout
    (``convert.to_jax_params`` of a model; a train state's ``params`` are
    the model's own, in torch layout). A second variable collection, the
    ModifiedResNet's BatchNorm statistics, sits beside the parameters under
    flat ``batch_stats/<name>`` keys, as in the JAX package's files
    (:func:`save_variables`, :func:`load_variables`).
    :func:`masked_init` is the trainer's cross-resolution initialization
    (``config.masked_init``).
  * **resumable**: :class:`CheckpointManager` keeps ``<dir>/<step>/state.pt``
    step directories (``torch.save`` in place of Orbax) on a local path (a
    remote workdir's stage), each written in the background to a temporary
    directory whose name holds :data:`IN_FLIGHT_MARKER` and renamed into
    place, the newest `max_to_keep` kept. The trainer stores {params,
    optimizer state, step, chrono} there; every tensor comes back bit for
    bit, bf16 included. On several processes (a `mesh`) a step directory
    is instead one sharded ``torch.distributed.checkpoint`` (the JAX
    package's Orbax manager): each process writes its shards (FSDP's
    sharded parameters and moments as DTensors over the mesh, the rest
    once), in the background on a gloo group of its own, into the
    in-flight directory that process 0 renames into place. It restores at
    any process count and ``fsdp`` (resharded by the checkpoint's
    metadata), and without a process group, bit for bit; the single-file
    ``state.pt`` directories restore as before.
"""

from __future__ import annotations

import io
import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional, Sequence

import numpy as np
import torch

from clipa_tpu_torch import convert, pathio
from clipa_tpu_torch import utils as u
from clipa_tpu_torch.models import common


# The name of a step directory that is being written contains this; the
# remote sync never mirrors such a directory (a torn step).
IN_FLIGHT_MARKER = "-TEMPORARY-"


def npsave(data: dict, path: str) -> None:
    """Atomic np.savez of a flat {name: np.ndarray} dict: written to a
    temporary file beside `path`, then renamed over it (a URL: written
    whole to ``<path>-TEMPORARY`` and moved, as the JAX package does)."""
    if pathio.is_remote(path):
        with io.BytesIO() as buf:
            np.savez(buf, **data)
            pathio.write_bytes_atomic(path, buf.getvalue())
        return
    parent = pathio.dirname(path)
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=parent, suffix=".npz-TEMPORARY")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **data)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _to_np(x: torch.Tensor) -> np.ndarray:
    """A tensor as npz stores it: bf16 as its raw bytes in ``V2`` void
    (np.savez cannot store bf16; :func:`u.recover_dtype` reads it back)."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view("V2")
    return x.numpy()


def save_params(params: Any, path: str) -> None:
    """Saves a tree of tensors (nested dicts, or a flat dict of slash-joined
    names such as a train state's ``params``) as a flat npz, the format of
    the JAX package's ``save_checkpoint``."""
    npsave({name: _to_np(x) for name, x in u.tree_flatten_with_names(params)},
           path)


def npload(path: str) -> dict:
    """Reads an npz file (a local path or a URL, read whole first) into a
    flat {name: np.ndarray} dict."""
    with pathio.open_file(path) as f:
        data = io.BytesIO(f.read()) if pathio.is_remote(path) else f
        with np.load(data, allow_pickle=False) as checkpoint:
            return {k: checkpoint[k] for k in checkpoint.files}


def load_checkpoint(path: str) -> dict:
    """Loads a flat npz into a nested dict of CPU tensors."""
    flat = npload(path)
    return u.recover_tree(list(flat),
                          [u.recover_dtype(v) for v in flat.values()])


def save_variables(variables: dict, path: str) -> None:
    """Saves the JAX variables ``{"params": tree, "batch_stats": tree}``
    (``convert.to_jax_variables`` of a model) as one flat npz: the
    parameters under their names, the statistics under
    ``batch_stats/<name>``."""
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise ValueError(f"unknown variable collections {sorted(extra)}")
    flat = dict(u.tree_flatten_with_names(variables["params"]))
    flat.update((f"batch_stats/{k}", v) for k, v in
                u.tree_flatten_with_names(variables.get("batch_stats", {})))
    save_params(flat, path)


def load_variables(path: str) -> dict:
    """Reads :func:`load_params`' tree and moves its ``batch_stats``
    subtree out: ``{"params": tree}`` and, where the file has statistics,
    ``"batch_stats"``."""
    params = load_params(path)
    if isinstance(params, dict) and "batch_stats" in params:
        params = dict(params)
        return {"batch_stats": params.pop("batch_stats"), "params": params}
    return {"params": params}


def load_params(path: str) -> dict:
    """Loads params from `file.npz` or `file.npz:subtree/key`, where the
    file may be a URL (``file:///run/params.npz:img``: the scheme's ``:``
    is not a subtree's).

    Accepts checkpoints that are a bare params tree or a full train
    checkpoint containing a `params/` prefix. Returns a nested dict of CPU
    tensors (or one tensor, when the subtree key names a leaf).
    """
    key = None
    if path.count(":") > (1 if pathio.is_remote(path) else 0):
        path, _, key = path.rpartition(":")
    tree = load_checkpoint(path)
    if "params" in tree and isinstance(tree["params"], dict) and \
            (not key or key.split("/")[0] not in tree):
        tree = tree["params"]  # full train checkpoint: dig out the params
    if key:
        for part in key.split("/"):
            tree = tree[part]
    return tree


def masked_init(model: torch.nn.Module, path: str,
                dont_load: Sequence = (), log=None) -> torch.nn.Module:
    """Initializes `model`'s parameters in place from the checkpoint at
    `path` (a local path or a URL; the JAX layout, as the JAX package and
    :func:`save_params` of ``convert.to_jax_params`` write it): the
    trainer's ``config.masked_init`` branch (clipa_tpu/train/loop.py). The
    checkpoint is merged into the model's parameters, mapped to the JAX
    layout, by :func:`common.merge_params` under `dont_load`
    (``config.masked_no_load``): every tensor is copied, except position
    embeddings of another length, which are resampled (the pretrain text
    tower's 8 positions to the fine-tune's 32), and what `dont_load` keeps
    at its init. BatchNorm statistics are not merged: a model with them
    keeps its own. `log` (a print-like callable) gets one line: how many
    tensors were copied, and which were resampled or kept. Returns
    `model`.
    """
    loaded = load_variables(path)["params"]
    inited = convert.to_jax_params(model)
    merged = common.merge_params(loaded, inited, dont_load)
    convert.load_jax_params(model, {
        "params": merged, "batch_stats": convert.to_jax_batch_stats(model)})
    if log is not None:   # merge_params's three cases, counted
        shapes = {n: tuple(x.shape)
                  for n, x in u.tree_flatten_with_names(loaded)}
        skip = u.check_and_compile_patterns(dont_load)
        copied, resampled, kept = [], [], []
        for n, x in inited.items():
            if n in shapes and shapes[n] == tuple(x.shape) and not any(
                    p.fullmatch(n) for p in skip):
                copied.append(n)
            elif n.endswith("pos_embedding") and n in shapes:
                resampled.append(n)
            else:
                kept.append(n)
        log(f"masked_init from {path}: {len(copied)} of {len(inited)} "
            f"tensors copied, resampled {resampled}, kept at init {kept}")
    return model


def _to_host(tree: Any) -> Any:
    """A copy of a nested dict with every tensor copied to the CPU (the
    caller's tensors may change under the next step while it is written)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


class AsyncCheckpointWriter:
    """Single-slot async npz writer: saves overlap the next train steps.

    The tensors are copied to the host before `save` returns; a second
    save waits for the first. `wait` raises a failed write's error, or a
    ``TimeoutError`` after `timeout_secs`.
    """

    def __init__(self, timeout_secs: float = 600.0):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt")
        self._future = None
        self.timeout_secs = timeout_secs

    def wait(self):
        if self._future is not None:
            future, self._future = self._future, None
            future.result(timeout=self.timeout_secs)

    def save(self, params: Any, path: str) -> None:
        self.wait()  # one write in flight at a time
        self._future = self._pool.submit(save_params, _to_host(params), path)

    def close(self):
        self.wait()
        self._pool.shutdown(wait=True)


def is_sharded(path: str) -> bool:
    """Whether a local step directory holds a sharded checkpoint."""
    return os.path.exists(os.path.join(path, ".metadata"))


def load_state(path: str, template: Optional[dict] = None,
               shards=None) -> dict:
    """Reads a resumable checkpoint: a :class:`CheckpointManager` step
    directory or its ``state.pt`` (``config.resume``; a local path or a
    URL), onto the CPU. A sharded step directory (local) is read into the
    structure of `template` (the live state's ``checkpoint_state``:
    this process's shards where `shards`, the state's
    ``collectives.ParamShards``, shards them, whole tensors otherwise)."""
    if not pathio.is_remote(path) and is_sharded(path):
        if template is None:
            raise ValueError(f"{path} is a sharded checkpoint: restoring it "
                             "needs the live state as a template")
        return _load_sharded(path, template, shards)
    if pathio.is_remote(path):
        if not path.endswith(CheckpointManager.STATE):
            path = pathio.join(path, CheckpointManager.STATE)
        with pathio.open_file(path) as f:
            return torch.load(io.BytesIO(f.read()), map_location="cpu",
                              weights_only=True)
    if os.path.isdir(path):
        path = os.path.join(path, CheckpointManager.STATE)
    return torch.load(path, map_location="cpu", weights_only=True)


def _tensor_map(tree: Any, fn, name: Optional[str] = None,
                parent: Optional[str] = None) -> Any:
    """Maps `fn(name, tensor)` over a checkpoint state: `name` is a
    tensor's key inside ``params`` / ``mu`` / ``nu`` (the parameter it
    belongs to), None elsewhere."""
    if isinstance(tree, dict):
        return {k: _tensor_map(v, fn, k if parent in ("params", "mu", "nu")
                               else None, k) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return fn(name, tree)
    return tree


def _cpu_mesh(mesh):
    """The mesh's layout on the CPU device type (the sharded checkpoint's
    DTensors live on host copies)."""
    if mesh.device_type == "cpu":
        return mesh
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", mesh.mesh, mesh_dim_names=mesh.mesh_dim_names)


def _load_sharded(path: str, template: dict, shards) -> dict:
    import torch.distributed.checkpoint as dcp

    mesh = _cpu_mesh(shards.mesh) if shards is not None else None
    target = _dcp_host(template, shards, mesh, copy=False)
    dcp.load(target, checkpoint_id=path)
    return _tensor_map(target, lambda name, x: x.to_local()
                       if hasattr(x, "to_local") else x)


def _dcp_host(tree: Any, shards, cpu_mesh, copy: bool) -> Any:
    """`tree` with each tensor on the CPU (a copy where `copy`, else zeros
    of its shape); under `shards`, the ``params`` / ``mu`` / ``nu`` tensors
    of a name FSDP shards wrapped as DTensors of the full shape, Replicate
    over ``data`` and Shard over ``fsdp``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def leaf(name, x):
        x = (x.detach().to("cpu", copy=True) if copy
             else torch.zeros(x.shape, dtype=x.dtype))
        dim = shards.dims.get(name) if shards is not None and name else None
        if dim is None:
            return x
        return DTensor.from_local(x, cpu_mesh, [Replicate(), Shard(dim)],
                                  run_check=False)

    return _tensor_map(tree, leaf)


class CheckpointManager:
    """Resumable checkpoints in step directories: ``<directory>/<step>/
    state.pt`` holds one ``torch.save``-d nested dict of tensors and
    Python scalars; with `shards` (the train state's
    ``collectives.ParamShards``, whose mesh spans the process group) each
    step directory is one sharded checkpoint (module docstring).

    :meth:`save` copies the state to the host and writes it in a background
    thread (one write in flight) into a temporary directory, renamed into
    place when whole, so a step directory is complete or absent; then only
    the newest `max_to_keep` steps are kept. Saving a step that exists is a
    no-op. :meth:`restore` reads a step (the latest by default) onto the
    CPU. `directory` is a local path: a remote workdir's checkpoints live
    on its local stage (a URL raises, it is never made absolute).
    """

    STATE = "state.pt"

    def __init__(self, directory: str, max_to_keep: int = 3, shards=None):
        self.directory = os.path.abspath(pathio.local_path(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.shards = shards
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt")
        self._future = None
        self._group = self._mesh = None
        if shards is not None:
            import torch.distributed as dist
            # the background writes' collectives run on a group of their
            # own, never beside the step's on the default group
            self._group = dist.new_group(backend="gloo")
            self._mesh = _cpu_mesh(shards.mesh)
            self._rank = dist.get_rank()

    def all_steps(self) -> list[int]:
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and (
                          os.path.exists(os.path.join(self.directory, name,
                                                      self.STATE))
                          or is_sharded(os.path.join(self.directory, name))))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state: dict) -> bool:
        self.wait()
        if step in self.all_steps():
            return False
        if self.shards is not None:
            host = _dcp_host(state, self.shards, self._mesh, copy=True)
            self._future = self._pool.submit(self._write_sharded, step, host)
        else:
            self._future = self._pool.submit(self._write, step,
                                             _to_host(state))
        return True

    def _write_sharded(self, step: int, host: dict) -> None:
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        tmp = os.path.join(self.directory, f".{step}{IN_FLIGHT_MARKER}dcp")
        if self._rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        dist.barrier(group=self._group)
        dcp.save(host, checkpoint_id=tmp, process_group=self._group)
        if self._rank == 0:
            os.replace(tmp, self.step_dir(step))
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.step_dir(old))
        dist.barrier(group=self._group)

    def _write(self, step: int, host: dict) -> None:
        tmp = tempfile.mkdtemp(dir=self.directory,
                               prefix=f".{step}{IN_FLIGHT_MARKER}")
        try:
            torch.save(host, os.path.join(tmp, self.STATE))
            os.replace(tmp, self.step_dir(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.step_dir(old))

    def restore(self, step: Optional[int] = None,
                template: Optional[dict] = None) -> Optional[dict]:
        """Reads a step (the latest by default) onto the CPU; a sharded
        step into `template`'s structure (:func:`load_state`)."""
        self.wait()
        step = self.latest_step() if step is None else step
        return None if step is None else load_state(
            self.step_dir(step), template, self.shards)

    def wait(self) -> None:
        if self._future is not None:
            future, self._future = self._future, None
            future.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)
