"""Process group, mesh and sharding rules for training on several devices.

Port of ``clipa_tpu/parallel/mesh.py``. The JAX package runs one SPMD
program over a ``jax.sharding.Mesh``; here each device is a process of a
``torch.distributed`` group (torchrun's environment, one process per GPU
through NCCL, or CPU processes through gloo) and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the same two dims:

  * ``data``: the batch dimension;
  * ``fsdp``: the dimension the large parameters, and Adam's moments, are
    sharded over (:func:`fsdp_shardings`); the batch spans it too.

The batch rule, written down once and used by the step, the evaluators and
:func:`local_batch_to_global`: the global batch splits over ``("data",
"fsdp")`` jointly, row-major over the mesh, so the process at mesh
coordinate (d, f) holds batch shard ``d * fsdp + f`` of ``mesh.size()``,
which is its rank when the mesh spans the group in rank order
(:func:`create_mesh`): with ``b`` local rows, rank ``r`` holds the global
rows ``[r * b, (r + 1) * b)`` (:func:`batch_shard`, :func:`batch_rows`).
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from clipa_tpu_torch import utils

BATCH_AXES = ("data", "fsdp")


def init_distributed(device="cuda", timeout_s: float = 1800.0
                     ) -> torch.device:
    """Joins the process group torchrun's environment describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) and
    returns the device this process runs on.

    On a CUDA `device` the process takes ``cuda:LOCAL_RANK`` and the group
    runs CUDA tensors through NCCL (CPU tensors, such as the evaluators'
    counts, through gloo); a failure of NCCL raises, nothing falls back to
    gloo. On the CPU the group is gloo. Without ``WORLD_SIZE`` in the
    environment, or with a group already initialized, no group is made.
    """
    device = utils.resolve_device(device, "init_distributed")
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return device
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", 0))
    if device.type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "cuda:nccl,cpu:gloo"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def _mesh_device_type() -> str:
    return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"


def create_mesh(fsdp: int = 1, devices: Optional[Sequence[int]] = None):
    """A ``(data, fsdp)`` DeviceMesh of shape ``(n // fsdp, fsdp)`` over
    the ranks `devices` (default: every rank of the group, in order), on
    the group's device type. Raises ValueError where `fsdp` does not
    divide n, and RuntimeError without a process group."""
    from torch.distributed.device_mesh import DeviceMesh

    initialized = dist.is_available() and dist.is_initialized()
    ranks = list(devices) if devices is not None else list(
        range(dist.get_world_size() if initialized else 1))
    n = len(ranks)
    if n % fsdp:
        raise ValueError(f"fsdp={fsdp} does not divide device count {n}")
    if not initialized:
        raise RuntimeError("create_mesh needs a process group: call "
                           "init_distributed() first")
    return DeviceMesh(_mesh_device_type(),
                      torch.tensor(ranks).reshape(n // fsdp, fsdp),
                      mesh_dim_names=BATCH_AXES)


def batch_shard(mesh) -> tuple[int, int]:
    """(index, count) of this process's batch shard: row-major over the
    mesh (module docstring)."""
    d, f = mesh.get_coordinate()
    return d * mesh.size(1) + f, mesh.size()


def batch_rows(mesh, local_batch: int) -> slice:
    """The global rows this process holds of a batch of `local_batch` rows
    per process."""
    index, _ = batch_shard(mesh)
    return slice(index * local_batch, (index + 1) * local_batch)


def fsdp_shardings(params: dict, mesh: Union[Any, int],
                   min_size_to_shard: int = 2 ** 18) -> dict:
    """{name: the dimension a parameter shards over ``fsdp``, or None}.

    `params` maps names to tensors (any device, ``meta`` too) or shapes;
    `mesh` is the DeviceMesh or the size of its ``fsdp`` dim. The JAX
    rule: with ``fsdp == 1`` or fewer than `min_size_to_shard` elements a
    parameter is replicated (norms, biases, ``t``, ``cls``); otherwise it
    shards over its first dim in ``sorted(dims, key=(divisible, size),
    reverse=True)`` that ``fsdp`` divides, else it is replicated.
    """
    fsdp = mesh if isinstance(mesh, int) else mesh.size(1)

    def rule(shape):
        shape = tuple(shape)
        if fsdp == 1 or math.prod(shape) < min_size_to_shard:
            return None
        dims = sorted(range(len(shape)),
                      key=lambda d: (shape[d] % fsdp == 0, shape[d]),
                      reverse=True)
        for d in dims:
            if shape[d] % fsdp == 0 and shape[d] >= fsdp:
                return d
        return None

    return {name: rule(getattr(x, "shape", x)) for name, x in params.items()}


def local_batch_to_global(local_arrays: Any, device) -> Any:
    """The host -> device boundary: this process's rows of the global batch
    (numpy arrays, nested dicts of them) as tensors on `device`. Under the
    batch rule the process's rows are its shard of the global batch, so
    nothing moves between processes."""
    if isinstance(local_arrays, dict):
        return {k: local_batch_to_global(v, device)
                for k, v in local_arrays.items()}
    return torch.from_numpy(np.ascontiguousarray(local_arrays)).to(device)
