"""Collectives of the data-parallel and FSDP step, and of the evaluators.

The training step takes its gradients with ``torch.autograd.grad``, which
bypasses the hooks ``DistributedDataParallel`` and ``fully_shard`` rely
on, so every collective is explicit here:

  * :func:`gather_rows`, the differentiable all-gather of the embeddings
    along the batch dim (its backward reduce-scatters the gradient, summing
    it back to the rows' owners), and :func:`gather_rows_nograd`;
  * :class:`ParamShards`, FSDP by hand over the mesh's ``fsdp`` dim: each
    process keeps its shard of the fp32 masters (and the optimizer its
    moments of those shards) along ``mesh.fsdp_shardings``' dimension,
    gathers the full parameters into the model after each update,
    reduce-scatters the gradients within the ``fsdp`` group and all-reduces
    them over the ``data`` group, and forms norms from the shards;
  * the evaluators' sums and row gathers over host arrays
    (:func:`all_reduce_sum`, :func:`gather_varlen`), through CPU tensors: a
    group made by ``mesh.init_distributed`` runs those on gloo, beside NCCL
    for the CUDA tensors.

Without a process group each of them is the identity (one process).
:data:`calls` counts the step's collectives by kind (a plain counter:
callers reset it and read it back to prove a run went through them).
"""

from __future__ import annotations

import collections

import numpy as np
import torch
import torch.distributed as dist

from clipa_tpu_torch.parallel import mesh as mesh_lib

calls: collections.Counter = collections.Counter()


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    return dist.get_world_size(group) if initialized() else 1


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0, in rank order; the backward sums every
    process's gradient of the gathered rows and returns each its own."""

    @staticmethod
    def forward(ctx, x, group):
        calls["gather_rows"] += 1
        ctx.group = group
        n = dist.get_world_size(group)
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), group=ctx.group)
        return out, None


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every process's `x` stacked along dim 0 in rank order (the global
    batch, under the batch rule), differentiably: the gradient that reaches
    the gathered rows, summed over the processes, flows back to the
    owners' rows."""
    if not initialized():
        return x
    return _GatherRows.apply(x, group)


@torch.no_grad()
def gather_rows_nograd(x: torch.Tensor, group=None) -> torch.Tensor:
    """:func:`gather_rows` without a gradient (the distillation teacher)."""
    if not initialized():
        return x
    out = x.new_empty((world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


@torch.no_grad()
def all_reduce_total(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over the processes (a new tensor)."""
    if not initialized():
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def all_reduce_sum(values) -> np.ndarray:
    """The element-wise sum over the processes of a host array (float64),
    every process getting it."""
    out = torch.as_tensor(np.asarray(values, np.float64))
    if initialized():
        dist.all_reduce(out)
    return out.numpy()


def all_reduce_max(value: int) -> int:
    """The largest of every process's `value`."""
    out = torch.tensor([int(value)], dtype=torch.int64)
    if initialized():
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return int(out)


def gather_varlen(array: np.ndarray) -> np.ndarray:
    """Every process's rows of `array` (any count, the same trailing shape
    and dtype), concatenated in rank order, on every process: the counts
    are all-gathered first and each block is padded to the largest."""
    if not initialized():
        return array
    n = world_size()
    counts = torch.zeros(n, dtype=torch.int64)
    dist.all_gather_into_tensor(counts, torch.tensor([len(array)]))
    longest = int(counts.max())
    # bytes, so any dtype travels; the trailing shape is every process's
    row_bytes = array.dtype.itemsize * int(np.prod(array.shape[1:]))
    mine = np.zeros((longest, row_bytes), np.uint8)
    mine[:len(array)] = np.ascontiguousarray(array).view(np.uint8).reshape(
        len(array), row_bytes)
    out = torch.empty((n * longest, row_bytes), dtype=torch.uint8)
    dist.all_gather_into_tensor(out, torch.from_numpy(mine))
    blocks = out.numpy().reshape(n, longest, row_bytes)
    rows = np.concatenate([blocks[i, :int(c)] for i, c in enumerate(counts)])
    return rows.reshape(-1).view(array.dtype).reshape(
        (-1,) + array.shape[1:])


class ParamShards:
    """FSDP over the ``fsdp`` dim of `mesh` (module docstring).

    `params`: the model's {JAX name: parameter} (full, identical on every
    process). :meth:`local` gives the optimizer's view: a shard (a new fp32
    tensor) for each name :func:`mesh.fsdp_shardings` shards, the model's
    own parameter for the others.
    """

    def __init__(self, params: dict, mesh,
                 min_size_to_shard: int = 2 ** 18):
        self.full = params
        self.mesh = mesh
        self.dims = mesh_lib.fsdp_shardings(params, mesh, min_size_to_shard)
        self.sharded = [n for n, d in self.dims.items() if d is not None]
        self.world = mesh.size()
        self.fsdp = mesh.size(1)
        self.fsdp_index = mesh.get_local_rank("fsdp")
        self.fsdp_group = mesh.get_group("fsdp")
        self.data_group = mesh.get_group("data")
        self.data = mesh.size(0)

    def _chunk(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return x.chunk(self.fsdp, dim=self.dims[name])[self.fsdp_index]

    @torch.no_grad()
    def local(self) -> dict:
        return {n: (self._chunk(n, p).clone() if self.dims[n] is not None
                    else p) for n, p in self.full.items()}

    @torch.no_grad()
    def scatter(self, shards: dict) -> None:
        """Copies this process's chunk of each full parameter into its
        shard (after the model's parameters were loaded)."""
        for n in self.sharded:
            shards[n].copy_(self._chunk(n, self.full[n]))

    @torch.no_grad()
    def gather(self, shards: dict) -> None:
        """Writes the full parameters, gathered from every process's
        shards within its ``fsdp`` group, into the model."""
        calls["gather_params"] += 1
        for n in self.sharded:
            shard = shards[n].contiguous()
            parts = [torch.empty_like(shard) for _ in range(self.fsdp)]
            dist.all_gather(parts, shard, group=self.fsdp_group)
            self.full[n].copy_(torch.cat(parts, dim=self.dims[n]))

    @torch.no_grad()
    def whole(self, tensors: dict) -> dict:
        """{name: full tensor} of a dict of shards and whole tensors (the
        parameters, the moments or the gradients), gathered within the
        ``fsdp`` group."""
        out = {}
        for n, x in tensors.items():
            if self.dims.get(n) is None:
                out[n] = x
                continue
            parts = [torch.empty_like(x) for _ in range(self.fsdp)]
            dist.all_gather(parts, x.contiguous(), group=self.fsdp_group)
            out[n] = torch.cat(parts, dim=self.dims[n])
        return out

    @torch.no_grad()
    def reduce_gradients(self, grads: dict) -> dict:
        """The gradients averaged over every process: a sharded name's as
        this process's shard (reduce-scattered within the ``fsdp`` group,
        then all-reduced over the ``data`` group), the others whole (one
        all-reduce of their concatenation)."""
        calls["reduce_gradients"] += 1
        out = {}
        whole = [n for n in grads if self.dims[n] is None]
        if whole:
            flat = torch.cat([grads[n].float().reshape(-1) for n in whole])
            dist.all_reduce(flat)
            flat /= self.world
            for n, g in zip(whole, flat.split([grads[n].numel()
                                               for n in whole])):
                out[n] = g.view(grads[n].shape)
        for n in self.sharded:
            parts = [p.contiguous() for p in
                     grads[n].float().chunk(self.fsdp, dim=self.dims[n])]
            shard = torch.empty_like(parts[0])
            dist.reduce_scatter(shard, parts, group=self.fsdp_group)
            if self.data > 1:
                dist.all_reduce(shard, group=self.data_group)
            out[n] = shard / self.world
        return {n: out[n] for n in grads}

    def sqsum(self, tensors: dict, names=None) -> torch.Tensor:
        """The sum of squares (fp32) of the full tensors whose shards and
        whole tensors `tensors` holds, over `names` (default: all): the
        shards' sums all-reduced within the ``fsdp`` group."""
        names = list(tensors) if names is None else list(names)
        sharded = set(self.sharded)
        device = next(iter(self.full.values())).device
        whole = sum((tensors[n].float().square().sum() for n in names
                     if n not in sharded), torch.zeros((), device=device))
        parts = sum((tensors[n].float().square().sum() for n in names
                     if n in sharded), torch.zeros((), device=device))
        if self.fsdp > 1:
            dist.all_reduce(parts, group=self.fsdp_group)
        return whole + parts


def broadcast_parameters(params: dict, src: int = 0) -> None:
    """Copies process `src`'s parameters to every process (one identical
    initialization, whatever each process drew)."""
    if not initialized():
        return
    with torch.no_grad():
        for p in params.values():
            dist.broadcast(p.data, src)


def reduce_scalar_mean(values: dict) -> dict:
    """{name: 0-d tensor} averaged over the processes, with one all-reduce
    (measurements)."""
    if not initialized() or not values:
        return values
    names = list(values)
    stacked = torch.stack([values[n].detach().float().reshape(())
                           for n in names])
    dist.all_reduce(stacked)
    stacked /= world_size()
    return dict(zip(names, stacked.unbind()))

