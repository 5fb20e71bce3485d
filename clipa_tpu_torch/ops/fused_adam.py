"""The optimizer's Adam chain for every parameter in one CUDA pass.

``csrc/fused_adam.cu`` replaces no Pallas kernel: the JAX package runs the
chain as an optax transform that XLA fuses (``clipa_tpu/optim.py``
``scale_by_fused_adam``, :143-230), while the port ran it as eager
PyTorch, some twenty elementwise kernels per leaf issued by a host loop
that left the card idle (907 leaves at H/14). The op is bound by bytes: it
reads p, g, mu and nu once and writes p, mu and nu once, 24 bytes per
parameter with fp32 p, g and nu and a bf16 mu (6.9 ms at H/14, 3.0 ms at
L/16, at 3.35 TB/s). So the design moves each byte once and issues one
launch per step: a chunk table over all leaves (one block per chunk of at
most :data:`CHUNK` elements, the tiny leaves and the large ones in one
grid), 16-byte loads where a chunk's pointers allow, the leaves' pointers
and constants on the device from construction, and per step only the
gradients' pointers (one asynchronous copy from pinned memory) and the
step's scalars (launch arguments; the clip's norm by device pointer).

The plain version is the per-parameter chain,
``optim.Optimizer.chain_update``: the only route for CPU tensors, and the
one the kernel matches bit for bit on the card (``tests/test_torch_cuda.py``:
the kernel rounds after every op as PyTorch's CUDA kernels do, see the
source). :class:`AdamTables` is built by ``optim.Optimizer`` over CUDA
parameters; :func:`fused_adam_step` launches the kernel or raises, never
falling back.

Dtypes: fp32 parameters and gradients, mu and nu each fp32 or bf16 (what
a config's ``mu_dtype`` and ``nu_dtype`` can name), scale_by_adam or
scale_by_fused_adam, all instantiated in the source; one launch a step
(the optimizer makes every mu of one dtype and every nu of one). Any other
dtype is refused, as is a parameter, mu or nu that is not contiguous (at
construction: the kernel updates them in place) or a gradient not of its
parameter's shape (at the step). A gradient that is a strided view
(autograd's, for a weight the model uses permuted, as the conv towers'
stems) is copied to a contiguous one first; the others are read in place.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from clipa_tpu_torch.ops import cuda_build

_SOURCE = "fused_adam.cu"
_ENTRY = "clipa_fused_adam"

# csrc/fused_adam.cu with_moment_dtype's codes; parameters and gradients
# are fp32
MOMENT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# elements per chunk (one block each); a multiple of the kernel's 8-element
# vector step, so every chunk of an aligned leaf starts aligned
CHUNK = 1 << 16
# schedules one launch takes (csrc kMaxGroups)
MAX_GROUPS = 8

# csrc/fused_adam.cu Leaf and Chunk
LEAF = np.dtype({
    "names": ["p", "mu", "nu", "numel", "out", "wd", "lr_mult", "lwd",
              "group", "has_wd"],
    "formats": ["<u8", "<u8", "<u8", "<i8", "<i8", "<f4", "<f4", "<f4",
                "<i4", "<i4"],
    "offsets": [0, 8, 16, 24, 32, 40, 44, 48, 52, 56],
    "itemsize": 64})
CHUNK_ROW = np.dtype({"names": ["leaf", "len", "begin"],
                      "formats": ["<i4", "<i4", "<i8"],
                      "offsets": [0, 4, 8], "itemsize": 16})


class StepArgs(ctypes.Structure):
    """csrc/fused_adam.cu StepArgs: the step's scalars, each the fp32 value
    PyTorch's CUDA kernels compute with in the chain."""
    _fields_ = [(name, ctypes.c_float) for name in (
        "one_minus_b1", "b1", "b1_mu", "one_minus_b2", "b2", "inv_bc1",
        "inv_bc2", "eps_root", "eps", "lr", "clip")] + [
        ("n_groups", ctypes.c_int32), ("norm", ctypes.c_void_p),
        ("updates", ctypes.c_void_p), ("sched", ctypes.c_float * MAX_GROUPS)]


def _f32(x: float) -> float:
    """A Python scalar as PyTorch hands it to an fp32 kernel."""
    return float(np.float32(x))


def update_offsets(params: dict) -> tuple[dict, int]:
    """({name: offset of the leaf in the flat fp32 updates buffer}, its
    length): every parameter in the dict's order."""
    offsets, total = {}, 0
    for n, p in params.items():
        offsets[n] = total
        total += p.numel()
    return offsets, total


def leaf_table(opt, names) -> np.ndarray:
    """The kernel's leaf table (:data:`LEAF` rows) of the unfrozen leaves
    `names` of `opt` (an ``optim.Optimizer``), in that order: the
    parameter's and moments' pointers, the numel, the offset in the updates
    buffer, and the chain's per-leaf constants, ``opt.wd`` (has_wd where the
    name is in it), ``opt.lr_mults`` and ``opt.lwd`` (1 where absent) and
    ``opt.group``. Pure: runs on any device."""
    offsets, _ = update_offsets(opt.params)
    rows = np.zeros(len(names), LEAF)
    for i, n in enumerate(names):
        if opt.group[n] is None:
            raise ValueError(f"{n} is frozen: the kernel takes no frozen leaf")
        rows[i] = (opt.params[n].data_ptr(), opt.mu[n].data_ptr(),
                   opt.nu[n].data_ptr(), opt.params[n].numel(), offsets[n],
                   opt.wd.get(n, 0.0), opt.lr_mults.get(n, 1.0),
                   opt.lwd.get(n, 1.0), opt.group[n], int(n in opt.wd))
    return rows


def chunk_table(numels, leaves, chunk: int = CHUNK) -> np.ndarray:
    """:data:`CHUNK_ROW` rows cutting each leaf (index `leaves[i]`, of
    `numels[i]` elements) into pieces of at most `chunk`: every element in
    exactly one row."""
    rows = [(leaf, min(chunk, n - begin), begin)
            for leaf, n in zip(leaves, numels)
            for begin in range(0, n, chunk)]
    return np.array(rows, CHUNK_ROW)


def _check(t: torch.Tensor, what: str, device: torch.device,
           dtypes) -> None:
    if t.device != device:
        raise ValueError(f"{what} on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: {t.dtype} (the kernel takes "
                        f"{', '.join(map(str, dtypes))})")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")


class AdamTables:
    """The kernel's per-optimizer state on the card, built once from an
    ``optim.Optimizer`` over CUDA parameters: the leaf table, the chunk
    table and a buffer for the gradients' pointers. Raises for a parameter
    or moment that is not contiguous, of a dtype the kernel lacks (or, for
    a moment, not the first leaf's), on another device, or sharing memory
    with another parameter (the kernel updates each in place). Holds the
    moments' storage: ``load_state_dict`` copies into it."""

    def __init__(self, opt):
        params = opt.params
        self.device = next(iter(params.values())).device
        if self.device.type != "cuda":
            raise ValueError(f"the fused Adam kernel runs on CUDA tensors, "
                             f"got {self.device}")
        self.names = [n for n in params
                      if opt.group[n] is not None and params[n].numel()]
        if not self.names:
            raise ValueError("every parameter is frozen: nothing to update")
        first = self.names[0]
        for n in self.names:
            _check(params[n], f"parameter {n}", self.device,
                   [torch.float32])
            for key, m in (("mu", opt.mu), ("nu", opt.nu)):
                _check(m[n], f"{key}[{n}]", self.device,
                       [m[first].dtype] if n != first else MOMENT_DTYPES)
        spans = sorted((params[n].data_ptr(), params[n].data_ptr()
                        + params[n].numel() * params[n].element_size(), n)
                       for n in self.names)
        for (_, end, a), (start, _, b) in zip(spans, spans[1:]):
            if start < end:
                raise ValueError(f"parameters {a} and {b} share memory")
        self.offsets, self.total = update_offsets(params)
        self.complete = len(self.names) == len(params)
        self.m_dtype, self.n_dtype = opt.mu[first].dtype, opt.nu[first].dtype
        self.shapes = [params[n].shape for n in self.names]
        chunks = chunk_table([params[n].numel() for n in self.names],
                             range(len(self.names)))
        self.chunks = torch.from_numpy(chunks.view(np.uint8)).to(self.device)
        self.n_chunks = len(chunks)
        table = leaf_table(opt, self.names)
        self.leaves = torch.from_numpy(table.view(np.uint8)).to(self.device)
        self.grad_ptrs = torch.empty(len(self.names), dtype=torch.int64,
                                     device=self.device)


def library() -> ctypes.CDLL:
    """The kernel's library, built at first use: (leaves, chunks, grads,
    n_chunks, mu and nu dtype codes, fused, args, stream)."""
    return cuda_build.load_entries(
        _SOURCE, [_ENTRY],
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)


def step_args(opt, m_dtype: torch.dtype, bc1: float, bc2: float,
              sched, norm: Optional[torch.Tensor],
              updates: Optional[torch.Tensor]) -> StepArgs:
    """The launch's scalars for `opt`'s chain, each as PyTorch's CUDA
    kernels take it: a Python scalar rounded to fp32; a division by one a
    multiply by its fp32 reciprocal; scale_by_adam's b1 as a 0-d tensor of
    mu's dtype."""
    if len(sched) > MAX_GROUPS:
        raise ValueError(f"{len(sched)} schedules; the kernel takes at most "
                         f"{MAX_GROUPS}")
    one = np.float32(1)
    return StepArgs(
        one_minus_b1=_f32(1 - opt.b1), b1=_f32(opt.b1),
        b1_mu=float(torch.tensor(opt.b1, dtype=m_dtype)),
        one_minus_b2=_f32(1 - opt.b2), b2=_f32(opt.b2),
        inv_bc1=float(one / np.float32(bc1)),
        inv_bc2=float(one / np.float32(bc2)),
        eps_root=_f32(opt.eps_root), eps=_f32(opt.eps), lr=_f32(opt.lr),
        clip=_f32(opt.clip or 0.0), n_groups=max(len(sched), 1),
        norm=None if norm is None else norm.data_ptr(),
        updates=None if updates is None else updates.data_ptr(),
        sched=(ctypes.c_float * MAX_GROUPS)(*map(_f32, sched)))


def fused_adam_step(tables: AdamTables, opt, grads: dict, bc1: float,
                    bc2: float, sched, norm: Optional[torch.Tensor],
                    want_updates: bool) -> Optional[dict]:
    """One step of `opt`'s chain by the kernel: the parameters and moments
    of `tables`' leaves move in place. `grads`: {name: fp32 gradient}, each
    in its parameter's shape on the card; `bc1`, `bc2`: the bias
    corrections; `sched`: each schedule's value; `norm`: the gradients'
    global norm (a 0-d fp32 tensor on the card) where the chain clips, else
    None. Returns {name: fp32 update} of every parameter (0 for the frozen)
    when `want_updates`, else None."""
    ptrs, copies = [], []
    for n, shape in zip(tables.names, tables.shapes):
        g = grads[n]
        if g.device != tables.device or g.shape != shape:
            raise ValueError(f"gradient {n}: {tuple(g.shape)} on {g.device}"
                             f", expected {tuple(shape)} on {tables.device}")
        if g.dtype != torch.float32:
            raise TypeError(f"gradient {n}: {g.dtype}; the kernel takes "
                            f"torch.float32")
        if not g.is_contiguous():
            g = g.contiguous()
            copies.append(g)   # alive until the launch is queued
        ptrs.append(g.data_ptr())
    # the gradients' pointers, one copy: the caching host allocator keeps
    # the pinned block from reuse until the copy has run
    host = torch.empty(len(ptrs), dtype=torch.int64, pin_memory=True)
    host.numpy()[:] = ptrs
    tables.grad_ptrs.copy_(host, non_blocking=True)
    out = None
    if want_updates:
        out = (torch.empty if tables.complete else torch.zeros)(
            tables.total, dtype=torch.float32, device=tables.device)
    if norm is not None:
        norm = norm.to(torch.float32).contiguous()
    args = step_args(opt, tables.m_dtype, bc1, bc2, sched, norm, out)
    lib = library()
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream(tables.device).cuda_stream
        err = getattr(lib, _ENTRY)(
            tables.leaves.data_ptr(), tables.chunks.data_ptr(),
            tables.grad_ptrs.data_ptr(), tables.n_chunks,
            MOMENT_DTYPES[tables.m_dtype], MOMENT_DTYPES[tables.n_dtype],
            int(opt.fused), ctypes.byref(args), stream)
    cuda_build.raise_on(err, lib, "fused Adam kernel")
    fused_adam_step.launches += 1
    if out is None:
        return None
    return {n: out[off:off + p.numel()].view(p.shape)
            for (n, p), off in zip(opt.params.items(),
                                   tables.offsets.values())}


# Kernel launches (a plain counter: callers reset it to 0 and read it back to
# prove a step went through the kernel).
fused_adam_step.launches = 0
