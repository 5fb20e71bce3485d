"""Fused multi-head self-attention forward: CUDA kernel and plain version.

Port of the forward half of ``clipa_tpu/ops/block_attention.py``. The three
Pallas forwards there (``_fwd_kernel`` over (B, L, D), ``_fwd2d_kernel`` and
``_fwd2d_bias_kernel`` over flat (B*L, D) rows) compute one function, and on
Hopper one hand-written kernel serves all three:
``csrc/fused_attention_fwd.cu``, launched by :func:`fused_attention`. The
TPU kernels' VMEM plans, sample groups and block-diagonal masks suited
Mosaic only; the CUDA kernel runs one block per (sample, head, q-tile).
bf16 operands go through the tensor cores; fp32 operands (the service at
precision float32) through a scalar fp32 twin in the same source.

:func:`attention_plain` is the same function in plain PyTorch. It is what
the wrapper runs for a tensor on the CPU (the tests), and what the kernel is
held against on the card. It reproduces the Pallas math:

  * fp32 scores from the operand dtype, the scale applied to the fp32
    scores;
  * ``exp(clip(s, +-70))`` with no row max (``_EXP_CLIP``), or the row-max
    form when ``exact``;
  * deferred normalization O = (E.V) / rowsum(E), E cast to the operand
    dtype before the product;
  * per-sample attention only: row i belongs to sample i // seq_len.

The backward kernels (the JAX custom VJPs) are not ported yet; see
ROADMAP.md queue B.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from clipa_tpu_torch.ops import cuda_build

# fp32 exp stays finite for |s| <= 87; see clipa_tpu/ops/block_attention.py
# for why the clip is 70 and what the clipped softmax gives up.
_EXP_CLIP = 70.0

# The kernel's limits: head_dim a multiple of 8 (16-byte row chunks) up to
# 128 (the largest register tile it instantiates).
MAX_HEAD_DIM = 128

# Kernel vs plain version: |kernel - plain| <= ATOL + RTOL * |plain|.
# bf16 operands: both round E to bf16 and the output to bf16, so what remains
# is the fp32 summation order, the hardware exp, and in exact mode the online
# row max (E rounded against the running max, not the final one). Each moves
# an output by well under one bf16 ulp before the last rounding, which can
# then land one ulp (2^-8 relative) apart.
KERNEL_ATOL = 1e-2
KERNEL_RTOL = 1e-2
# fp32 operands: nothing is rounded to a narrower type, so only the fp32
# summation order and exp's last bits differ (a few fp32 ulps over <= 577
# keys); the same 2e-5 the plain version is held to against Pallas.
KERNEL_F32_ATOL = 2e-5
KERNEL_F32_RTOL = 2e-5

# Operand dtype -> the C entry point of csrc/fused_attention_fwd.cu.
_ENTRY = {torch.bfloat16: "clipa_fused_attention_fwd",
          torch.float32: "clipa_fused_attention_fwd_f32"}

_SOURCE = "fused_attention_fwd.cu"


def tolerance(dtype: torch.dtype) -> tuple[float, float]:
    """(atol, rtol) of the kernel against :func:`attention_plain`."""
    if dtype == torch.float32:
        return KERNEL_F32_ATOL, KERNEL_F32_RTOL
    return KERNEL_ATOL, KERNEL_RTOL


def _head_error(d_model: int, num_heads: int) -> Optional[str]:
    """Why the kernel cannot take this width and head count, or None."""
    if num_heads <= 0 or d_model % num_heads:
        return f"width {d_model} not divisible by {num_heads} heads"
    hd = d_model // num_heads
    if hd % 8 or hd > MAX_HEAD_DIM:
        return (f"head_dim {hd} unsupported by the kernel (needs a multiple "
                f"of 8 up to {MAX_HEAD_DIM})")
    return None


def eligible(d_model: int, num_heads: int, mask) -> bool:
    """Whether the fused path takes these operands (the kernel's limits)."""
    return mask is None and _head_error(d_model, num_heads) is None


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, seq_len: int,
                    biases: Optional[Sequence[torch.Tensor]] = None,
                    exact: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device.

    q, k, v: (B*L, D) with L = seq_len; biases: optional three (D,) tensors
    added to q/k/v in the operand dtype (one rounding). Returns (B*L, D) in
    q's dtype.
    """
    rows, d = q.shape
    hd = d // num_heads
    b = rows // seq_len
    if biases is not None:
        bq, bk, bv = biases
        q, k, v = q + bq, k + bk, v + bv

    def heads(x):  # (B*L, D) -> (B, H, L, hd) in fp32
        return x.reshape(b, seq_len, num_heads, hd).transpose(1, 2).float()

    s = heads(q) @ heads(k).transpose(-1, -2) * (hd ** -0.5)
    if exact:
        e = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    else:
        e = s.clamp_(-_EXP_CLIP, _EXP_CLIP).exp_()
    r = e.sum(dim=-1, keepdim=True)
    o = (e.to(q.dtype).float() @ heads(v)) / r
    return o.to(q.dtype).transpose(1, 2).reshape(rows, d)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, seq_len: int,
                    biases: Optional[Sequence[torch.Tensor]] = None,
                    exact: bool = False) -> torch.Tensor:
    """Multi-head self-attention over flat (B*L, D) rows.

    On a CUDA tensor this launches the CUDA kernel (bf16 or fp32 operands);
    on a CPU tensor it runs :func:`attention_plain`. On either it raises on
    a shape the kernel does not take. `biases`: optional (bq, bk, bv), each
    (D,), added inside the kernel. `exact` selects the row-max softmax.
    """
    _check_shapes(q, k, v, num_heads, seq_len, biases)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, num_heads, seq_len, biases, exact)
    if not q.is_cuda:
        raise ValueError(f"fused_attention runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    out = _launch(q, k, v, num_heads, seq_len, biases, exact)
    fused_attention.launches += 1
    return out


# Kernel launches made through fused_attention (a plain counter: callers
# reset it to 0 and read it back to prove a run went through the kernel).
fused_attention.launches = 0


def _check_shapes(q, k, v, num_heads, seq_len, biases) -> None:
    """The kernel's limits, for every device (the one place they live)."""
    if q.dim() != 2:
        raise ValueError(f"expected flat (B*L, D) operands, got {q.shape}")
    rows, d = q.shape
    error = _head_error(d, num_heads)
    if error:
        raise ValueError(error)
    if seq_len <= 0 or rows % seq_len:
        raise ValueError(f"{rows} rows are not a multiple of seq_len "
                         f"{seq_len}")
    if rows // seq_len > 65535 or num_heads > 65535:
        raise ValueError("batch and num_heads must be at most 65535")
    named = [("k", k, (rows, d)), ("v", v, (rows, d))]
    if biases is not None:
        named += [(n, b, (d,)) for n, b in zip(("bq", "bk", "bv"), biases)]
    for name, x, shape in named:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{shape}")


def _check_memory(name: str, x: torch.Tensor, like: torch.Tensor) -> None:
    if x.device != like.device:
        raise ValueError(f"{name} on {x.device}, expected {like.device}")
    if x.dtype not in _ENTRY or x.dtype != like.dtype:
        raise TypeError(f"{name} is {x.dtype}; the CUDA kernel takes q, k, "
                        f"v and biases all bfloat16 or all float32")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library(_SOURCE)
    if lib.clipa_cuda_error_string.argtypes is None:
        for entry in _ENTRY.values():
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.clipa_cuda_error_string.restype = ctypes.c_char_p
        lib.clipa_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _launch(q, k, v, num_heads, seq_len, biases, exact):
    rows, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_memory(name, x, q)
    ptrs = [None, None, None]
    if biases is not None:
        for i, (name, b) in enumerate(zip(("bq", "bk", "bv"), biases)):
            _check_memory(name, b, q)
            ptrs[i] = b.data_ptr()
    hd = d // num_heads
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs, out.data_ptr(),
            rows // seq_len, seq_len, num_heads, hd, hd ** -0.5,
            int(bool(exact)), stream)
    if err:
        raise RuntimeError(
            "fused attention kernel launch failed: "
            f"{lib.clipa_cuda_error_string(err).decode()} (cudaError {err})")
    return out
